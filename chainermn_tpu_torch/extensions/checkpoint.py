"""Distributed checkpointing with generation GC and auto-resume.

Counterpart of ``chainermn_tpu/extensions/checkpoint.py`` (the reference's
``create_multi_node_checkpointer``): each rank saves its own state under a
shared name and path, old generations are collected, and ``resume()``
restores every rank from the newest generation that every rank holds --
the reference's crash recovery (fail-stop, then snapshot and resume).

The format is the JAX package's npz backend: one file per rank and
generation, ``{path}/{name}.{iteration}.rank{r}.npz``, written to
``....tmp.npz`` and published with ``os.replace``.  A state is a tree
(dicts, lists, tuples) of tensors, numpy arrays and numbers; its leaves are
stored under their paths in the tree (``model/conv_init.weight``), with a
sidecar of their dtypes, so a resume can refuse a leaf whose name, shape or
dtype differs from the live state's -- which is how ZeRO-1 shards saved at
another world size are refused.  bfloat16 tensors are stored as their
16-bit patterns.

An :class:`~chainermn_tpu_torch.parallel.FsdpState` in the state is
stored as ``{path}/shards/{bucket}/{buffer}`` (this rank's shards) and
``{path}/inner/...`` (its optimizer's state), and restored in place; the
``__fsdp_meta__`` sidecar holds the world size, the bucket count and the
shard lengths, so a resume into another world size or bucket
configuration, or between sharded and unsharded states, is refused before
anything is restored.  :func:`consolidate_fsdp_checkpoint` turns a
sharded checkpoint into full parameters, reading every rank's file: a
process of any world (a server) can load what the training world saved.

A :class:`~chainermn_tpu_torch.compression.CompressionState` (a
quantized FSDP bucket's, inside its FsdpState, or a compressed optimizer's
``comp_state`` put in the tree) is stored as ``{path}/ef``, ``/scale`` and
``/step`` and restored in place; the ``__compression_meta__`` sidecar
holds the compressor specs and the EF version, and a resume refuses a
checkpoint with EF state into a target without compression, one without
into a compressed target, and a compressor config other than the live
one (JAX's three refusals).

After an online plan-table hot-swap
(:func:`~chainermn_tpu_torch.planner.set_active_plan_table`) a save pins the
live table's content hash and swap step in the ``__plan_table_meta__``
sidecar; a resume refuses a checkpoint whose pinned table is not the live
one, and one that pins a table while none is registered (JAX's two
refusals): the run would execute other collective plans than the one that
saved.

A save is two parts (JAX's split): :meth:`_snapshot_arrays`, the
device-to-host copy and the sidecars, taken at the step boundary into host
memory that no live tensor shares, and :meth:`_persist`, the npz write,
the atomic publish and the generation GC.  ``backend="async"`` runs the
second part on a background thread
(:mod:`chainermn_tpu_torch.elastic.async_ckpt`); ``orbax`` has no twin in
PyTorch.
"""

from __future__ import annotations

import json
import os
import re
import time
import zipfile
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from chainermn_tpu_torch.compression import (
    CompressionState, compression_layout)
from chainermn_tpu_torch.parallel.fsdp import (
    FsdpMeta, FsdpState, fsdp_full_params, fsdp_layout, iter_fsdp_states,
    unpack_full_params)

# the sidecar of each leaf's dtype (no leaf path starts with "__")
_DTYPES_KEY = "__dtypes__"
# the FSDP sharding layout (world size, buckets, shard lengths)
_FSDP_META_KEY = "__fsdp_meta__"
# the compression config of every error-feedback state in the tree
_COMPRESSION_META_KEY = "__compression_meta__"
# the hash and swap step of the live (hot-swapped) plan table
_PLAN_TABLE_META_KEY = "__plan_table_meta__"


def _leaves(tree, prefix: str = "") -> Dict[str, object]:
    """``{path: leaf}`` of a tree of dicts, lists and tuples (an
    FsdpState as its :meth:`~FsdpState.tree`)."""
    if isinstance(tree, (FsdpState, CompressionState)):
        return _leaves(tree.tree(), prefix)
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _rebuild(tree, values: Dict[str, object], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[path]``;
    an FsdpState is restored in place and returned."""
    if isinstance(tree, (FsdpState, CompressionState)):
        tree.load_tree(_rebuild(tree.tree(), values, prefix))
        return tree
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _rebuild(v, values, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return values[prefix]


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype)
    return "numpy." + np.asarray(leaf).dtype.name


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if torch.is_tensor(leaf) else \
        np.shape(leaf)


def _host_copy(leaves: Dict[str, object]) -> Dict[str, np.ndarray]:
    """``{path: array}``, each array a host copy of its leaf that shares
    no memory with it.  A CUDA tensor is copied into pinned host memory
    on the current stream (so after the work that produced it), all of
    them queued before one wait: when this returns every copy has landed
    and a later in-place update of the leaf cannot reach the snapshot."""
    out: Dict[str, np.ndarray] = {}
    pending = False
    for k, leaf in leaves.items():
        if torch.is_tensor(leaf) and leaf.is_cuda:
            buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            buf.copy_(leaf.detach(), non_blocking=True)
            pending = True
        elif torch.is_tensor(leaf):
            buf = leaf.detach().clone()
        else:
            out[k] = np.array(leaf)
            continue
        if buf.dtype == torch.bfloat16:
            buf = buf.view(torch.int16)
        out[k] = buf.numpy()
    if pending:
        torch.cuda.current_stream().synchronize()
    return out


def _restore_leaf(arr: np.ndarray, like):
    """The saved array as a leaf of ``like``'s kind, dtype and device."""
    if torch.is_tensor(like):
        t = torch.from_numpy(np.array(arr))
        if like.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(like.device)
    if isinstance(like, np.ndarray):
        return np.array(arr)
    return arr[()]  # numpy scalars and Python numbers: a numpy scalar


class _MultiNodeCheckpointer:
    def __init__(self, comm, path: str, name: str, keep: int = 2):
        self.comm = comm
        self.path = path
        self.name = name
        self.keep = keep
        # seconds each save of this process took, device copy included
        self.save_seconds: List[float] = []
        os.makedirs(path, exist_ok=True)

    # -- naming --------------------------------------------------------------
    def _file(self, iteration: int, rank: Optional[int] = None) -> str:
        r = self.comm.rank if rank is None else rank
        return os.path.join(self.path,
                            f"{self.name}.{iteration}.rank{r}.npz")

    def _local_generations(self) -> List[int]:
        pat = re.compile(
            rf"^{re.escape(self.name)}\.(\d+)\.rank{self.comm.rank}\.npz$")
        return sorted(int(m.group(1)) for m in map(pat.match,
                                                   os.listdir(self.path))
                      if m)

    # -- save / GC -----------------------------------------------------------
    def save(self, state, iteration: int) -> None:
        """Write this rank's ``state`` as generation ``iteration``, publish
        it atomically, then collect old generations."""
        from chainermn_tpu_torch.observability import (
            flight_recorder as _flight)
        fr = _flight.get_flight_recorder()
        tok = None
        if fr is not None:
            tok = fr.span_begin("checkpoint", "checkpoint_save",
                                iteration=iteration)
        t0 = time.perf_counter()
        try:
            self._persist(self._snapshot_arrays(state), iteration)
        finally:
            if tok is not None:
                fr.span_end(tok)
        self.save_seconds.append(time.perf_counter() - t0)

    def _snapshot_arrays(self, state) -> dict:
        """The device-to-host copy plus the sidecars: the only part of a
        save that must happen at the step boundary.  Returns the whole npz
        payload, a copy that owns its memory (the live tensors are updated
        in place by the next step), so :meth:`_persist` can write it from
        any thread later (the async backend's split)."""
        leaves = _leaves(state)
        arrays = _host_copy(leaves)
        arrays[_DTYPES_KEY] = np.array(json.dumps(
            {k: _dtype_name(v) for k, v in leaves.items()}))
        layout = fsdp_layout(state)
        if layout is not None:
            arrays[_FSDP_META_KEY] = np.array(json.dumps(layout))
        clayout = compression_layout(state)
        if clayout is not None:
            arrays[_COMPRESSION_META_KEY] = np.array(json.dumps(clayout))
        from chainermn_tpu_torch.planner.online import active_plan_table_meta
        tmeta = active_plan_table_meta()
        if tmeta is not None:
            arrays[_PLAN_TABLE_META_KEY] = np.array(json.dumps(tmeta))
        return arrays

    def _persist(self, arrays: dict, iteration: int) -> None:
        """Write and atomically publish one snapshot, then collect old
        generations.  The collection runs strictly after ``os.replace``:
        a generation is never collected while the one that supersedes it
        is still a torn temp file (the write barrier the async backend
        relies on).  It reads only the directory and runs no collective,
        so any thread may call it."""
        # np.savez appends .npz when missing, so the temp name ends in it
        tmp = self._file(iteration) + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._file(iteration))
        self._gc()

    def _all_rank_generations(self) -> Dict[int, Set[int]]:
        """generation -> ranks with a published file (every rank's files
        that this directory shows)."""
        pat = re.compile(
            rf"^{re.escape(self.name)}\.(\d+)\.rank(\d+)\.npz$")
        out: Dict[int, Set[int]] = {}
        for m in map(pat.match, os.listdir(self.path)):
            if m:
                out.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
        return out

    def _gc(self) -> None:
        """Delete this rank's generations past the newest ``keep``, but
        never one at or after the newest generation that every rank seen
        in the directory (below ``comm.size``) holds: a peer that lags may
        still need it to resume.  ``keep=0`` keeps everything."""
        if not self.keep:
            return
        candidates = self._local_generations()[:-self.keep]
        if not candidates:
            return
        by_gen = self._all_rank_generations()
        present: Set[int] = set()
        for ranks in by_gen.values():
            present |= {r for r in ranks if r < self.comm.size}
        complete = [g for g, ranks in by_gen.items()
                    if present and present <= ranks]
        newest_complete = max(complete) if complete else None
        for g in candidates:
            if newest_complete is not None and g >= newest_complete:
                continue
            try:
                os.remove(self._file(g))
            except OSError:
                pass

    # -- resume --------------------------------------------------------------
    @staticmethod
    def _is_readable(fn: str) -> bool:
        """True when the npz at ``fn`` is a complete zip whose CRCs check."""
        try:
            with zipfile.ZipFile(fn) as z:
                return z.testzip() is None
        except (OSError, zipfile.BadZipFile):
            return False

    def latest_consistent_generation(self) -> Optional[int]:
        """The newest generation every rank holds a readable file of (a
        collective over the object plane)."""
        local = [g for g in self._local_generations()
                 if self._is_readable(self._file(g))]
        common = None
        for gens in self.comm.allgather_obj(local):
            common = set(gens) if common is None else common & set(gens)
        return max(common) if common else None

    def _validate_fsdp(self, arrays: dict, state, gen: int) -> None:
        """Refuse a world-size, bucket or sharding-mode mismatch before any
        leaf is restored (an FSDP checkpoint reloaded into another world
        would train on garbage shards)."""
        raw = arrays.pop(_FSDP_META_KEY, None)
        saved = json.loads(str(raw)) if raw is not None else None
        live = fsdp_layout(state)
        where = f"{self.name}.{gen} (rank {self.comm.rank})"
        if saved is None and live is not None:
            raise ValueError(
                f"checkpoint {where} holds no FSDP-sharded state but the "
                f"resume target is an FsdpState (world_size="
                f"{live['world_size']}) -- resume into the unsharded state "
                f"it was saved from, then shard it with fsdp_init")
        if saved is None:
            return
        if live is None:
            raise ValueError(
                f"checkpoint {where} holds an FSDP-sharded state "
                f"(world_size={saved['world_size']}) but the resume "
                f"target is unsharded -- export full parameters via "
                f"fsdp_full_params(state, meta, comm) before saving, or "
                f"resume into an FsdpState from fsdp_init on the same world")
        if saved["world_size"] != self.comm.size:
            raise ValueError(
                f"checkpoint {where} was saved with FSDP "
                f"world_size={saved['world_size']} but this world has "
                f"comm.size={self.comm.size}; shard layouts are bound to "
                f"the world size -- restore on a matching world, export "
                f"with fsdp_full_params and re-shard with fsdp_init (the "
                f"cross-size/cross-mode path), or, for inference, "
                f"consolidate with consolidate_fsdp_checkpoint and load "
                f"the full params with chainermn_tpu_torch.serving.weights."
                f"load_inference_params (world-size-free)")
        if saved["num_buckets"] != live["num_buckets"]:
            raise ValueError(
                f"checkpoint {where} was saved with "
                f"num_buckets={saved['num_buckets']} but the live "
                f"FsdpState was built with "
                f"num_buckets={live['num_buckets']}; the bucketed shard "
                f"layout is bound to the bucket config -- pass the same "
                f"num_buckets/bucket_bytes to fsdp_init before resuming, or "
                f"export with fsdp_full_params and re-shard under the new "
                f"config")
        if saved["shard_lens"] != live["shard_lens"]:
            raise ValueError(
                f"checkpoint {where} shard layout {saved['shard_lens']} "
                f"does not match the live FsdpState layout "
                f"{live['shard_lens']} -- the model or packing changed "
                f"since the save")

    def _validate_compression(self, arrays: dict, state, gen: int) -> None:
        """Refuse EF state saved under another compressor config (or
        none) before any leaf is restored: residuals and delayed scales
        are bound to the compressor's spec."""
        where = f"{self.name}.{gen} (rank {self.comm.rank})"
        raw = arrays.pop(_COMPRESSION_META_KEY, None)
        saved = json.loads(str(raw)) if raw is not None else None
        live = compression_layout(state)
        if saved is not None and live is None:
            raise ValueError(
                f"checkpoint {where} carries error-feedback compression "
                f"state for {saved['specs']} but the resume target has "
                f"no compression configured -- rebuild with the same "
                f"compression config (fsdp_init(bucket_compressors=...) "
                f"/ create_multi_node_optimizer(compression=...)), or "
                f"restart training fresh to drop the EF state")
        if saved is None and live is not None:
            raise ValueError(
                f"checkpoint {where} has no compression state but the "
                f"resume target expects EF state for {live['specs']} -- "
                f"resume into an uncompressed state and re-init, or save "
                f"from a compressed run; EF residuals cannot be "
                f"fabricated from an uncompressed checkpoint")
        if saved is not None and saved != live:
            raise ValueError(
                f"checkpoint {where} compression config {saved} does "
                f"not match the live config {live} -- the EF residuals "
                f"and delayed scales are bound to the compressor spec; "
                f"pass the identical compression config, or restart "
                f"fresh under the new one")

    def _validate_plan_table(self, arrays: dict, gen: int) -> None:
        """Refuse a checkpoint saved after a plan-table hot-swap unless the
        same table is live here: resuming without it (or with another)
        would silently execute other collective plans than the run that
        saved."""
        from chainermn_tpu_torch.planner.online import active_plan_table_meta
        where = f"{self.name}.{gen} (rank {self.comm.rank})"
        raw = arrays.pop(_PLAN_TABLE_META_KEY, None)
        saved = json.loads(str(raw)) if raw is not None else None
        live = active_plan_table_meta()
        if saved is not None and live is None:
            raise ValueError(
                f"checkpoint {where} was saved after an online plan-table "
                f"hot-swap (table_hash={saved['table_hash']}, swap step "
                f"{saved['swap_step']}) but no active plan table is "
                f"registered in this process -- reload the swapped table "
                f"(PlanTable.load) and register it with "
                f"planner.online.set_active_plan_table before resuming, "
                f"or, to deliberately discard the tuned plans, resume into "
                f"a fresh run without the sidecar (re-save after "
                f"planner.online.clear_active_plan_table)")
        if saved is not None and saved["table_hash"] != live["table_hash"]:
            raise ValueError(
                f"checkpoint {where} pins plan table {saved['table_hash']} "
                f"(hot-swapped at step {saved['swap_step']}) but the active "
                f"table is {live['table_hash']} -- the run would silently "
                f"execute different collective plans than the one that "
                f"saved; register the matching table via "
                f"planner.online.set_active_plan_table(PlanTable.load(...)) "
                f"or re-tune from scratch with "
                f"planner.online.clear_active_plan_table()")

    def _validate(self, arrays: dict, leaves: dict, gen: int) -> None:
        where = f"{self.name}.{gen} (rank {self.comm.rank})"
        saved = json.loads(str(arrays.pop(_DTYPES_KEY)))
        missing = sorted(set(leaves) - set(saved))
        extra = sorted(set(saved) - set(leaves))
        if missing or extra:
            raise ValueError(
                f"checkpoint {where} does not hold the live state's leaves: "
                f"missing {missing[:5]}, not in the live state {extra[:5]}")
        for k, leaf in leaves.items():
            got, want = tuple(arrays[k].shape), _shape(leaf)
            if got != want:
                raise ValueError(
                    f"checkpoint {where} leaf {k!r} has shape {got} but the "
                    f"live state expects {want} -- another model, or ZeRO-1 "
                    f"shards saved at another world size (this world has "
                    f"{self.comm.size} ranks)")
            if saved[k] != _dtype_name(leaf):
                raise ValueError(
                    f"checkpoint {where} leaf {k!r} is {saved[k]} but the "
                    f"live state holds {_dtype_name(leaf)}")

    def resume(self, state):
        """Restore the newest consistent generation into ``state``'s
        structure; returns ``(restored, iteration)``, or ``(state, None)``
        when there is none (a fresh start).  Tensors come back on the
        device and in the dtype of the live leaves."""
        from chainermn_tpu_torch.observability import (
            flight_recorder as _flight)
        gen = self.latest_consistent_generation()
        if gen is None:
            return state, None
        fr = _flight.get_flight_recorder()
        tok = None
        if fr is not None:
            tok = fr.span_begin("checkpoint", "checkpoint_resume",
                                generation=gen)
        try:
            with np.load(self._file(gen)) as data:
                arrays = {k: data[k] for k in data.files}
            self._validate_fsdp(arrays, state, gen)
            self._validate_compression(arrays, state, gen)
            self._validate_plan_table(arrays, gen)
            leaves = _leaves(state)
            self._validate(arrays, leaves, gen)
            return _rebuild(state, {k: _restore_leaf(arrays[k], v)
                                    for k, v in leaves.items()}), gen
        finally:
            if tok is not None:
                fr.span_end(tok)

    def finalize(self) -> None:
        self.comm.barrier()


def _load_file(fn: str) -> dict:
    with np.load(fn) as data:
        return {k: data[k] for k in data.files}


def _complete_generation(ckpt, world_size: int) -> Optional[int]:
    """The newest generation of which ranks ``0..world_size-1`` each have
    a readable file in ``ckpt``'s directory (no collective)."""
    for gen, ranks in sorted(ckpt._all_rank_generations().items(),
                             reverse=True):
        if set(range(world_size)) <= ranks and all(
                ckpt._is_readable(ckpt._file(gen, r))
                for r in range(world_size)):
            return gen
    return None


def consolidate_fsdp_checkpoint(state, metas, checkpointer=None, comm=None,
                                generation: Optional[int] = None):
    """Consolidate every FSDP-sharded sub-state of a training state into
    its full parameters: the world-size-free export that
    :func:`chainermn_tpu_torch.serving.weights.load_inference_params`
    takes.

    ``state`` is a tree (dicts, lists, tuples) holding one or more
    :class:`~chainermn_tpu_torch.parallel.FsdpState` nodes, ``metas`` the
    matching :class:`~chainermn_tpu_torch.parallel.FsdpMeta` (or a
    sequence of them, one per FsdpState in ``iter_fsdp_states`` order).
    Returns the tree with each FsdpState replaced by its ``{name: tensor}``
    parameters; the inner optimizer's state is dropped.

    * With ``checkpointer``, the parameters come from the checkpoint:
      generation ``generation`` (default: the newest that every rank of
      the metas' world saved), every rank's file read in turn, so no
      collective runs and the caller's world may have any size -- a
      one-process server loads what four ranks saved.  There ``state`` is
      a template: an FsdpState only marks where the parameters go and the
      device they go to (build it with ``fsdp_init`` on the caller's own
      communicator), and every other leaf is restored from rank 0's file.
    * Without it, the live shards are gathered
      (:func:`~chainermn_tpu_torch.parallel.fsdp_full_params`, a
      collective over ``comm``, which every rank calls).
    """
    metas = [metas] if isinstance(metas, FsdpMeta) else list(metas)
    states = list(iter_fsdp_states(state))
    if len(states) != len(metas):
        raise ValueError(
            f"state tree holds {len(states)} FsdpState(s) but {len(metas)} "
            f"FsdpMeta(s) were given -- pass one meta per sharded "
            f"sub-state, in iter_fsdp_states order")
    if checkpointer is None:
        if comm is None:
            raise ValueError("consolidating live FSDP shards gathers them: "
                             "pass the training communicator (comm=)")
        return _consolidated(state, {
            pre: fsdp_full_params(st, m, comm)
            for (pre, st), m in zip(_fsdp_paths(state).items(), metas)})
    worlds = {m.world_size for m in metas}
    if len(worlds) != 1:
        raise ValueError(f"the metas were cut for several worlds {worlds}")
    world = worlds.pop()
    gen = generation if generation is not None else \
        _complete_generation(checkpointer, world)
    if gen is None:
        raise FileNotFoundError(
            f"no generation of {checkpointer.name!r} under "
            f"{checkpointer.path!r} holds a readable file of each of the "
            f"{world} ranks the metas were cut for")
    files = [_load_file(checkpointer._file(gen, r)) for r in range(world)]
    where = f"{checkpointer.name}.{gen}"
    raw = files[0].get(_FSDP_META_KEY)
    saved = json.loads(str(raw)) if raw is not None else None
    want = [[list(bl.shard_lens) for bl in m.buckets] for m in metas]
    if saved is None or saved["world_size"] != world \
            or saved["shard_lens"] != want:
        raise ValueError(
            f"checkpoint {where} layout {saved} does not match the metas "
            f"(world_size={world}, shard_lens={want}) -- pass the metas of "
            f"the training world (make_fsdp_meta(model, world_size, ...))")
    paths = _fsdp_paths(state)
    full = {}
    for (pre, st), meta in zip(paths.items(), metas):
        dev = st.flat_shards()[0].device if st.flat_shards() \
            else torch.device("cpu")
        fulls = []
        for b, bl in enumerate(meta.buckets):
            bufs = []
            # the buffers' dtypes, in pack order (bfloat16 saved as int16)
            for j, key in enumerate(bl.pack_meta[1]):
                name = f"{pre}/shards/{b}/{j}" if pre else f"shards/{b}/{j}"
                parts = [torch.from_numpy(np.array(f[name])) for f in files]
                if key == "bfloat16":
                    parts = [t.view(torch.bfloat16) for t in parts]
                bufs.append(torch.cat(parts).to(dev))
            fulls.append(bufs)
        full[pre] = unpack_full_params(fulls, meta)
    others = _leaves(_consolidated(state, dict.fromkeys(full, {})))
    return _consolidated(state, full, {
        k: _restore_leaf(files[0][k], v) for k, v in others.items()})


def _fsdp_paths(tree, prefix: str = "") -> Dict[str, FsdpState]:
    """``{path: state}`` of the FsdpStates in a tree, in
    ``iter_fsdp_states`` order."""
    if isinstance(tree, FsdpState):
        return {prefix: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_fsdp_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_fsdp_paths(v, f"{prefix}/{i}" if prefix else str(i)))
    return out


def _consolidated(tree, full: dict, values: Optional[dict] = None,
                  prefix: str = ""):
    """``tree`` with the FsdpState at each path of ``full`` replaced by
    ``full[path]`` and, given ``values``, every other leaf by
    ``values[path]``."""
    if isinstance(tree, FsdpState):
        return full[prefix]
    if isinstance(tree, dict):
        return {k: _consolidated(v, full, values,
                                 f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _consolidated(v, full, values,
                          f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return tree if values is None else values[prefix]


def create_multi_node_checkpointer(communicator, path: str,
                                   name: str = "snapshot", keep: int = 2,
                                   backend: str = "npz"):
    """Reference signature: ``create_multi_node_checkpointer(name, comm,
    path=...)``.  ``keep`` newest generations are kept (``keep=0``: all of
    them).  ``backend="npz"`` saves on the calling thread;
    ``backend="async"`` (:class:`~chainermn_tpu_torch.elastic.
    AsyncCheckpointer`) takes the device-to-host snapshot on the calling
    thread and writes the same npz files on a background thread."""
    if keep < 0:
        raise ValueError(f"keep must be >= 0 (got {keep}); "
                         f"0 means retain every generation")
    if backend == "orbax":
        raise NotImplementedError(
            "backend='orbax' has no twin in the PyTorch port (Orbax is "
            "JAX's checkpoint library); use backend='npz'")
    if backend not in ("npz", "async"):
        raise ValueError(f"unknown checkpoint backend {backend!r} "
                         "(expected 'npz', 'async' or 'orbax')")
    inner = _MultiNodeCheckpointer(communicator, path, name, keep)
    if backend == "async":
        from chainermn_tpu_torch.elastic.async_ckpt import AsyncCheckpointer
        return AsyncCheckpointer(inner)
    return inner


__all__ = ["consolidate_fsdp_checkpoint", "create_multi_node_checkpointer"]
