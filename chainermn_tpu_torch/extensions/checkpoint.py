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

Not ported: the ``async`` backend (ROADMAP.md Queue A14) and ``orbax``,
which has no twin in PyTorch; the FSDP, compression and plan-table
sidecars wait for the modules they describe (Queues A9, A10, A11).
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

# the sidecar of each leaf's dtype (no leaf path starts with "__")
_DTYPES_KEY = "__dtypes__"


def _leaves(tree, prefix: str = "") -> Dict[str, object]:
    """``{path: leaf}`` of a tree of dicts, lists and tuples."""
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
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
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


def _to_array(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


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
        t0 = time.perf_counter()
        leaves = _leaves(state)
        arrays = {k: _to_array(v) for k, v in leaves.items()}
        arrays[_DTYPES_KEY] = np.array(json.dumps(
            {k: _dtype_name(v) for k, v in leaves.items()}))
        # np.savez appends .npz when missing, so the temp name ends in it
        tmp = self._file(iteration) + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._file(iteration))
        self._gc()
        self.save_seconds.append(time.perf_counter() - t0)

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
        gen = self.latest_consistent_generation()
        if gen is None:
            return state, None
        leaves = _leaves(state)
        with np.load(self._file(gen)) as data:
            arrays = {k: data[k] for k in data.files}
        self._validate(arrays, leaves, gen)
        return _rebuild(state, {k: _restore_leaf(arrays[k], v)
                                for k, v in leaves.items()}), gen

    def finalize(self) -> None:
        self.comm.barrier()


def create_multi_node_checkpointer(communicator, path: str,
                                   name: str = "snapshot", keep: int = 2,
                                   backend: str = "npz"):
    """Reference signature: ``create_multi_node_checkpointer(name, comm,
    path=...)``.  ``keep`` newest generations are kept (``keep=0``: all of
    them).  Only ``backend="npz"`` is ported."""
    if keep < 0:
        raise ValueError(f"keep must be >= 0 (got {keep}); "
                         f"0 means retain every generation")
    if backend == "async":
        raise NotImplementedError(
            "backend='async' (the elastic runtime's background writer) is "
            "not ported yet; see ROADMAP.md Queue A14")
    if backend == "orbax":
        raise NotImplementedError(
            "backend='orbax' has no twin in the PyTorch port (Orbax is "
            "JAX's checkpoint library); use backend='npz'")
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r} "
                         "(expected 'npz', 'async' or 'orbax')")
    return _MultiNodeCheckpointer(communicator, path, name, keep)


__all__ = ["create_multi_node_checkpointer"]
