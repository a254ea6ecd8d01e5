"""World-resize resume: reshard, re-key, re-tune -- instead of refusing.

Counterpart of ``chainermn_tpu/elastic/resize.py``.  The checkpoint's
FSDP sidecar pins the world size, and the plain ``resume()`` refuses a
generation saved at another one (:mod:`chainermn_tpu_torch.extensions.
checkpoint` -- the right default).  This module is the deliberate
cross-size path those refusals point at:

* **reshard** -- here one process holds one rank's shards, so a saved
  generation is a set of rank files, each with its own slice of every
  bucket's padded flat buffer.  Stacking the saved world's files rebuilds
  JAX's ``[old_size, old_shard]`` leaf, which flattened IS the padded
  buffer (the buckets follow the module's registration order and are cut
  the same at every world size: :func:`~chainermn_tpu_torch.parallel.
  make_fsdp_meta`).  :func:`_resize_stacked` strips the old world's pad,
  re-pads for the new world and reshapes to ``[new_size, new_shard]``;
  this rank keeps its row.  Adam's moments follow their shards through
  the same transform; state every old rank agreed on (the step count) is
  detected by content and broadcast to the new world.
* **re-key** -- error-feedback residuals and delayed scales are bound to a
  rank's shard of the OLD world; they are dropped, the new world keeps the
  fresh zeros of its ``fsdp_init``, and the dropped norm is recorded in
  the report (``dropped_ef_norm``), not silently discarded.
* **re-tune** -- a plan table the saving run pinned belongs to the old
  topology; :func:`retune_plan_table` prices the candidate zoo for the
  NEW topology, hot-swaps it through the ``auto`` communicator's
  ``swap_plan_table`` and re-registers the active-table pin; the hash
  change is recorded in the report instead of refused.

There is one process per card, so the saved world is the number of rank
files of the generation (:func:`_find_resizable_generation`); every one of
them is read.  Resuming at the SAME world size is the ordinary
``checkpointer.resume`` (every refusal intact).  The live state must
already hold its optimizer state (``optim.init_optimizer_state(state.
inner)`` after ``fsdp_init``), as for a plain resume.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

_REPORT: Optional[dict] = None


def resize_report() -> Optional[dict]:
    """The report of the last :func:`resume_resized` in this process
    (``None`` before any) -- what the supervisor's workers embed in their
    results."""
    return _REPORT


def _rows_equal(a: np.ndarray) -> bool:
    """True when every row of the stacked leading axis is identical --
    the signature of a replicated leaf."""
    if a.ndim == 0 or a.shape[0] <= 1:
        return True
    return bool(np.all(a == a[:1]))


def _resize_stacked(saved: np.ndarray, want_shape: Tuple[int, ...],
                    report: dict) -> np.ndarray:
    """Reshard one stacked ``[old_size, old_shard]`` buffer leaf to
    ``want_shape`` = ``[new_size, new_shard]``: flatten (recovering the
    old world's padded full buffer), re-pad with zeros or drop the old
    tail pad, reshape.  The payload prefix is preserved exactly; only the
    world-size pad region changes."""
    want = tuple(int(s) for s in want_shape)
    n_new = int(np.prod(want)) if want else 1
    flat = np.asarray(saved).reshape(-1)
    if flat.size < n_new:
        flat = np.concatenate(
            [flat, np.zeros(n_new - flat.size, flat.dtype)])
    elif flat.size > n_new:
        # the tail beyond the new padded length lies inside the OLD
        # world's pad region (orig_len <= n_new always); quantization
        # noise can leave it slightly nonzero, so record, don't refuse
        tail = flat[n_new:]
        report["dropped_pad_maxabs"] = max(
            report.get("dropped_pad_maxabs", 0.0),
            float(np.max(np.abs(tail))) if tail.size else 0.0)
        flat = flat[:n_new]
    report["resharded_leaves"] = report.get("resharded_leaves", 0) + 1
    return flat.reshape(want)


def _resize_inner(saved: np.ndarray, want: Tuple[int, ...],
                  report: dict) -> np.ndarray:
    """One inner-optimizer leaf, stacked over the old world, for the new
    world's stack ``want``: kept, broadcast when replicated (the step
    count), else resharded with its parameters (Adam's moments)."""
    if saved.shape == want:
        return saved
    if saved.shape[1:] == want[1:] and _rows_equal(saved):
        report["replicated_leaves"] = report.get("replicated_leaves", 0) + 1
        return np.broadcast_to(saved[:1], want).copy()
    return _resize_stacked(saved, want, report)


def _find_resizable_generation(ckpt) -> Optional[Tuple[int, int]]:
    """Newest generation with a complete, readable rank set in the
    checkpoint directory, whatever the CURRENT world size.  Returns
    ``(generation, saved_world)`` or ``None``.  One process holds one
    card, so the saved world is the generation's rank count -- or, for a
    sharded state, the world size in rank 0's FSDP sidecar, whose ranks
    must all be there (a rank that died before saving leaves the set short
    of it).  The rank set must be contiguous from 0; readability is the
    CRC check of the consistent-generation vote."""
    from chainermn_tpu_torch.extensions.checkpoint import _FSDP_META_KEY
    by_gen = ckpt._all_rank_generations()
    for g in sorted(by_gen, reverse=True):
        ranks = by_gen[g]
        n = len(ranks)
        if ranks != set(range(n)):
            continue
        if not all(ckpt._is_readable(ckpt._file(g, rank=r)) for r in ranks):
            continue
        with np.load(ckpt._file(g, rank=0)) as data:
            raw = data[_FSDP_META_KEY] if _FSDP_META_KEY in data.files \
                else None
        if raw is not None:
            world = json.loads(str(raw))["world_size"]
            if not isinstance(world, int) or world != n:
                continue
        return g, n
    return None


def _owners(state) -> Tuple[Dict[str, object], Dict[str, object]]:
    """``({path: FsdpState}, {path: CompressionState})`` of the sharded
    and error-feedback nodes of a state tree."""
    from chainermn_tpu_torch.compression import CompressionState
    from chainermn_tpu_torch.parallel.fsdp import FsdpState
    fsdp: Dict[str, object] = {}
    comp: Dict[str, object] = {}

    def walk(node, prefix):
        if isinstance(node, FsdpState):
            fsdp[prefix] = node
            for i, c in enumerate(node.comp):
                if c is not None:
                    comp[f"{prefix}/comp/{i}" if prefix else
                         f"comp/{i}"] = c
        elif isinstance(node, CompressionState):
            comp[prefix] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))

    walk(state, "")
    return fsdp, comp


def _under(path: str, owners) -> Optional[Tuple[str, str]]:
    """``(owner path, rest)`` when ``path`` lies under one of ``owners``."""
    for pre in owners:
        if not pre:
            return pre, path
        if path.startswith(pre + "/"):
            return pre, path[len(pre) + 1:]
    return None


def resume_resized(checkpointer, state, communicator=None,
                   link_gbps: Optional[Dict[str, float]] = None):
    """Resume ``state`` (freshly built for the CURRENT world) from the
    newest complete generation in ``checkpointer``'s directory, even when
    that generation was saved at another world size.

    Returns ``(state, generation, report)`` -- ``generation`` is None on a
    fresh start.  When the saved world size matches the current one this
    is exactly ``checkpointer.resume`` (every sidecar refusal intact).
    Otherwise every saved rank's file is read, the FSDP shards and the
    optimizer state are resharded into this rank's slice, EF state is
    re-keyed, and -- when the saving run pinned a hot-swapped plan table
    and ``communicator`` has ``swap_plan_table`` -- the table is re-tuned
    for the new topology (:func:`retune_plan_table`), the hash change
    recorded in the report.  The FsdpStates are restored in place.
    """
    global _REPORT
    from chainermn_tpu_torch.compression import compression_layout
    from chainermn_tpu_torch.extensions.checkpoint import (
        _COMPRESSION_META_KEY, _DTYPES_KEY, _FSDP_META_KEY,
        _PLAN_TABLE_META_KEY, _leaves, _load_file, _rebuild, _restore_leaf,
        _shape)
    from chainermn_tpu_torch.observability import flight_recorder as _flight

    comm = checkpointer.comm
    if hasattr(checkpointer, "drain"):  # async backend: write barrier
        checkpointer.drain()
    files = getattr(checkpointer, "_inner", checkpointer)
    found = _find_resizable_generation(files)
    if found is None:
        return state, None, {}
    gen, old_world = found
    if old_world == comm.size:
        restored, it = checkpointer.resume(state)
        _REPORT = {"generation": it, "from_world": old_world,
                   "to_world": comm.size, "resized": False}
        return restored, it, _REPORT
    report: dict = {"generation": gen, "from_world": old_world,
                    "to_world": comm.size, "resized": True,
                    "controllers": {"saved": old_world, "now": comm.size}}
    fr = _flight.get_flight_recorder()
    tok = None
    if fr is not None:
        tok = fr.span_begin("checkpoint", "checkpoint_resume_resized",
                            generation=gen, from_world=old_world,
                            to_world=comm.size)
    try:
        saved = [_load_file(files._file(gen, rank=r))
                 for r in range(old_world)]
        where = f"{files.name}.{gen}"
        meta = {}
        for key in (_FSDP_META_KEY, _COMPRESSION_META_KEY,
                    _PLAN_TABLE_META_KEY, _DTYPES_KEY):
            raw = saved[0].get(key)
            meta[key] = json.loads(str(raw)) if raw is not None else None
            for f in saved:
                f.pop(key, None)
        leaves = _leaves(state)
        missing = sorted(set(leaves) - set(meta[_DTYPES_KEY]))
        extra = sorted(set(meta[_DTYPES_KEY]) - set(leaves))
        if missing or extra:
            raise ValueError(
                f"resize: checkpoint {where} does not hold the new state's "
                f"leaves (missing {missing[:5]}, not in the new state "
                f"{extra[:5]}) -- the bucket, optimizer or compression "
                f"config must match the saving run; only the world size "
                f"may differ on the resize path")
        live_comp = compression_layout(state)
        saved_comp = meta[_COMPRESSION_META_KEY]
        if (saved_comp or {}).get("specs") != (live_comp or {}).get("specs"):
            raise ValueError(
                f"resize: checkpoint {where} compression config "
                f"{saved_comp} does not match the new state's {live_comp}")
        fsdp, comp = _owners(state)
        values = {}
        dropped = None
        for k, live in leaves.items():
            stacked = lambda: np.stack([f[k] for f in saved])  # noqa: E731
            if _under(k, comp) is not None:
                # re-key: the new world keeps its fresh EF state
                norm = float(np.linalg.norm(
                    stacked().astype(np.float64).ravel()))
                dropped = (dropped or 0.0) + norm
                values[k] = live
                continue
            hit = _under(k, fsdp)
            want = (comm.size,) + tuple(_shape(live))
            if hit is not None and hit[1].startswith("shards/"):
                row = _resize_stacked(stacked(), want, report)[comm.rank]
            elif hit is not None and hit[1].startswith("inner/"):
                row = _resize_inner(stacked(), want, report)[comm.rank]
            else:
                row = saved[0][k]
                if tuple(row.shape) != tuple(_shape(live)):
                    raise ValueError(
                        f"resize: leaf {k!r} outside an FsdpState was saved "
                        f"with shape {tuple(row.shape)} but the new world "
                        f"expects {tuple(_shape(live))} -- only FsdpState "
                        f"shards and optimizer state reshard across world "
                        f"sizes; replicated leaves must keep their shape")
            values[k] = _restore_leaf(np.asarray(row), live)
        if comp:
            report["rekeyed_comp_states"] = len(comp)
            report["dropped_ef_norm"] = dropped or 0.0
        restored = _rebuild(state, values)
        # plan-table pin: re-tune for the new topology rather than
        # refusing the saved hash (the hash CHANGE is the record)
        saved_t = meta[_PLAN_TABLE_META_KEY]
        if saved_t is not None:
            if communicator is not None \
                    and hasattr(communicator, "swap_plan_table"):
                report["plan_table"] = retune_plan_table(
                    communicator, link_gbps=link_gbps, step=gen,
                    old_meta=saved_t)
            else:
                from chainermn_tpu_torch.planner.online import \
                    clear_active_plan_table
                clear_active_plan_table()
                report["plan_table"] = {
                    "old": saved_t, "new": None,
                    "action": "cleared (no tunable communicator -- "
                              "plans fall back to the flavor default)"}
    finally:
        if tok is not None:
            fr.span_end(tok)
    _REPORT = report
    return restored, gen, report


def retune_plan_table(communicator,
                      link_gbps: Optional[Dict[str, float]] = None,
                      nbytes_grid=(1 << 20, 16 << 20),
                      dtype: str = "float32",
                      step: Optional[int] = None,
                      old_meta: Optional[dict] = None) -> dict:
    """Re-tune the collective plan table for ``communicator``'s
    (post-resize) topology and hot-swap it through ``swap_plan_table`` /
    ``set_active_plan_table``.

    Prices the candidate zoo with modeled link rates
    (:func:`~chainermn_tpu_torch.planner.online.synthesize_sweep_rows` --
    the online tuner's pricing when no observation window exists yet,
    which is the situation right after a restart) and selects per size
    bucket with :func:`~chainermn_tpu_torch.planner.autotune.
    autotune_from_rows`.  ``link_gbps`` is keyed ``"nvlink"``/``"ib"``
    (JAX's ``"ici"``/``"dcn"``).  Returns ``{"old", "new", "topology"}``
    with both table hashes -- the recorded, not refused, hash change.
    """
    from chainermn_tpu_torch.observability import flight_recorder as _flight
    from chainermn_tpu_torch.planner.autotune import autotune_from_rows
    from chainermn_tpu_torch.planner.online import (active_plan_table_meta,
                                                    set_active_plan_table,
                                                    synthesize_sweep_rows)

    if old_meta is None:
        old_meta = active_plan_table_meta()
    topo = communicator.plan_topology()
    rates = dict(link_gbps) if link_gbps else {"nvlink": 10.0, "ib": 1.0}
    rows: List[dict] = []
    for nbytes in nbytes_grid:
        rows.extend(synthesize_sweep_rows(topo, dtype, int(nbytes), rates))
    table, _ = autotune_from_rows(rows)
    communicator.swap_plan_table(table)
    new_meta = set_active_plan_table(
        table, step=step,
        evidence={"kind": "elastic_resize", "topology": topo.key(),
                  "link_gbps": rates})
    fr = _flight.get_flight_recorder()
    if fr is not None:
        fr.record("planner", op="elastic_plan_retune",
                  topology=topo.key(),
                  old_hash=(old_meta or {}).get("table_hash"),
                  new_hash=new_meta["table_hash"])
    return {"old": old_meta, "new": new_meta, "topology": topo.key()}


__all__ = ["resize_report", "resume_resized", "retune_plan_table"]
