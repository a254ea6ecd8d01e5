"""Plan executor: runs a :class:`~chainermn_tpu_torch.planner.ir.Plan` over a
communicator's process groups.

Counterpart of ``chainermn_tpu/planner/compiler.py``.  JAX lowers a plan to
traced primitives inside an SPMD program; here ONE executor issues each
stage eagerly as a ``torch.distributed`` collective (NCCL on the card, gloo
on the CPU).  The conventions it keeps from the JAX compiler:

* **packing** -- flat plans run over ``_packing.pack`` buffers with the
  1/size mean applied at the end (after the cast back); leaf plans run the
  stage chain per leaf and divide each by the size.  A communicator whose
  own flavor moves leaves packed (``packs_leaf_plans``: hierarchical,
  single_node, one collective per dtype group) runs leaf plans packed the
  same way: each element sees the same stage sums and the same division,
  and only the collectives' summation order follows the layout.
* **padding** -- a reduce-scatter pads its buffer to a multiple of the scope
  size (``_packing.pad_to_multiple``); the matching all-gather strips it.
* **scopes** -- ``intra`` is the communicator's intra (NVLink) group,
  ``inter`` its inter-node group, ``all`` its world.  A scope of one rank
  runs no collective, but its wire casts still run: the JAX compiler emits
  a stage over axes of size 1, so a bf16-wire plan on a world of one still
  rounds the gradients through bf16.
* **wire casts** -- a stage with a ``wire_dtype`` (and a plan with one)
  casts in before its collective and back after, through
  :func:`~chainermn_tpu_torch.ops.cast_scale` (the CUDA kernel on the card;
  float32, bfloat16 and float16); a float8 wire casts with
  ``compression.quantize.to_e4m3fn`` (ml_dtypes' rounding).  A flat plan's
  own wire cast back to float32 carries the 1/size mean (``x * f32 *
  scale``, the ``xla`` flavor's ``_allreduce_grad_wire_start``): the same
  bits as a cast followed by unpack's float32 multiply.
* **all-gather** -- both lowerings gather natively (``all_gather_into_
  tensor``).  JAX's default is a masked psum, which turns a ``-0.0`` into
  ``+0.0``; the values are the same.
* **multicast** is ``dist.broadcast`` from the scope's ``root``; **p2p** one
  ring hop by +1 in one ``batch_isend_irecv``.
* **quantized stages** -- EF-encode, sum the codes over the stage's group in
  wire arithmetic (``MeshCommunicator._sum_codes``), decode.

Per-stage spans (JAX ``pobs``): given a
:class:`~chainermn_tpu_torch.observability.spans.PlanObs`
(``observability.get_plan_obs(comm)``), :func:`execute_plan` and
:func:`execute_alltoall` bracket every emitted stage with
``plan_stage_begin``/``_end`` edges at JAX's points, with JAX's payload
pricing.  JAX's edges are device callbacks that fire when the device
reaches the stage; here the hook synchronizes the buffer's current CUDA
stream before it stamps, so an edge is the stage's and not its launch's
(the cost is one synchronize an edge, only when a ``PlanObs`` is given).
``pobs=None`` adds nothing: no synchronize, no event, the same launches.
Unlike JAX, the executor does not fetch the hook itself: the caller
passes it.

The plan's cost model (:func:`plan_wire_bytes`, :func:`plan_link_bytes`,
:func:`plan_modeled_time_s`, ...) is JAX's arithmetic.  Its link classes are
the card's: ``intra`` rides NVLink (``"nvlink"``), ``inter`` and ``all``
cross the inter-node network (``"ib"``); JAX's ``"ici"``/``"dcn"``.
Function and field names stay JAX's (``plan_dcn_bytes`` prices the
inter-node bytes).

:func:`record_collectives` records the collectives the executor issues,
and :func:`census_of_record` maps them to JAX's HLO census kinds
(:func:`plan_census_kinds`): a default all-gather and a multicast are
``all-reduce`` there (masked psums), a p2p hop ``collective-permute``, and
an fp8 stage's all-to-all plus all-gather is its one code ``all-reduce``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.planner.ir import (Plan, PlanError, PlanTopology,
                                            Stage, dtype_itemsize,
                                            dtype_name, torch_dtype)


def _stage_hook(pobs, plan: Plan, st: Stage, i: int, buf: torch.Tensor,
                edge: str, wire_bytes: Optional[float] = None,
                group: Optional[int] = None) -> None:
    """One per-stage span edge (``plan_stage_begin``/``_end``) once the
    stream has reached it.  ``link`` classes the hop as
    :func:`plan_link_bytes` does (``intra`` rides NVLink, ``inter`` and
    ``all`` the inter-node network); ``wire_bytes`` overrides the payload
    (the leaf path prices the whole tree)."""
    if pobs is None:
        return
    if buf.is_cuda:
        torch.cuda.current_stream(buf.device).synchronize()
    if wire_bytes is None:
        wire_bytes = _stage_wire_elem_bytes(
            plan, st, float(buf.shape[0]), buf.element_size())
    link = "nvlink" if st.scope == "intra" else "ib"
    pobs.edge(edge, plan.name, i, st.op, st.scope, link,
              int(round(wire_bytes)), group=group)


# ---- issuing collectives ----------------------------------------------------

#: while a :func:`record_collectives` block is open: ``(call, stage)`` of
#: every collective the executor issues
_RECORD: Optional[list] = None
_STAGE: Optional[Stage] = None


@contextlib.contextmanager
def record_collectives():
    """Record, in issue order, the collectives the executor starts inside
    the block: a list of ``(call, stage)`` with ``call`` one of
    ``all_reduce``, ``reduce_scatter``, ``all_gather``, ``broadcast``,
    ``p2p``, ``all_to_all``."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _note(call: str) -> None:
    if _RECORD is not None:
        _RECORD.append((call, _STAGE))


#: issued call -> JAX census kind (a default all-gather and a multicast are
#: masked psums in JAX: "all-reduce")
_CALL_KIND = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
              "broadcast": "all-reduce", "p2p": "collective-permute",
              "all_to_all": "all-to-all"}


def census_of_record(record) -> tuple:
    """JAX's census kinds of a :func:`record_collectives` record: one kind
    a collective, with two mappings (see the module note).  A stage over
    one rank issues nothing, where JAX's census still counts it."""
    out = []
    skip = False
    for i, (call, st) in enumerate(record):
        if skip:
            skip = False
            continue
        if call == "all_gather":
            out.append("all-gather" if st is not None
                       and st.lowering == "native" else "all-reduce")
        elif call == "all_to_all" and st is not None and \
                st.op == "all-reduce":
            # an fp8 code sum: all-to-all + float16 shard sum + all-gather
            out.append("all-reduce")
            skip = i + 1 < len(record) and record[i + 1][0] == "all_gather"
        else:
            out.append(_CALL_KIND[call])
    return tuple(out)


def _scope(comm, scope: str):
    """``(group, size, index of this rank, global rank of member i)`` of
    ``comm``'s ranks in ``scope`` (``comm=None``: a world of one)."""
    if comm is None:
        return None, 1, 0, lambda i: i
    if scope == "all":
        return (comm._group, comm.size, comm.rank,
                lambda i: comm._global_rank(i))
    isz = comm.intra_size
    if scope == "intra":
        base = comm.inter_rank * isz
        return (comm._groups["intra"], isz, comm.intra_rank,
                lambda i: comm._global_rank(base + i))
    if scope == "inter":
        return (comm._groups["inter"], comm.inter_size, comm.inter_rank,
                lambda i: comm._global_rank(i * isz + comm.intra_rank))
    raise PlanError(f"unknown scope {scope!r}")


def _all_reduce(comm, buf: torch.Tensor, scope: str) -> torch.Tensor:
    """Sum ``buf`` over the scope (in place when a collective runs)."""
    group, size, _, _ = _scope(comm, scope)
    if size > 1:
        _note("all_reduce")
        comm._plan_all_reduce(buf, group, scope)
    return buf


def _reduce_scatter(comm, buf: torch.Tensor, scope: str) -> torch.Tensor:
    from chainermn_tpu_torch.communicators import mesh_communicator_base as m
    group, size, _, _ = _scope(comm, scope)
    if size == 1:
        return buf
    out = buf.new_empty(buf.shape[0] // size)
    _note("reduce_scatter")
    m.reduce_scatter_tensor(out, buf.contiguous(), dist.ReduceOp.SUM,
                            group=group)
    return out


def _all_gather(comm, shard: torch.Tensor, scope: str) -> torch.Tensor:
    from chainermn_tpu_torch.communicators import mesh_communicator_base as m
    group, size, _, _ = _scope(comm, scope)
    if size == 1:
        return shard
    out = shard.new_empty(shard.shape[0] * size)
    _note("all_gather")
    m.all_gather_tensor(out, shard.contiguous(), group=group)
    return out


def _broadcast(comm, buf: torch.Tensor, scope: str,
               root: int) -> torch.Tensor:
    group, size, _, member = _scope(comm, scope)
    if not 0 <= root < size:
        raise PlanError(f"multicast root {root} is not a rank of scope "
                        f"{scope!r} (size {size})")
    if size > 1:
        buf = buf.contiguous()
        _note("broadcast")
        dist.broadcast(buf, src=member(root), group=group)
    return buf


def _ring_hop(comm, buf: torch.Tensor, scope: str) -> torch.Tensor:
    """Rank ``i`` of the scope sends to ``i + 1`` and receives from
    ``i - 1`` (JAX ``ppermute`` by +1)."""
    group, size, idx, member = _scope(comm, scope)
    if size == 1:
        return buf
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    _note("p2p")
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, member((idx + 1) % size), group=group),
        dist.P2POp(dist.irecv, out, member((idx - 1) % size), group=group)])
    for w in works:
        w.wait()
    return out


def _all_to_all(comm, buf: torch.Tensor, scope: str) -> torch.Tensor:
    """Tiled exchange over the scope's ranks along dim 0 (JAX
    ``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``).  The
    blocks move as bytes: no backend reduces them, and gloo refuses float8
    even here."""
    group, size, _, _ = _scope(comm, scope)
    if size == 1:
        return buf
    src = buf.contiguous()
    raw = src.view(torch.uint8) if src.dim() else src
    out = torch.empty_like(raw)
    _note("all_to_all")
    dist.all_to_all_single(out, raw, group=group)
    return out.view(buf.dtype)


# ---- wire casts -------------------------------------------------------------

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _cast(x: torch.Tensor, dtype: torch.dtype,
          scale: float = 1.0) -> torch.Tensor:
    """``x`` in ``dtype``, times ``scale`` (in float32): the cast kernel for
    float32 / bfloat16 / float16, ml_dtypes' rounding into float8."""
    if x.dtype == dtype and scale == 1.0:
        return x
    if x.dtype in _KERNEL_DTYPES and dtype in _KERNEL_DTYPES:
        from chainermn_tpu_torch.ops.cast_scale import cast_scale
        return cast_scale(x.contiguous(), dtype, scale)
    if scale != 1.0:
        raise ValueError(f"no scaled cast from {x.dtype} to {dtype}")
    if dtype == torch.float8_e4m3fn:
        from chainermn_tpu_torch.compression.quantize import to_e4m3fn
        return to_e4m3fn(x)
    return x.to(dtype)


def _with_wire(buf: torch.Tensor, wire_dtype, fn):
    """Run ``fn`` with ``buf`` cast to the stage wire dtype (if any),
    casting the result back to ``buf``'s dtype (JAX ``_with_wire``)."""
    if wire_dtype is None:
        return fn(buf)
    orig = buf.dtype
    wire = torch_dtype(wire_dtype)
    if wire == orig:
        return fn(buf)
    return _cast(fn(_cast(buf, wire)), orig)


# ---- per-hop compression ----------------------------------------------------

class _ShardFrame:
    """One live reduce-scatter (popped by the matching all-gather)."""

    def __init__(self, scope: str, size: int, padded_len: int, strip):
        self.scope = scope
        self.size = size
        self.padded_len = padded_len
        self.strip = strip


def _quantizer_for(st: Stage):
    """The stage's resolved compressor when it is a stateful quantizer
    (int8/fp8); None for uncompressed and identity-compressed stages."""
    if st.compression is None:
        return None
    from chainermn_tpu_torch.compression import quantize as _cq
    comp = st.compressor()
    return comp if _cq.is_quantizing(comp) else None


def _wire_of(comp) -> str:
    """A compressor's wire dtype name (a quantizer's ``wire``, an identity
    codec's ``wire_dtype``; ``""`` for none)."""
    wire = getattr(comp, "wire", None)
    if isinstance(wire, torch.dtype) or (isinstance(wire, str) and wire):
        return dtype_name(wire)
    wd = getattr(comp, "wire_dtype", None)
    return dtype_name(wd) if wd else ""


def plan_group_lengths(plan: Plan, length: int) -> List[int]:
    """Element count of each concurrent group's slice of a packed flat
    buffer of ``length`` elements: boundaries at ``round(length *
    cumulative_ratio)``, monotone, summing exactly to ``length`` (the last
    group takes the rounding remainder).  A plain plan is one group."""
    groups = plan.stage_groups()
    bounds = [0]
    cum = 0.0
    for grp in groups[:-1]:
        cum += grp.ratio
        b = int(round(length * cum))
        bounds.append(min(max(b, bounds[-1]), int(length)))
    bounds.append(int(length))
    return [bounds[i + 1] - bounds[i] for i in range(len(groups))]


def _stage_at(plan: Plan, key) -> Stage:
    """The Stage a hop key addresses: ``(group, stage)`` tuples for striped
    plans, bare stage indices for plain ones."""
    if isinstance(key, tuple):
        g, i = key
        return plan.groups[g].stages[i]
    return plan.stages[key]


def plan_compressed_hops(plan: Plan,
                         topology: Optional[PlanTopology] = None) -> Dict:
    """``{hop_key: Compressor}`` for every stage carrying a stateful
    quantizer -- the stage index for a plain plan, a ``(group, stage)``
    tuple for a striped one.  With a ``topology``, stages whose scope
    resolves to no axes are dropped (they hold no state)."""
    hops = {}
    striped = plan.groups is not None
    for g, grp in enumerate(plan.stage_groups()):
        for i, st in enumerate(grp.stages):
            if topology is not None and not topology.scope_axes(st.scope):
                continue
            comp = _quantizer_for(st)
            if comp is not None:
                hops[(g, i) if striped else i] = comp
    return hops


def _chain_stage_lengths(stages, topology: PlanTopology,
                         length: int) -> Dict[int, int]:
    lengths: Dict[int, int] = {}
    cur = int(length)
    stack: List[Tuple[int, int]] = []  # (orig_len, padded_len)
    for i, st in enumerate(stages):
        axes = topology.scope_axes(st.scope)
        if not axes:
            continue
        lengths[i] = cur
        if st.op == "reduce-scatter":
            size = topology.scope_size(st.scope)
            padded = cur + (-cur) % size
            stack.append((cur, padded))
            cur = padded // size
        elif st.op == "all-gather":
            orig, _ = stack.pop()
            cur = orig
    return lengths


def plan_stage_lengths(plan: Plan, topology: PlanTopology,
                       length: int) -> Dict:
    """Flat-buffer element count at ENTRY to each stage that runs -- what
    sizes the per-hop EF states (a compressed inter hop after a
    reduce-scatter sees 1/intra of the packed buffer).  Keys as
    :func:`plan_compressed_hops`."""
    if plan.groups is None:
        return _chain_stage_lengths(plan.stages, topology, length)
    lengths: Dict = {}
    for g, (grp, ln) in enumerate(
            zip(plan.stage_groups(), plan_group_lengths(plan, length))):
        for i, val in _chain_stage_lengths(
                grp.stages, topology, ln).items():
            lengths[(g, i)] = val
    return lengths


def init_plan_compression_states(plan: Plan, topology: PlanTopology,
                                 length: int, device=None) -> Optional[Dict]:
    """Fresh per-hop EF states for ``plan`` over a packed buffer of
    ``length`` float32 elements, on ``device``: ``{hop_key:
    CompressionState}``, one per quantizing stage, each sized to the buffer
    AT that stage and tagged with its hop key (``state.hop``).  ``None``
    when the plan has no quantizing stages."""
    hops = plan_compressed_hops(plan, topology)
    if not hops:
        return None
    lengths = plan_stage_lengths(plan, topology, length)
    states = {}
    for key, comp in hops.items():
        world = topology.scope_size(_stage_at(plan, key).scope)
        comp.clip_limit(world)  # fail early at unworkable scope sizes
        states[key] = comp.init_state(lengths[key], world, hop=key,
                                      device=device)
    return states


def _compressed_sum(comm, st: Stage, key, buf: torch.Tensor, state):
    """One quantized all-reduce stage: EF-encode to wire codes, sum the
    codes (and the saturation flags after them) in wire arithmetic over the
    stage's scope, decode with the delayed-scale update.  Returns
    ``(summed float32 buffer in buf's dtype, new_state)`` -- sum semantics,
    so the 1/world mean at the end is untouched."""
    comp = _quantizer_for(st)
    m = int(buf.shape[0])
    if int(state.ef.shape[0]) != comp._padded(m):
        raise ValueError(
            f"per-hop compression state for stage {key} is sized for "
            f"ef={int(state.ef.shape[0])} but the buffer at this stage "
            f"has {m} elements (needs {comp._padded(m)}): build the "
            "states with init_plan_compression_states(plan, topology, "
            "packed_length) / comm.init_compression_state(grads, plan)")
    _, world, idx, _ = _scope(comm, st.scope)
    v = buf.to(torch.float32)
    from chainermn_tpu_torch.compression import observe as _cobs
    obs = _cobs.get_compression_obs()
    if obs is not None:
        from chainermn_tpu_torch.compression.quantize import (
            wire_bits_per_param)
        tags = (f"plan:{st.scope}", key, comp.name,
                wire_bits_per_param(comp, m, world),
                m * 4 - (comp._padded(m) + comp.n_chunks(m))
                * comp.wire_dtype.itemsize)
        obs.device_edge(idx, "compress", "begin", *tags, dep=v)
    codes, state = comp.compress(v, state, rank=idx, world_size=world)
    if obs is not None:
        obs.device_edge(idx, "compress", "end", *tags, residual=state.ef,
                        dep=codes)
    if world > 1:
        _note("all_to_all" if codes.dtype == torch.float8_e4m3fn
              else "all_reduce")
        if codes.dtype == torch.float8_e4m3fn:
            _note("all_gather")
    summed = comm._sum_codes(codes, st.scope)
    if obs is not None:
        obs.device_edge(idx, "decompress", "begin", *tags, dep=summed)
    out, state = comp.decompress(summed, state, world_size=world)
    if obs is not None:
        mp = comp._padded(m)
        obs.device_sat(idx, tags[0], key, comp.name,
                       summed[mp:].to(torch.float32).sum())
        obs.device_edge(idx, "decompress", "end", *tags, dep=out)
    return out[:m].to(buf.dtype), state


# ---- the stage chains -------------------------------------------------------

def _run_stages_flat(plan: Plan, topology: PlanTopology, comm,
                     buf: torch.Tensor, states: Optional[Dict] = None,
                     group: Optional[int] = None, pobs=None):
    """Apply one stage chain to one flat buffer (``group`` selects a striped
    plan's chain; hop keys are then ``(group, stage)``).  ``pobs``
    brackets every emitted stage.  Returns ``(buf, new_states)``."""
    global _STAGE
    states = dict(states or {})
    new_states: Dict = {}
    shard_stack: List[_ShardFrame] = []
    stages = plan.stages if group is None else plan.groups[group].stages
    for i, st in enumerate(stages):
        key = i if group is None else (group, i)
        axes = topology.scope_axes(st.scope)
        if not axes:
            continue
        _stage_hook(pobs, plan, st, i, buf, "begin", group=group)
        _STAGE = st
        try:
            quant = _quantizer_for(st)
            if quant is not None:
                state = states.get(key)
                if state is None:
                    # one-shot path (sweeps, candidate checks): a cold EF
                    # state, discarded
                    state = quant.init_state(
                        int(buf.shape[0]), topology.scope_size(st.scope),
                        hop=key, device=buf.device)
                buf, new_states[key] = _compressed_sum(comm, st, key, buf,
                                                       state)
            elif st.op == "all-reduce":
                wire = (st.compressor().wire_dtype
                        if st.compression is not None else st.wire_dtype)
                buf = _with_wire(
                    buf, wire,
                    lambda b, s=st.scope: _all_reduce(comm, b, s))
            elif st.op == "reduce-scatter":
                if len(axes) != 1:
                    raise PlanError(
                        f"reduce-scatter scope {st.scope!r} resolves to "
                        f"{axes} -- a reduce-scatter shards over exactly "
                        "one axis; declare a topology whose scope is a "
                        "single axis")
                size = topology.scope_size(st.scope)
                from chainermn_tpu_torch.communicators import _packing
                buf, strip = _packing.pad_to_multiple(buf, size)
                frame = _ShardFrame(st.scope, size, int(buf.shape[0]), strip)
                buf = _with_wire(
                    buf, st.wire_dtype,
                    lambda b, s=st.scope: _reduce_scatter(comm, b, s))
                shard_stack.append(frame)
            elif st.op == "all-gather":
                frame = shard_stack.pop()  # validate() guarantees matching
                buf = _with_wire(
                    buf, st.wire_dtype,
                    lambda b, s=frame.scope: _all_gather(comm, b, s))
                buf = frame.strip(buf)
            elif st.op == "multicast":
                buf = _with_wire(
                    buf, st.wire_dtype,
                    lambda b, s=st: _broadcast(comm, b, s.scope, s.root))
            elif st.op == "p2p":
                if len(axes) != 1:
                    raise PlanError(
                        f"p2p scope {st.scope!r} resolves to {axes} -- "
                        "ring hops run over exactly one axis")
                buf = _with_wire(
                    buf, st.wire_dtype,
                    lambda b, s=st.scope: _ring_hop(comm, b, s))
            elif st.op == "all-to-all":
                raise PlanError(
                    f"plan {plan.name!r}: all-to-all stages run through "
                    "execute_alltoall (a block exchange over [P, ...] "
                    "buffers), not the gradient-mean executor")
            else:  # pragma: no cover -- ir validation rejects unknown ops
                raise PlanError(f"unknown stage op {st.op!r}")
        finally:
            _STAGE = None
        _stage_hook(pobs, plan, st, i, buf, "end", group=group)
    return buf, new_states


def _leaf_stage_op(topology: PlanTopology, comm, st: Stage, leaf):
    """Apply ONE stage to one leaf (leaf-mode ops only: all-reduce,
    multicast, p2p -- ir.validate).  Degenerate scopes pass through."""
    global _STAGE
    if not topology.scope_axes(st.scope):
        return leaf
    _STAGE = st
    try:
        if st.op == "all-reduce":
            return _with_wire(leaf, st.wire_dtype,
                              lambda v: _all_reduce(comm, v, st.scope))
        if st.op == "multicast":
            return _with_wire(
                leaf, st.wire_dtype,
                lambda v: _broadcast(comm, v, st.scope, st.root))
        if st.op == "p2p":
            return _with_wire(leaf, st.wire_dtype,
                              lambda v: _ring_hop(comm, v, st.scope))
    finally:
        _STAGE = None
    # pragma: no cover -- leaf validation rejects sharding ops
    raise PlanError(f"stage op {st.op!r} is not legal under leaf packing")


def _check_topology(comm, topology: Optional[PlanTopology]) -> PlanTopology:
    own = comm.plan_topology() if comm is not None else \
        PlanTopology(axes=(("inter", 1), ("intra", 1)))
    if topology is not None and topology.size != own.size:
        raise PlanError(
            f"topology {topology.key()} has {topology.size} ranks; the "
            f"communicator has {own.size} ({own.key()})")
    return topology if topology is not None else own


def _run_leaf_chain(plan: Plan, topology: PlanTopology, comm,
                    leaves: list, pobs=None, mean: bool = True) -> list:
    """Leaf packing: stage-outer, leaf-inner, each stage applied to every
    leaf (a leaf, or a packed dtype group) in turn; ``mean`` divides by the
    world size.  With ``pobs`` one begin/end pair brackets each stage for
    the whole tree, priced over every leaf, as JAX's
    ``_run_stages_leaf_traced``."""
    leaves = [l.clone(memory_format=torch.contiguous_format)
              for l in leaves]
    for i, st in enumerate(plan.stages):
        if not topology.scope_axes(st.scope):
            continue
        sized = [l for l in leaves if l.numel()] if pobs is not None else []
        if sized:
            wire_bytes = sum(_stage_wire_elem_bytes(
                plan, st, float(l.numel()), l.element_size())
                for l in sized)
            _stage_hook(pobs, plan, st, i, max(sized, key=torch.numel),
                        "begin", wire_bytes=wire_bytes)
        for j, leaf in enumerate(leaves):
            leaves[j] = _leaf_stage_op(topology, comm, st, leaf)
        if sized:
            _stage_hook(pobs, plan, st, i,
                        max(leaves, key=torch.numel), "end",
                        wire_bytes=wire_bytes)
    return [l / topology.size for l in leaves] if mean else leaves


def _run_leaf_plan(plan: Plan, topology: PlanTopology, comm, grads,
                   mean: bool = True, pobs=None):
    from chainermn_tpu_torch.communicators import _packing
    if getattr(comm, "packs_leaf_plans", False):
        buffers, meta = _packing.pack(grads)
        return _packing.unpack(_run_leaf_chain(
            plan, topology, comm, buffers, pobs, mean), meta)
    leaves, treedef = _packing.tree_flatten(grads)
    return _packing.tree_unflatten(treedef, _run_leaf_chain(
        plan, topology, comm, leaves, pobs, mean))


def execute_plan(plan: Plan, comm, grads, *, states: Optional[Dict] = None,
                 topology: Optional[PlanTopology] = None, pobs=None):
    """Run ``plan`` as ``comm``'s gradient mean over the tree ``grads``.

    ``comm`` supplies the process groups and, through
    ``comm.plan_topology()``, the group sizes (``topology`` may name the
    same world with other axis names).  ``states`` threads per-hop
    error-feedback state through quantizing stages: a ``{hop_key:
    CompressionState}`` dict from :func:`init_plan_compression_states`.
    When given, the call returns ``(mean_grads, new_states)``; when
    omitted, quantizing stages run from a cold state (the one-shot sweep /
    check path) and the call returns ``mean_grads``.  ``pobs`` (a
    :class:`~chainermn_tpu_torch.observability.spans.PlanObs`, from
    ``observability.get_plan_obs(comm)``) brackets every emitted stage
    with ``plan_stage`` edges (see the module note); the outputs are the
    same bits.
    """
    from chainermn_tpu_torch.communicators import _packing
    topology = _check_topology(comm, topology)
    n = topology.size
    has_quant = bool(plan_compressed_hops(plan, topology))
    if plan.packing == "leaf":
        if states is not None:
            raise PlanError(
                f"plan {plan.name!r}: leaf packing carries no per-hop "
                "compression state")
        return _run_leaf_plan(plan, topology, comm, grads, pobs=pobs)
    # quantizing plans exchange ONE float32 buffer (EF state maps one to
    # one onto it); per-stage wires still cast per hop
    comm_dtype = (torch_dtype(plan.wire_dtype)
                  if plan.wire_dtype is not None else None)
    if has_quant and comm_dtype is None:
        comm_dtype = torch.float32
    buffers, meta = _packing.pack(grads)
    treedef, keys, order = meta
    if comm_dtype is not None and len(buffers) > 1:
        # JAX packs every leaf, in tree order, into ONE buffer of the
        # communication dtype
        groups = {k: list(torch.split(_cast(b, comm_dtype),
                                      _group_sizes(order, k)))
                  for k, b in zip(keys, buffers)}
        work = [torch.cat([groups[k][i] for k, i, _, _ in order])]
    elif comm_dtype is not None:
        work = [_cast(b, comm_dtype) for b in buffers]
    else:
        work = buffers
    new_states: Dict = {}
    outs = []
    for b in work:
        lens = plan_group_lengths(plan, int(b.shape[0]))
        if plan.groups is not None and len(lens) > 1:
            parts = []
            off = 0
            for g, ln in enumerate(lens):
                seg = b[off:off + ln]
                off += ln
                if ln:
                    seg, st_out = _run_stages_flat(
                        plan, topology, comm, seg, states=states, group=g,
                        pobs=pobs)
                    new_states.update(st_out)
                parts.append(seg)
            b = torch.cat(parts)
        else:
            b, st_out = _run_stages_flat(
                plan, topology, comm, b, states=states,
                group=0 if plan.groups is not None else None, pobs=pobs)
            new_states.update(st_out)
        outs.append(b)
    result = _finish_flat(outs, meta, comm_dtype, n)
    if states is not None:
        return result, new_states
    return result


def _group_sizes(order, key) -> List[int]:
    sizes = []
    for k, _, shape, _ in order:
        if k == key:
            sizes.append(int(np.prod(shape, dtype=np.int64)))
    return sizes


def _finish_flat(outs, meta, comm_dtype, n: int):
    """Cast the chain's buffers back to their dtype groups and unpack with
    the 1/n mean.  A float32 group's cast back carries the mean (one
    launch of the cast kernel, the ``xla`` flavor's program)."""
    from chainermn_tpu_torch.communicators import _packing
    treedef, keys, order = meta
    if comm_dtype is None:
        return _packing.unpack(outs, meta, scale=1.0 / n)
    if len(keys) > 1:
        # back from JAX's one buffer to the dtype groups
        pieces = torch.split(outs[0], [int(np.prod(s, dtype=np.int64))
                                       for _, _, s, _ in order])
        outs = [torch.cat([p for p, (k, _, _, _) in zip(pieces, order)
                           if k == key]) for key in keys]
    groups = [getattr(torch, k) for k in keys]
    if all(g == torch.float32 for g in groups) and \
            comm_dtype != torch.float32 and comm_dtype in _KERNEL_DTYPES:
        return _packing.unpack([_cast(b, torch.float32, 1.0 / n)
                                for b in outs], meta)
    return _packing.unpack([_cast(b, g) for b, g in zip(outs, groups)],
                           meta, scale=1.0 / n)


# ---- block exchange ---------------------------------------------------------

def _exchange_hook(pobs, plan: Plan, st: Stage, i: int, buf: torch.Tensor,
                   edge: str, group: Optional[int] = None) -> None:
    """Per-stage edge of an exchange stage: the payload is the WHOLE block
    buffer, priced at the stage's wire width (JAX's ``_exchange_hook``)."""
    if pobs is None:
        return
    wb = _stage_wire_elem_bytes(plan, st, float(buf.numel()),
                                buf.element_size())
    _stage_hook(pobs, plan, st, i, buf, edge, wire_bytes=wb, group=group)


def _run_alltoall_chain(plan: Plan, topology: PlanTopology, comm, stages,
                        buf: torch.Tensor, pobs=None,
                        group: Optional[int] = None) -> torch.Tensor:
    """One exchange chain over one ``[P, ...]`` block buffer: one stage
    over ``all`` (or ``intra`` on a one-node topology), or the hierarchical
    ``intra`` then ``inter`` pair, which lands blocks in source global-rank
    order exactly as the flat exchange does."""
    global _STAGE
    emitted = [(i, st) for i, st in enumerate(stages)
               if topology.scope_axes(st.scope)]
    scopes = tuple(st.scope for _, st in emitted)
    if int(buf.shape[0]) != topology.size:
        raise PlanError(
            f"plan {plan.name!r}: exchange buffer leading dim "
            f"{int(buf.shape[0])} != topology size {topology.size} -- "
            "all-to-all buffers carry one block per destination rank")

    def hop(i, st, b):
        global _STAGE
        _exchange_hook(pobs, plan, st, i, b, "begin", group=group)
        _STAGE = st
        try:
            out = _with_wire(b, st.wire_dtype,
                             lambda v: _all_to_all(comm, v, st.scope))
        finally:
            _STAGE = None
        _exchange_hook(pobs, plan, st, i, out, "end", group=group)
        return out

    if scopes in (("all",), ("intra",)):
        if scopes == ("intra",) and topology.inter_size != 1:
            raise PlanError(
                f"plan {plan.name!r}: an intra-only exchange on a "
                f"multi-node topology ({topology.key()}) is not a full "
                "all-to-all -- use scope 'all' or the hierarchical "
                "intra+inter chain")
        return hop(*emitted[0], buf)
    if scopes != ("intra", "inter"):
        raise PlanError(
            f"plan {plan.name!r}: unsupported exchange chain over scopes "
            f"{scopes}; supported: one flat stage (scope 'all') or the "
            "hierarchical 'intra' then 'inter' pair")
    (ii, intra_st), (ji, inter_st) = emitted
    isz, jsz = topology.inter_size, topology.intra_size
    rest = tuple(buf.shape[1:])
    # [P (dest rank, inter-major), ...] -> intra-major, so the NVLink hop
    # splits by destination intra coordinate
    x = buf.reshape((isz, jsz) + rest).transpose(0, 1).reshape(
        (jsz * isz,) + rest)
    x = hop(ii, intra_st, x)
    # x[b' * I + i] = block from intra peer b' destined (i, own j);
    # re-major by destination node for the inter-node hop
    x = x.reshape((jsz, isz) + rest).transpose(0, 1).reshape(
        (isz * jsz,) + rest)
    # x[a' * J + b'] = block from source (a', b'): source global-rank order
    return hop(ji, inter_st, x)


def check_exchange_plan(plan) -> Plan:
    """``plan`` if it is an exchange plan (flat packing, all-to-all stages
    only); else ``TypeError`` (not a Plan) or ``PlanError``."""
    if not isinstance(plan, Plan):
        raise TypeError(f"an exchange plan must be a planner Plan, got "
                        f"{type(plan).__name__}")
    if plan.packing != "flat":
        raise PlanError(
            f"plan {plan.name!r}: all-to-all requires flat packing")
    ops = {st.op for grp in plan.stage_groups() for st in grp.stages}
    if ops != {"all-to-all"}:
        raise PlanError(
            f"plan {plan.name!r} is not an exchange plan: its stages are "
            f"{sorted(ops)}, an exchange runs all-to-all stages only")
    return plan


def _exchange(plan: Plan, topology: PlanTopology, comm,
              buf: torch.Tensor, pobs=None) -> torch.Tensor:
    check_exchange_plan(plan)
    if plan.groups is None:
        return _run_alltoall_chain(plan, topology, comm, plan.stages, buf,
                                   pobs=pobs)
    if buf.dim() < 2:
        raise PlanError(
            f"plan {plan.name!r}: a striped exchange splits the "
            "within-block payload -- the buffer needs a second dim")
    lens = plan_group_lengths(plan, int(buf.shape[1]))
    if len(lens) == 1:
        return _run_alltoall_chain(plan, topology, comm,
                                   plan.groups[0].stages, buf, pobs=pobs,
                                   group=0)
    parts = []
    off = 0
    for g, ln in enumerate(lens):
        seg = buf[:, off:off + ln]
        off += ln
        if ln:
            seg = _run_alltoall_chain(plan, topology, comm,
                                      plan.groups[g].stages, seg, pobs=pobs,
                                      group=g)
        parts.append(seg)
    return torch.cat(parts, dim=1)


class _PlanExchange(torch.autograd.Function):
    """The exchange is a permutation of blocks that is its own transpose:
    the backward exchanges the cotangent with the same plan (its wire casts
    included, as JAX's transpose of ``astype``)."""

    @staticmethod
    def forward(ctx, plan, topology, comm, pobs, buf):
        ctx.args = (plan, topology, comm, pobs)
        return _exchange(plan, topology, comm, buf, pobs)

    @staticmethod
    def backward(ctx, g):
        plan, topology, comm, pobs = ctx.args
        return None, None, None, None, _exchange(plan, topology, comm,
                                                 g.contiguous(), pobs)


def execute_alltoall(plan: Plan, comm, buf: torch.Tensor, *,
                     topology: Optional[PlanTopology] = None, pobs=None):
    """Run ``plan`` as a block exchange of ``buf`` over ``comm``'s ranks --
    the MoE dispatch / combine seam
    (``parallel.expert.moe_apply(plan=...)``).

    ``buf`` is ``[P, ...]``, one block per destination rank in global-rank
    (inter-major) order; the result holds the blocks by SOURCE rank,
    exactly ``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``
    (and ``comm.alltoall``), whatever decomposition the plan picks.  A
    striped plan splits the buffer's second dim at its group ratios.
    Differentiable (the backward exchanges the cotangent).  ``topology``
    defaults to ``comm.plan_topology()``; ``comm=None`` is a world of one
    (only the wire casts run).  ``pobs`` brackets every emitted hop with
    ``plan_stage`` edges (the backward's hops too), so the NVLink and
    inter-node legs of one dispatch are separate spans.
    """
    topology = _check_topology(comm, topology)
    if torch.is_grad_enabled() and buf.requires_grad:
        return _PlanExchange.apply(plan, topology, comm, pobs, buf)
    return _exchange(plan, topology, comm, buf, pobs)


# ---- the device-free cost model (JAX's arithmetic) --------------------------

#: stage op -> HLO collective kind of its JAX lowering
_CENSUS_KIND = {
    "all-reduce": "all-reduce",
    "reduce-scatter": "reduce-scatter",
    # the JAX default all-gather is a masked psum
    "all-gather": "all-reduce",
    "multicast": "all-reduce",
    "p2p": "collective-permute",
    "all-to-all": "all-to-all",
}


def _group_stages(plan: Plan, group: Optional[int]):
    if group is not None:
        return plan.stage_groups()[group].stages
    return tuple(st for grp in plan.stage_groups() for st in grp.stages)


def plan_census_kinds(plan: Plan, topology: PlanTopology,
                      group: Optional[int] = None) -> tuple:
    """JAX's expected HLO collective-kind sequence of ``plan`` on
    ``topology`` (a stage over axes of size 1 counts; a scope with no axes
    does not).  ``group`` selects one concurrent group of a striped plan;
    ``None`` concatenates them.  :func:`census_of_record` maps what this
    executor issued onto these kinds."""
    kinds = []
    for st in _group_stages(plan, group):
        if not topology.scope_axes(st.scope):
            continue
        if st.op == "all-gather" and st.lowering == "native":
            kinds.append("all-gather")
        else:
            kinds.append(_CENSUS_KIND[st.op])
    return tuple(kinds)


def issued_census_kinds(plan: Plan, topology: PlanTopology) -> tuple:
    """:func:`plan_census_kinds` of the stages that issue a collective
    here: those over more than one rank (JAX counts a stage over axes of
    size 1; this executor runs no collective there).  What
    :func:`census_of_record` of an executed plan must equal."""
    kinds = iter(plan_census_kinds(plan, topology))
    out = []
    for st in _group_stages(plan, None):
        if not topology.scope_axes(st.scope):
            continue
        kind = next(kinds)
        if topology.scope_size(st.scope) > 1:
            out.append(kind)
    return tuple(out)


def plan_wire_dtypes(plan: Plan, topology: PlanTopology,
                     dtype="float32", group: Optional[int] = None) -> tuple:
    """On-wire dtype NAME per stage that runs, aligned with
    :func:`plan_census_kinds`: a compressed stage's compressor wire, else
    the stage wire dtype, the plan wire dtype, then the payload ``dtype``."""
    payload = dtype_name(dtype) if plan.wire_dtype is None \
        else dtype_name(plan.wire_dtype)
    if plan_compressed_hops(plan, topology) and plan.wire_dtype is None:
        payload = "float32"  # quantizing plans pack one f32 buffer
    out = []
    for st in _group_stages(plan, group):
        if not topology.scope_axes(st.scope):
            continue
        if st.compression is not None:
            wire = _wire_of(st.compressor())
            out.append(wire if wire else payload)
        elif st.wire_dtype is not None:
            out.append(dtype_name(st.wire_dtype))
        else:
            out.append(payload)
    return tuple(out)


def _stage_wire_elem_bytes(plan: Plan, st: Stage, elems: float,
                           item: int) -> float:
    """Bytes ``elems`` payload elements occupy on THIS stage's wire (stage
    wire, then plan wire, then payload); a quantizing hop pays its wire
    width on the chunk-padded length plus one flag per chunk."""
    quant = _quantizer_for(st)
    if quant is not None:
        n = int(np.ceil(elems))
        wire_item = dtype_itemsize(quant.wire)
        return float(quant._padded(n) + quant.n_chunks(n)) * wire_item
    if st.compression is not None:  # identity codec
        wd = st.compressor().wire_dtype
        wire_item = dtype_itemsize(wd) if wd else item
        return elems * wire_item
    wire_item = (dtype_itemsize(st.wire_dtype)
                 if st.wire_dtype else
                 dtype_itemsize(plan.wire_dtype)
                 if plan.wire_dtype else item)
    return elems * wire_item


def _chain_stage_costs(plan: Plan, stages, topology: PlanTopology,
                       nbytes: float, item: int) -> List[Tuple[str, float]]:
    """Per stage of one chain: ``(scope, bytes_moved)`` under the ring cost
    model (all-reduce 2x, reduce-scatter/all-gather 1x, p2p 1/size), each
    stage priced at its own wire width (JAX's model: a default all-gather
    is priced as the masked psum JAX issues)."""
    out: List[Tuple[str, float]] = []
    frac = 1.0  # fraction of the chain's payload live at this stage
    for st in stages:
        axes = topology.scope_axes(st.scope)
        if not axes:
            continue
        size = topology.scope_size(st.scope)
        elems = (nbytes / item) * frac
        stage_bytes = _stage_wire_elem_bytes(plan, st, elems, item)
        if st.op == "all-reduce":
            moved = 2.0 * stage_bytes * (size - 1) / max(size, 1)
        elif st.op == "reduce-scatter":
            moved = stage_bytes * (size - 1) / max(size, 1)
            frac /= size
        elif st.op == "all-gather":
            gathered = stage_bytes * size
            if st.lowering == "native":
                moved = gathered * (size - 1) / max(size, 1)
            else:  # masked psum pays ring-allreduce cost on full length
                moved = 2.0 * gathered * (size - 1) / max(size, 1)
            frac *= size
        elif st.op == "multicast":
            moved = 2.0 * stage_bytes * (size - 1) / max(size, 1)
        elif st.op == "p2p":
            moved = stage_bytes
        elif st.op == "all-to-all":
            moved = stage_bytes * (size - 1) / max(size, 1)
        else:  # pragma: no cover
            moved = stage_bytes
        out.append((st.scope, moved))
    return out


def plan_wire_bytes(plan: Plan, topology: PlanTopology, nbytes: int,
                    dtype="float32") -> dict:
    """Static per-scope wire-cost model of a plan moving ``nbytes`` of
    ``dtype`` payload: bytes each scope's links carry per rank (ring
    costs), each stage at its own wire width, a striped plan summed over
    its groups at their ratios.  Not a substitute for measurement."""
    item = dtype_itemsize(dtype)
    costs: dict = {}
    for grp in plan.stage_groups():
        for scope, moved in _chain_stage_costs(
                plan, grp.stages, topology, nbytes * grp.ratio, item):
            costs[scope] = costs.get(scope, 0.0) + moved
    return costs


#: scope -> the card's link class its traffic rides: the intra (last) axis
#: is one node's NVLink, inter and flat-over-all traffic crosses the
#: inter-node network (JAX: "ici" / "dcn")
LINK_CLASS = {"intra": "nvlink", "inter": "ib", "all": "ib"}


def validate_link_gbps(link_gbps: Dict[str, float]) -> Dict[str, float]:
    """Validate a ``{link class: GB/s}`` mapping against the
    :data:`LINK_CLASS` values and return it with float rates; an unknown
    class (which the model would price as free) raises, naming the
    accepted ones."""
    accepted = sorted(set(LINK_CLASS.values()))
    unknown = sorted(set(str(k) for k in link_gbps) - set(accepted))
    if unknown:
        raise ValueError(
            f"unknown link class(es) {unknown} in link rates; accepted "
            f"names are {accepted} (the LINK_CLASS values)")
    out = {}
    for link, bw in link_gbps.items():
        bw = float(bw)
        if bw < 0:
            raise ValueError(
                f"link class {link!r} has negative bandwidth {bw}")
        out[str(link)] = bw
    return out


def plan_link_bytes(plan: Plan, topology: PlanTopology, nbytes: int,
                    dtype="float32") -> dict:
    """``{(scope, link): bytes}`` of ``plan`` moving ``nbytes`` of
    ``dtype`` payload, with ``link`` per :data:`LINK_CLASS`."""
    costs = plan_wire_bytes(plan, topology, nbytes, dtype=dtype)
    return {(scope, LINK_CLASS[scope]): moved
            for scope, moved in costs.items()}


def plan_modeled_time_s(plan: Plan, topology: PlanTopology, nbytes: int,
                        link_gbps: Dict[str, float],
                        dtype="float32") -> float:
    """Predicted wire time (seconds) of ``plan`` moving ``nbytes`` of
    ``dtype`` payload over links of ``link_gbps`` (``{"nvlink": GB/s,
    "ib": GB/s}``; a missing class is free): the larger of the slowest
    group's chain time and the busiest link's summed time (JAX's model)."""
    item = dtype_itemsize(dtype)
    link_gbps = validate_link_gbps(link_gbps)

    def _rate(link: str) -> float:
        bw = link_gbps.get(link)
        return float(bw) * 1e9 if bw else float("inf")

    chain_times = []
    link_busy: Dict[str, float] = {}
    for grp in plan.stage_groups():
        t = 0.0
        for scope, moved in _chain_stage_costs(
                plan, grp.stages, topology, nbytes * grp.ratio, item):
            link = LINK_CLASS[scope]
            dt = moved / _rate(link)
            t += dt
            link_busy[link] = link_busy.get(link, 0.0) + dt
        chain_times.append(t)
    busiest = max(link_busy.values()) if link_busy else 0.0
    return max(max(chain_times, default=0.0), busiest)


def plan_dcn_bytes(plan: Plan, topology: PlanTopology, nbytes: int,
                   dtype="float32") -> float:
    """Bytes a plan moves across the inter-node boundary: the ``inter``
    scope plus the ``all`` scope (a flat ring over every rank crosses it)
    -- the name is JAX's (its inter-node link is the DCN)."""
    costs = plan_wire_bytes(plan, topology, nbytes, dtype=dtype)
    return float(costs.get("inter", 0.0) + costs.get("all", 0.0))


__all__ = ["LINK_CLASS", "census_of_record", "check_exchange_plan",
           "execute_alltoall",
           "execute_plan", "init_plan_compression_states",
           "issued_census_kinds",
           "plan_census_kinds", "plan_compressed_hops", "plan_dcn_bytes",
           "plan_group_lengths", "plan_link_bytes", "plan_modeled_time_s",
           "plan_stage_lengths", "plan_wire_bytes", "plan_wire_dtypes",
           "record_collectives", "validate_link_gbps"]
