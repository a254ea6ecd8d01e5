"""Fixed plans: the seven communicator flavors as plan data.

Counterpart of ``chainermn_tpu/planner/plans.py``: the same plans, names and
dicts.  Each flavor's plan, run by
:func:`~chainermn_tpu_torch.planner.compiler.execute_plan` on that flavor's
communicator, gives the bits of its own ``allreduce_grad``
(``tests/test_torch_auto_communicator.py``).  ``candidate_plans``
extends the fixed set with tuning knobs (wire dtype, decomposition ×
message-size tradeoffs) for the autotuner to measure.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from chainermn_tpu_torch.planner.ir import (
    Plan, PlanError, PlanTopology, Stage, StageGroup)


def _ar(scope: str, **kw) -> Stage:
    return Stage(op="all-reduce", scope=scope, **kw)


#: flavor name -> plan factory (wire_dtype threaded for the xla flavor)
def flavor_plan(name: str, wire_dtype: Optional[str] = None) -> Plan:
    """The fixed plan a named communicator flavor executes.

    ``wire_dtype`` is a numpy dtype *name* (e.g. ``"bfloat16"``) — only
    meaningful for flavors with flat packing; the xla flavor is the one
    whose factory knob sets it (``allreduce_grad_dtype``).
    """
    if name in ("pure_nccl", "xla"):
        return Plan(name="xla", packing="flat", wire_dtype=wire_dtype,
                    stages=(_ar("all"),))
    if wire_dtype is not None:
        raise ValueError(f"flavor {name!r} takes no wire_dtype")
    if name == "naive":
        # per-leaf all-reduce over every rank (the base class default)
        return Plan(name="naive", packing="leaf", stages=(_ar("all"),))
    if name in ("flat", "non_cuda_aware"):
        # non_cuda_aware's decomposition is flat; the flavor stages its
        # world all-reduce through the host (its _plan_all_reduce)
        return Plan(name=name, packing="flat", stages=(_ar("all"),))
    if name in ("hierarchical", "single_node"):
        # per-leaf all-reduce(intra) then (inter).  single_node runs the
        # same stages on an inter_size==1 topology, where the inter stage
        # moves no data (JAX keeps it to clear the device-varying type; a
        # scope of one rank runs no collective here).
        return Plan(name=name, packing="leaf",
                    stages=(_ar("intra"), _ar("inter")))
    if name == "two_dimensional":
        # RS(intra) -> AR(inter) on the shard -> gather-back (JAX: a
        # masked psum)
        return Plan(name="two_dimensional", packing="flat", stages=(
            Stage(op="reduce-scatter", scope="intra"),
            _ar("inter"),
            Stage(op="all-gather", scope="intra", lowering="masked-psum"),
        ))
    raise ValueError(f"unknown flavor {name!r}")


#: the flavors with distinct plans (pure_nccl aliases xla; non_cuda_aware
#: shares flat's stages but keeps its own plan name)
FLAVOR_NAMES = ("naive", "flat", "hierarchical", "two_dimensional",
                "single_node", "non_cuda_aware", "xla")


#: per-hop inter-node compressor configs the candidate zoo sweeps.
#: ``stochastic=False``: the sweep's correctness probe and the identity
#: parity tests run ONE cold-state step, where deterministic rounding is
#: exact on small-integer payloads; training seams that want the
#: unbiased dither pass their own spec through ``Stage.compression``.
DCN_COMPRESSORS = (
    {"name": "int8", "stochastic": False},
    {"name": "fp8", "stochastic": False},
)


def compressed_two_dimensional(comp: dict, wire_dtype: str = "bfloat16",
                               name: str = None) -> Plan:
    """The per-hop compressed 2-D decomposition (DynamiQ direction):
    reduce-scatter on NVLink in ``wire_dtype``, the shard's inter
    all-reduce quantized by ``comp`` (the inter-node hop carries 1-byte codes
    with per-hop error feedback), masked-psum gather-back on NVLink in
    ``wire_dtype``."""
    cname = comp.get("name", "?")
    return Plan(
        name=name or f"two_dimensional_{cname}_dcn", packing="flat",
        stages=(Stage(op="reduce-scatter", scope="intra",
                      wire_dtype=wire_dtype),
                Stage(op="all-reduce", scope="inter", compression=comp),
                Stage(op="all-gather", scope="intra",
                      lowering="masked-psum", wire_dtype=wire_dtype)))


def _two_dimensional_stages(wire_dtype: Optional[str] = None,
                            dcn_comp: Optional[dict] = None) -> tuple:
    """The 2-D chain as stage data: RS(intra) → AR(inter) → masked-psum
    AG(intra), NVLink legs on ``wire_dtype``, the inter hop either on
    ``wire_dtype`` too or quantized by ``dcn_comp``."""
    inter = (Stage(op="all-reduce", scope="inter", compression=dcn_comp)
             if dcn_comp is not None else
             Stage(op="all-reduce", scope="inter", wire_dtype=wire_dtype))
    return (Stage(op="reduce-scatter", scope="intra",
                  wire_dtype=wire_dtype),
            inter,
            Stage(op="all-gather", scope="intra", lowering="masked-psum",
                  wire_dtype=wire_dtype))


#: default split-ratio sweep for striped candidates — the NVLink stripe's
#: share of the payload (the inter-node stripe takes the rest).  The FlexLink
#: sweet spot moves with the NVLink:inter-node bandwidth gap, so the autotuner
#: measures the ladder instead of trusting one analytic point.
STRIPE_RATIOS = (0.5, 0.6, 0.7, 0.8, 0.9)


def striped_plan(ratio: float,
                 dcn_comp: Optional[dict] = None,
                 wire_dtype: str = "bfloat16",
                 name: Optional[str] = None) -> Plan:
    """A two-group striped allreduce (FlexLink direction): ``ratio`` of
    the packed buffer rides an NVLink-dominant 2-D chain (NVLink legs in
    ``wire_dtype``, inter hop in ``wire_dtype``), the remaining
    ``1 - ratio`` rides an inter-node-lean 2-D chain whose inter hop is
    quantized by ``dcn_comp`` (int8/fp8 + error feedback: per-stage
    compression composing with striping).  With
    ``dcn_comp=None`` both stripes are the plain ``wire_dtype`` chain —
    the pure pipelining candidate, where the win is one stripe's NVLink
    legs hiding behind the other stripe's inter-node hop.

    The two chains are data-independent slices, so the compiler's
    lowering lets them interleave; the per-link cost model
    (``plan_modeled_time_s``) prices the plan as max(slowest chain,
    busiest link), which is what makes an intermediate ratio beat both
    single-path endpoints on heterogeneous links.
    """
    if not (0.0 < ratio <= 1.0):
        raise PlanError(f"stripe ratio must be in (0, 1], got {ratio}")
    tag = f"r{int(round(ratio * 100)):02d}"
    if dcn_comp is not None:
        tag += f"_{dcn_comp.get('name', '?')}"
    groups = [StageGroup(stages=_two_dimensional_stages(wire_dtype),
                         ratio=ratio)]
    if ratio < 1.0:
        groups.append(StageGroup(
            stages=_two_dimensional_stages(wire_dtype, dcn_comp=dcn_comp),
            ratio=round(1.0 - ratio, 12)))
    return Plan(name=name or f"striped_{tag}", packing="flat",
                groups=tuple(groups))


def multicast_plan(hierarchical: bool = False, root: int = 0,
                   wire_dtype: Optional[str] = None,
                   topology: Optional[PlanTopology] = None,
                   name: Optional[str] = None) -> Plan:
    """Weight-broadcast as a tuned plan: one ``multicast`` stage over
    every data axis (flat), or the hierarchical two-stage form —
    multicast over NVLink first (each inter position learns its intra
    root's value), then over the inter-node axes (the root's inter
    position overwrites the rest) — so the expensive one-to-many crosses
    the inter-node boundary on 1 stage of ``intra``-fanned traffic
    instead of a global fan.  Leaf packing: serving params are arbitrary trees.  A non-zero
    global ``root`` under the hierarchical form needs the ``topology``
    to split into (inter, intra) coordinates."""
    if not hierarchical:
        return Plan(name=name or "multicast_flat", packing="leaf",
                    stages=(Stage(op="multicast", scope="all", root=root,
                                  wire_dtype=wire_dtype),))
    root_inter, root_intra = 0, 0
    if root:
        if topology is None:
            raise PlanError(
                "hierarchical multicast with a non-zero root needs the "
                "topology to split the root into (inter, intra) coords")
        root_inter, root_intra = divmod(int(root), topology.intra_size)
    return Plan(name=name or "multicast_hierarchical", packing="leaf",
                stages=(Stage(op="multicast", scope="intra",
                              root=root_intra, wire_dtype=wire_dtype),
                        Stage(op="multicast", scope="inter",
                              root=root_inter, wire_dtype=wire_dtype)))


def broadcast_plans(topology: PlanTopology,
                    wire_dtypes: tuple = ("bfloat16",)) -> List[Plan]:
    """The broadcast/param-distribution candidate zoo for one topology:
    flat and (on multi-axis topologies) hierarchical multicast, at full
    precision and at each reduced wire dtype.  The serving weight path
    (``serving/weights.broadcast_inference_params``) accepts any of
    these through its ``plan=`` seam."""
    out: List[Plan] = [multicast_plan()]
    for wd in wire_dtypes:
        out.append(multicast_plan(wire_dtype=wd,
                                  name=f"multicast_flat_{wd}"))
    if len(topology.axes) >= 2 and topology.inter_size > 1:
        out.append(multicast_plan(hierarchical=True))
        for wd in wire_dtypes:
            out.append(multicast_plan(
                hierarchical=True, wire_dtype=wd,
                name=f"multicast_hierarchical_{wd}"))
    return out


def _a2a(scope: str, wire_dtype: Optional[str] = None) -> Stage:
    return Stage(op="all-to-all", scope=scope, wire_dtype=wire_dtype)


def _hier_a2a(intra_wire: Optional[str] = None,
              inter_wire: Optional[str] = None) -> tuple:
    """The hierarchical exchange chain: NVLink regroup hop, then the inter-node
    hop — the only leg worth a narrow wire (``inter_wire``)."""
    return (_a2a("intra", intra_wire), _a2a("inter", inter_wire))


#: narrow wires the all-to-all zoo tries on the inter-node hop.  Exchange hops
#: move values instead of summing them, so the per-hop knob is a plain
#: wire CAST (bf16 / fp8), not the integer-code compressors — in-wire
#: summed int8 codes have no meaning on a hop with no reduction.
ALLTOALL_DCN_WIRES = ("bfloat16", "float8_e4m3fn")


def alltoall_plans(topology: PlanTopology,
                   wire_dtypes: tuple = ("bfloat16",),
                   dcn_wires: tuple = ALLTOALL_DCN_WIRES,
                   stripe_ratios: tuple = ()) -> List[Plan]:
    """The all-to-all (MoE dispatch) candidate zoo for one topology.

    * ``alltoall_flat`` — one exchange over every data axis (today's raw
      ``all_to_all`` path as plan data; scope ``all`` prices at inter-node
      rates, which is exactly the flat path's problem on multi-host
      topologies), plus reduced-wire variants.
    * ``alltoall_hierarchical`` — NVLink regroup hop + inter-node hop
      (HiCCL's composition argument applied to the exchange), full
      precision.
    * ``alltoall_hier_<wd>_dcn`` — hierarchical with ONLY the inter-node
      hop on a narrow wire (bf16 / fp8 cast): the DynamiQ-flavored
      variant whose inter-node bytes ``bench_moe --sweep`` records.
    * ``alltoall_hier_<wd>`` — both hops on the reduced wire.
    * ``alltoall_striped_rNN`` — striping: a full-precision stripe and a
      narrow-inter-node stripe exchanging concurrent slices of the block
      payload.

    ``PlanTable`` tunes over these per (topology, dtype, size) exactly
    like the allreduce zoo — same sweep row schema, same bucket ladder.
    """
    out: List[Plan] = [Plan(name="alltoall_flat", packing="flat",
                            stages=(_a2a("all"),))]
    for wd in wire_dtypes:
        out.append(Plan(name=f"alltoall_flat_{wd}", packing="flat",
                        stages=(_a2a("all", wd),)))
    if len(topology.axes) >= 2 and topology.inter_size > 1:
        out.append(Plan(name="alltoall_hierarchical", packing="flat",
                        stages=_hier_a2a()))
        for wd in dcn_wires:
            out.append(Plan(name=f"alltoall_hier_{wd}_dcn",
                            packing="flat",
                            stages=_hier_a2a(inter_wire=wd)))
        for wd in wire_dtypes:
            out.append(Plan(name=f"alltoall_hier_{wd}", packing="flat",
                            stages=_hier_a2a(wd, wd)))
        narrow = dcn_wires[0] if dcn_wires else None
        for r in stripe_ratios:
            r = float(r)
            if not 0.0 < r < 1.0 or narrow is None:
                continue
            out.append(Plan(
                name=f"alltoall_striped_r{int(round(r * 100)):02d}",
                packing="flat",
                groups=(StageGroup(stages=_hier_a2a(), ratio=r,
                                   name="full"),
                        StageGroup(stages=_hier_a2a(inter_wire=narrow),
                                   ratio=round(1.0 - r, 12),
                                   name="narrow"))))
    seen: Dict[str, Plan] = {}
    for p in out:
        d = p.to_dict()
        d.pop("name", None)
        seen.setdefault(repr(d), p)
    return list(seen.values())


def candidate_plans(topology: PlanTopology,
                    wire_dtypes: tuple = ("bfloat16",),
                    dcn_compressors: tuple = DCN_COMPRESSORS,
                    stripe_ratios: tuple = (),
                    op: str = "all-reduce") -> List[Plan]:
    """The autotuner's search space for one topology.

    Always includes every fixed flavor legal on the topology (so the
    tuned table is never worse than the best fixed flavor on the run it
    was tuned from), plus reduced-precision-wire variants of the flat
    decompositions — the knob the fixed zoo only exposes through the xla
    flavor, and the main lever at bandwidth-bound message sizes — plus,
    on multi-axis topologies whose inter scope can carry in-wire summed
    codes, per-hop compressed variants (quantized inter-node hop, reduced-wire
    NVLink hops).

    ``stripe_ratios`` adds two-group striped candidates at each ratio
    (``striped_plan`` — a compressed-inter-node stripe when the topology's
    inter size can carry int8 codes, plus the uncompressed pipelining
    stripe), so the autotuner tunes the split ratio the same way it
    tunes wire dtypes.

    ``op`` selects the collective family: the default ``"all-reduce"``
    zoo above, or ``"all-to-all"`` for the exchange zoo
    (:func:`alltoall_plans` — MoE dispatch decompositions tuned through
    the same :class:`~chainermn_tpu_torch.planner.autotune.PlanTable`).
    """
    if op == "all-to-all":
        return alltoall_plans(topology, wire_dtypes=wire_dtypes,
                              stripe_ratios=stripe_ratios)
    if op != "all-reduce":
        raise ValueError(f"unknown candidate-plan op {op!r}")
    multi_axis = len(topology.axes) >= 2 and topology.inter_size >= 1
    out: List[Plan] = [flavor_plan("naive"), flavor_plan("flat"),
                       flavor_plan("xla")]
    if multi_axis:
        out.append(flavor_plan("hierarchical"))
        out.append(flavor_plan("two_dimensional"))
    if topology.inter_size == 1:
        out.append(flavor_plan("single_node"))
    for wd in wire_dtypes:
        out.append(Plan(name=f"flat_{wd}", packing="flat", wire_dtype=wd,
                        stages=(_ar("all"),)))
        if multi_axis:
            # 2-D decomposition with the reduced wire only on the two
            # NVLink legs' payload; the inter-node leg already carries
            # 1/intra of the bytes.
            out.append(Plan(
                name=f"two_dimensional_{wd}", packing="flat", wire_dtype=wd,
                stages=(Stage(op="reduce-scatter", scope="intra"),
                        _ar("inter"),
                        Stage(op="all-gather", scope="intra",
                              lowering="masked-psum"))))
    if multi_axis and topology.inter_size > 1:
        from chainermn_tpu_torch.compression import resolve_compressor

        def _legal(comp: dict) -> bool:
            try:
                resolve_compressor(dict(comp)).clip_limit(
                    topology.inter_size)
                return True
            except ValueError:
                return False  # too few code levels at this inter size

        for comp in dcn_compressors:
            if _legal(comp):
                out.append(compressed_two_dimensional(dict(comp)))
        stripe_comp = next((dict(c) for c in dcn_compressors
                            if _legal(c)), None)
        for r in stripe_ratios:
            out.append(striped_plan(float(r)))
            if stripe_comp is not None and float(r) < 1.0:
                out.append(striped_plan(float(r), dcn_comp=stripe_comp))
    # De-duplicate by serialized form (xla with no wire == flat, etc.)
    seen: Dict[str, Plan] = {}
    for p in out:
        d = p.to_dict()
        d.pop("name", None)
        seen.setdefault(repr(d), p)
    return list(seen.values())


__all__ = ["ALLTOALL_DCN_WIRES", "DCN_COMPRESSORS", "FLAVOR_NAMES",
           "STRIPE_RATIOS", "alltoall_plans", "broadcast_plans",
           "candidate_plans", "compressed_two_dimensional", "flavor_plan",
           "multicast_plan", "striped_plan"]
