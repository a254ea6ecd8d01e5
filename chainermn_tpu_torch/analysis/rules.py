"""cmn-lint rule registry -- each rule proves one collective-schedule
invariant before a mesh is involved.

Counterpart of ``chainermn_tpu/analysis/rules.py``: the same 14 rule IDs,
severities and summaries.  The protocol rules, ``overlapping-collectives``
and ``artifact-drift`` are JAX's; the data-plane rules read what the
port records instead of a jaxpr or compiled HLO (:mod:`.schedule`):

* ``schedule-desync`` -- one recorded schedule per variant (a dry run at
  each rank on the fake process group);
* ``census-drift`` -- the recorded ``allreduce_grad`` of the flavor in
  JAX's census kinds (:func:`~.schedule.census_schedule`) against the
  stages that issue a collective (``issued_census_kinds``: a plan stage
  over one rank issues none, nor does a flavor's level of one rank); an
  HLO census (``census=<text>``) is held to JAX's count, size-1 stages
  included;
* ``wire-dtype-mismatch`` -- recorded c10d dtypes against the plan's
  stages and the FSDP buckets' wires;
* ``async-pair`` -- an ``async_op=True`` work handle no ``wait()``
  reached by the time the step's ``finalize()`` returned;
* ``unpinned-transpose`` -- a collective issued in the gradient probe's
  backward (``functions.allreduce``'s backward issues none);
* ``donation-alias`` -- an argument sharing storage with one in
  ``donate_argnums`` (the arguments the step writes in place);
* ``captured-constant`` -- a large tensor the step reads that its
  arguments do not hold and the step did not create (:mod:`.captured`).

Every rule has a **stable ID** (the contract for CI greps, findings
JSON, and the docs catalog in ``docs/static_analysis.md``) and names, in
its finding message, the runtime subsystem that would otherwise catch
the bug only after a mesh is wedged -- the flight recorder / hang
watchdog cross-link.

Rules read a duck-typed context object (``LintContext`` in ``lint.py``;
tests may pass any namespace with the same attributes).  A rule whose
required inputs are absent is *skipped*, not failed — ``LintReport``
records the reason.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch

SEVERITIES = ("error", "warning", "info")

#: numpy dtype name -> HLO shape dtype token (wire-dtype-mismatch rule)
NP_TO_HLO_DTYPE = {
    "float64": "f64", "float32": "f32", "float16": "f16",
    "bfloat16": "bf16", "float8_e4m3fn": "f8e4m3fn",
    "float8_e5m2": "f8e5m2", "int64": "s64", "int32": "s32",
    "int16": "s16", "int8": "s8", "uint8": "u8", "bool": "pred",
}


@dataclass
class Finding:
    """One lint finding.  ``rule`` is the stable ID; ``target`` names the
    linted program (entry point / flavor / function)."""
    rule: str
    severity: str
    message: str
    target: str = ""
    details: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "target": self.target, "message": self.message,
                "details": self.details}

    def render(self) -> str:
        head = f"[{self.severity}] {self.rule}"
        if self.target:
            head += f" ({self.target})"
        return head + ": " + self.message


@dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    summary: str
    requires: tuple            # context attributes that must be non-None
    fn: Callable               # fn(ctx) -> List[Finding]
    #: attributes of which AT LEAST ONE must be non-None (e.g. a rule
    #: that reads either a hand-declared spec or a plan-derived one)
    requires_any: tuple = ()

    def missing(self, ctx) -> List[str]:
        out = [r for r in self.requires
               if getattr(ctx, r, None) is None]
        if self.requires_any and not any(
                getattr(ctx, r, None) is not None
                for r in self.requires_any):
            out.append(" or ".join(self.requires_any))
        return out

    def run(self, ctx) -> List[Finding]:
        out = []
        for f in self.fn(ctx):
            f.rule = self.id
            f.severity = f.severity or self.severity
            f.target = f.target or getattr(ctx, "name", "") or ""
            out.append(f)
        return out


_REGISTRY: "Dict[str, Rule]" = {}


def rule(id: str, severity: str, summary: str, requires: tuple = (),
         requires_any: tuple = ()):
    assert severity in SEVERITIES, severity

    def deco(fn):
        _REGISTRY[id] = Rule(id=id, severity=severity, summary=summary,
                             requires=requires, requires_any=requires_any,
                             fn=fn)
        return fn
    return deco


def all_rules() -> List[Rule]:
    return list(_REGISTRY.values())


def get_rule(id: str) -> Rule:
    try:
        return _REGISTRY[id]
    except KeyError:
        raise ValueError(
            f"unknown lint rule {id!r}; available: "
            f"{sorted(_REGISTRY)}") from None


def _finding(message: str, **details) -> Finding:
    return Finding(rule="", severity="", message=message, details=details)


# ---------------------------------------------------------------------------
# schedule-desync — the static identify_desync
# ---------------------------------------------------------------------------

@rule("schedule-desync", "error",
      "per-rank/per-config traced schedules must be identical",
      requires=("variants",))
def _schedule_desync(ctx) -> List[Finding]:
    """Every rank runs the SAME Python; a branch on rank (or any
    nondeterminism in issue order) gives two ranks different collective
    schedules, and the world wedges at the first divergence.  This is the
    static version of the flight recorder's ``identify_desync``: the
    runtime analysis names the rank stuck behind after the hang — this
    rule names the diverging op before anything runs."""
    variants = ctx.variants      # dict label -> CollectiveSchedule
    labels = sorted(variants)
    if len(labels) < 2:
        return []
    base_label = labels[0]
    base = variants[base_label]
    out: List[Finding] = []
    for other_label in labels[1:]:
        d = base.diff(variants[other_label])
        if d is None:
            continue
        out.append(_finding(
            f"collective schedules diverge between {base_label!r} and "
            f"{other_label!r} at op #{d['index']}: "
            f"{base_label!r} issues {d['left'] or '<end of schedule>'}, "
            f"{other_label!r} issues {d['right'] or '<end of schedule>'}. "
            "On a live mesh this wedges every rank at that collective — "
            "the hang the flight-recorder watchdog diagnoses at runtime "
            "(docs/observability.md, identify_desync); fix the "
            "rank/config-dependent trace so all ranks issue one schedule.",
            index=d["index"], left=d["left"], right=d["right"],
            left_label=base_label, right_label=other_label))
        break  # first divergence is THE actionable one
    return out


# ---------------------------------------------------------------------------
# census-drift — per-flavor expected decomposition, DERIVED from the plan
# ---------------------------------------------------------------------------

def expected_kinds(flavor: str, inter_size: int = 1) -> tuple:
    """Expected ``allreduce_grad`` collective-kind sequence for a
    communicator flavor in JAX's HLO census count (a stage over axes of
    size 1 counts), as JAX's ``expected_kinds``.

    Derived, not maintained: the flavor's fixed plan
    (``planner.plans.flavor_plan``) is compiled statically against an
    (inter, intra) topology and the census read off the IR
    (``planner.compiler.plan_census_kinds``).  What the port's executor
    issues on a real topology -- the stages over more than one rank -- is
    :func:`expected_issued_kinds`."""
    from chainermn_tpu_torch.planner.compiler import plan_census_kinds
    from chainermn_tpu_torch.planner.ir import PlanTopology
    from chainermn_tpu_torch.planner.plans import flavor_plan
    plan = flavor_plan(flavor)  # raises ValueError on unknown flavors
    # kinds depend on which scopes HAVE axes, not on axis sizes; the
    # standard (inter, intra) mesh always declares both axes
    topo = PlanTopology(axes=(("inter", max(int(inter_size or 1), 1)),
                              ("intra", 1)))
    return plan_census_kinds(plan, topo)


def expected_issued_kinds(flavor: str, topology) -> tuple:
    """The census kinds a flavor's own ``allreduce_grad`` issues on
    ``topology``: JAX's count without the stages over an ``intra`` or
    ``inter`` level of one rank (the flavors skip those levels, as the
    plan executor skips every scope of one rank,
    ``planner.compiler.issued_census_kinds``); a flavor's all-reduce over
    the world runs even in a world of one, as XLA keeps a singleton-group
    collective."""
    from chainermn_tpu_torch.planner.plans import flavor_plan
    return _stage_lanes(flavor_plan(flavor), topology, None, "flavor")[0]


def _stage_lanes(plan, topo, group, issued: str):
    """``(kinds, wire dtype names)`` of a plan's stages (of one concurrent
    group, or all), aligned.  ``issued`` says which stages issue a
    collective: ``"hlo"`` all of them (JAX's compiled count),
    ``"executor"`` those over more than one rank (the plan executor),
    ``"flavor"`` those but the world scope's, which always runs (a
    flavor's own program)."""
    from chainermn_tpu_torch.planner.compiler import (
        _group_stages, plan_census_kinds, plan_wire_dtypes)
    kinds = plan_census_kinds(plan, topo, group=group)
    dts = plan_wire_dtypes(plan, topo, group=group)
    if issued == "hlo":
        return tuple(kinds), tuple(dts)
    run = [st for st in _group_stages(plan, group)
           if topo.scope_axes(st.scope)]
    keep = [topo.scope_size(st.scope) > 1
            or (issued == "flavor" and st.scope == "all") for st in run]
    return (tuple(k for k, m in zip(kinds, keep) if m),
            tuple(d for d, m in zip(dts, keep) if m))


def _interleaves(seqs, observed, match=None) -> bool:
    """True iff ``observed`` is a valid interleaving of the sequences in
    ``seqs`` — each sequence's internal order preserved, elements freely
    merged across sequences.  ``match(want, got)`` compares elements
    (default ``==``).

    This is the census comparison for striped plans: XLA is free to
    reorder collectives from INDEPENDENT concurrent stage groups (they
    share no data), so the compiled schedule is only required to be SOME
    interleaving of the per-group expected sequences, never an arbitrary
    permutation — within a group the chain order is a data dependency
    and must survive.  Memoized DP over per-sequence cursors.
    """
    if match is None:
        def match(w, g):
            return w == g
    seqs = [tuple(s) for s in seqs]
    observed = tuple(observed)
    if sum(len(s) for s in seqs) != len(observed):
        return False
    memo: Dict[tuple, bool] = {}

    def _ok(idx: tuple) -> bool:
        pos = sum(idx)
        if pos == len(observed):
            return True
        if idx in memo:
            return memo[idx]
        res = False
        for gi, s in enumerate(seqs):
            j = idx[gi]
            if j < len(s) and match(s[j], observed[pos]):
                if _ok(idx[:gi] + (j + 1,) + idx[gi + 1:]):
                    res = True
                    break
        memo[idx] = res
        return res

    return _ok(tuple(0 for _ in seqs))


@rule("census-drift", "error",
      "compiled allreduce_grad decomposition must match the flavor's "
      "plan-derived census",
      requires=("census_schedule",), requires_any=("flavor", "plan"))
def _census_drift(ctx) -> List[Finding]:
    """The census schedule is either recorded -- the spec is then the
    stages that issue a collective on the communicator's topology: over
    more than one rank when the plan executor ran it
    (``issued_census_kinds``; its collectives carry their stage), and
    also a world all-reduce in a world of one when a flavor's own program
    ran it (:func:`expected_issued_kinds`) -- or read from HLO (JAX's
    count, size-1 stages included)."""
    from chainermn_tpu_torch.planner.ir import PlanTopology
    from chainermn_tpu_torch.planner.plans import flavor_plan
    inter = getattr(ctx, "inter_size", 1) or 1
    plan = getattr(ctx, "plan", None)
    flavor = getattr(ctx, "flavor", None)
    comm = getattr(ctx, "comm", None)
    census = ctx.census_schedule
    # which stages issue depends on the program recorded: the plan
    # executor's collectives carry their stage, a flavor's own do not
    if census.origin == "hlo":
        mode = "hlo"
    elif not census.ops or any(op.stage is not None for op in census):
        mode = "executor"
    else:
        mode = "flavor"
    # the communicator's levels, with the inter size the context names
    # (an explicit inter_size audits the comm against another layout)
    intra = max(comm.size // inter, 1) if comm is not None else 1
    topo = PlanTopology(axes=(("inter", inter), ("intra", intra)))
    if plan is not None and getattr(plan, "groups", None) is not None:
        # striped plan: the groups are data-independent, so their chains
        # may interleave (but not reorder within) -- the observed schedule
        # must be a valid interleaving of the per-group expected
        # sequences, first on kinds, then on (kind, wire-dtype) lanes
        # (the recorder reads each collective's exact dtype, so a lane
        # matches only at its declared width).
        n_groups = len(plan.groups)
        lanes = [_stage_lanes(plan, topo, g, mode)
                 for g in range(n_groups)]
        group_kinds = [k for k, _ in lanes]
        got = tuple(census.kinds())
        if not _interleaves(group_kinds, got):
            return [_finding(
                f"striped plan {plan.name!r} issued allreduce_grad as "
                f"{list(got) or '<no collectives>'} which is not an "
                f"interleaving of its {n_groups} concurrent stage "
                f"groups' expected sequences "
                f"{[list(s) for s in group_kinds]} (inter_size={inter})."
                f"  Groups are independent so their chains may merge, "
                f"but each group's internal order is a data "
                f"dependency -- drift here means a stripe lost or grew a "
                f"hop and the per-link cost model prices a schedule the "
                f"program does not run.",
                expected_groups=[list(s) for s in group_kinds],
                observed=list(got), plan=plan.name, inter_size=inter)]
        group_lanes = [tuple((k, NP_TO_HLO_DTYPE.get(d, d))
                             for k, d in zip(kinds, dts))
                       for kinds, dts in lanes]
        got_lanes = tuple((op.kind, op.dtype) for op in census)

        if not _interleaves(group_lanes, got_lanes):
            return [_finding(
                f"striped plan {plan.name!r} issued collectives "
                f"{[list(l) for l in got_lanes]} do not interleave its "
                f"per-group (kind, wire-dtype) lanes "
                f"{[[list(l) for l in grp] for grp in group_lanes]}: "
                f"some hop runs at a width its stripe does not declare."
                f"  A compressed stripe whose codes never hit the "
                f"wire is compression silently off at full wire cost; a "
                f"narrower-than-declared stripe silently drops numerics "
                f"-- either way plan_link_bytes prices a wire the "
                f"program does not move.",
                expected_group_lanes=[[list(l) for l in grp]
                                      for grp in group_lanes],
                observed_lanes=[list(l) for l in got_lanes],
                plan=plan.name, inter_size=inter)]
        return []
    if plan is not None:
        # explicit plan spec (e.g. an autotuned table entry) -- derive
        # the census against the communicator's declared topology
        want, want_np = _stage_lanes(plan, topo, None, mode)
        spec_name = f"plan {plan.name!r}"
    else:
        want, _ = _stage_lanes(flavor_plan(flavor), topo, None, mode)
        spec_name = f"flavor {flavor!r}"
    got = census.kinds()
    if got != want:
        return [_finding(
            f"communicator {spec_name} issued allreduce_grad as "
            f"{list(got) or '<no collectives>'} but its decomposition is "
            f"specified as {list(want)} (inter_size={inter}).  The "
            "decomposition IS the flavor (docs/performance.md census "
            "table; CENSUS_r*.json artifact): drift here means a "
            "different wire cost model and a schedule the other ranks do "
            "not expect.",
            expected=list(want), observed=list(got),
            flavor=flavor or (plan.name if plan is not None else None),
            inter_size=inter)]
    if plan is None:
        return []
    # Per-hop dtype census (explicit plans only): each issued collective
    # must run at its stage's declared wire width -- a compressed stage at
    # its COMPRESSOR's wire.  Same kinds with a wider hop is the per-hop
    # analogue of census drift: the cost model (plan_wire_bytes) prices
    # the hop at a width the program does not move.
    want_d = [NP_TO_HLO_DTYPE.get(d, d) for d in want_np]
    got_d = [op.dtype for op in census]
    out: List[Finding] = []
    for i, (w, g) in enumerate(zip(want_d, got_d)):
        if g == w:
            continue
        out.append(_finding(
            f"plan {plan.name!r} hop {i} ({want[i]}) is specified to "
            f"run its wire in {w} (stage dtype {want_np[i]!r}) but the "
            f"issued collective runs in {g} (per-hop dtypes: expected "
            f"{want_d}, observed {got_d}).  A compressed hop whose "
            f"codes never hit the wire is compression silently off at "
            f"full wire cost; a narrower-than-declared hop silently "
            f"drops numerics -- either way plan_wire_bytes and the "
            f"dcn_wire_bytes budget are pricing a wire the program "
            f"does not move.",
            stage=i, expected_dtype=w, observed_dtype=g,
            expected_dtypes=want_d, observed_dtypes=got_d,
            plan=plan.name, inter_size=inter))
    return out


# ---------------------------------------------------------------------------
# unpinned-transpose — the PR 1 bug class
# ---------------------------------------------------------------------------

@rule("unpinned-transpose", "error",
      "a psum differentiated inside the SPMD body must pin its identity "
      "transpose",
      requires=("grad_probe",))
def _unpinned_transpose(ctx) -> List[Finding]:
    """A loss differentiated on every rank (the ``make_train_step`` shape)
    that all-reduces a replicated value through an autograd collective
    whose backward all-reduces again (``torch.distributed.nn.functional.
    all_reduce``) gets its cotangent summed over the world: every
    gradient arrives inflated by ``size``.  The pinned path
    (``chainermn_tpu_torch.functions.allreduce``, whose backward is the
    identity) issues NO backward all-reduce -- so any all-reduce excess
    of the backward run over the forward run, per group, is an unpinned
    transpose."""
    probe = ctx.grad_probe   # {"primal": schedule, "grad": schedule}
    primal_counts = probe["primal"].counts_by_axes("all-reduce")
    grad_counts = probe["grad"].counts_by_axes("all-reduce")
    out: List[Finding] = []
    for axes, n_grad in sorted(grad_counts.items(), key=str):
        extra = n_grad - primal_counts.get(axes, 0)
        if extra <= 0:
            continue
        ax_txt = ",".join(str(a) for a in axes if a is not None) or "?"
        out.append(_finding(
            f"{extra} all-reduce(s) over ({ax_txt}) run in the backward "
            f"of the per-rank loss but not in its forward: the "
            f"collective's backward all-reduced the cotangent again, so "
            f"gradients are inflated by the group size.  Wrap the "
            f"allreduce in chainermn_tpu_torch.functions.allreduce (its "
            f"backward is the identity) instead of an autograd "
            f"collective whose backward reduces "
            f"(torch.distributed.nn.functional.all_reduce) inside a loss "
            f"that every rank differentiates.  At runtime this is "
            f"silent -- no hang for the watchdog to catch, just a wrong "
            f"effective learning rate.",
            axes=list(ax_txt.split(",")), extra_backward_psums=extra,
            primal_psums=primal_counts.get(axes, 0),
            grad_psums=n_grad))
    return out


# ---------------------------------------------------------------------------
# captured-constant -- the closed-over tensor guard
# ---------------------------------------------------------------------------

@rule("captured-constant", "error",
      "traced program must not close over large array constants",
      requires=("recording",))
def _captured_constant(ctx) -> List[Finding]:
    from chainermn_tpu_torch.analysis.captured import (
        DEFAULT_MAX_BYTES, captured_constant_message, constants_in_recording)

    max_bytes = getattr(ctx, "max_const_bytes", None) or DEFAULT_MAX_BYTES
    found = constants_in_recording(ctx.recording, max_bytes=max_bytes)
    if not found:
        return []
    label = getattr(ctx, "name", "") or "step"
    return [_finding(
        captured_constant_message(found, label, max_bytes),
        constants=found, max_bytes=max_bytes)]


# ---------------------------------------------------------------------------
# donation-alias -- an argument the step writes in place, read through a
# second alias
# ---------------------------------------------------------------------------

@rule("donation-alias", "error",
      "no argument buffer may alias a donated argument",
      requires=("args", "donate_argnums"))
def _donation_alias(ctx) -> List[Finding]:
    """Two checks on the step's ACTUAL operands, by storage:

    * one storage reached through two argument positions while at least
      one of them is donated (``donate_argnums``: the arguments the step
      writes in place -- parameters, optimizer state) -- the in-place
      update of one changes what the other reads, mid-step, differently
      on a rank that aliases and one that does not;
    * the same error-feedback ``CompressionState`` storage aliased into
      two FSDP buckets -- each bucket's reduce-scatter would accumulate
      its residual into one buffer and silently corrupt the other's EF
      stream.
    """
    from chainermn_tpu_torch.analysis.captured import reachable_tensors
    from chainermn_tpu_torch.analysis.schedule import _storage_key

    out: List[Finding] = []
    donated = set(ctx.donate_argnums or ())
    written = set()
    rec = getattr(ctx, "recording_if_run", None)
    if rec is not None:
        written = rec.recorder.written
    if donated:
        by_key: Dict[tuple, List[tuple]] = {}
        for argno, arg in enumerate(ctx.args):
            seen = set()
            for path, t in reachable_tensors(arg, with_paths=True):
                key = _storage_key(t)
                if key is None or key in seen:
                    continue
                seen.add(key)
                by_key.setdefault(key, []).append((argno, path))
        for key, sites in sorted(by_key.items(), key=lambda kv: str(kv[0])):
            if len({a for a, _ in sites}) < 2:
                continue
            if not any(argno in donated for argno, _ in sites):
                continue
            where = ", ".join(f"arg{argno}{p}" for argno, p in sites)
            out.append(_finding(
                f"the same storage is passed at {where} while "
                f"argument(s) {sorted({a for a, _ in sites if a in donated})} "
                f"are donated (written in place by the step): the update "
                f"of one alias changes what the other reads mid-step.  "
                f"Pass an explicit copy, or stop donating that argument.",
                positions=[{"arg": a, "path": p} for a, p in sites],
                donated=sorted(donated), written=key in written))
    # EF-state aliasing across FSDP buckets
    fsdp_state = getattr(ctx, "fsdp_state", None)
    if fsdp_state is not None and getattr(fsdp_state, "comp", ()):
        seen_b: Dict[tuple, int] = {}
        for b, comp in enumerate(fsdp_state.comp):
            if comp is None:
                continue
            for t in reachable_tensors(comp):
                key = _storage_key(t)
                if key is None:
                    continue
                if key in seen_b and seen_b[key] != b:
                    out.append(_finding(
                        f"error-feedback state buffer is aliased into "
                        f"buckets {seen_b[key]} and {b}: each bucket's "
                        f"compressed reduce-scatter feeds its residual "
                        f"back into the shared buffer, corrupting the "
                        f"other bucket's EF stream (convergence poison, "
                        f"invisible to the runtime watchdog).  Give every "
                        f"bucket its own CompressionState.",
                        buckets=[seen_b[key], b]))
                seen_b.setdefault(key, b)
    return out


# ---------------------------------------------------------------------------
# wire-dtype-mismatch — compression spec vs compiled collective dtype
# ---------------------------------------------------------------------------

@rule("wire-dtype-mismatch", "error",
      "compiled collectives must run in their declared wire dtypes "
      "(FSDP bucket layouts and plan specs)",
      requires=("schedule",), requires_any=("fsdp_meta", "plan"))
def _wire_dtype_mismatch(ctx) -> List[Finding]:
    """The spec SAYS int8-with-EF but the program moves f32 (compression
    silently off: 4x the wire), or vice versa (numerics silently
    narrowed).  Two spec sources, held to the recorded step's c10d
    dtypes:

    * an FSDP bucket layout -- each bucket's declared wire dtype must
      appear among the recorded reduce-scatter dtypes (the port's FSDP
      reduce-scatter is an all-to-all plus a sum in rank order);
    * a collective :class:`~chainermn_tpu_torch.planner.ir.Plan` -- the
      plan's (or a stage's) wire dtype must appear among the recorded
      collective dtypes (in census form, so a float8 stage's code sum,
      which travels as int8 views, reads as its wire); a stage carrying a
      per-hop ``compression`` spec expects its COMPRESSOR's wire (int8
      -> ``s8``, fp8 -> ``f8e4m3fn``).
    """
    from chainermn_tpu_torch.analysis.schedule import census_schedule
    from chainermn_tpu_torch.compression import resolve_compressor
    from chainermn_tpu_torch.planner.ir import dtype_name

    out: List[Finding] = []
    meta = getattr(ctx, "fsdp_meta", None)
    if meta is not None:
        expected: List[tuple] = []       # (bucket, dtype token, why)
        for b, layout in enumerate(meta.buckets):
            if getattr(layout, "compressor", None):
                comp = resolve_compressor(layout.compressor)
                wire = dtype_name(comp.wire_dtype_for(torch.float32))
                expected.append((b, NP_TO_HLO_DTYPE.get(wire, wire),
                                 f"compressor {comp.name!r}"))
            elif getattr(layout, "wire_dtype", None):
                wire = dtype_name(layout.wire_dtype)
                expected.append((b, NP_TO_HLO_DTYPE.get(wire, wire),
                                 f"wire_dtype {wire!r}"))
        observed = [op.dtype for op in ctx.schedule
                    if op.kind in ("reduce-scatter", "all-to-all")]
        remaining = list(observed)
        for b, token, why in expected:
            if token in remaining:
                remaining.remove(token)
                continue
            out.append(_finding(
                f"bucket {b} declares {why} (wire dtype {token}) but no "
                f"recorded reduce-scatter runs in {token} "
                f"(observed reduce-scatter dtypes: {observed or 'none'}).  "
                f"The checkpoint sidecar and resume guard trust the "
                f"layout's spec -- a program that moves a different dtype "
                f"is either paying full-precision wire cost or silently "
                f"narrowing numerics.",
                bucket=b, expected_dtype=token, observed_dtypes=observed,
                declared=why))
    plan = getattr(ctx, "plan", None)
    if plan is not None:
        wires = []                       # (dtype token, why)
        if getattr(plan, "wire_dtype", None):
            wire = dtype_name(plan.wire_dtype)
            wires.append((NP_TO_HLO_DTYPE.get(wire, wire),
                          f"plan {plan.name!r} wire_dtype {wire!r}"))
        # walk concurrent stage groups too: a striped plan keeps its
        # stages under plan.groups (plan.stages is empty)
        if getattr(plan, "groups", None) is not None:
            chains = [(f" group {g} stage ", grp.stages)
                      for g, grp in enumerate(plan.groups)]
        else:
            chains = [(" stage ", getattr(plan, "stages", ()) or ())]
        for prefix, stages in chains:
            for i, st in enumerate(stages):
                if getattr(st, "compression", None):
                    comp = st.compressor()
                    wire = dtype_name(comp.wire_dtype_for(torch.float32))
                    wires.append((NP_TO_HLO_DTYPE.get(wire, wire),
                                  f"plan {plan.name!r}{prefix}{i} "
                                  f"({st.op}) compressor {comp.name!r} "
                                  f"wire {wire!r}"))
                elif getattr(st, "wire_dtype", None):
                    wire = dtype_name(st.wire_dtype)
                    wires.append((NP_TO_HLO_DTYPE.get(wire, wire),
                                  f"plan {plan.name!r}{prefix}{i} "
                                  f"({st.op}) wire_dtype {wire!r}"))
        sched = ctx.schedule
        if sched.origin == "recorded":
            sched = census_schedule(sched)
        observed = [op.dtype for op in sched
                    if op.kind in ("all-reduce", "reduce-scatter",
                                   "all-gather", "collective-permute",
                                   "all-to-all")]
        for token, why in wires:
            if token in observed:
                continue
            out.append(_finding(
                f"{why} (dtype {token}) but no recorded collective "
                f"runs in {token} (observed collective dtypes: "
                f"{observed or 'none'}).  A plan whose wire dtype the "
                f"program does not move is either paying full-precision "
                f"wire cost or silently narrowing numerics -- the same "
                f"trust contract as the FSDP layout spec.",
                expected_dtype=token, observed_dtypes=observed,
                declared=why))
    return out


# ---------------------------------------------------------------------------
# async-pair -- a started collective never waited
# ---------------------------------------------------------------------------

@rule("async-pair", "error",
      "every async collective start must have a matching done",
      requires=("schedule",))
def _async_pair(ctx) -> List[Finding]:
    """An ``async_op=True`` collective whose work handle no ``wait()``
    reached by the time the step (and its ``finalize()``) returned --
    recorded in the schedule's ``problems`` (an HLO census adds its
    unmatched ``*-start``/``*-done`` halves).  The double-buffered
    optimizer's handle spans one step boundary and is waited by the next
    update or by ``finalize()``."""
    out: List[Finding] = []
    problems = list(ctx.schedule.problems)
    census = getattr(ctx, "census_schedule_if_built", None)
    if census is not None:
        problems += list(census.problems)
    for p in problems:
        if not str(p.get("kind", "")).startswith("unmatched-async"):
            continue
        half = "start" if p["kind"].endswith("start") else "done"
        out.append(_finding(
            f"async collective {p.get('op')!r} ({p.get('name')}) has an "
            f"unmatched -{half}: the program "
            f"{'issues a collective it never awaits' if half == 'start' else 'awaits a collective it never issued'}"
            f" -- on hardware that is a guaranteed wedge, the exact hang "
            f"class the collective watchdog exists to catch at runtime "
            f"(docs/observability.md).",
            **p))
    return out


# ---------------------------------------------------------------------------
# overlapping-collectives — independently-tuned plans contending for a link
# ---------------------------------------------------------------------------

@rule("overlapping-collectives", "warning",
      "concurrent same-link-class collectives with independently-tuned plans",
      requires=("flight_spans",))
def _overlapping_collectives(ctx) -> List[Finding]:
    """Flag spans that occupy the SAME link class at the SAME time but
    belong to DIFFERENT tuning identities (plan names / subsystems).

    Each independently-tuned plan prices the link at full bandwidth, so
    when two of them actually run concurrently both deliver below their
    modeled GB/s — the contention blind spot ROADMAP item 4 names.
    Spans sharing one identity are one co-tuned decision and are never
    flagged: a striped plan's concurrent groups split the link on
    purpose, and plans co-tuned in one ``StepWorkload``
    (``planner.schedule.jointly_tune``) carry the shared workload
    signature in their ``@wl:``-tagged names, which ``plan_identity``
    folds to one ``workload:<sig>`` identity — the joint scheduler's
    deliberate cross-communicator overlap is priced by the fair-share
    simulator, not a blind spot.  Full nesting counts: one identity's span time-containing
    another's IS overlap (the worst case — the inner transfer runs
    entirely under contention); only a true wrapper-over-decomposition
    pair (``leaf_comm_spans``) is exempt.  Severity is ``warning``:
    contention is a throughput bug, not a wedge.  Runtime evidence, not a compile-time proof — feed it
    the flight events of a representative window (``flight_events=``,
    or a flight dump's ``events`` via ``cmn_lint --events``).
    """
    from chainermn_tpu_torch.observability.contention import (
        leaf_comm_spans, plan_identity, span_link)
    cells: Dict[tuple, dict] = {}
    for rank, spans in sorted(ctx.flight_spans.items()):
        per_link: Dict[str, list] = {}
        for sp in leaf_comm_spans(spans):
            link, ident = span_link(sp), plan_identity(sp)
            if link is not None and ident is not None:
                per_link.setdefault(link, []).append((sp.t0, sp.t1, ident))
        for link, rows in per_link.items():
            rows.sort()
            active: List[tuple] = []  # sweep: spans still open at t0
            for t0, t1, ident in rows:
                active = [r for r in active if r[1] > t0]
                for _a0, a1, aident in active:
                    if aident == ident:
                        continue
                    ov = min(a1, t1) - t0
                    if ov <= 0.0:
                        continue
                    a, b = sorted((aident, ident))
                    cell = cells.setdefault(
                        (link, a, b), {"s": 0.0, "n": 0, "ranks": set()})
                    cell["s"] += ov
                    cell["n"] += 1
                    cell["ranks"].add(rank)
                active.append((t0, t1, ident))
    out: List[Finding] = []
    for (link, a, b), cell in sorted(cells.items()):
        out.append(_finding(
            f"{a!r} and {b!r} overlap on the {link} link class for "
            f"{cell['s'] * 1e3:.3f} ms across {cell['n']} span pair(s) "
            f"but are tuned independently — each plan prices the link "
            f"at full bandwidth, so both run below their modeled GB/s "
            f"under contention.  Inspect with obs_report --contention; "
            f"co-tune them into one plan or serialize the issue order.",
            link=link, identities=[a, b], contended_s=cell["s"],
            n_pairs=cell["n"], ranks=sorted(cell["ranks"])))
    return out


# ---------------------------------------------------------------------------
# artifact-drift — committed artifacts vs the run-ledger schema registry
# ---------------------------------------------------------------------------

#: modeled-vs-measured link-rate disagreement a committed artifact may
#: carry before the rule flags its claims as priced on a stale wire
DRIFT_TOLERANCE_X = 1.5


@rule("artifact-drift", "warning",
      "committed artifacts must carry a registered schema, the common "
      "envelope, and modeled link rates consistent with the latest "
      "measured rates for the same device kind",
      requires=("artifact_census",))
def _artifact_drift(ctx) -> List[Finding]:
    """Three longitudinal invariants over the committed artifact set
    (``artifact_root=``, or ``cmn_lint --artifacts``):

    * **unknown schema** (error): an artifact the run-ledger registry
      cannot classify — it would land outside every gate and trend;
    * **missing envelope** (info, aggregated): artifacts predating the
      common envelope (no ``schema``+``git_sha`` stamp) — historical
      r01–r05 era files are expected here, NEW writers are not;
    * **modeled-rate drift** (warning): an artifact whose modeled
      ``link_gbps`` disagrees with the LATEST measured rates
      (LinkObservations / contention report) recorded for the SAME
      device kind by more than ``DRIFT_TOLERANCE_X`` — its gated claims
      are priced on a wire the fleet no longer has.  Rates measured on
      a different (or unknown) device kind never cross-contaminate.
    """
    census = ctx.artifact_census
    tol = float(getattr(ctx, "drift_tolerance", None)
                or DRIFT_TOLERANCE_X)
    out: List[Finding] = []
    legacy: List[str] = []
    # newest measured rates per (device_kind, link)
    measured: Dict[tuple, tuple] = {}   # (dk, link) -> (order, gbps, path)
    for row in census:
        man = row.get("manifest")
        if not man or man.get("device_kind") is None:
            continue
        order = (man.get("round") or "", man.get("timestamp") or "")
        for link, gbps in (man.get("link_gbps_measured") or {}).items():
            key = (man["device_kind"], link)
            if key not in measured or order >= measured[key][0]:
                measured[key] = (order, float(gbps), row["path"])
    for row in census:
        if "error" in row:
            out.append(Finding(
                rule="", severity="error", message=(
                    f"artifact {row['path']} is unreadable "
                    f"({row['error']}): it can be neither gated nor "
                    f"registered in the run ledger"),
                details={"artifact": row["path"],
                         "error": row["error"]}))
            continue
        cls = row.get("classification")
        if cls is None:
            doc = row.get("doc")
            declared = doc.get("schema") \
                if isinstance(doc, dict) else None
            out.append(Finding(
                rule="", severity="error", message=(
                    f"artifact {row['path']} has "
                    + (f"unregistered schema {declared!r}"
                       if declared else "no recognizable schema")
                    + " — register it in observability.ledger."
                    "KNOWN_SCHEMAS (and stamp the writer with "
                    "stamp_envelope) or the ledger, the gates, and the "
                    "trend lanes all skip it silently"),
                details={"artifact": row["path"],
                         "declared_schema": declared}))
            continue
        if cls.get("legacy"):
            legacy.append(row["path"])
        man = row["manifest"]
        dk = man.get("device_kind")
        if dk is None:
            continue
        for link, modeled in (man.get("link_gbps_modeled")
                              or {}).items():
            hit = measured.get((dk, link))
            if hit is None or modeled <= 0 or hit[1] <= 0:
                continue
            _order, meas, src = hit
            ratio = max(modeled / meas, meas / modeled)
            if ratio <= tol:
                continue
            out.append(_finding(
                f"artifact {row['path']} models the {link} link at "
                f"{modeled:g} GB/s but the latest measured rate for "
                f"device kind {dk!r} is {meas:g} GB/s ({src}) — "
                f"x{ratio:.2f} apart (tolerance x{tol:g}).  Every "
                f"speedup this artifact gates is priced on a wire the "
                f"fleet does not have; re-run the sweep or re-baseline "
                f"via perf_gate --ledger.",
                artifact=row["path"], link=link, device_kind=dk,
                modeled_gbps=modeled, measured_gbps=meas,
                measured_in=src, ratio=ratio, tolerance=tol))
    if legacy:
        out.append(Finding(
            rule="", severity="info", message=(
                f"{len(legacy)} committed artifact(s) predate the "
                f"common envelope (no schema/git_sha stamp): "
                f"{', '.join(legacy[:6])}"
                + (" ..." if len(legacy) > 6 else "")
                + ".  Historical artifacts stay as-is; new writers "
                "must stamp via observability.ledger.stamp_envelope."),
            details={"artifacts": legacy}))
    return out


# ---------------------------------------------------------------------------
# control-plane protocol rules — read the static ProtocolModel
# (analysis/protocol.py); ctx.protocol_model is built from protocol_root
# ---------------------------------------------------------------------------

def _overlaps(a, b) -> bool:
    return a[0] < b[1] and b[0] < a[1]


def _const_sites(model):
    """Sites with a resolved constant tag, excluding op-default tags (the
    sanctioned defaults: tag=0 plane, barrier 900)."""
    return [s for s in model.sites
            if s.tag.get("kind") == "const"
            and s.tag.get("provenance") != "default"
            and s.tag.get("value") is not None]


@rule("tag-band-collision", "error",
      "control-plane tag sets of two subsystems must not intersect",
      requires=("protocol_model",))
def _tag_band_collision(ctx) -> List[Finding]:
    """Tags are the only thing keeping concurrent object-plane protocols
    apart on a shared DCN edge (TELEMETRY_TAG=770, barrier 900,
    FLIGHT_TAG=(1<<28)+7, the default tag-0 plane) — and until now they
    were kept apart by comments.  Two failure shapes: a magic number
    landing inside a reserved band it does not own, and two subsystems'
    resolved tag intervals intersecting (arithmetic neighbors included:
    an allgather at t also consumes t+1).  A collision means a recv can
    complete against the WRONG protocol's payload — the worst kind of
    desync, because nothing hangs until the unpickle explodes."""
    from chainermn_tpu_torch.runtime.control_plane import (
        RESERVED_TAG_BANDS)
    model = ctx.protocol_model
    out: List[Finding] = []
    bands = [b for b in RESERVED_TAG_BANDS.values() if b.name != "default"]
    default = RESERVED_TAG_BANDS["default"]
    sites = [s for s in _const_sites(model)
             # intervals fully inside the default band ride the shared
             # tag-0 plane — sanctioned for everyone
             if not (s.tag_interval()[0] >= default.base
                     and s.tag_interval()[1] <= default.stop)]
    # (a) magic literals inside a reserved band
    for s in sites:
        if s.tag.get("provenance") != "literal":
            continue
        iv = s.tag_interval()
        for band in bands:
            if _overlaps(iv, (band.base, band.stop)):
                out.append(_finding(
                    f"{s.where()}: literal tag {s.tag['source']} lands in "
                    f"the reserved {band.name!r} band "
                    f"[{band.base}, {band.stop}) owned by {band.owner} — "
                    f"import the named tag from "
                    f"runtime.control_plane.RESERVED_TAG_BANDS instead "
                    f"of a magic number",
                    site=s.as_dict(), band=band.as_dict()))
    # (b) cross-subsystem interval intersections
    seen = set()
    for i, a in enumerate(sites):
        for b in sites[i + 1:]:
            if a.subsystem == b.subsystem:
                continue
            iva, ivb = a.tag_interval(), b.tag_interval()
            if not _overlaps(iva, ivb):
                continue
            # a matched p2p channel across subsystems is deliberate
            if {a.op, b.op} == {"send_obj", "recv_obj"} \
                    or (a.raw and b.raw and {a.op, b.op} == {"send",
                                                            "recv"}):
                continue
            # both sides naming the same reserved band is the sanctioned
            # way to share it (gather_telemetry's producer + consumer)
            band = next((bd for bd in bands
                         if iva[0] >= bd.base and iva[1] <= bd.stop
                         and ivb[0] >= bd.base and ivb[1] <= bd.stop), None)
            if band is not None and a.tag.get("provenance") == "named" \
                    and b.tag.get("provenance") == "named":
                continue
            key = (a.file, a.line, b.file, b.line)
            if key in seen:
                continue
            seen.add(key)
            out.append(_finding(
                f"{a.where()} ({a.subsystem}: {a.op} on tags "
                f"[{iva[0]}, {iva[1]})) collides with {b.where()} "
                f"({b.subsystem}: {b.op} on tags [{ivb[0]}, {ivb[1]})) — "
                f"two subsystems share a wire tag, so either protocol "
                f"can consume the other's payload; claim a band in "
                f"RESERVED_TAG_BANDS",
                site=a.as_dict(), other=b.as_dict()))
    return out


@rule("lockstep-divergence", "error",
      "collective object ops must be reachable on every rank's path",
      requires=("protocol_model",))
def _lockstep_divergence(ctx) -> List[Finding]:
    """The static twin of the flight recorder's ``identify_desync``: a
    collective object op under a rank guard (``if rank == 0:``) with no
    collective on the complementary branch means the guarded ranks enter
    a tree collective their peers never join — the exact hang the
    watchdog diagnoses post-mortem, caught before a mesh is involved.
    Same logic for except-handlers: a collective that only runs on the
    exception path desyncs the ranks that did not fault."""
    model = ctx.protocol_model
    out: List[Finding] = []
    collectives = model.collectives()
    for s in collectives:
        if s.rank_guards:
            g = s.rank_guards[-1]
            complement = "orelse" if g["branch"] == "body" else "body"
            matched = any(
                o is not s and o.file == s.file and any(
                    og.get("line") == g["line"]
                    and og.get("branch") == complement
                    for og in o.guards)
                for o in collectives)
            if not matched:
                out.append(_finding(
                    f"{s.where()}: collective {s.op} runs only under rank "
                    f"guard `{g['test']}` ({g['branch']} branch) with no "
                    f"collective on the complementary path — unguarded "
                    f"ranks never join the tree and the mesh wedges "
                    f"(identify_desync would report this rank stuck in "
                    f"{s.op})",
                    site=s.as_dict(), guard=g))
        for t in s.trys:
            if t["branch"] != "except":
                continue
            matched = any(
                o is not s and o.collective and o.file == s.file and any(
                    ot.get("line") == t["line"]
                    and ot.get("branch") == "try"
                    for ot in o.trys)
                for o in model.sites)
            if not matched:
                out.append(_finding(
                    f"{s.where()}: collective {s.op} runs only on an "
                    f"except path (try at line {t['line']}) — ranks that "
                    f"did not fault sail past while the faulted rank "
                    f"blocks in {s.op}",
                    site=s.as_dict(), try_line=t["line"]))
    return out


def _p2p_key_matches(a, b) -> bool:
    """Can send site ``a`` pair with recv site ``b``? Same plane (raw vs
    object), and overlapping tag sets: const↔const by interval, param↔
    param by base offset; a dynamic tag is a wildcard (statically
    unknowable — never report it unmatched, never let it mask a const
    mismatch elsewhere)."""
    if a.raw != b.raw:
        return False
    ta, tb = a.tag, b.tag
    if "dynamic" in (ta.get("kind"), tb.get("kind")):
        return True
    if ta.get("kind") == "const" and tb.get("kind") == "const":
        return _overlaps(a.tag_interval(), b.tag_interval())
    if ta.get("kind") == "param" and tb.get("kind") == "param":
        return ta.get("base") == tb.get("base")
    # const vs param: a parametric endpoint can be instantiated at the
    # const tag iff the const lies in the param namespace's band
    cs, ps = (ta, tb) if ta.get("kind") == "const" else (tb, ta)
    return cs.get("value", -1) >= ps.get("base", 0)


@rule("unmatched-send-recv", "error",
      "every p2p send needs a structurally matching recv (and vice versa)",
      requires=("protocol_model",))
def _unmatched_send_recv(ctx) -> List[Finding]:
    """A ``send_obj`` whose (plane, tag) no ``recv_obj`` in the tree can
    match blocks forever once the transport's buffering runs out — and an
    orphaned recv blocks immediately.  This is the seam ROADMAP item 2's
    pipeline-parallel p2p stages will stress: every new stage boundary
    adds a send/recv pair that must line up by tag."""
    model = ctx.protocol_model
    out: List[Finding] = []
    sends = [s for s in model.p2p()
             if s.op in ("send_obj", "send")]
    recvs = [s for s in model.p2p()
             if s.op in ("recv_obj", "recv")]
    for s in sends:
        if not any(_p2p_key_matches(s, r) for r in recvs):
            out.append(_finding(
                f"{s.where()}: {s.op} on tag {s.tag.get('source')} has no "
                f"structurally matching recv anywhere in the tree — the "
                f"payload is never consumed and the peer's inbox grows "
                f"until the transport stalls",
                site=s.as_dict()))
    for r in recvs:
        if not any(_p2p_key_matches(s, r) for s in sends):
            out.append(_finding(
                f"{r.where()}: {r.op} on tag {r.tag.get('source')} has no "
                f"structurally matching send anywhere in the tree — this "
                f"endpoint blocks forever",
                site=r.as_dict()))
    return out


@rule("wrapper-surface-drift", "error",
      "wrapper classes must accept and forward the full wrapped surface",
      requires=("protocol_model",))
def _wrapper_surface_drift(ctx) -> List[Finding]:
    """A proxy that forwards an object op while silently narrowing its
    signature turns a working call into a TypeError — exactly the
    ``InstrumentedCommunicator`` bug where ``gather_obj`` dropped
    ``tag=`` and every instrumented ``gather_telemetry``
    (tag=TELEMETRY_TAG) exploded.  Generic check: a class forwarding two
    or more object ops to the same wrapped attribute must, for each
    forwarded op, accept every optional parameter some implementation of
    that op defines, and actually pass it across the forwarding
    boundary."""
    model = ctx.protocol_model
    out: List[Finding] = []
    reference: Dict[str, set] = {}
    for c in model.class_ops:
        if not c.forwards_to:
            reference.setdefault(c.op, set()).update(c.optional_params)
    by_wrapper: Dict[tuple, list] = {}
    for c in model.class_ops:
        if c.forwards_to:
            by_wrapper.setdefault((c.file, c.cls, c.forwards_to),
                                  []).append(c)
    for (file, cls, attr), ops in by_wrapper.items():
        if len(ops) < 2:   # a one-off delegation is not a wrapper surface
            continue
        for c in ops:
            ref = reference.get(c.op, set())
            dropped = sorted(ref - set(c.params))
            if dropped:
                out.append(_finding(
                    f"{c.file}:{c.line}: {cls}.{c.op} forwards to "
                    f"self.{attr} but does not accept "
                    f"{', '.join(dropped)} — parameters the wrapped "
                    f"surface takes; callers passing them get a "
                    f"TypeError only through the wrapper",
                    cls=cls, op=c.op, file=c.file, line=c.line,
                    dropped=dropped, forwards_to=attr))
            swallowed = sorted((ref & set(c.params))
                               - set(c.forwarded_params))
            if swallowed:
                out.append(_finding(
                    f"{c.file}:{c.line}: {cls}.{c.op} accepts "
                    f"{', '.join(swallowed)} but drops them at the "
                    f"forwarding boundary to self.{attr} — the wrapped "
                    f"call silently runs with defaults",
                    cls=cls, op=c.op, file=c.file, line=c.line,
                    swallowed=swallowed, forwards_to=attr))
    return out


@rule("protocol-replay-desync", "error",
      "recorded object-plane event sequences must agree across ranks",
      requires=("protocol_model", "flight_events"))
def _protocol_replay_desync(ctx) -> List[Finding]:
    """Replay a flight dump's per-rank object-plane events against the
    static model: ranks that completed different op sequences, or a rank
    wedged inside an op its peers sailed past, are protocol violations —
    with the model's rank-guarded collective sites attached as prime
    suspects.  This is the triage path for ``elastic_run`` incident
    manifests (restart_manifest/v1 embeds the per-rank dumps)."""
    from chainermn_tpu_torch.analysis.protocol import (
        load_events_by_rank, replay_flight)
    events = load_events_by_rank(ctx.flight_events)
    out: List[Finding] = []
    for v in replay_flight(ctx.protocol_model, events):
        f = _finding(v["message"], **{k: val for k, val in v.items()
                                      if k != "message"})
        if v.get("kind") == "unknown-op":
            f.severity = "info"
        out.append(f)
    return out


__all__ = ["DRIFT_TOLERANCE_X", "Finding",
           "NP_TO_HLO_DTYPE", "Rule", "SEVERITIES", "all_rules",
           "expected_issued_kinds", "expected_kinds", "get_rule", "rule"]
