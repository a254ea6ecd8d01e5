"""Global collective scheduler: the shared link schedule over the SET of
plans in flight per step.

Counterpart of ``chainermn_tpu/planner/schedule.py``, whole and device-free
(JAX's arithmetic; link classes are the card's ``"nvlink"`` and ``"ib"``).

* :class:`StepWorkload` -- named plan slots (payload shape + collective op
  + ordering constraints) over one topology, serializable like the IR; its
  :meth:`~StepWorkload.signature` hashes the slot SHAPES, never the plan
  choices.
* :func:`simulate_workload` / :func:`workload_modeled_time_s` -- an
  event-driven fair-share simulator: each slot's plan unrolls to its
  concurrent stage chains, each link class's bandwidth is split evenly
  across the slots busy on it; a slot's own chains are priced by dilation
  (``kappa = plan_modeled_time_s / max_chain_sum``), so a slot alone
  finishes at exactly ``plan_modeled_time_s``.
* :func:`jointly_tune` -- coordinate descent over per-slot candidate zoos
  under the shared-link simulator.
* :class:`JointPlanTable` -- ``{workload signature: {slot: plan}}`` on
  disk, falling back to per-plan :class:`~chainermn_tpu_torch.planner.
  autotune.PlanTable` lookups for unknown workloads.
* the plan-slot registry (:func:`register_plan_slot`,
  :func:`set_slot_plan` / :func:`get_slot_plan` / :func:`resolve_slot_plan`,
  :func:`clear_plan_slots`) -- the MoE exchange and the auto communicator
  announce their in-flight collectives there, and a jointly tuned plan is
  installed there.  :func:`reconstruct_workload` rebuilds the workload
  from the registry, filtered by contention occupancy timelines
  (``timelines=``, ``observability.contention``).

Jointly tuned plans are name-tagged ``<base>@wl:<signature>``.
"""

from __future__ import annotations

import hashlib
import math
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from chainermn_tpu_torch.planner.autotune import PlanTable, size_bucket
from chainermn_tpu_torch.planner.compiler import (
    LINK_CLASS, _chain_stage_costs, plan_modeled_time_s, validate_link_gbps)
from chainermn_tpu_torch.planner.ir import (Plan, PlanError, PlanTopology,
                                            dtype_itemsize, dtype_name)

WORKLOAD_SCHEMA = "step_workload/v1"
JOINT_TABLE_SCHEMA = "joint_plan_table/v1"

#: the plan-name tag a jointly-tuned plan carries: ``<base>@wl:<sig>``.
#: ``observability.contention.plan_identity`` parses the same literal
#: (kept in sync by ``tests/test_planner.py``) — spans whose plans share
#: a workload signature were tuned TOGETHER.
WORKLOAD_TAG = "@wl:"

_EPS = 1e-12


# ---------------------------------------------------------------------------
# plan-name workload tagging
# ---------------------------------------------------------------------------

def untagged_plan_name(name: str) -> str:
    """The base plan name with any ``@wl:<sig>`` workload tag removed."""
    base, sep, _sig = str(name).partition(WORKLOAD_TAG)
    return base if sep else str(name)


def plan_workload_signature(name: str) -> Optional[str]:
    """Workload signature embedded in a plan name (``None`` when the
    plan was tuned independently)."""
    _base, sep, sig = str(name).partition(WORKLOAD_TAG)
    return sig if (sep and sig) else None


def tag_plan(plan: Plan, signature: str) -> Plan:
    """``plan`` renamed to carry ``signature`` (replacing any existing
    workload tag) — the co-tuned identity the contention lint reads."""
    return plan.with_name(
        f"{untagged_plan_name(plan.name)}{WORKLOAD_TAG}{signature}")


# ---------------------------------------------------------------------------
# the workload IR
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WorkloadSlot:
    """One named plan slot of a :class:`StepWorkload`: a collective a
    subsystem issues each step, as payload shape plus constraints.

    ``after`` names slots that must FINISH before this one starts (the
    ordering constraint — e.g. a combine exchange after its dispatch);
    slots not ordered against each other run concurrently, which is the
    default and the whole point.  ``plan`` is the slot's current
    assignment; it is NOT part of the workload signature.
    """

    name: str
    nbytes: int
    dtype: str = "float32"
    op: str = "all-reduce"
    after: Tuple[str, ...] = ()
    plan: Optional[Plan] = None

    def __post_init__(self):
        if not self.name:
            raise PlanError("workload slot needs a name")
        object.__setattr__(self, "nbytes", int(self.nbytes))
        object.__setattr__(self, "after", tuple(str(a) for a in self.after))
        if self.nbytes <= 0:
            raise PlanError(
                f"slot {self.name!r}: nbytes must be > 0, got {self.nbytes}")
        try:
            dtype_name(self.dtype)
        except TypeError as e:
            raise PlanError(
                f"slot {self.name!r}: bad dtype {self.dtype!r}: {e}") \
                from None
        if self.plan is not None and not isinstance(self.plan, Plan):
            raise PlanError(
                f"slot {self.name!r}: plan is not a Plan: {self.plan!r}")

    def shape_dict(self) -> dict:
        """The slot's signature contribution — everything EXCEPT the
        plan choice."""
        return {"name": self.name, "nbytes": self.nbytes,
                "dtype": dtype_name(self.dtype), "op": self.op,
                "after": sorted(self.after)}

    def to_dict(self) -> dict:
        d = {"name": self.name, "nbytes": self.nbytes, "dtype": self.dtype,
             "op": self.op}
        if self.after:
            d["after"] = list(self.after)
        if self.plan is not None:
            d["plan"] = self.plan.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSlot":
        plan = d.get("plan")
        return cls(name=d["name"], nbytes=int(d["nbytes"]),
                   dtype=d.get("dtype", "float32"),
                   op=d.get("op", "all-reduce"),
                   after=tuple(d.get("after", ())),
                   plan=Plan.from_dict(plan) if plan is not None else None)


@dataclass(frozen=True)
class StepWorkload:
    """The set of plans in flight per step: named slots over ONE
    topology, serializable like the rest of the IR (``to_dict`` /
    ``from_dict`` / JSON / save / load)."""

    topology: PlanTopology
    slots: Tuple[WorkloadSlot, ...]

    def __post_init__(self):
        object.__setattr__(self, "slots", tuple(self.slots))
        if not self.slots:
            raise PlanError("workload needs at least one slot")
        names = [s.name for s in self.slots]
        if len(set(names)) != len(names):
            raise PlanError(f"duplicate slot names: {sorted(names)}")
        known = set(names)
        deps = {}
        for s in self.slots:
            for a in s.after:
                if a not in known:
                    raise PlanError(
                        f"slot {s.name!r} ordered after unknown slot {a!r}")
            deps[s.name] = set(s.after)
        # Kahn cycle check: ordering constraints must be a DAG
        ready = [n for n, d in deps.items() if not d]
        done = set()
        while ready:
            n = ready.pop()
            done.add(n)
            for m, d in deps.items():
                if m not in done and d <= done:
                    if m not in ready:
                        ready.append(m)
        if len(done) != len(names):
            cyc = sorted(set(names) - done)
            raise PlanError(f"ordering cycle among slots {cyc}")

    def slot(self, name: str) -> WorkloadSlot:
        for s in self.slots:
            if s.name == name:
                return s
        raise KeyError(name)

    def plans(self) -> Dict[str, Plan]:
        """Current slot assignments (slots with no plan omitted)."""
        return {s.name: s.plan for s in self.slots if s.plan is not None}

    def with_plans(self, plans: Dict[str, Plan]) -> "StepWorkload":
        """The workload with the given slots' plans replaced (other
        slots keep theirs) — the coordinate-descent move."""
        import dataclasses
        out = []
        for s in self.slots:
            if s.name in plans:
                out.append(dataclasses.replace(s, plan=plans[s.name]))
            else:
                out.append(s)
        return StepWorkload(topology=self.topology, slots=tuple(out))

    def signature(self) -> str:
        """Canonical hash of the workload SHAPE — topology plus slot
        payloads/ops/ordering, never the plan choices — so a
        :class:`JointPlanTable` keyed by it matches the same workload
        whatever plans currently fill the slots.  Slot payloads hash by
        size bucket (the same ladder the plan table is keyed on), so
        step-to-step payload jitter within a bucket recalls the same
        joint decision."""
        shape = {
            "topology": self.topology.key(),
            "slots": sorted(
                (dict(s.shape_dict(),
                      nbytes=size_bucket(s.nbytes)) for s in self.slots),
                key=lambda d: d["name"]),
        }
        blob = json.dumps(shape, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def to_dict(self) -> dict:
        return {"schema": WORKLOAD_SCHEMA,
                "topology": self.topology.to_dict(),
                "slots": [s.to_dict() for s in self.slots]}

    @classmethod
    def from_dict(cls, d: dict) -> "StepWorkload":
        schema = d.get("schema", WORKLOAD_SCHEMA)
        if schema != WORKLOAD_SCHEMA:
            raise ValueError(
                f"unsupported workload schema {schema!r} "
                f"(this build reads {WORKLOAD_SCHEMA!r})")
        return cls(topology=PlanTopology.from_dict(d["topology"]),
                   slots=tuple(WorkloadSlot.from_dict(s)
                               for s in d["slots"]))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "StepWorkload":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "StepWorkload":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# the event-driven fair-share simulator
# ---------------------------------------------------------------------------

@dataclass
class WorkloadSchedule:
    """:func:`simulate_workload` output: per-slot start/finish times,
    the makespan, and the modeled per-(link, owner) occupancy —
    ``busy_s`` is wall-clock time the owner kept the link busy,
    ``share_s`` its fair share of it (per link, owner shares sum to the
    link's union busy time — the conservation invariant)."""

    makespan_s: float
    start_s: Dict[str, float]
    finish_s: Dict[str, float]
    #: (link, slot name) -> {"busy_s", "share_s"}
    occupancy: Dict[Tuple[str, str], Dict[str, float]]
    #: union busy seconds per link class
    link_busy_s: Dict[str, float]
    #: per-slot solo price (== plan_modeled_time_s of its plan)
    slot_solo_s: Dict[str, float]
    #: slots that ever shared a link with another slot
    contended_slots: Tuple[str, ...] = ()


class _Chain:
    """One stage chain's simulation state: (link, dilated solo seconds)
    segments and a cursor."""

    __slots__ = ("segs", "idx", "remaining")

    def __init__(self, segs: List[Tuple[str, float]]):
        self.segs = segs
        self.idx = 0
        self.remaining = segs[0][1] if segs else 0.0
        self._skip_empty()

    def _skip_empty(self) -> None:
        while self.idx < len(self.segs) and self.remaining <= _EPS:
            self.idx += 1
            self.remaining = (self.segs[self.idx][1]
                              if self.idx < len(self.segs) else 0.0)

    @property
    def done(self) -> bool:
        return self.idx >= len(self.segs)

    @property
    def link(self) -> str:
        return self.segs[self.idx][0]

    def advance(self, solo_s: float) -> None:
        self.remaining -= solo_s
        if self.remaining <= _EPS:
            self.remaining = 0.0
            self._skip_empty()


def _slot_chains(slot: WorkloadSlot, topology: PlanTopology,
                 link_gbps: Dict[str, float]
                 ) -> Tuple[List[List[Tuple[str, float]]], float]:
    """Unroll a slot's plan into per-chain ``(link, dilated solo
    seconds)`` segment lists.  Each chain's segments are priced at the
    FULL declared link rate, then dilated by ``kappa = solo modeled
    time / max chain sum`` — a slot running alone finishes at exactly
    ``plan_modeled_time_s`` (its within-plan link contention is priced
    by the dilation, not by sharing against itself).  Returns the
    chains and the slot's solo modeled time."""
    if slot.plan is None:
        raise PlanError(f"slot {slot.name!r} has no plan assigned")
    item = dtype_itemsize(slot.dtype)

    def _rate(link: str) -> float:
        bw = link_gbps.get(link)
        return float(bw) * 1e9 if bw else float("inf")

    chains: List[List[Tuple[str, float]]] = []
    chain_sums: List[float] = []
    for grp in slot.plan.stage_groups():
        segs: List[Tuple[str, float]] = []
        for scope, moved in _chain_stage_costs(
                slot.plan, grp.stages, topology,
                slot.nbytes * grp.ratio, item):
            link = LINK_CLASS[scope]
            segs.append((link, moved / _rate(link)))
        chains.append(segs)
        chain_sums.append(sum(d for _, d in segs))
    solo = plan_modeled_time_s(slot.plan, topology, slot.nbytes,
                               link_gbps, dtype=slot.dtype)
    max_chain = max(chain_sums, default=0.0)
    kappa = (solo / max_chain) if max_chain > 0.0 else 1.0
    dilated = [[(link, d * kappa) for link, d in segs] for segs in chains]
    return dilated, solo


def simulate_workload(workload: StepWorkload,
                      link_gbps: Dict[str, float],
                      derate: Optional[Dict[str, float]] = None
                      ) -> WorkloadSchedule:
    """Event-driven fair-share simulation of the workload's plans over
    shared link classes.

    Semantics: each link class's bandwidth splits EVENLY across the
    slots (owners) concurrently busy on it — a slot busy on a link
    shared by ``n`` owners progresses its chains at ``1/n`` solo-speed
    there.  A slot's own concurrent chains do NOT contend against each
    other (their interleaving is already priced into the slot's solo
    time by the kappa dilation, see :func:`_slot_chains`).  Slots with
    ``after`` constraints start when every predecessor finished.

    ``derate`` optionally multiplies declared link rates by measured
    contention derates (a ``link_rates`` document) before simulating —
    :func:`derated_link_gbps` builds it from a rates document.

    Invariants (property-tested in ``tests/test_planner.py``):

    * conservation — per link, owner ``share_s`` sums to the link's
      union busy seconds;
    * monotonicity — adding a slot never finishes another slot earlier;
    * single-slot exactness — a one-slot workload finishes at exactly
      ``plan_modeled_time_s`` of its plan.
    """
    gbps = validate_link_gbps(link_gbps)
    if derate:
        gbps = {link: bw * float(derate.get(link, 1.0))
                for link, bw in gbps.items()}
    chains: Dict[str, List[_Chain]] = {}
    solo_s: Dict[str, float] = {}
    for slot in workload.slots:
        segs, solo = _slot_chains(slot, workload.topology, gbps)
        chains[slot.name] = [_Chain(s) for s in segs]
        solo_s[slot.name] = solo

    deps = {s.name: set(s.after) for s in workload.slots}
    start_s: Dict[str, float] = {}
    finish_s: Dict[str, float] = {}
    occupancy: Dict[Tuple[str, str], Dict[str, float]] = {}
    link_busy: Dict[str, float] = {}
    contended: set = set()

    t = 0.0
    running: set = set()

    def _sync(now: float) -> None:
        """Finish slots whose chains drained; start slots whose
        predecessors finished."""
        moved = True
        while moved:
            moved = False
            for name in sorted(running):
                if all(c.done for c in chains[name]):
                    running.discard(name)
                    finish_s[name] = now
                    moved = True
            for name in sorted(deps):
                if name in running or name in finish_s:
                    continue
                if deps[name] <= set(finish_s):
                    running.add(name)
                    start_s[name] = now
                    if all(c.done for c in chains[name]):
                        # a zero-work slot finishes where it starts
                        running.discard(name)
                        finish_s[name] = now
                    moved = True

    _sync(t)
    while running:
        # owners concurrently busy per link
        owners: Dict[str, set] = {}
        for name in running:
            for c in chains[name]:
                if not c.done:
                    owners.setdefault(c.link, set()).add(name)
        # progress rate (solo seconds per wall second) per running slot
        # chain = 1 / n_owners on its current link
        dt = float("inf")
        for name in running:
            for c in chains[name]:
                if c.done:
                    continue
                n = len(owners[c.link])
                dt = min(dt, c.remaining * n)
        if not math.isfinite(dt):  # pragma: no cover - _sync drains these
            break
        for link, who in owners.items():
            n = len(who)
            link_busy[link] = link_busy.get(link, 0.0) + dt
            for name in who:
                cell = occupancy.setdefault(
                    (link, name), {"busy_s": 0.0, "share_s": 0.0})
                cell["busy_s"] += dt
                cell["share_s"] += dt / n
            if n > 1:
                contended.update(who)
        for name in running:
            for c in chains[name]:
                if not c.done:
                    c.advance(dt / len(owners[c.link]))
        t += dt
        _sync(t)

    # exactness: a slot that never shared a link ran at solo speed
    # throughout — pin its finish to exactly start + solo price,
    # removing accumulated event-loop rounding (this is what makes a
    # single-slot workload bit-exact with plan_modeled_time_s)
    for name, solo in solo_s.items():
        if name not in contended and name in finish_s:
            finish_s[name] = start_s.get(name, 0.0) + solo
    makespan = max(finish_s.values(), default=0.0)
    return WorkloadSchedule(
        makespan_s=makespan, start_s=start_s, finish_s=finish_s,
        occupancy=occupancy, link_busy_s=link_busy, slot_solo_s=solo_s,
        contended_slots=tuple(sorted(contended)))


def workload_modeled_time_s(workload: StepWorkload,
                            link_gbps: Dict[str, float],
                            derate: Optional[Dict[str, float]] = None
                            ) -> float:
    """Predicted wall seconds for the whole step workload — the
    makespan of :func:`simulate_workload`: the multi-plan counterpart
    of ``plan_modeled_time_s`` (to which it reduces exactly for a
    single-slot workload)."""
    return simulate_workload(workload, link_gbps, derate=derate).makespan_s


def derated_link_gbps(link_gbps: Dict[str, float],
                      rates: Dict[str, dict]) -> Dict[str, float]:
    """Declared link rates multiplied by the measured contention
    derates of a ``link_rates`` document — the observed-rate
    pricing the online joint retune feeds the simulator."""
    out = dict(validate_link_gbps(link_gbps))
    for link, row in (rates or {}).items():
        if link in out and isinstance(row, dict):
            d = float(row.get("derate", 1.0))
            if d > 0.0:
                out[link] = out[link] * d
    return out


# ---------------------------------------------------------------------------
# the joint plan table
# ---------------------------------------------------------------------------

@dataclass
class JointPlanTable:
    """On-disk map ``workload signature -> {slot name: Plan}`` — the
    jointly-tuned decisions, degrading gracefully to per-plan
    :class:`~chainermn_tpu_torch.planner.autotune.PlanTable` lookups for
    workloads never jointly tuned (:meth:`slot_plan`)."""

    entries: Dict[str, Dict[str, Plan]] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    def put(self, workload: StepWorkload,
            plans: Dict[str, Plan]) -> str:
        sig = workload.signature()
        self.entries[sig] = dict(plans)
        return sig

    def lookup(self, workload_or_sig) -> Optional[Dict[str, Plan]]:
        sig = (workload_or_sig if isinstance(workload_or_sig, str)
               else workload_or_sig.signature())
        found = self.entries.get(sig)
        return dict(found) if found is not None else None

    def slot_plan(self, workload: StepWorkload, slot_name: str,
                  fallback: Optional[PlanTable] = None) -> Optional[Plan]:
        """The plan for one slot: the joint decision when this exact
        workload signature was tuned, else the per-plan table's answer
        for the slot's (topology, dtype, nbytes) — the graceful
        degradation for unknown workloads."""
        joint = self.lookup(workload)
        if joint is not None and slot_name in joint:
            return joint[slot_name]
        if fallback is not None:
            slot = workload.slot(slot_name)
            return fallback.lookup(workload.topology,
                                   dtype_name(slot.dtype), slot.nbytes)
        return None

    def to_dict(self) -> dict:
        return {
            "schema": JOINT_TABLE_SCHEMA,
            "meta": self.meta,
            "entries": [
                {"signature": sig,
                 "slots": {name: plan.to_dict()
                           for name, plan in sorted(plans.items())}}
                for sig, plans in sorted(self.entries.items())],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "JointPlanTable":
        schema = d.get("schema", JOINT_TABLE_SCHEMA)
        if schema != JOINT_TABLE_SCHEMA:
            raise ValueError(
                f"unsupported joint-table schema {schema!r} "
                f"(this build reads {JOINT_TABLE_SCHEMA!r})")
        table = cls(meta=dict(d.get("meta", {})))
        for e in d.get("entries", []):
            table.entries[e["signature"]] = {
                name: Plan.from_dict(spec)
                for name, spec in e["slots"].items()}
        return table

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "JointPlanTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# joint tuning: coordinate descent under the shared-link simulator
# ---------------------------------------------------------------------------

def independent_plans(workload: StepWorkload,
                      candidates_per_slot: Dict[str, Sequence[Plan]],
                      link_gbps: Dict[str, float]) -> Dict[str, Plan]:
    """Per-slot winners under the SOLO price (``plan_modeled_time_s``)
    — what today's per-communicator tuning picks, and the baseline
    ``jointly_tune`` must beat.  Deterministic tie-break by name."""
    gbps = validate_link_gbps(link_gbps)
    out: Dict[str, Plan] = {}
    for slot in workload.slots:
        cands = list(candidates_per_slot.get(slot.name, ()))
        if not cands:
            raise ValueError(f"no candidates for slot {slot.name!r}")
        out[slot.name] = min(
            cands, key=lambda p: (plan_modeled_time_s(
                p, workload.topology, slot.nbytes, gbps,
                dtype=slot.dtype), p.name))
    return out


def default_candidates(workload: StepWorkload,
                       stripe_ratios: Tuple[float, ...] = ()
                       ) -> Dict[str, List[Plan]]:
    """Per-slot candidate zoos from the stock generators, keyed by each
    slot's collective op (``candidate_plans`` for all-reduce slots, the
    ``alltoall_plans`` zoo for exchange slots)."""
    from chainermn_tpu_torch.planner.plans import candidate_plans
    return {slot.name: candidate_plans(workload.topology,
                                       stripe_ratios=tuple(stripe_ratios),
                                       op=slot.op)
            for slot in workload.slots}


def jointly_tune(workload: StepWorkload,
                 candidates_per_slot: Optional[
                     Dict[str, Sequence[Plan]]] = None,
                 link_gbps: Optional[Dict[str, float]] = None,
                 derate: Optional[Dict[str, float]] = None,
                 max_rounds: int = 8,
                 stripe_ratios: Tuple[float, ...] = (),
                 ) -> Tuple[JointPlanTable, dict]:
    """Pick every slot's plan JOINTLY under the shared-link simulator.

    Coordinate descent seeded from the independently-tuned picks: sweep
    the slots round-robin, re-choosing each slot's plan to minimize the
    workload makespan with every other slot held fixed, until a full
    round changes nothing (or ``max_rounds``).  Each accepted move
    strictly lowers the makespan, so descent terminates; the seed
    guarantees the joint choice is never worse than independent under
    the workload model.

    Returns ``(table, comparison)`` — the :class:`JointPlanTable` entry
    holds the winning plans name-tagged with the workload signature
    (:func:`tag_plan`), and ``comparison`` records joint vs independent
    modeled times, per-slot choices, and which slots the joint winner
    changed (the ceded-link evidence).
    """
    if link_gbps is None:
        raise ValueError("jointly_tune needs link_gbps rates to price at")
    gbps = validate_link_gbps(link_gbps)
    if derate:
        gbps = {link: bw * float(derate.get(link, 1.0))
                for link, bw in gbps.items()}
    if candidates_per_slot is None:
        candidates_per_slot = default_candidates(
            workload, stripe_ratios=stripe_ratios)

    indep = independent_plans(workload, candidates_per_slot, gbps)
    indep_sched = simulate_workload(workload.with_plans(indep), gbps)
    independent_s = indep_sched.makespan_s

    current = dict(indep)
    current_s = independent_s
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        changed = False
        for slot in workload.slots:
            best_plan, best_s = current[slot.name], current_s
            for cand in candidates_per_slot[slot.name]:
                if cand.name == best_plan.name:
                    continue
                trial = dict(current, **{slot.name: cand})
                s = simulate_workload(
                    workload.with_plans(trial), gbps).makespan_s
                if s < best_s * (1.0 - 1e-12):
                    best_plan, best_s = cand, s
            if best_plan.name != current[slot.name].name:
                current[slot.name] = best_plan
                current_s = best_s
                changed = True
        if not changed:
            break
    joint_sched = simulate_workload(workload.with_plans(current), gbps)
    joint_s = joint_sched.makespan_s

    sig = workload.signature()
    tagged = {name: tag_plan(plan, sig) for name, plan in current.items()}
    table = JointPlanTable(meta={
        "link_gbps": {k: float(v) for k, v in sorted(gbps.items())},
        "rounds": rounds,
    })
    table.entries[sig] = tagged

    changed_slots = sorted(
        name for name in indep
        if untagged_plan_name(current[name].name)
        != untagged_plan_name(indep[name].name))
    comparison = {
        "signature": sig,
        "topology": workload.topology.key(),
        "link_gbps": {k: float(v) for k, v in sorted(gbps.items())},
        "rounds": rounds,
        "independent": {
            "plans": {n: p.name for n, p in sorted(indep.items())},
            "modeled_s": independent_s,
            "finish_s": dict(sorted(indep_sched.finish_s.items())),
        },
        "joint": {
            "plans": {n: untagged_plan_name(p.name)
                      for n, p in sorted(current.items())},
            "modeled_s": joint_s,
            "finish_s": dict(sorted(joint_sched.finish_s.items())),
        },
        "speedup": (independent_s / joint_s) if joint_s > 0 else 1.0,
        "changed_slots": changed_slots,
        "slots": [{
            "slot": slot.name, "op": slot.op, "nbytes": slot.nbytes,
            "dtype": slot.dtype,
            "independent_plan": indep[slot.name].name,
            "joint_plan": untagged_plan_name(current[slot.name].name),
            "changed": slot.name in changed_slots,
            "solo_s": plan_modeled_time_s(
                current[slot.name], workload.topology, slot.nbytes,
                gbps, dtype=slot.dtype),
        } for slot in workload.slots],
    }
    return table, comparison


# ---------------------------------------------------------------------------
# plan-slot registry — how live subsystems announce their in-flight
# collectives so the online tuner can reconstruct the step workload
# ---------------------------------------------------------------------------

_SLOTS: Dict[str, dict] = {}
_ACTIVE_PLANS: Dict[str, Plan] = {}


def register_plan_slot(name: str, *, nbytes: int, dtype: str = "float32",
                       op: str = "all-reduce",
                       owners: Tuple[str, ...] = (),
                       after: Tuple[str, ...] = ()) -> None:
    """Announce that subsystem slot ``name`` issues a
    collective of this shape each step.  ``owners`` are the contention
    occupancy owner labels that evidence this slot in timelines (a name
    ending in ``":"`` matches as a prefix, e.g. ``"plan:"``); payload
    size is kept as the max seen, so re-registration with a smaller
    microbatch does not shrink the priced workload."""
    prev = _SLOTS.get(name)
    nbytes = int(nbytes)
    if prev is not None:
        nbytes = max(nbytes, int(prev.get("nbytes", 0)))
    _SLOTS[name] = {"nbytes": nbytes, "dtype": str(dtype), "op": str(op),
                    "owners": tuple(owners), "after": tuple(after)}


def registered_slots() -> Dict[str, dict]:
    return {name: dict(spec) for name, spec in _SLOTS.items()}


def set_slot_plan(name: str, plan: Plan) -> None:
    """Install a jointly-tuned plan as slot ``name``'s live override
    (the online tuner's atomic multi-slot swap writes every slot here;
    plan-seam call sites pick it up via :func:`resolve_slot_plan` at
    their next call)."""
    _ACTIVE_PLANS[name] = plan


def get_slot_plan(name: str) -> Optional[Plan]:
    return _ACTIVE_PLANS.get(name)


def resolve_slot_plan(name: str, default: Optional[Plan]) -> Optional[Plan]:
    """The plan a slot's call site should execute: its live jointly-
    tuned override when one is installed, else the caller's own."""
    return _ACTIVE_PLANS.get(name, default)


def clear_plan_slots() -> None:
    _SLOTS.clear()
    _ACTIVE_PLANS.clear()


def _owner_matches(owner: str, patterns: Tuple[str, ...]) -> bool:
    for p in patterns:
        if p.endswith(":"):
            if owner.startswith(p) or owner == p[:-1]:
                return True
        elif owner == p:
            return True
    return False


def reconstruct_workload(topology: PlanTopology,
                         timelines: Optional[dict] = None,
                         slots: Optional[Dict[str, dict]] = None
                         ) -> Optional[StepWorkload]:
    """Rebuild the in-flight :class:`StepWorkload` from the plan-slot
    registry, filtered by contention occupancy evidence.

    ``timelines`` is ``occupancy_timelines`` output (``{link: {owner:
    intervals}}``); a registered slot is included when any timeline
    owner matches its declared ``owners`` patterns (no timelines =
    include every registered slot).  ``None`` when nothing matches —
    the online tuner then stays on its per-plan path."""
    specs = slots if slots is not None else _SLOTS
    if not specs:
        return None
    seen = set()
    if timelines:
        for per_owner in timelines.values():
            seen.update(per_owner)
    out = []
    for name, spec in sorted(specs.items()):
        patterns = tuple(spec.get("owners", ()))
        if timelines and patterns and not any(
                _owner_matches(o, patterns) for o in seen):
            continue
        out.append(WorkloadSlot(
            name=name, nbytes=int(spec["nbytes"]),
            dtype=spec.get("dtype", "float32"),
            op=spec.get("op", "all-reduce"),
            after=tuple(spec.get("after", ()))))
    if not out:
        return None
    return StepWorkload(topology=topology, slots=tuple(out))


__all__ = [
    "JOINT_TABLE_SCHEMA",
    "JointPlanTable",
    "StepWorkload",
    "WORKLOAD_SCHEMA",
    "WORKLOAD_TAG",
    "WorkloadSchedule",
    "WorkloadSlot",
    "clear_plan_slots",
    "default_candidates",
    "derated_link_gbps",
    "get_slot_plan",
    "independent_plans",
    "jointly_tune",
    "plan_workload_signature",
    "reconstruct_workload",
    "register_plan_slot",
    "registered_slots",
    "resolve_slot_plan",
    "set_slot_plan",
    "simulate_workload",
    "tag_plan",
    "untagged_plan_name",
    "workload_modeled_time_s",
]
