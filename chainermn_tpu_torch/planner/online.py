"""Online plan autotuning: re-tuning the plan table from observed link
rates.

Counterpart of ``chainermn_tpu/planner/online.py``.  The offline autotuner
measures candidate plans once, at the link rates of the tuning run; an
:class:`OnlineTuner`

1. consumes the ``(group, stage)``-tagged ``plan_stage`` spans the plan
   executor emits into the flight recorder (:meth:`OnlineTuner.ingest`),
   folding each completed span into a rolling per-link-class observation
   window (:class:`LinkObservations`, keyed ``"nvlink"`` / ``"ib"``; a
   span tagged with JAX's ``"ici"`` / ``"dcn"`` counts as those);
2. arms a re-tune when :class:`~chainermn_tpu_torch.observability.
   straggler.AttributionWatch` flags a sustained ``ici_comm`` /
   ``dcn_comm`` regression (:meth:`OnlineTuner.on_regression`);
3. re-prices the candidate zoo (``planner.plans.candidate_plans``) through
   :func:`~chainermn_tpu_torch.planner.compiler.plan_modeled_time_s` at
   the *observed* rates, feeds the synthesized ``allreduce_sweep/v1`` rows
   to the unchanged :func:`~chainermn_tpu_torch.planner.autotune.
   autotune_from_rows`, and
4. hot-swaps the :class:`~chainermn_tpu_torch.planner.autotune.PlanTable`
   at a step boundary when the modeled win clears ``threshold``: rank 0
   decides, the decision is broadcast on the object plane so every rank
   flips on the same step, a ``plan_table_swap`` flight event marks the
   boundary, and the new table's content hash (:func:`plan_table_hash`)
   is pinned into the checkpoint sidecar (``extensions/checkpoint.py``) so
   a resume refuses a silently different table.

The joint mode re-prices the whole registered step workload
(``planner.schedule``), filtered by contention occupancy timelines
(:meth:`OnlineTuner.observe_timelines`).  :func:`recommend_prefetch_depth`
is the FSDP prefetch-depth advice from stall fractions
(:meth:`OnlineTuner.observe_attribution`).  Observations also go in
directly through :meth:`LinkObservations.add` and
:meth:`OnlineTuner.observe_payload`.

Offline replay: ``chainermn_tpu_torch.benchmarks.bench_allreduce
--replay-spans FILE`` feeds a span dump through this module to reproduce
a re-tune decision.
"""

from __future__ import annotations

import collections
import hashlib
import json
from typing import Dict, List, Optional, Tuple

from chainermn_tpu_torch.planner.autotune import (
    PlanTable, autotune_from_rows, size_bucket)
from chainermn_tpu_torch.planner.compiler import plan_modeled_time_s
from chainermn_tpu_torch.planner.ir import Plan, PlanTopology
from chainermn_tpu_torch.planner.plans import (STRIPE_RATIOS, candidate_plans,
                                               flavor_plan)

ONLINE_TUNE_SCHEMA = "online_tune/v1"

#: attribution buckets whose sustained regression arms a re-tune (the
#: comm buckets -- a compute or host_input regression says nothing about
#: plan choice); JAX's names, which the port's attribution keeps
COMM_BUCKETS = ("ici_comm", "dcn_comm")
#: the same buckets under the card's link names
_COMM_BUCKET_ALIASES = ("nvlink_comm", "ib_comm")


def plan_table_hash(table) -> str:
    """Content hash of a plan table — canonical JSON of ``to_dict`` so
    semantically-equal tables hash equal across processes and sessions.
    This is the value the checkpoint sidecar pins and the swap broadcast
    carries."""
    d = table.to_dict() if isinstance(table, PlanTable) else dict(table)
    blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# active-table registry — the seam the checkpoint sidecar and the serving
# engine read (the swapped table is not part of the state pytree, so the
# pin rides a module-level registry the tuner maintains)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[dict] = None


def set_active_plan_table(table: PlanTable, step: Optional[int] = None,
                          evidence=None) -> dict:
    """Publish ``table`` as the live (hot-swapped) plan table.  Returns
    the registered meta dict (``table_hash`` / ``swap_step``)."""
    global _ACTIVE
    _ACTIVE = {"table": table, "table_hash": plan_table_hash(table),
               "swap_step": step, "evidence": evidence}
    return active_plan_table_meta()


def get_active_plan_table() -> Optional[PlanTable]:
    return _ACTIVE["table"] if _ACTIVE is not None else None


def active_plan_table_meta() -> Optional[dict]:
    """The checkpoint-sidecar pin: ``None`` when no swap has happened
    (plain runs carry no plan-table sidecar)."""
    if _ACTIVE is None:
        return None
    return {"table_hash": _ACTIVE["table_hash"],
            "swap_step": _ACTIVE["swap_step"]}


def clear_active_plan_table() -> None:
    global _ACTIVE
    _ACTIVE = None


# ---------------------------------------------------------------------------
# observation store
# ---------------------------------------------------------------------------

class LinkObservations:
    """Rolling window of observed per-link-class transfer rates.

    Fed from completed ``plan_stage`` spans (each carries ``link``, wire
    ``nbytes`` and a host-observed duration) or one transfer at a time
    (:meth:`add`: ``link`` in {"nvlink", "ib"}, wire ``nbytes``,
    seconds); the aggregate rate per link class is total bytes over total
    seconds in the window -- the harmonic weighting a byte-cost model
    wants, not a mean of per-transfer rates that would let tiny transfers
    dominate.
    """

    def __init__(self, window: int = 256):
        self._window = int(window)
        self._samples: Dict[str, collections.deque] = {}

    def add(self, link: str, nbytes: float, seconds: float) -> None:
        if not link or nbytes is None or seconds is None:
            return
        nbytes, seconds = float(nbytes), float(seconds)
        if nbytes <= 0 or seconds <= 0:
            return
        self._samples.setdefault(
            str(link), collections.deque(maxlen=self._window)).append(
            (nbytes, seconds))

    def ingest_spans(self, spans) -> int:
        """Fold completed :class:`~chainermn_tpu_torch.observability.spans.
        Span` objects (only ``kind == "plan_stage"`` counts; JAX's link
        names read as the card's).  Returns how many were absorbed."""
        from chainermn_tpu_torch.observability.spans import link_class

        n = 0
        for sp in spans:
            if getattr(sp, "kind", None) != "plan_stage":
                continue
            self.add(link_class(sp.meta.get("link")), sp.meta.get("nbytes"),
                     sp.dur_s)
            n += 1
        return n

    def ingest_events(self, events) -> int:
        """Fold raw flight-recorder events via the spans module's
        per-stage link-timing export."""
        from chainermn_tpu_torch.observability.spans import (
            link_class, stage_link_timings)

        timings = stage_link_timings(events)
        for link, nbytes, dur_s in timings:
            self.add(link_class(link), nbytes, dur_s)
        return len(timings)

    def n_samples(self, link: str) -> int:
        return len(self._samples.get(link, ()))

    def observed_gbps(self, min_samples: int = 1) -> Dict[str, float]:
        """Observed GB/s per link class with at least ``min_samples``
        banked spans.  Links never observed are absent — the caller
        decides whether to fall back to a static figure or leave the
        link unpriced."""
        out = {}
        for link, window in self._samples.items():
            if len(window) < max(min_samples, 1):
                continue
            total_b = sum(b for b, _ in window)
            total_s = sum(s for _, s in window)
            if total_s > 0:
                out[link] = total_b / total_s / 1e9
        return out

    def summary(self) -> dict:
        return {link: {"n": self.n_samples(link)}
                for link in sorted(self._samples)}


# ---------------------------------------------------------------------------
# span -> sweep-row synthesis
# ---------------------------------------------------------------------------

def synthesize_sweep_rows(topology: PlanTopology, dtype: str, nbytes: int,
                          link_gbps: Dict[str, float],
                          stripe_ratios: Tuple[float, ...] = STRIPE_RATIOS,
                          ) -> List[dict]:
    """Price the whole candidate zoo at ``nbytes`` under the given link
    rates and return ``allreduce_sweep/v1`` rows —
    :func:`~chainermn_tpu_torch.planner.autotune.autotune_from_rows` eats them
    unchanged, so the online loop reuses the offline selection logic
    verbatim (modeled microseconds stand in for measured ones)."""
    rows = []
    for plan in candidate_plans(topology, stripe_ratios=stripe_ratios):
        t = plan_modeled_time_s(plan, topology, int(nbytes), link_gbps,
                                dtype=dtype)
        rows.append({
            "topology": topology.key(), "dtype": str(dtype),
            "bytes": int(nbytes), "plan": plan.name, "us": t * 1e6,
            "plan_spec": plan.to_dict(),
        })
    return rows


def recommend_prefetch_depth(stall_fracs, current: int, num_buckets: int,
                             high: float = 0.15) -> int:
    """FSDP prefetch-depth recommendation from stall-bucket evidence.

    When the attribution ``stall`` bucket persistently claims more than
    ``high`` of the step (the signature of bucket ``i``'s all-gather not
    hidden behind bucket ``i-1``'s compute — the ``fsdp_overlap_*``
    dispatch-gap family tells the same story), deepen the prefetch
    window by one bucket, bounded by the bucket count.  Healthy runs
    keep their depth: shrinking a working window only saves memory and
    risks re-exposing the gather latency this knob exists to hide."""
    fracs = [float(f) for f in stall_fracs if f is not None]
    if not fracs:
        return int(current)
    fracs.sort()
    n = len(fracs)
    median = fracs[n // 2] if n % 2 else \
        0.5 * (fracs[n // 2 - 1] + fracs[n // 2])
    if median > high and current + 1 < num_buckets:
        return int(current) + 1
    return int(current)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

class OnlineTuner:
    """The attribution-closed control loop over one communicator's plan
    table.

    Drive it from ``MetricsReport`` (``MetricsReport(online_tune=True)``):
    :meth:`ingest` absorbs each newly-completed step's flight events
    (``observations.add`` and :meth:`observe_payload` feed it directly),
    :meth:`on_regression` arms a re-tune from the attribution watch's
    flagged comm buckets, and :meth:`maybe_swap` -- COLLECTIVE, called at
    the same trigger on every rank -- computes the decision on rank 0,
    broadcasts it on the object plane, and applies it everywhere on the
    same step boundary.

    ``flight`` / ``registry`` default to the process-wide flight recorder
    and (with observability on) metrics registry: the re-tune, swap and
    prefetch-recommendation events and the ``plan_table_swaps_total`` /
    ``online_retunes_total`` / ``retune_speedup`` metrics go there.

    ``fallback_gbps`` prices link classes the window has not observed
    yet (e.g. a plan with no inter-node hop never exercises ``ib``); with no
    fallback an unobserved link is left out and, per
    ``plan_modeled_time_s``, priced as free — pass the static tuning-run
    figures to avoid over-rewarding plans that shift traffic onto a
    never-measured wire.
    """

    def __init__(self, comm=None, topology: Optional[PlanTopology] = None,
                 dtype: str = "float32", table=None, flight=None,
                 registry=None, window: int = 256, min_samples: int = 2,
                 threshold: float = 1.05,
                 stripe_ratios: Tuple[float, ...] = STRIPE_RATIOS,
                 fallback_gbps: Optional[Dict[str, float]] = None,
                 joint: bool = False):
        from chainermn_tpu_torch.observability import (
            flight_recorder as _flight, registry as _registry)

        if threshold < 1.0:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.comm = comm
        if topology is None:
            if comm is None:
                raise ValueError("pass topology= when there is no comm")
            topology = comm.plan_topology()
        self.topology = topology
        self.dtype = str(dtype)
        if table is None:
            table = getattr(comm, "plan_table", None) or PlanTable()
        self.table = table if isinstance(table, PlanTable) \
            else PlanTable.from_dict(table)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.stripe_ratios = tuple(stripe_ratios)
        self.fallback_gbps = dict(fallback_gbps or {})
        #: joint mode (ROADMAP item 4): re-price the whole in-flight
        #: StepWorkload — reconstructed from registered plan slots +
        #: contention occupancy timelines — instead of this
        #: communicator's plans alone, and swap every slot atomically
        self.joint = bool(joint)
        self._timelines: Optional[dict] = None
        self.observations = LinkObservations(window=window)
        self._flight = flight if flight is not None \
            else _flight.get_flight_recorder()
        reg = registry if registry is not None else \
            (_registry.get_registry() if _registry.enabled() else None)
        self._reg = reg
        if reg is not None:
            self._swaps_total = reg.counter(
                "plan_table_swaps_total",
                "plan-table hot-swaps applied by the online tuner")
            self._retunes_total = reg.counter(
                "online_retunes_total",
                "re-tune decisions computed (swapped or not)")
            self._speedup_gauge = reg.gauge(
                "retune_speedup",
                "modeled old-plan/new-plan time ratio of the last "
                "re-tune decision")
        #: max payload wire bytes seen per size bucket — the cells the
        #: re-tune re-prices (only traffic actually observed)
        self._payload_max: Dict[str, int] = {}
        self._stall_fracs: collections.deque = collections.deque(maxlen=64)
        self._armed = False
        self._evidence: List[dict] = []
        self._pending: Optional[dict] = None
        self.swaps: List[dict] = []
        self.last_swap: Optional[dict] = None
        self.last_decision: Optional[dict] = None

    # -- observation -------------------------------------------------------
    def ingest(self, events) -> int:
        """Absorb a slice of flight-recorder events: plan-stage spans
        feed the link-rate window and mark their size bucket live."""
        from chainermn_tpu_torch.observability.spans import pair_events

        spans = pair_events(list(events))
        n = self.observations.ingest_spans(spans)
        for sp in spans:
            if sp.kind != "plan_stage":
                continue
            nb = sp.meta.get("nbytes")
            if nb:
                self.observe_payload(int(nb))
        return n

    def observe_payload(self, nbytes: int) -> None:
        """Mark the size bucket of a ``nbytes`` payload live: the re-tune
        re-prices only buckets that carried traffic, at the largest
        payload seen in each (what ``ingest`` records from a span's
        ``nbytes``)."""
        nb = int(nbytes)
        if nb:
            b = size_bucket(nb)
            self._payload_max[b] = max(self._payload_max.get(b, 0), nb)

    def observe_attribution(self, attribution: dict) -> None:
        """Bank one step's attribution (stall fraction feeds the FSDP
        prefetch recommendation)."""
        step_s = float(attribution.get("step_s") or 0.0)
        if step_s > 0:
            stall = float(attribution.get("buckets", {}).get("stall", 0.0))
            self._stall_fracs.append(stall / step_s)

    def observe_timelines(self, timelines: dict) -> None:
        """Bank the latest contention occupancy timelines
        (:func:`~chainermn_tpu_torch.observability.contention.
        occupancy_timelines` / ``occupancy_from_events`` output) — the
        evidence the joint retune uses to reconstruct WHICH registered
        plan slots are actually in flight."""
        self._timelines = timelines

    def on_regression(self, flagged: List[dict]) -> bool:
        """The AttributionWatch trigger seam: arm a re-tune when a comm
        bucket regressed.  Returns whether this call armed it."""
        comm_regs = [f for f in (flagged or [])
                     if f.get("bucket") in COMM_BUCKETS
                     + _COMM_BUCKET_ALIASES]
        if not comm_regs:
            return False
        self._evidence.extend(comm_regs)
        self._evidence = self._evidence[-16:]
        self._armed = True
        return True

    @property
    def armed(self) -> bool:
        return self._armed

    # -- decision ----------------------------------------------------------
    def retune(self, link_gbps: Optional[Dict[str, float]] = None,
               ) -> Optional[dict]:
        """Compute (but do not apply) a re-tune decision from the
        current observation window: synthesized sweep rows under the
        observed link rates, through ``autotune_from_rows``, with the
        modeled old-vs-new speedup per cell.  ``None`` when there is
        nothing to price (no observed traffic, no link rates).

        In joint mode (``joint=True``) the decision is computed over
        the whole in-flight :class:`~chainermn_tpu_torch.planner.schedule.
        StepWorkload` instead — reconstructed from the registered plan
        slots filtered by the banked contention occupancy timelines —
        and re-priced under the shared-link fair-share simulator at the
        observed (contention-derated, when fed through
        ``feed_link_observations``) rates; it falls back to the
        per-plan path when fewer than two slots are in flight."""
        gbps = dict(self.fallback_gbps)
        gbps.update(link_gbps if link_gbps is not None
                    else self.observations.observed_gbps(self.min_samples))
        if self.joint and gbps:
            decision = self._retune_joint(gbps)
            if decision is not None:
                return decision
        if not gbps or not self._payload_max:
            return None
        rows: List[dict] = []
        for _bucket, nbytes in sorted(self._payload_max.items()):
            rows.extend(synthesize_sweep_rows(
                self.topology, self.dtype, nbytes, gbps,
                stripe_ratios=self.stripe_ratios))
        new_table, comparison = autotune_from_rows(rows)
        cells = []
        best_speedup = 0.0
        for _bucket, nbytes in sorted(self._payload_max.items()):
            old_plan = self.table.lookup(self.topology, self.dtype,
                                         int(nbytes)) or flavor_plan("flat")
            new_plan = new_table.lookup(self.topology, self.dtype,
                                        int(nbytes))
            if new_plan is None:
                continue
            old_s = plan_modeled_time_s(old_plan, self.topology, int(nbytes),
                                        gbps, dtype=self.dtype)
            new_s = plan_modeled_time_s(new_plan, self.topology, int(nbytes),
                                        gbps, dtype=self.dtype)
            speedup = (old_s / new_s) if new_s > 0 else 1.0
            best_speedup = max(best_speedup, speedup)
            cells.append({
                "topology": self.topology.key(), "dtype": self.dtype,
                "bucket": size_bucket(int(nbytes)), "bytes": int(nbytes),
                "old_plan": old_plan.name, "new_plan": new_plan.name,
                "old_modeled_s": old_s, "new_modeled_s": new_s,
                "speedup": speedup,
            })
        if not cells:
            return None
        decision = {
            "schema": ONLINE_TUNE_SCHEMA,
            "kind": "plan_table_swap",
            "step": None,  # stamped when the swap lands
            "table": new_table.to_dict(),
            "table_hash": plan_table_hash(new_table),
            "observed_gbps": {k: float(v) for k, v in sorted(gbps.items())},
            "cells": cells,
            "best_speedup": best_speedup,
            "threshold": self.threshold,
            "swap": best_speedup >= self.threshold,
            "evidence": list(self._evidence),
            "comparison": comparison,
            "rows_merged": new_table.meta.get("rows_merged", 0),
        }
        self.last_decision = decision
        if self._reg is not None:
            self._retunes_total.inc(1)
            self._speedup_gauge.set(float(best_speedup))
        if self._flight is not None:
            self._flight.record(
                "plan_table_retune", best_speedup=best_speedup,
                swap=decision["swap"], n_cells=len(cells),
                table_hash=decision["table_hash"])
        return decision

    def _retune_joint(self, gbps: Dict[str, float]) -> Optional[dict]:
        """The joint decision: rebuild the in-flight workload from the
        plan-slot registry (filtered by banked occupancy timelines),
        jointly tune every slot under the shared-link simulator at the
        observed rates, and package the result so the EXISTING swap
        machinery applies it atomically — all-reduce slots ride the
        plan-table swap (rank-0 broadcast + sidecar hash untouched),
        other slots ride ``joint.slot_plans`` which
        :meth:`apply_decision` installs into the schedule registry in
        the same step-boundary apply.  ``None`` when fewer than two
        slots are in flight (the per-plan path then runs)."""
        from chainermn_tpu_torch.planner import schedule as _sched

        workload = _sched.reconstruct_workload(
            self.topology, timelines=self._timelines)
        if workload is None or len(workload.slots) < 2:
            return None
        old_s = None
        old_plans = {}
        for slot in workload.slots:
            if slot.op == "all-reduce":
                old_plans[slot.name] = (
                    self.table.lookup(self.topology, slot.dtype,
                                      slot.nbytes) or flavor_plan("flat"))
            else:
                old_plans[slot.name] = _sched.get_slot_plan(slot.name)
        if all(p is not None for p in old_plans.values()):
            old_s = _sched.workload_modeled_time_s(
                workload.with_plans(old_plans), gbps)
        jtable, cmp = _sched.jointly_tune(
            workload, link_gbps=gbps, stripe_ratios=self.stripe_ratios)
        sig = cmp["signature"]
        tagged = jtable.entries[sig]
        new_table = PlanTable(meta=dict(self.table.meta,
                                        joint_signature=sig))
        new_table.entries.update(self.table.entries)
        slot_plans = {}
        for slot in workload.slots:
            plan = tagged[slot.name]
            if slot.op == "all-reduce":
                new_table.put(self.topology, slot.dtype,
                              size_bucket(slot.nbytes), plan)
            else:
                slot_plans[slot.name] = plan.to_dict()
        joint_s = cmp["joint"]["modeled_s"]
        # the swap criterion: modeled win of the joint pick over the
        # CURRENTLY-INSTALLED plans when all are known, else over the
        # independently-tuned baseline
        base_s = old_s if old_s is not None \
            else cmp["independent"]["modeled_s"]
        best_speedup = (base_s / joint_s) if joint_s > 0 else 1.0
        cells = [{
            "topology": self.topology.key(), "dtype": row["dtype"],
            "slot": row["slot"], "bucket": size_bucket(int(row["nbytes"])),
            "bytes": int(row["nbytes"]),
            "old_plan": getattr(old_plans.get(row["slot"]), "name", None),
            "independent_plan": row["independent_plan"],
            "new_plan": row["joint_plan"], "changed": row["changed"],
        } for row in cmp["slots"]]
        decision = {
            "schema": ONLINE_TUNE_SCHEMA,
            "kind": "plan_table_swap",
            "mode": "joint",
            "step": None,
            "table": new_table.to_dict(),
            "table_hash": plan_table_hash(new_table),
            "observed_gbps": {k: float(v) for k, v in sorted(gbps.items())},
            "cells": cells,
            "best_speedup": best_speedup,
            "threshold": self.threshold,
            "swap": best_speedup >= self.threshold,
            "evidence": list(self._evidence),
            "joint": {
                "signature": sig,
                "slot_plans": slot_plans,
                "speedup_vs_independent": cmp["speedup"],
                "changed_slots": cmp["changed_slots"],
                "comparison": cmp,
            },
        }
        self.last_decision = decision
        if self._reg is not None:
            self._retunes_total.inc(1)
            self._speedup_gauge.set(float(best_speedup))
        if self._flight is not None:
            self._flight.record(
                "plan_table_retune", best_speedup=best_speedup,
                swap=decision["swap"], n_cells=len(cells),
                table_hash=decision["table_hash"], mode="joint",
                workload_signature=sig)
        return decision

    # -- the step-boundary hot-swap ---------------------------------------
    def maybe_swap(self, step: int) -> Optional[dict]:
        """COLLECTIVE on a world of several ranks: every rank calls this at
        the same trigger (drive it from a trainer trigger).  Rank 0
        computes the pending decision; the object-plane broadcast puts the
        SAME decision (or ``None``) on every rank, so all of them flip --
        or none -- on this exact step boundary."""
        rank = getattr(self.comm, "rank", 0) if self.comm is not None else 0
        multi = self.comm is not None and getattr(self.comm, "size", 1) > 1
        decision = None
        if rank == 0:
            if self._pending is None and self._armed:
                self._pending = self.retune()
            decision = self._pending
            if decision is not None and not decision.get("swap"):
                decision = None  # below threshold: keep the table
        if multi:
            decision = self.comm.bcast_obj(decision, root=0)
        self._pending = None
        self._armed = False
        if decision is None:
            return None
        return self.apply_decision(decision, step)

    def apply_decision(self, decision: dict, step: int) -> dict:
        """Install the decision's table on this rank: swap the
        communicator's table (its next ``allreduce_grad`` selects from
        it), publish the active-table pin for the checkpoint sidecar, and
        install a joint decision's slot plans."""
        new_table = PlanTable.from_dict(decision["table"])
        decision = dict(decision, step=int(step))
        if self.comm is not None and hasattr(self.comm, "swap_plan_table"):
            self.comm.swap_plan_table(new_table)
        self.table = new_table
        set_active_plan_table(new_table, step=int(step),
                              evidence=decision.get("evidence"))
        joint = decision.get("joint")
        if joint:
            # the atomic multi-slot half of a joint swap: non-table
            # slots (e.g. the MoE exchange) flip via the schedule
            # registry in the SAME apply — every rank runs this
            # with the same broadcast decision, so all slots of all
            # ranks land on this step boundary together
            from chainermn_tpu_torch.planner import schedule as _sched
            for slot_name, spec in sorted(
                    joint.get("slot_plans", {}).items()):
                _sched.set_slot_plan(slot_name, Plan.from_dict(spec))
            if self._flight is not None:
                self._flight.record(
                    "workload_swap", step=int(step),
                    workload_signature=joint.get("signature"),
                    changed_slots=joint.get("changed_slots"),
                    slots=sorted(joint.get("slot_plans", {})))
        if self._flight is not None:
            self._flight.record(
                "plan_table_swap", step=int(step),
                table_hash=decision["table_hash"],
                best_speedup=decision.get("best_speedup"),
                n_cells=len(decision.get("cells", ())),
                evidence=decision.get("evidence"))
        if self._reg is not None:
            self._swaps_total.inc(1)
        self.last_swap = decision
        self.swaps.append(decision)
        return decision

    # -- the non-collective knob ------------------------------------------
    def recommend_prefetch(self, current: int, num_buckets: int,
                           high: float = 0.15) -> int:
        """Advisory FSDP prefetch-depth re-tune from the banked stall
        fractions; a changed recommendation is surfaced as an
        ``fsdp_prefetch_recommendation`` flight event (the bucketed
        schedule is compiled in — apply it at the next ``fsdp_init``)."""
        rec = recommend_prefetch_depth(self._stall_fracs, current,
                                       num_buckets, high=high)
        if rec != current and self._flight is not None:
            fracs = list(self._stall_fracs)
            self._flight.record(
                "fsdp_prefetch_recommendation", current=int(current),
                recommended=int(rec),
                stall_frac=sum(fracs) / len(fracs) if fracs else 0.0)
        return rec

    # -- reporting ---------------------------------------------------------
    def state(self) -> dict:
        """The ``plan_table_state`` record the metrics JSONL carries and
        ``obs_report --attribution`` renders: current tuned plan per
        cell, last swap, trigger evidence, observed link rates."""
        cells = [{"topology": t, "dtype": d, "bucket": b,
                  "plan": plan.name,
                  "striped": len(plan.stage_groups()) > 1}
                 for (t, d, b), plan in sorted(self.table.entries.items())]
        last = self.last_swap
        return {
            "kind": "plan_table_state",
            "table_hash": plan_table_hash(self.table),
            "cells": cells,
            "last_swap_step": last.get("step") if last else None,
            "last_swap_speedup": last.get("best_speedup") if last else None,
            "evidence": (last or {}).get("evidence") or
            list(self._evidence),
            "observed_gbps": self.observations.observed_gbps(
                self.min_samples),
            "observations": self.observations.summary(),
            "armed": self._armed,
        }


__all__ = [
    "COMM_BUCKETS",
    "LinkObservations",
    "ONLINE_TUNE_SCHEMA",
    "OnlineTuner",
    "active_plan_table_meta",
    "clear_active_plan_table",
    "get_active_plan_table",
    "plan_table_hash",
    "recommend_prefetch_depth",
    "set_active_plan_table",
    "synthesize_sweep_rows",
]
