"""Plan autotuner: per-(topology, dtype, message-size bucket) plan
selection from ``bench_allreduce --sweep`` rows, kept as a plan table.

Counterpart of ``chainermn_tpu/planner/autotune.py`` (same buckets, same
lookup fallback, same table dict).  Workflow:

1. ``python -m chainermn_tpu_torch.benchmarks.bench_allreduce --sweep
   sweep.json`` times every candidate plan
   (``planner.plans.candidate_plans``) across a message-size ladder on the
   card and writes ``allreduce_sweep/v1`` rows ``{"topology", "dtype",
   "bytes", "plan", "us", "plan_spec"}``.
2. :func:`autotune_from_rows` picks the fastest plan per (topology, dtype,
   size bucket) cell and returns the :class:`PlanTable` plus the
   tuned-vs-best-fixed comparison rows.
3. ``PlanTable.save`` writes the table;
   ``create_communicator("auto", plan_table=...)`` loads it and routes
   each ``allreduce_grad`` through the plan for its packed byte size.

The table is keyed by bucket, not exact size, so one tuning run
generalizes: message sizes within a bucket share a bandwidth regime
(power-of-16 edges, the ladder the sweep samples).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from chainermn_tpu_torch.planner.ir import Plan, PlanTopology
from chainermn_tpu_torch.planner.plans import flavor_plan

SWEEP_SCHEMA = "allreduce_sweep/v1"
PLAN_TABLE_SCHEMA = "plan_table/v1"

#: size-bucket upper edges in bytes (power-of-16 ladder; last is open)
BUCKET_EDGES = (4 << 10, 64 << 10, 1 << 20, 16 << 20, 256 << 20)


def size_bucket(nbytes: int) -> str:
    """Bucket label for a payload size, e.g. ``"<=64KiB"`` / ``">256MiB"``."""
    for edge in BUCKET_EDGES:
        if nbytes <= edge:
            if edge >= 1 << 20:
                return f"<={edge >> 20}MiB"
            return f"<={edge >> 10}KiB"
    return f">{BUCKET_EDGES[-1] >> 20}MiB"


@dataclass
class PlanTable:
    """On-disk map (topology key, dtype, size bucket) -> :class:`Plan`.

    ``entries`` keys are the 3-tuples; :meth:`lookup` resolves a live
    (topology, dtype, nbytes) query with fallback order exact-cell ->
    any-bucket-same-topology-and-dtype (nearest bucket) -> miss (None;
    the auto communicator then uses its default plan).
    """

    entries: Dict[Tuple[str, str, str], Plan] = field(default_factory=dict)
    #: provenance rows from the tuning run (kept in the artifact so a
    #: reviewer can see what each cell won against)
    meta: dict = field(default_factory=dict)

    def put(self, topology: PlanTopology, dtype: str, bucket: str,
            plan: Plan) -> None:
        self.entries[(topology.key(), str(dtype), bucket)] = plan

    def lookup(self, topology: PlanTopology, dtype: str,
               nbytes: int) -> Optional[Plan]:
        tkey = topology.key()
        dtype = str(dtype)
        exact = self.entries.get((tkey, dtype, size_bucket(nbytes)))
        if exact is not None:
            return exact
        # nearest bucket for the same (topology, dtype): tuning runs may
        # not have swept every rung of the ladder.  Equidistant neighbors
        # break toward the SMALLER bucket — a plan tuned on a smaller
        # payload degrades more gracefully when extrapolated up than a
        # large-payload pick (e.g. a striped split whose slices round to
        # nothing) does when extrapolated down — and the deterministic
        # tie keeps table lookups reproducible across dict orderings.
        ladder = [size_bucket(e) for e in BUCKET_EDGES] + [
            size_bucket(BUCKET_EDGES[-1] + 1)]
        want = ladder.index(size_bucket(nbytes))
        best = None
        best_key = None
        for (t, d, b), plan in self.entries.items():
            if t != tkey or d != dtype or b not in ladder:
                continue
            idx = ladder.index(b)
            key = (abs(idx - want), 0 if idx < want else 1, idx)
            if best_key is None or key < best_key:
                best, best_key = plan, key
        return best

    def to_dict(self) -> dict:
        return {
            "schema": PLAN_TABLE_SCHEMA,
            "meta": self.meta,
            "entries": [
                {"topology": t, "dtype": d, "bucket": b,
                 "plan": plan.to_dict()}
                for (t, d, b), plan in sorted(self.entries.items())],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PlanTable":
        schema = d.get("schema", PLAN_TABLE_SCHEMA)
        if schema != PLAN_TABLE_SCHEMA:
            raise ValueError(
                f"unsupported plan-table schema {schema!r} "
                f"(this build reads {PLAN_TABLE_SCHEMA!r})")
        table = cls(meta=dict(d.get("meta", {})))
        for e in d.get("entries", []):
            table.entries[(e["topology"], e["dtype"], e["bucket"])] = \
                Plan.from_dict(e["plan"])
        return table

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "PlanTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def validate_sweep_rows(rows: List[dict]) -> None:
    for i, r in enumerate(rows):
        for k in ("topology", "dtype", "bytes", "plan", "us"):
            if k not in r:
                raise ValueError(
                    f"sweep row {i} missing {k!r} (schema "
                    f"{SWEEP_SCHEMA}): {r}")


#: plan names that are fixed communicator flavors (the baseline the
#: tuned table must beat); everything else in a sweep is a candidate
#: only the planner can express
FIXED_PLAN_NAMES = ("naive", "flat", "hierarchical", "two_dimensional",
                    "single_node", "non_cuda_aware", "xla")


def autotune_from_rows(rows: List[dict]):
    """Select the fastest plan per (topology, dtype, bucket) cell.

    Returns ``(table, comparison)`` where ``comparison`` has one row per
    cell::

        {"topology", "dtype", "bucket", "tuned_plan", "tuned_us",
         "best_fixed_plan", "best_fixed_us", "speedup",
         "tuned_striped", "best_single_plan", "best_single_us",
         "striped_speedup"}

    ``speedup > 1`` means the tuned pick beats the best fixed flavor in
    that cell.  The striped lane compares against the best SINGLE-path
    plan (fixed flavors AND single-chain candidates): when the cell's
    winner is a striped plan, ``striped_speedup = best_single_us /
    tuned_us``.  Within a cell a plan's
    time is the MEAN over the sweep's sizes in that bucket, so a plan
    must win across the bucket, not on one lucky rung.

    Colliding rows — two sweeps (e.g. concatenated sweep files, or an
    online re-tune folded over an offline table) timing the SAME
    (topology, dtype, bytes, plan) rung — are mean-merged first, so a
    duplicated rung cannot double-weight the bucket mean; the collision
    count is surfaced as ``rows_merged`` in the table artifact's
    ``meta`` (0 for a clean single sweep).
    """
    validate_sweep_rows(rows)
    # dedup pass: (cell, plan, bytes) -> [(us, plan_spec)]; a rung timed
    # more than once collapses to its mean before the bucket mean
    rungs: Dict[tuple, List[tuple]] = {}
    for r in rows:
        cell = (r["topology"], str(r["dtype"]), size_bucket(int(r["bytes"])))
        rungs.setdefault((cell, r["plan"], int(r["bytes"])), []).append(
            (float(r["us"]), r.get("plan_spec")))
    rows_merged = sum(len(samples) - 1 for samples in rungs.values())
    # cell -> plan name -> [(us, plan_spec)] with one sample per rung
    cells: Dict[tuple, Dict[str, List[tuple]]] = {}
    for (cell, plan_name, _nbytes), samples in rungs.items():
        us = sum(u for u, _ in samples) / len(samples)
        spec = next((s for _, s in samples if s is not None), None)
        cells.setdefault(cell, {}).setdefault(plan_name, []).append(
            (us, spec))
    table = PlanTable(meta={"schema_in": SWEEP_SCHEMA, "rows": len(rows),
                            "rows_merged": rows_merged})
    comparison: List[dict] = []
    for cell, by_plan in sorted(cells.items()):
        tkey, dtype, bucket = cell
        means = {name: sum(u for u, _ in samples) / len(samples)
                 for name, samples in by_plan.items()}

        def _is_striped(name: str) -> bool:
            spec = next((s for _, s in by_plan[name] if s is not None),
                        None)
            return bool(spec and spec.get("groups"))

        tuned_name = min(means, key=lambda n: means[n])
        fixed = {n: u for n, u in means.items() if n in FIXED_PLAN_NAMES}
        best_fixed = min(fixed, key=lambda n: fixed[n]) if fixed else None
        single = {n: u for n, u in means.items() if not _is_striped(n)}
        best_single = (min(single, key=lambda n: single[n])
                       if single else None)
        tuned_striped = _is_striped(tuned_name)
        spec = next((s for _, s in by_plan[tuned_name] if s is not None),
                    None)
        plan = (Plan.from_dict(spec) if spec is not None
                else flavor_plan(tuned_name))
        topology = PlanTopology.from_key(tkey)
        table.put(topology, dtype, bucket, plan)
        comparison.append({
            "topology": tkey, "dtype": dtype, "bucket": bucket,
            "tuned_plan": tuned_name, "tuned_us": means[tuned_name],
            "best_fixed_plan": best_fixed,
            "best_fixed_us": fixed.get(best_fixed) if best_fixed else None,
            "speedup": (fixed[best_fixed] / means[tuned_name])
            if best_fixed else None,
            "tuned_striped": tuned_striped,
            "best_single_plan": best_single,
            "best_single_us": single.get(best_single)
            if best_single else None,
            "striped_speedup": (single[best_single] / means[tuned_name])
            if (tuned_striped and best_single) else None,
        })
    return table, comparison


__all__ = ["BUCKET_EDGES", "FIXED_PLAN_NAMES", "PLAN_TABLE_SCHEMA",
           "PlanTable", "SWEEP_SCHEMA", "autotune_from_rows",
           "size_bucket", "validate_sweep_rows"]
