"""Differential attribution — localize a cross-run regression.

Counterpart of ``chainermn_tpu/observability/diffing.py``: the same run
profiles and ``run_diff/v1`` document.  Link classes are the card's
(``"nvlink"`` / ``"ib"``; JAX's ``"ici"`` / ``"dcn"`` in a dump the JAX
package wrote read as those, in the occupancy rows, the stage keys and
the evidence), the attribution buckets keep JAX's names.

Two runs of the same program rarely disagree everywhere at once: a
slower inter-node link slows exactly the ``dcn_comm`` bucket, a
straggling input pipeline grows exactly ``host_input``.  This module
turns two runs' flight-recorder windows into comparable **run profiles**
and diffs them along every axis the within-run stack already measures:

* attribution-bucket seconds (:func:`~.attribution.classify_span` over
  the paired spans; the exact six-bucket ``attribute_step``
  decomposition when the window carries ``step`` events);
* per-``(link, owner)`` occupancy
  (:func:`~.contention.occupancy_from_events`);
* per-plan-stage span timings — count, mean, effective GB/s per
  ``(plan, stage, op, scope, link)``;
* :class:`~.registry.StreamingHistogram` states — the fixed log grid
  is shared by construction, so cross-run quantile deltas are computed
  on the merged counts EXACTLY, not re-estimated from summaries.

:func:`diff_profiles` emits a ``run_diff/v1`` document whose
``regression`` block names the regressed bucket with magnitude
(``delta_s`` / ``ratio``), a confidence (the share of the total
positive drift that bucket explains), and corroborating link / stage
evidence.  Replaying ``tests/data/degraded_dcn_spans.json`` against
its healthy twin names ``dcn_comm``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from chainermn_tpu_torch.observability import contention
from chainermn_tpu_torch.observability.attribution import (
    BUCKETS, _merge, _total, attribute_step, classify_span)
from chainermn_tpu_torch.observability.ledger import stamp_envelope
from chainermn_tpu_torch.observability.spans import (
    build_step_trees, link_class, pair_events)

SCHEMA = "run_diff/v1"

#: link class -> the attribution bucket its spans land in (evidence
#: cross-referencing only; classification itself is classify_span's)
_LINK_BUCKET = {"nvlink": "ici_comm", "ib": "dcn_comm"}

#: a bucket must drift by at least this much to be called a regression
MIN_ABS_S = 1e-4
#: ... and by at least this relative factor over the baseline
MIN_REL = 0.10


# ---------------------------------------------------------------------------
# run profiles
# ---------------------------------------------------------------------------

def _events_by_rank(events) -> Dict[int, List[dict]]:
    if isinstance(events, dict):
        return {int(r): list(e) for r, e in events.items()}
    return {0: list(events or [])}


def _stage_key(span) -> Optional[str]:
    if span.kind != "plan_stage":
        return None
    m = span.meta
    grp = m.get("group")
    return (f"{m.get('plan', '?')}:"
            f"{'g%s:' % grp if grp is not None else ''}"
            f"{m.get('stage', '?')}:{m.get('op', '?')}:"
            f"{m.get('scope', '?')}:{link_class(m.get('link', '?'))}")


def run_profile(events, label: str = "",
                histograms: Optional[dict] = None) -> dict:
    """A comparable profile of one run's flight-recorder window.

    ``events`` is a flat event list or ``{rank: events}``;
    ``histograms`` optionally carries streaming-histogram grid docs in
    the ``TelemetryAggregator.local_summary`` shape (``{name: {lo, hi,
    buckets_per_decade, series: [{labels, state}]}}``) for exact
    cross-run quantile diffs.

    Bucket seconds come from the exact :func:`attribute_step`
    decomposition when the window has ``step`` events; a step-less
    window (a raw span dump, e.g. the online-tune replay inputs) falls
    back to merged classified span intervals per bucket — ``compute``
    and ``stall`` are then structurally zero and the profile says so
    (``bucket_source: "spans"``)."""
    by_rank = _events_by_rank(events)
    buckets = {b: 0.0 for b in BUCKETS}
    bucket_source = "spans"
    steps_n, steps_total = 0, 0.0
    occupancy: Dict[str, Dict[str, float]] = {}
    stages: Dict[str, dict] = {}
    n_events = 0
    for rank, evs in sorted(by_rank.items()):
        n_events += len(evs)
        trees = build_step_trees(evs, rank=rank)
        if trees:
            bucket_source = "steps"
            for step in trees:
                att = attribute_step(step)
                steps_n += 1
                steps_total += att["step_s"]
                for b, v in att["buckets"].items():
                    buckets[b] = buckets.get(b, 0.0) + float(v)
        spans = pair_events(evs, rank=rank)
        if not trees:
            per_bucket: Dict[str, list] = {}
            for sp in contention.leaf_comm_spans(spans):
                b = classify_span(sp)
                if b is not None:
                    per_bucket.setdefault(b, []).append((sp.t0, sp.t1))
            for sp in spans:
                b = classify_span(sp)
                if b in ("checkpoint", "host_input"):
                    per_bucket.setdefault(b, []).append((sp.t0, sp.t1))
            for b, ivs in per_bucket.items():
                buckets[b] = buckets.get(b, 0.0) + _total(_merge(ivs))
        for link, owners in contention.occupancy_from_events(
                evs, rank=rank).items():
            row = occupancy.setdefault(link, {})
            for owner, ivs in owners.items():
                row[owner] = row.get(owner, 0.0) + _total(ivs)
        for sp in spans:
            key = _stage_key(sp)
            if key is None:
                continue
            cell = stages.setdefault(key, {
                "link": link_class(sp.meta.get("link")), "n": 0,
                "total_s": 0.0, "bytes": 0})
            cell["n"] += 1
            cell["total_s"] += sp.dur_s
            cell["bytes"] += int(sp.meta.get("nbytes") or 0)
    for cell in stages.values():
        cell["mean_s"] = cell["total_s"] / cell["n"] if cell["n"] else 0.0
        cell["gbps"] = (cell["bytes"] / cell["total_s"] / 1e9
                        if cell["total_s"] > 0 else None)
    return {
        "label": label,
        "n_ranks": len(by_rank),
        "n_events": n_events,
        "bucket_source": bucket_source,
        "buckets_s": buckets,
        "steps": {"n": steps_n, "total_s": steps_total,
                  "mean_s": steps_total / steps_n if steps_n else None},
        "occupancy": occupancy,
        "stages": stages,
        "histograms": histograms or {},
    }


def load_run(path_or_doc, label: str = "") -> dict:
    """A run profile from a flight dump path/document (``{"events":
    [...]}``, a bare event list, or ``{rank: events}``)."""
    doc = path_or_doc
    if isinstance(doc, str):
        label = label or doc
        with open(doc) as fh:
            doc = json.load(fh)
    if isinstance(doc, dict) and "events" in doc:
        events = doc["events"]
    else:
        events = doc
    hists = doc.get("histograms") if isinstance(doc, dict) else None
    return run_profile(events, label=label, histograms=hists)


# ---------------------------------------------------------------------------
# histogram state diffing (exact on the shared grid)
# ---------------------------------------------------------------------------

def _fold_states(grid: dict) -> Optional[list]:
    """Elementwise-sum the counts of every labelled series on one
    histogram grid doc; ``None`` when empty."""
    counts: Optional[list] = None
    for series in grid.get("series", []):
        st = series.get("state", {})
        cs = st.get("counts")
        if cs is None:
            continue
        if counts is None:
            counts = [0] * len(cs)
        if len(cs) != len(counts):
            return None
        counts = [a + b for a, b in zip(counts, cs)]
    return counts


def diff_histograms(a: dict, b: dict,
                    quantiles: Sequence[float] = (0.5, 0.95, 0.99)
                    ) -> Dict[str, dict]:
    """Per-metric quantile deltas between two runs' streaming-histogram
    states.  Both runs' grids must agree (same ``lo``/``hi``/
    ``buckets_per_decade`` — they do by construction, the grid is fixed
    at metric definition); a mismatch is reported as such instead of a
    wrong delta, because counts from different grids do not merge."""
    from chainermn_tpu_torch.observability.registry import \
        StreamingHistogram
    out: Dict[str, dict] = {}
    for name in sorted(set(a) & set(b)):
        ga, gb = a[name], b[name]
        grid_keys = ("lo", "hi", "buckets_per_decade")
        if any(ga.get(k) != gb.get(k) for k in grid_keys):
            out[name] = {"grid_mismatch": True,
                         "a_grid": {k: ga.get(k) for k in grid_keys},
                         "b_grid": {k: gb.get(k) for k in grid_keys}}
            continue
        ca, cb = _fold_states(ga), _fold_states(gb)
        if ca is None or cb is None:
            continue
        hist = StreamingHistogram(
            name, lo=ga["lo"], hi=ga["hi"],
            buckets_per_decade=ga["buckets_per_decade"])
        row = {}
        for q in quantiles:
            qa = hist._quantile_from_counts(ca, q)
            qb = hist._quantile_from_counts(cb, q)
            row[f"p{int(q * 100)}"] = {
                "a": qa, "b": qb,
                "delta": (qb - qa) if qa is not None and qb is not None
                else None}
        out[name] = row
    return out


# ---------------------------------------------------------------------------
# the diff
# ---------------------------------------------------------------------------

def _ratio(a: float, b: float) -> Optional[float]:
    if a > 0:
        return b / a
    return None if b == 0 else float("inf")


def diff_profiles(base: dict, cand: dict, *,
                  min_abs_s: float = MIN_ABS_S,
                  min_rel: float = MIN_REL) -> dict:
    """``run_diff/v1``: candidate run vs baseline run.

    The ``regression`` block names the attribution bucket with the
    largest positive drift, provided it clears both the absolute
    (``min_abs_s``) and relative (``min_rel``) floors; ``confidence``
    is the share of all positive bucket drift that bucket explains
    (1.0 = the whole slowdown is in one bucket).  ``evidence`` carries
    the per-link occupancy drift and the worst-moved plan stage on the
    bucket's link class — the "which wire, which hop" pointer."""
    bucket_rows = []
    for b in BUCKETS:
        a_s = float(base["buckets_s"].get(b, 0.0))
        c_s = float(cand["buckets_s"].get(b, 0.0))
        bucket_rows.append({"bucket": b, "base_s": a_s, "cand_s": c_s,
                            "delta_s": c_s - a_s,
                            "ratio": _ratio(a_s, c_s)})

    # per-(link, owner) occupancy drift
    occ_rows = []
    links = set(base["occupancy"]) | set(cand["occupancy"])
    for link in sorted(links):
        oa = base["occupancy"].get(link, {})
        ob = cand["occupancy"].get(link, {})
        for owner in sorted(set(oa) | set(ob)):
            a_s, c_s = oa.get(owner, 0.0), ob.get(owner, 0.0)
            occ_rows.append({"link": link, "owner": owner,
                             "base_s": a_s, "cand_s": c_s,
                             "delta_s": c_s - a_s,
                             "ratio": _ratio(a_s, c_s)})

    # per-stage timing drift
    stage_rows = []
    for key in sorted(set(base["stages"]) | set(cand["stages"])):
        sa = base["stages"].get(key)
        sb = cand["stages"].get(key)
        row = {"stage": key,
               "link": (sb or sa or {}).get("link"),
               "base_mean_s": sa["mean_s"] if sa else None,
               "cand_mean_s": sb["mean_s"] if sb else None,
               "base_gbps": sa["gbps"] if sa else None,
               "cand_gbps": sb["gbps"] if sb else None}
        if sa and sb:
            row["mean_ratio"] = _ratio(sa["mean_s"], sb["mean_s"])
        stage_rows.append(row)

    # localization
    positive = [r for r in bucket_rows if r["delta_s"] > 0.0]
    total_pos = sum(r["delta_s"] for r in positive)
    regression = None
    if positive:
        top = max(positive, key=lambda r: r["delta_s"])
        rel_ok = top["base_s"] == 0.0 or (
            top["ratio"] is not None
            and top["ratio"] >= 1.0 + min_rel)
        if top["delta_s"] >= min_abs_s and rel_ok:
            link = next((lk for lk, bk in _LINK_BUCKET.items()
                         if bk == top["bucket"]), None)
            link_rows = [r for r in occ_rows if r["link"] == link]
            worst_owner = max(link_rows, key=lambda r: r["delta_s"]) \
                if link_rows else None
            cand_stages = [
                r for r in stage_rows
                if r.get("link") == link
                and r.get("mean_ratio") is not None] if link else []
            worst_stage = max(cand_stages,
                              key=lambda r: r["mean_ratio"]) \
                if cand_stages else None
            regression = {
                "bucket": top["bucket"],
                "base_s": top["base_s"],
                "cand_s": top["cand_s"],
                "delta_s": top["delta_s"],
                "ratio": top["ratio"],
                "confidence": (top["delta_s"] / total_pos
                               if total_pos > 0 else 1.0),
                "evidence": {
                    "link": link,
                    "occupancy": worst_owner,
                    "stage": worst_stage,
                },
            }

    doc = {
        "schema": SCHEMA,
        "schema_version": 1,
        "baseline": {k: base[k] for k in
                     ("label", "n_ranks", "n_events", "bucket_source",
                      "steps")},
        "candidate": {k: cand[k] for k in
                      ("label", "n_ranks", "n_events", "bucket_source",
                       "steps")},
        "buckets": bucket_rows,
        "occupancy": occ_rows,
        "stages": stage_rows,
        "histograms": diff_histograms(base.get("histograms") or {},
                                      cand.get("histograms") or {}),
        "regression": regression,
        "regressed": regression is not None,
    }
    return stamp_envelope(doc)


def diff_runs(base, cand, *, label_a: str = "baseline",
              label_b: str = "candidate", **kw) -> dict:
    """``diff_profiles`` over two flight dumps (paths, documents, or
    event lists)."""
    return diff_profiles(load_run(base, label=label_a),
                         load_run(cand, label=label_b), **kw)


def diff_manifests(a: dict, b: dict) -> dict:
    """Metric deltas between two ledger ``run_manifest/v1`` records —
    the shallow (summary-level) cousin of :func:`diff_profiles` for
    artifacts that carry headline metrics but no spans."""
    ma, mb = a.get("metrics", {}), b.get("metrics", {})
    rows = []
    for metric in sorted(set(ma) | set(mb)):
        va, vb = ma.get(metric), mb.get(metric)
        rows.append({
            "metric": metric, "base": va, "cand": vb,
            "delta": (vb - va) if va is not None and vb is not None
            else None,
            "ratio": _ratio(va, vb)
            if va is not None and vb is not None else None})
    doc = {
        "schema": SCHEMA,
        "schema_version": 1,
        "baseline": {"artifact": a.get("artifact"),
                     "round": a.get("round"),
                     "device_kind": a.get("device_kind")},
        "candidate": {"artifact": b.get("artifact"),
                      "round": b.get("round"),
                      "device_kind": b.get("device_kind")},
        "metrics": rows,
        "regression": None,
        "regressed": False,
    }
    return stamp_envelope(doc)


__all__ = [
    "MIN_ABS_S",
    "MIN_REL",
    "SCHEMA",
    "diff_histograms",
    "diff_manifests",
    "diff_profiles",
    "diff_runs",
    "load_run",
    "run_profile",
]
