"""Streaming fleet telemetry — per-step rank summaries gathered to
rank 0.

Counterpart of ``chainermn_tpu/observability/streaming.py``: the same
summaries and ``fleet_telemetry/v1`` document, link classes the card's
(``"nvlink"`` / ``"ib"``).

Each rank cuts a **compact** summary of its flight-recorder window every
N steps — per-(link, owner) occupancy from :func:`~.contention.
occupancy_from_events`, step durations, dropped-event counts, and the
shippable states of its serving latency streaming histograms — and
ships it to rank 0: on the control plane's reserved telemetry tag
(:data:`~chainermn_tpu_torch.runtime.control_plane.TELEMETRY_TAG`) when
the communicator has a socket control plane, else on its own
``gather_obj`` (the gloo object plane, which matches messages by call
order).  Rank 0 folds the summaries into one ``fleet_telemetry/v1``
document:

* fleet occupancy + a live overlap matrix per link class,
* straggler flags (a rank whose mean step time exceeds the fleet
  median by the straggler factor),
* fleet-merged serving latency distributions with p50/p95/p99 — the
  SLO percentile gauges, published back into the registry as
  ``fleet_<metric>`` gauges labelled by quantile.

Zero-cost-when-disabled contract: construct the aggregator only when
:func:`~chainermn_tpu_torch.observability.enabled` is on
(``MetricsReport`` does exactly that).  A constructed-but-never-collected
aggregator sends nothing; a disabled run never constructs one.

Timebase caveat: the live view merges per-rank wall-clock intervals
WITHOUT the clock handshake (that would cost a collective per window).
Same-host ranks share a wall clock so the live overlap matrix is
exact there; across hosts it is approximate, and the post-hoc
:func:`~.contention.contention_report` (clock-corrected) is the
authoritative cut.  Interval lists are additionally capped at
``max_intervals`` per (link, owner) per window; a capped row ships
``truncated``/``dropped_s`` and the fleet document lists the affected
``(link, owner)`` pairs under ``truncated`` — union ``busy_s`` and the
live matrix are lower bounds for those (per-rank ``by_rank`` busy
stays exact: it is computed before the cap).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from chainermn_tpu_torch.observability import contention
from chainermn_tpu_torch.observability.attribution import _merge, _total
from chainermn_tpu_torch.observability.flight_recorder import \
    get_flight_recorder
from chainermn_tpu_torch.observability.registry import (
    StreamingHistogram, get_registry)

SCHEMA = "fleet_telemetry/v1"

#: serving latency streaming histograms shipped by default (the SLO set)
DEFAULT_HISTOGRAMS = (
    "serving_ttft_seconds",
    "serving_token_seconds",
    "serving_step_seconds",
)

_SLO_QUANTILES = (0.5, 0.95, 0.99)


def _plane_of(comm):
    """The socket control plane under a communicator (also looks through
    the instrumented wrapper); ``None`` when the comm has none (its
    object ops then ride the gloo plane)."""
    for c in (comm, getattr(comm, "_comm", None)):
        cp = getattr(c, "_cp", None)
        if cp is not None:
            return cp
    return None


class TelemetryAggregator:
    """Per-rank summary builder + rank-0 fleet folder.

    ``collect(step)`` is a COLLECTIVE over the object plane — every
    rank must call it on the same steps (``MetricsReport`` triggers it
    on its emit interval, which is trigger-synchronized by
    construction).  Returns the fleet document on rank 0, ``None``
    elsewhere.
    """

    def __init__(self, comm, max_intervals: int = 32,
                 straggler_factor: float = 1.2,
                 histograms=DEFAULT_HISTOGRAMS):
        self._comm = comm
        self._plane = _plane_of(comm)
        self._fr = get_flight_recorder()
        self._reg = get_registry()
        self._max_intervals = int(max_intervals)
        self._straggler_factor = float(straggler_factor)
        self._hist_names = tuple(histograms)
        # flight-recorder cursor: each window ships once.  events_since
        # is strictly-greater, and the first recorded event has seq 0,
        # so the cursor must start BELOW it.
        self._seq = -1
        self._dropped_last = 0
        self.rank = getattr(comm, "rank", 0)
        self.size = getattr(comm, "size", 1)

    # ---- per-rank summary --------------------------------------------------

    def _window_events(self) -> List[dict]:
        if self._fr is None:
            return []
        events = self._fr.events_since(self._seq)
        if events:
            self._seq = max(int(e.get("seq", 0)) for e in events)
        return events

    def local_summary(self, step: int) -> dict:
        """The compact summary this rank ships: occupancy per (link,
        owner) with capped interval lists, step durations in the
        window, dropped-event delta, and serving histogram states.

        When a (link, owner) timeline exceeds ``max_intervals`` only
        the newest intervals ship; the row then carries ``truncated``
        and ``dropped_s`` (busy seconds of the intervals cut) so the
        fleet fold can mark its live matrix a lower bound instead of
        silently undercounting — ``busy_s`` itself is always the full
        uncapped window total."""
        events = self._window_events()
        occ = contention.occupancy_from_events(events, rank=self.rank)
        occ_doc: Dict[str, dict] = {}
        for link in sorted(occ):
            occ_doc[link] = {}
            for owner in sorted(occ[link]):
                ivs = occ[link][owner]
                dropped = ivs[:-self._max_intervals] \
                    if len(ivs) > self._max_intervals else []
                occ_doc[link][owner] = {
                    "busy_s": _total(ivs),
                    "n_intervals": len(ivs),
                    "intervals": [[a, b]
                                  for a, b in ivs[-self._max_intervals:]],
                    "truncated": bool(dropped),
                    "dropped_s": _total(dropped),
                }
        step_durs = [float(e["dur_s"]) for e in events
                     if e.get("kind") == "step" and e.get("dur_s")]
        dropped = int(getattr(self._fr, "dropped_events", 0) or 0) \
            if self._fr is not None else 0
        dropped_delta = max(dropped - self._dropped_last, 0)
        self._dropped_last = dropped
        hists = {}
        for name in self._hist_names:
            m = self._reg.get(name)
            if not isinstance(m, StreamingHistogram):
                continue
            hists[name] = {
                "lo": m.lo, "hi": m.hi,
                "buckets_per_decade": m.buckets_per_decade,
                "series": [{"labels": labels, "state": m.state(**labels)}
                           for labels in m.labels_seen()],
            }
        return {
            "rank": self.rank,
            "step": int(step),
            "occupancy": occ_doc,
            "step_durs": step_durs,
            "dropped_events": dropped_delta,
            "histograms": hists,
        }

    # ---- rank-0 fleet fold -------------------------------------------------

    def collect(self, step: int) -> Optional[dict]:
        """Gather every rank's summary to rank 0 and fold the fleet
        document.  Collective; returns the document on rank 0 only."""
        summary = self.local_summary(step)
        if self._plane is not None:
            gathered = self._plane.gather_telemetry(summary, root=0)
        elif hasattr(self._comm, "gather_obj"):
            gathered = self._comm.gather_obj(summary, root=0)
        else:
            gathered = [summary]
        if gathered is None:
            return None
        return self._fold(step, [s for s in gathered if s is not None])

    def _fold(self, step: int, summaries: List[dict]) -> dict:
        # fleet occupancy: union each (link, owner) across ranks, then
        # the live overlap matrix on the merged timelines
        timelines: Dict[str, Dict[str, list]] = {}
        per_rank_busy: Dict[str, dict] = {}
        dropped_s: Dict[str, Dict[str, float]] = {}
        for s in summaries:
            for link, owners in s.get("occupancy", {}).items():
                for owner, row in owners.items():
                    timelines.setdefault(link, {}).setdefault(
                        owner, []).extend(
                        tuple(iv) for iv in row.get("intervals", []))
                    per_rank_busy.setdefault(link, {}).setdefault(
                        owner, {})[str(s["rank"])] = row.get("busy_s", 0.0)
                    if row.get("truncated"):
                        cell = dropped_s.setdefault(link, {})
                        cell[owner] = cell.get(owner, 0.0) \
                            + float(row.get("dropped_s", 0.0))
        timelines = {link: {o: _merge(ivs) for o, ivs in owners.items()}
                     for link, owners in timelines.items()}
        matrix = contention.overlap_matrix(timelines)
        # union busy_s / the live matrix only see the SHIPPED intervals;
        # a truncated (link, owner) makes both lower bounds for this
        # window, so the fold says so instead of undercounting silently
        truncated = sorted(
            [link, owner]
            for link, owners in dropped_s.items() for owner in owners)
        occupancy_doc = {
            link: {owner: dict(
                       {"busy_s": _total(ivs),
                        "by_rank": per_rank_busy[link][owner]},
                       **({"truncated": True,
                           "dropped_s": dropped_s[link][owner]}
                          if owner in dropped_s.get(link, {}) else {}))
                   for owner, ivs in sorted(timelines[link].items())}
            for link in sorted(timelines)}

        # straggler flags: mean step time vs the fleet median of means
        means = {s["rank"]: (sum(s["step_durs"]) / len(s["step_durs"]))
                 for s in summaries if s.get("step_durs")}
        stragglers = []
        if len(means) >= 2:
            ordered = sorted(means.values())
            median = ordered[len(ordered) // 2]
            if median > 0:
                stragglers = sorted(
                    r for r, m in means.items()
                    if m > self._straggler_factor * median)

        # fleet-merged serving histograms -> SLO percentiles; publish
        # the percentiles back into the registry as fleet gauges so the
        # Prometheus sink exposes them on the next snapshot
        slo: Dict[str, dict] = {}
        for name in self._hist_names:
            grids = [s["histograms"][name] for s in summaries
                     if name in s.get("histograms", {})]
            if not any(g["series"] for g in grids):
                continue
            g0 = grids[0]
            fleet = StreamingHistogram(
                name, lo=g0["lo"], hi=g0["hi"],
                buckets_per_decade=g0["buckets_per_decade"])
            for g in grids:
                for series in g["series"]:
                    fleet.merge(series["state"], **series["labels"])
            counts = [0] * (len(fleet.bounds) + 1)
            total = 0
            total_sum = 0.0
            for labels in fleet.labels_seen():
                st = fleet.state(**labels)
                for i, c in enumerate(st["counts"]):
                    counts[i] += c
                total += st["count"]
                total_sum += st["sum"]
            quantiles = {
                f"p{int(q * 100)}": fleet._quantile_from_counts(counts, q)
                for q in _SLO_QUANTILES}
            slo[name] = {"count": total, "sum": total_sum,
                         "quantiles": quantiles}
            gauge = self._reg.gauge(
                f"fleet_{name}", f"fleet percentile of {name}")
            for label, v in quantiles.items():
                if v is not None:
                    gauge.set(v, quantile=label)

        return {
            "kind": "fleet_telemetry",
            "schema": SCHEMA,
            "step": int(step),
            "n_ranks": len(summaries),
            "occupancy": occupancy_doc,
            "truncated": truncated,
            "overlap": contention._matrix_rows(matrix),
            "step_time": {str(r): m for r, m in sorted(means.items())},
            "stragglers": stragglers,
            "dropped_events": sum(int(s.get("dropped_events", 0))
                                  for s in summaries),
            "slo": slo,
        }


__all__ = [
    "DEFAULT_HISTOGRAMS",
    "SCHEMA",
    "TelemetryAggregator",
]
