"""Step-time attribution — where did the step's wall time go, and on
which rank.

Counterpart of ``chainermn_tpu/observability/attribution.py``, with its
bucket names (``ici_comm`` is the fast, intra-node interconnect's time --
NVLink here -- and ``dcn_comm`` the inter-node network's).  The port's
link classes ``"nvlink"`` and ``"ib"`` classify as JAX's ``"ici"`` and
``"dcn"``.

Consumes the per-rank span trees :mod:`chainermn_tpu_torch.observability.spans`
reconstructs and answers the question every perf round had to answer by
hand:

* :func:`attribute_step` decomposes ONE step tree into the six buckets
  ``compute / ici_comm / dcn_comm / host_input / checkpoint / stall`` by
  interval arithmetic (union the classified spans, subtract by
  priority), so the buckets are disjoint and sum to the measured step
  time exactly — the residual the spans cannot explain is ``stall``;
* :func:`merge_ranks` + :func:`attribution_report` merge trees across
  ranks (each rank's timestamps shifted into the reference rank's
  timebase by a clock-handshake offset) and compute the per-step
  cross-rank critical path (:func:`critical_path`);
* :func:`clock_handshake` estimates the wall-clock offset between this
  rank and rank 0 over the communicator's object/control plane with the
  NTP midpoint formula (min-RTT sample wins) —
  :func:`offset_from_samples` is the pure math, shared with the
  watchdog's probe/reply handshake;
* :func:`to_trace_events` exports a merged timeline as Chrome/Perfetto
  trace-event JSON (``chrome://tracing`` / https://ui.perfetto.dev).

Bucket definitions:

=============  =============================================================
``host_input``  ``data_load`` + ``host_put`` phases — iterator and batch
                sharding time the device spent idle (unless prefetch hid it)
``ici_comm``    union of spans tagged ``link="ici"`` (intra-scope plan
                stages, FSDP bucket collectives) plus untagged collective
                spans — fast-interconnect time
``dcn_comm``    union of spans tagged ``link="dcn"`` (inter/all-scope plan
                stages) plus object-plane ops — slow-boundary time
``checkpoint``  checkpoint_save spans
``compute``     device window (``dispatch`` + ``device_block`` phases, or
                the whole step when phases are absent) minus everything
                above — includes codec compute (separable in the tree)
``stall``       measured step time minus every bucket — time no span
                explains (scheduler noise, GIL, untraced waits)
=============  =============================================================
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from chainermn_tpu_torch.observability.spans import Span, build_step_trees

BUCKETS = ("compute", "ici_comm", "dcn_comm", "host_input", "checkpoint",
           "stall")

#: span kinds whose link field (or default) classifies comm time
_HOST_PHASES = ("data_load", "host_put")
_DEVICE_PHASES = ("dispatch", "device_block")


# ---------------------------------------------------------------------------
# interval arithmetic (half-open [t0, t1) semantics, merged ascending)
# ---------------------------------------------------------------------------

def _merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    ivs = sorted((a, b) for a, b in intervals if b > a)
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _subtract(a: List[Tuple[float, float]],
              b: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """``a - b``; both merged ascending."""
    out: List[Tuple[float, float]] = []
    for a0, a1 in a:
        cur = a0
        for b0, b1 in b:
            if b1 <= cur or b0 >= a1:
                continue
            if b0 > cur:
                out.append((cur, b0))
            cur = max(cur, b1)
            if cur >= a1:
                break
        if cur < a1:
            out.append((cur, a1))
    return out


def _clip(intervals: List[Tuple[float, float]],
          t0: float, t1: float) -> List[Tuple[float, float]]:
    return [(max(a, t0), min(b, t1)) for a, b in intervals
            if min(b, t1) > max(a, t0)]


def _total(intervals: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in intervals)


# ---------------------------------------------------------------------------
# bucket decomposition
# ---------------------------------------------------------------------------

def classify_span(span: Span) -> Optional[str]:
    """Bucket a leaf span contributes comm/checkpoint time to, or
    ``None`` for spans that stay inside the compute bucket (codec
    compute, serving sub-spans, phases — phases are handled
    separately)."""
    link = span.meta.get("link")
    if link in ("ici", "nvlink"):
        return "ici_comm"
    if link in ("dcn", "ib"):
        return "dcn_comm"
    if span.kind == "plan_stage":
        return "dcn_comm" if span.meta.get("scope") in ("inter", "all") \
            else "ici_comm"
    if span.kind == "fsdp":
        return "ici_comm"
    if span.kind == "collective":
        return "ici_comm"
    if span.kind == "object":
        return "dcn_comm"
    if span.kind == "checkpoint":
        return "checkpoint"
    return None


def attribute_step(step: Span) -> dict:
    """Decompose one step tree into the six buckets.

    Construction guarantees the buckets are disjoint, clipped to the
    step window, and sum to the measured step time exactly: classified
    spans are unioned per bucket then subtracted in priority order
    (checkpoint > dcn > ici > host_input), compute is the device window
    minus all of those, and stall is the unexplained remainder.
    """
    t0, t1 = step.t0, step.t1
    total = step.dur_s
    by_bucket: Dict[str, List[Tuple[float, float]]] = {
        "ici_comm": [], "dcn_comm": [], "checkpoint": []}
    host_iv: List[Tuple[float, float]] = []
    device_iv: List[Tuple[float, float]] = []
    for sp in step.walk():
        if sp is step:
            continue
        if sp.kind == "phase":
            name = sp.meta.get("phase")
            if name in _HOST_PHASES:
                host_iv.append((sp.t0, sp.t1))
            elif name in _DEVICE_PHASES:
                device_iv.append((sp.t0, sp.t1))
            continue
        bucket = classify_span(sp)
        if bucket is not None:
            by_bucket[bucket].append((sp.t0, sp.t1))
    ckpt = _clip(_merge(by_bucket["checkpoint"]), t0, t1)
    dcn = _subtract(_clip(_merge(by_bucket["dcn_comm"]), t0, t1), ckpt)
    used = _merge(ckpt + dcn)
    ici = _subtract(_clip(_merge(by_bucket["ici_comm"]), t0, t1), used)
    used = _merge(used + ici)
    host = _subtract(_clip(_merge(host_iv), t0, t1), used)
    used = _merge(used + host)
    dev_window = _clip(_merge(device_iv), t0, t1) if device_iv \
        else [(t0, t1)]
    compute = _subtract(dev_window, used)
    buckets = {
        "compute": _total(compute),
        "ici_comm": _total(ici),
        "dcn_comm": _total(dcn),
        "host_input": _total(host),
        "checkpoint": _total(ckpt),
    }
    buckets["stall"] = max(total - sum(buckets.values()), 0.0)
    ssum = sum(buckets.values())
    return {
        "rank": step.rank,
        "iteration": step.meta.get("iteration"),
        "step_s": total,
        "buckets": buckets,
        "sum_s": ssum,
        "sum_frac": ssum / total if total > 0 else 1.0,
    }


# ---------------------------------------------------------------------------
# clock offset estimation (the control-plane handshake)
# ---------------------------------------------------------------------------

def offset_from_samples(
        samples: Sequence[Tuple[float, float, float]]) -> Tuple[float, float]:
    """NTP midpoint estimate from ``(t_send, t_peer, t_recv)`` samples,
    all on the local clock except ``t_peer``: the min-RTT sample gives
    ``offset = t_peer - (t_send + t_recv) / 2`` (add ``offset`` to a
    local stamp to land in the peer's timebase) with uncertainty
    ``rtt / 2``.  Returns ``(offset_s, rtt_s)``."""
    if not samples:
        raise ValueError("offset_from_samples needs at least one sample")
    t_send, t_peer, t_recv = min(samples, key=lambda s: s[2] - s[0])
    rtt = max(t_recv - t_send, 0.0)
    return t_peer - 0.5 * (t_send + t_recv), rtt


def clock_handshake(comm, rounds: int = 8) -> dict:
    """Estimate this rank's wall-clock offset to rank 0 over the
    communicator's object plane.  COLLECTIVE (every rank must call it at
    the same point); each round is one ``allgather_obj`` of wall stamps,
    bracketed by local send/recv stamps — the NTP request/response pair
    with the allgather as both legs.  Single-host worlds return a zero
    offset without touching the wire.

    Returns ``{"rank", "offset_s", "rtt_s", "rounds"}`` where
    ``local_ts + offset_s ≈ the same instant on rank 0's clock`` — the
    shift :func:`merge_ranks` applies.
    """
    rank = int(getattr(comm, "rank", 0) or 0)
    if comm is None or int(getattr(comm, "host_size", 1) or 1) <= 1:
        return {"rank": rank, "offset_s": 0.0, "rtt_s": 0.0, "rounds": 0}
    samples = []
    for _ in range(max(int(rounds), 1)):
        t_send = time.time()
        stamps = comm.allgather_obj({"rank": rank, "wall": time.time()})
        t_recv = time.time()
        ref = next((s for s in stamps if s.get("rank") == 0), None)
        if ref is not None:
            samples.append((t_send, float(ref["wall"]), t_recv))
    offset, rtt = offset_from_samples(samples) if samples else (0.0, 0.0)
    if rank == 0:
        offset = 0.0  # rank 0 IS the reference timebase
    return {"rank": rank, "offset_s": offset, "rtt_s": rtt,
            "rounds": len(samples)}


# ---------------------------------------------------------------------------
# cross-rank merge + critical path
# ---------------------------------------------------------------------------

def merge_ranks(events_by_rank: Dict[int, List[dict]],
                offsets: Optional[Dict[int, float]] = None
                ) -> Dict[int, List[Span]]:
    """Build per-rank step trees with every rank's timestamps shifted
    into the reference timebase.  ``offsets`` maps rank -> the
    ``offset_s`` its :func:`clock_handshake` reported (missing ranks
    shift by zero — single-host merges need no correction)."""
    offsets = offsets or {}
    return {int(r): build_step_trees(evs, rank=int(r),
                                     offset=float(offsets.get(int(r), 0.0)))
            for r, evs in events_by_rank.items()}


def _match_collective(trees_by_rank: Dict[int, Span], rank: int,
                      span: Span) -> Optional[Tuple[int, Span]]:
    """The last entrant into a symmetric collective: the rank whose
    matching (op, op_seq) span starts latest — the one everybody else
    waited for."""
    op, seq = span.meta.get("op"), span.meta.get("op_seq")
    if op is None or seq is None:
        return None
    best = None
    for r, tree in trees_by_rank.items():
        for sp in tree.walk():
            if (sp.kind == span.kind and sp.meta.get("op") == op
                    and sp.meta.get("op_seq") == seq):
                if best is None or sp.t0 > best[1].t0:
                    best = (r, sp)
    if best is not None and best[0] != rank:
        return best
    return None


def critical_path(trees_by_rank: Dict[int, Span]) -> List[dict]:
    """Cross-rank critical path of ONE step: start at the gating rank
    (longest step), greedily descend into the longest child; at a
    collective present on several ranks, hop to the last entrant (the
    rank the others blocked on) and keep descending there.  Each entry
    names a (rank, span) pair."""
    if not trees_by_rank:
        return []
    rank = max(trees_by_rank, key=lambda r: trees_by_rank[r].dur_s)
    span = trees_by_rank[rank]
    path: List[dict] = []
    visited = set()
    while span is not None and id(span) not in visited:
        visited.add(id(span))
        entry = {"rank": rank, "name": span.name, "kind": span.kind,
                 "dur_s": span.dur_s, "t0": span.t0, "t1": span.t1}
        if span.kind in ("collective", "plan_stage", "fsdp"):
            hop = _match_collective(trees_by_rank, rank, span)
            if hop is not None and id(hop[1]) not in visited:
                entry["blocked_by_rank"] = hop[0]
                path.append(entry)
                rank, span = hop
                visited.add(id(span))
                entry = {"rank": rank, "name": span.name, "kind": span.kind,
                         "dur_s": span.dur_s, "t0": span.t0, "t1": span.t1}
        path.append(entry)
        span = max(span.children, key=lambda s: s.dur_s, default=None)
    return path


def attribution_report(events_by_rank: Dict[int, List[dict]],
                       offsets: Optional[Dict[int, float]] = None) -> dict:
    """The full cross-rank report: per-iteration bucket decomposition on
    every rank plus the critical path, and a mean-bucket summary —
    what ``obs_report --attribution`` renders and the ATTRIBUTION
    runbook leg asserts over."""
    merged = merge_ranks(events_by_rank, offsets=offsets)
    by_iter: Dict[object, Dict[int, Span]] = {}
    for r, trees in merged.items():
        for i, tree in enumerate(trees):
            key = tree.meta.get("iteration")
            by_iter.setdefault(key if key is not None else f"#{i}",
                               {})[r] = tree
    steps = []
    totals = {b: 0.0 for b in BUCKETS}
    n = 0
    for key in sorted(by_iter, key=str):
        ranks = by_iter[key]
        attrs = {r: attribute_step(t) for r, t in sorted(ranks.items())}
        for a in attrs.values():
            for b in BUCKETS:
                totals[b] += a["buckets"][b]
            n += 1
        steps.append({
            "iteration": key,
            "step_s": max(t.dur_s for t in ranks.values()),
            "ranks": {str(r): a for r, a in attrs.items()},
            "critical_path": critical_path(ranks),
        })
    return {
        "kind": "attribution_report",
        "schema": 1,
        "n_ranks": len(merged),
        "n_steps": len(steps),
        "offsets": {str(r): float((offsets or {}).get(r, 0.0))
                    for r in merged},
        "steps": steps,
        "summary": {
            "mean_buckets_s": {b: totals[b] / n if n else 0.0
                               for b in BUCKETS},
        },
    }


def span_summary(events: List[dict], rank: int = 0, k: int = 3) -> dict:
    """Top-``k`` critical-path spans aggregated over every step in an
    event stream — the compact per-run attribution the benchmark
    artifacts embed (``bench.py --metrics`` / ``bench_serving.py``)."""
    trees = build_step_trees(events, rank=rank)
    agg: Dict[Tuple[str, str], List[float]] = {}
    for tree in trees:
        for entry in critical_path({rank: tree}):
            if entry["kind"] == "step":
                continue
            agg.setdefault((entry["name"], entry["kind"]),
                           []).append(entry["dur_s"])
    mean_step = (sum(t.dur_s for t in trees) / len(trees)) if trees else 0.0
    spans = sorted(
        ({"name": name, "kind": kind,
          "mean_dur_s": sum(ds) / len(ds), "hits": len(ds),
          "frac_of_step": (sum(ds) / len(ds)) / mean_step
          if mean_step > 0 else 0.0}
         for (name, kind), ds in agg.items()),
        key=lambda s: -s["mean_dur_s"])[:max(int(k), 0)]
    return {"steps": len(trees), "mean_step_s": mean_step,
            "top_spans": spans}


# ---------------------------------------------------------------------------
# Chrome / Perfetto trace-event export
# ---------------------------------------------------------------------------

#: span kind -> trace lane (tid) inside each rank's process track
_LANES = {"step": 0, "phase": 1, "collective": 2, "plan_stage": 3,
          "compute": 4, "fsdp": 5, "object": 6, "serving": 7,
          "checkpoint": 8}


def to_trace_events(trees_by_rank: Dict[int, List[Span]]) -> dict:
    """Merged timeline as Chrome trace-event JSON (the ``traceEvents``
    array format both ``chrome://tracing`` and https://ui.perfetto.dev
    open directly): one process per rank, one thread lane per span
    kind, ``"X"`` complete events in microseconds relative to the
    earliest span start."""
    base = min((sp.t0 for trees in trees_by_rank.values()
                for t in trees for sp in t.walk()), default=0.0)
    events: List[dict] = []
    for rank in sorted(trees_by_rank):
        events.append({"ph": "M", "name": "process_name", "pid": rank,
                       "tid": 0, "args": {"name": f"rank{rank}"}})
        lanes_used = set()
        for tree in trees_by_rank[rank]:
            for sp in tree.walk():
                tid = _LANES.get(sp.kind, 9)
                lanes_used.add((tid, sp.kind))
                args = {k: v for k, v in sp.meta.items() if v is not None}
                events.append({
                    "ph": "X", "name": sp.name, "cat": sp.kind,
                    "ts": (sp.t0 - base) * 1e6,
                    "dur": sp.dur_s * 1e6,
                    "pid": rank, "tid": tid, "args": args,
                })
        for tid, kind in sorted(lanes_used):
            events.append({"ph": "M", "name": "thread_name", "pid": rank,
                           "tid": tid, "args": {"name": kind}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


__all__ = [
    "BUCKETS",
    "attribute_step",
    "attribution_report",
    "classify_span",
    "clock_handshake",
    "critical_path",
    "merge_ranks",
    "offset_from_samples",
    "span_summary",
    "to_trace_events",
]
