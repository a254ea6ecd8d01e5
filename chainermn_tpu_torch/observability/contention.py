"""Link-contention observatory — who occupied each link class, when,
and what the overlap cost.

Counterpart of ``chainermn_tpu/observability/contention.py``: the same
classification, guard, interval arithmetic and ``contention/v1``
document.  The link classes are the card's, ``"nvlink"`` (intra-node)
and ``"ib"`` (inter-node); a span tagged with JAX's ``"ici"`` / ``"dcn"``
(a dump the JAX package wrote) reads as ``"nvlink"`` / ``"ib"``.  The
attribution buckets keep JAX's names, ``ici_comm`` / ``dcn_comm``.

Every subsystem issues its own tuned collectives — FSDP prefetch
gathers, MoE all-to-alls, serving multicasts, plan-compiled allreduce
hops, online-tune control traffic — and each is priced and observed in
isolation.  The attribution span trees (:mod:`.attribution`) already
record the real concurrency; this module re-cuts them per *physical
link class* instead of per step:

* :func:`occupancy_timelines` — busy intervals per link class keyed by
  owning subsystem (``fsdp`` / ``moe`` / ``serving`` /
  ``plan:<scope>`` / ``control`` / ``collective``), merged across
  ranks (feed it :func:`~.attribution.merge_ranks` output so all
  timestamps share rank 0's timebase);
* :func:`overlap_matrix` — pairwise contended seconds between owners
  on the same link class;
* :func:`link_rates` — effective vs modeled GB/s per link under
  overlap.  *Modeled* prices every span alone (bytes / its own
  duration, overlap double-counted — exactly what per-span tuning
  assumes); *effective* is bytes over the union busy window (what the
  link actually delivered per wall-second).  The ratio is the
  contention derate, and :func:`feed_link_observations` pushes the
  effective rates into the online tuner's
  :class:`~chainermn_tpu_torch.planner.online.LinkObservations`;
* :func:`attribution_consistency` — per (rank, step, link): the
  occupancy union must reconcile exactly with the ici_comm/dcn_comm
  attribution buckets once the higher-priority shave
  (checkpoint > ib > nvlink) is added back;
* :func:`contention_report` — the ``contention/v1`` document.

On the card a span's interval is a host-resolved time: the planner's
stage edges are stamped after a stream synchronize, FSDP's from CUDA
events read at the step's end.  An NCCL call returns once it is
enqueued, so two collectives the device runs side by side only overlap
here if their edges say so; the matrix reports what the edges show,
empty included.

Double-count guard: a ``collective`` span *contains* its plan-stage
children — the same wire traffic recorded twice — so unioning both
under different owners would manufacture fake self-contention.
Occupancy therefore drops those wrapper parents
(:func:`leaf_comm_spans`).  The guard is deliberately narrow: only a
same-rank known *decomposition* pair (a ``collective`` wrapper over its
``plan_stage`` stages or a nested instrumented call, an ``object`` op
over the ops composing it) marks a parent; mere time-containment — one
rank's FSDP gather spanning another subsystem's hop, on the same rank
or across ranks — is genuine concurrency and is KEPT.  The consistency
check uses the full classified union on purpose — that is what
:func:`~.attribution.attribute_step` buckets.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from chainermn_tpu_torch.observability.attribution import (
    _clip, _merge, _total, attribute_step, classify_span, merge_ranks)
from chainermn_tpu_torch.observability.spans import Span, pair_events

#: the physical link classes occupancy is cut by (JAX's "ici" / "dcn")
LINK_CLASSES = ("nvlink", "ib")

_EPS = 1e-9

_Interval = Tuple[float, float]


# ---------------------------------------------------------------------------
# span classification: link class + owning subsystem
# ---------------------------------------------------------------------------

def span_link(span: Span) -> Optional[str]:
    """Link class a span occupies (``"nvlink"`` / ``"ib"``), or ``None``
    for non-comm spans.  Derived from the same classification the
    attribution buckets use, so occupancy and buckets cut the same
    spans."""
    bucket = classify_span(span)
    if bucket == "ici_comm":
        return "nvlink"
    if bucket == "dcn_comm":
        return "ib"
    return None


def span_owner(span: Span) -> Optional[str]:
    """Owning subsystem of a comm span: which tuner/issuer put that
    traffic on the link.

    * ``fsdp`` — bucketed-FSDP gathers/scatters;
    * ``moe`` — all-to-all dispatch/combine plan stages
      (``alltoall_*`` plans);
    * ``serving`` — serving engine spans and ``serving*`` plans;
    * ``plan:<scope>`` — any other plan stage, keyed by its hop scope
      (``intra``/``inter``/``all``);
    * ``control`` — object-plane traffic (plan-table broadcasts,
      checkpoints' metadata, the control plane itself);
    * ``collective`` — a bare collective span with no plan decomposition
      under it.
    """
    if span.kind == "fsdp":
        return "fsdp"
    if span.kind == "serving":
        return "serving"
    if span.kind == "object":
        return "control"
    if span.kind == "plan_stage":
        plan = str(span.meta.get("plan") or "")
        if plan.startswith("alltoall"):
            return "moe"
        if plan.startswith("serving"):
            return "serving"
        return f"plan:{span.meta.get('scope', '?')}"
    if span.kind == "collective":
        return "collective"
    if span_link(span) is not None:
        return span.kind or "?"
    return None


#: the workload tag a jointly-tuned plan name carries
#: (``<base>@wl:<signature>`` — written by ``planner.schedule.tag_plan``;
#: the literal is duplicated here so observability does not import the
#: planner)
_WORKLOAD_TAG = "@wl:"


def plan_identity(span: Span) -> Optional[str]:
    """Tuning identity of a comm span — spans sharing an identity were
    tuned TOGETHER (a striped plan's concurrent groups share a plan
    name; plans co-tuned in one ``StepWorkload`` share the workload
    signature their ``@wl:`` name tag carries), spans with different
    identities were tuned independently."""
    if span.kind == "plan_stage":
        plan = span.meta.get("plan")
        if plan is not None:
            _base, sep, sig = str(plan).partition(_WORKLOAD_TAG)
            if sep and sig:
                return f"workload:{sig}"
            return f"plan:{plan}"
        return "plan:?"
    if span.kind == "fsdp":
        return "fsdp"
    if span.kind == "collective":
        return f"collective:{span.meta.get('op', '?')}"
    if span.kind == "object":
        return f"object:{span.meta.get('op', '?')}"
    if span.kind == "serving":
        return f"serving:{span.meta.get('op', '?')}"
    if span_link(span) is not None:
        return span.kind or "?"
    return None


#: (parent kind, child kind) pairs that are true traffic
#: decompositions: the parent is a host-side wrapper whose wire bytes
#: its contained child re-emits.  Everything else that merely
#: time-contains a comm span — an FSDP gather spanning a MoE hop — is
#: independent traffic contending for the link, not a re-count of it.
_DECOMPOSITION = frozenset({
    ("collective", "plan_stage"),
    ("collective", "collective"),
    ("object", "object"),
})


def leaf_comm_spans(spans: Sequence[Span]) -> List[Span]:
    """Comm spans minus wrapper parents whose traffic a contained span
    re-emits — the double-count guard.

    A span is dropped ONLY when, on the SAME rank, it time-contains
    another comm span in a known decomposition relationship
    (:data:`_DECOMPOSITION`).  Plain containment is NOT parenthood.
    Works on flat :func:`~.spans.pair_events` output and on tree walks
    alike (a per-rank stack sweep over ``(t0, -t1)`` order)."""
    comm = [sp for sp in spans if span_link(sp) is not None]
    non_leaf = set()
    by_rank: Dict[int, List[Span]] = {}
    for sp in comm:
        by_rank.setdefault(sp.rank, []).append(sp)
    for rank_spans in by_rank.values():
        rank_spans.sort(key=lambda s: (s.t0, -s.t1))
        stack: List[Span] = []
        for sp in rank_spans:
            while stack and not (sp.t0 >= stack[-1].t0 - _EPS
                                 and sp.t1 <= stack[-1].t1 + _EPS):
                stack.pop()
            for anc in stack:
                if (anc.kind, sp.kind) in _DECOMPOSITION:
                    non_leaf.add(id(anc))
            stack.append(sp)
    comm.sort(key=lambda s: (s.t0, -s.t1))
    return [sp for sp in comm if id(sp) not in non_leaf]


def _tree_spans(trees_by_rank: Dict[int, List[Span]]) -> List[Span]:
    return [sp for trees in trees_by_rank.values()
            for tree in trees for sp in tree.walk()]


# ---------------------------------------------------------------------------
# interval helpers on top of attribution's arithmetic
# ---------------------------------------------------------------------------

def _intersect(a: List[_Interval], b: List[_Interval]) -> List[_Interval]:
    """``a ∩ b``; both merged ascending."""
    out: List[_Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _occupancy(spans: Sequence[Span]) -> Dict[str, Dict[str, List[_Interval]]]:
    out: Dict[str, Dict[str, List[_Interval]]] = {}
    for sp in leaf_comm_spans(spans):
        link, owner = span_link(sp), span_owner(sp)
        if link is None or owner is None:
            continue
        out.setdefault(link, {}).setdefault(owner, []).append(
            (sp.t0, sp.t1))
    return {link: {owner: _merge(ivs) for owner, ivs in owners.items()}
            for link, owners in out.items()}


# ---------------------------------------------------------------------------
# occupancy timelines + overlap matrix
# ---------------------------------------------------------------------------

def occupancy_timelines(trees_by_rank: Dict[int, List[Span]]
                        ) -> Dict[str, Dict[str, List[_Interval]]]:
    """``{link: {owner: merged busy intervals}}`` over every rank's
    leaf comm spans.  Trees must already share a timebase
    (:func:`~.attribution.merge_ranks` applies the clock-handshake
    offsets) — occupancy is a property of the *link*, not of any one
    rank's clock."""
    return _occupancy(_tree_spans(trees_by_rank))


def overlap_matrix(timelines: Dict[str, Dict[str, List[_Interval]]]
                   ) -> Dict[str, Dict[Tuple[str, str], float]]:
    """Pairwise contended seconds between owners sharing a link class:
    ``{link: {(owner_a, owner_b): seconds}}`` with ``owner_a <
    owner_b`` and zero-overlap pairs dropped."""
    out: Dict[str, Dict[Tuple[str, str], float]] = {}
    for link, owners in timelines.items():
        names = sorted(owners)
        cells: Dict[Tuple[str, str], float] = {}
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                sec = _total(_intersect(owners[a], owners[b]))
                if sec > 0.0:
                    cells[(a, b)] = sec
        out[link] = cells
    return out


# ---------------------------------------------------------------------------
# effective vs modeled link rates under overlap
# ---------------------------------------------------------------------------

def link_rates(trees_by_rank: Dict[int, List[Span]],
               modeled_gbps: Optional[Dict[str, float]] = None
               ) -> Dict[str, dict]:
    """Per-link transfer accounting under overlap.

    For each link class: ``busy_s`` (union across owners), ``solo_s``
    vs ``contended_s`` (busy time with exactly one / more than one
    owner on the link), total ``bytes``, and three rates in GB/s:

    * ``modeled_gbps`` — bytes over the SUM of span durations: each
      span priced alone, concurrent seconds double-counted.  This is
      what per-span tuning (``LinkObservations.ingest_spans``) sees;
    * ``effective_gbps`` — bytes over the union busy window: what the
      link actually delivered per wall-second;
    * ``derate`` — effective / modeled (1.0 with no overlap; drops as
      contention stretches spans).

    ``modeled_gbps`` (the argument) optionally supplies static
    plan-table rates per link; when given, each link row also carries
    ``static_gbps`` and ``vs_static``.
    """
    spans = leaf_comm_spans(_tree_spans(trees_by_rank))
    per_link: Dict[str, List[Span]] = {}
    for sp in spans:
        link = span_link(sp)
        if link is not None:
            per_link.setdefault(link, []).append(sp)
    timelines = occupancy_timelines(trees_by_rank)
    out: Dict[str, dict] = {}
    for link, link_spans in sorted(per_link.items()):
        owners = timelines.get(link, {})
        busy = _merge([iv for ivs in owners.values() for iv in ivs])
        contended: List[_Interval] = []
        names = sorted(owners)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                contended.extend(_intersect(owners[a], owners[b]))
        contended = _merge(contended)
        busy_s = _total(busy)
        contended_s = _total(contended)
        span_s = sum(sp.dur_s for sp in link_spans)
        nbytes = sum(int(sp.meta.get("nbytes") or 0) for sp in link_spans)
        modeled = nbytes / span_s / 1e9 if span_s > 0 else 0.0
        effective = nbytes / busy_s / 1e9 if busy_s > 0 else 0.0
        row = {
            "n_spans": len(link_spans),
            "bytes": nbytes,
            "span_s": span_s,
            "busy_s": busy_s,
            "solo_s": max(busy_s - contended_s, 0.0),
            "contended_s": contended_s,
            "modeled_gbps": modeled,
            "effective_gbps": effective,
            "derate": effective / modeled if modeled > 0 else 1.0,
        }
        if modeled_gbps and link in modeled_gbps:
            static = float(modeled_gbps[link])
            row["static_gbps"] = static
            row["vs_static"] = effective / static if static > 0 else 0.0
        out[link] = row
    return out


def feed_link_observations(observations, rates: Dict[str, dict]) -> None:
    """Push the contention-derated effective rates into an online
    tuner's :class:`~chainermn_tpu_torch.planner.online.LinkObservations`:
    one aggregate (bytes, union-busy-seconds) sample per link, so
    ``observed_gbps`` prices links at what they deliver UNDER the
    measured overlap, not at per-span isolation rates."""
    for link, row in sorted(rates.items()):
        nbytes, busy_s = int(row.get("bytes", 0)), float(
            row.get("busy_s", 0.0))
        if nbytes > 0 and busy_s > 0.0:
            observations.add(link, nbytes, busy_s)


# ---------------------------------------------------------------------------
# consistency against the attribution buckets
# ---------------------------------------------------------------------------

_LINK_BUCKET = {"nvlink": "ici_comm", "ib": "dcn_comm"}


def _step_link_intervals(step: Span) -> Dict[str, List[_Interval]]:
    """Per-link classified interval unions of one step tree, built the
    way :func:`~.attribution.attribute_step` builds its buckets (ALL
    classified spans, ancestors included) plus the checkpoint union —
    so the consistency check reconciles against identical geometry."""
    ivs: Dict[str, List[_Interval]] = {"nvlink": [], "ib": [],
                                       "checkpoint": []}
    for sp in step.walk():
        if sp is step:
            continue
        bucket = classify_span(sp)
        if bucket == "ici_comm":
            ivs["nvlink"].append((sp.t0, sp.t1))
        elif bucket == "dcn_comm":
            ivs["ib"].append((sp.t0, sp.t1))
        elif bucket == "checkpoint":
            ivs["checkpoint"].append((sp.t0, sp.t1))
    return {k: _clip(_merge(v), step.t0, step.t1) for k, v in ivs.items()}


def attribution_consistency(trees_by_rank: Dict[int, List[Span]],
                            tol: float = 1e-6) -> List[dict]:
    """Reconcile per-link occupancy with the attribution buckets, per
    (rank, step, link).

    The buckets are the occupancy minus the higher-priority shave
    (``dcn_comm = ib − checkpoint``, ``ici_comm = nvlink − (checkpoint ∪
    ib)``), so for every row::

        occupancy_s − shaved_s == bucket_s   (within tol)

    Returns one row per (rank, iteration, link) with ``ok`` per row.
    """
    rows: List[dict] = []
    for rank, trees in sorted(trees_by_rank.items()):
        for step in trees:
            attr = attribute_step(step)
            ivs = _step_link_intervals(step)
            ckpt = ivs["checkpoint"]
            higher = {"ib": ckpt, "nvlink": _merge(ckpt + ivs["ib"])}
            for link in LINK_CLASSES:
                occupancy_s = _total(ivs[link])
                if occupancy_s <= 0.0:
                    continue
                shaved_s = _total(_intersect(ivs[link], higher[link]))
                bucket_s = attr["buckets"][_LINK_BUCKET[link]]
                err = abs((occupancy_s - shaved_s) - bucket_s)
                rows.append({
                    "rank": rank,
                    "iteration": step.meta.get("iteration"),
                    "link": link,
                    "occupancy_s": occupancy_s,
                    "shaved_s": shaved_s,
                    "bucket_s": bucket_s,
                    "abs_err_s": err,
                    "ok": err <= tol,
                })
    return rows


# ---------------------------------------------------------------------------
# the contention/v1 report document
# ---------------------------------------------------------------------------

def _matrix_rows(matrix: Dict[str, Dict[Tuple[str, str], float]]
                 ) -> List[dict]:
    return [{"link": link, "owners": [a, b], "contended_s": sec}
            for link in sorted(matrix)
            for (a, b), sec in sorted(matrix[link].items())]


def contention_report(events_by_rank: Dict[int, List[dict]],
                      offsets: Optional[Dict[int, float]] = None,
                      modeled_gbps: Optional[Dict[str, float]] = None,
                      max_intervals: int = 256) -> dict:
    """The full observatory document from raw per-rank flight events:
    clock-corrected merge, per-(link, owner) occupancy timelines, the
    overlap matrix, effective-vs-modeled link rates, and the
    per-step attribution reconciliation.  Schema ``contention/v1``."""
    trees = merge_ranks(events_by_rank, offsets=offsets)
    timelines = occupancy_timelines(trees)
    matrix = overlap_matrix(timelines)
    rates = link_rates(trees, modeled_gbps=modeled_gbps)
    consistency = attribution_consistency(trees)
    tl_doc = {}
    for link in sorted(timelines):
        tl_doc[link] = {}
        for owner in sorted(timelines[link]):
            ivs = timelines[link][owner]
            tl_doc[link][owner] = {
                "busy_s": _total(ivs),
                "n_intervals": len(ivs),
                "intervals": [[a, b] for a, b in ivs[-max_intervals:]],
            }
    return {
        "kind": "contention_report",
        "schema": "contention/v1",
        "n_ranks": len(trees),
        "n_steps": sum(len(t) for t in trees.values()),
        "links": sorted(timelines),
        "timelines": tl_doc,
        "overlap": _matrix_rows(matrix),
        "rates": rates,
        "consistency": consistency,
        "consistency_ok": all(r["ok"] for r in consistency),
    }


# ---------------------------------------------------------------------------
# flat-event occupancy (the streaming aggregator's per-window cut)
# ---------------------------------------------------------------------------

def occupancy_from_events(events: Sequence[dict], rank: int = 0
                          ) -> Dict[str, Dict[str, List[_Interval]]]:
    """``{link: {owner: merged busy intervals}}`` from ONE rank's raw
    flight events (no step trees, no clock correction) — the compact
    per-window cut each rank ships to rank 0
    (:class:`~chainermn_tpu_torch.observability.streaming.
    TelemetryAggregator`)."""
    return _occupancy(pair_events(list(events), rank=rank))


__all__ = [
    "LINK_CLASSES",
    "attribution_consistency",
    "contention_report",
    "feed_link_observations",
    "leaf_comm_spans",
    "link_rates",
    "occupancy_from_events",
    "occupancy_timelines",
    "overlap_matrix",
    "plan_identity",
    "span_link",
    "span_owner",
]
