"""Span-tree reconstruction — from flight-recorder events to a per-step
tree of timed regions.

Counterpart of ``chainermn_tpu/observability/spans.py`` (the same pairing
keys, span names and tree rules).

The flight recorder stores *edges*: ``<kind>_begin`` /
``<kind>_end`` pairs for tracked spans, plain ``phase`` / ``step``
progress markers from the updater, ``fsdp_{gather,scatter}_{begin,end}``
bucket edges from the bucketed FSDP step, and (new here) per-stage
``plan_stage_{begin,end}`` edges from the plan compiler.  This module
pairs those edges back into :class:`Span` intervals and nests them by
containment into one tree per train step::

    step #12 [0.034s]
      ├─ phase:data_load [0.002s]
      ├─ phase:host_put  [0.001s]
      ├─ phase:dispatch  [0.009s]
      │    └─ collective allreduce_grad (trace-time)
      └─ phase:device_block [0.022s]
           ├─ plan_stage hier:0 reduce-scatter intra (nvlink)
           ├─ plan_stage hier:1 all-reduce inter (ib)
           │    └─ compute compress:plan:inter
           └─ plan_stage hier:2 all-gather intra (nvlink)

:mod:`chainermn_tpu_torch.observability.attribution` consumes these trees for
the cross-rank merge, bucket decomposition, critical path, and the
Perfetto export; ``tools/obs_report.py --attribution`` renders them.

The second half of the module is :class:`PlanObs` /
:func:`get_plan_obs` -- the executor-side hook that EMITS the per-stage
edges, following the ``compression/observe.py`` pattern: bound once by
the caller, ``None`` while observability is off (no event, no
synchronization, the same launches in a disabled run).  Counterpart of
``chainermn_tpu/observability/spans.py``: JAX delivers the edges from
device-side callbacks gated to one device per controller; here each
process is one GPU and its own representative, and the executor calls
:meth:`PlanObs.edge` once the stream has reached the edge (it
synchronizes the current CUDA stream first, so the stamp is the stage's
and not its launch's).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: pairing slack for float timestamps (well under any real span)
_EPS = 1e-9

#: JAX's link-class names and the card's: ``"ici"`` is the intra-node
#: interconnect (NVLink here), ``"dcn"`` the inter-node network
LINK_ALIASES = {"ici": "nvlink", "dcn": "ib"}


def link_class(link):
    """The card's name of a link class: JAX's ``"ici"`` / ``"dcn"`` (in a
    dump written by the JAX package) read as ``"nvlink"`` / ``"ib"``;
    any other value is returned as it is."""
    return LINK_ALIASES.get(link, link)


@dataclass
class Span:
    """One timed region on one rank.  ``meta`` keeps the raw event
    fields (op_seq, plan, stage, scope, link, nbytes, iteration, ...)."""

    name: str
    kind: str
    rank: int
    t0: float
    t1: float
    meta: dict = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    @property
    def dur_s(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def walk(self):
        """Yield self and every descendant (pre-order)."""
        yield self
        for c in self.children:
            yield from c.walk()

    def to_dict(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "rank": self.rank,
            "t0": self.t0, "t1": self.t1, "dur_s": self.dur_s,
            "meta": dict(self.meta),
            "children": [c.to_dict() for c in self.children],
        }


# ---------------------------------------------------------------------------
# edge pairing
# ---------------------------------------------------------------------------

def _span_key(ev: dict) -> Optional[tuple]:
    """Pairing key for a ``*_begin``/``*_end`` edge event, or ``None``
    for non-edge events.  Tracked spans pair on (kind, op, op_seq); the
    plan-stage lane pairs on (plan, stage); the FSDP lane on
    (leg, bucket) — each mirrors how its emitter sequences edges."""
    k = ev.get("kind", "")
    if k.startswith("plan_stage_"):
        # ``group`` disambiguates concurrent stripes of a striped plan
        # (stage 0 of group 0 vs stage 0 of group 1); absent/None for
        # plain plans and events recorded before striping existed.
        return ("plan_stage", ev.get("plan"), ev.get("group"),
                ev.get("stage"))
    if k.startswith("fsdp_gather_") or k.startswith("fsdp_scatter_"):
        leg = k.split("_")[1]
        return ("fsdp", leg, ev.get("bucket"))
    if k.endswith("_begin") or k.endswith("_end"):
        base = k.rsplit("_", 1)[0]
        return (base, ev.get("op"), ev.get("op_seq"))
    return None


def _span_from_pair(begin: dict, end: dict, rank: int) -> Span:
    k = begin.get("kind", "")
    if k.startswith("plan_stage_"):
        grp = begin.get("group")
        tag = f"g{grp}:" if grp is not None else ""
        name = (f"plan_stage {begin.get('plan', '?')}:{tag}"
                f"{begin.get('stage', '?')} {begin.get('op', '?')} "
                f"{begin.get('scope', '?')}")
        kind = "plan_stage"
    elif k.startswith("fsdp_"):
        leg = k.split("_")[1]
        name = f"fsdp_{leg} b{begin.get('bucket', '?')}"
        kind = "fsdp"
    else:
        kind = k.rsplit("_", 1)[0]
        name = f"{kind} {begin.get('op', '?')}"
    meta = {kk: vv for kk, vv in begin.items()
            if kk not in ("kind", "ts", "seq", "mono")}
    for kk, vv in end.items():
        if kk not in ("kind", "ts", "seq", "mono") and kk not in meta:
            meta[kk] = vv
    return Span(name=name, kind=kind, rank=rank,
                t0=begin.get("ts", 0.0), t1=end.get("ts", 0.0), meta=meta)


def pair_events(events: List[dict], rank: int = 0) -> List[Span]:
    """Pair begin/end edges into flat (un-nested) spans, oldest first.
    Unmatched begins (still-open spans, or begins whose end was
    overwritten by ring wraparound) are dropped — attribution only
    counts completed regions."""
    open_edges: Dict[tuple, dict] = {}
    out: List[Span] = []
    for ev in events:
        key = _span_key(ev)
        if key is None:
            continue
        k = ev.get("kind", "")
        if k.endswith("_begin"):
            open_edges[key] = ev
        else:
            begin = open_edges.pop(key, None)
            if begin is not None:
                out.append(_span_from_pair(begin, ev, rank))
    out.sort(key=lambda s: (s.t0, -s.t1))
    return out


def stage_link_timings(events: List[dict]) -> List[tuple]:
    """Per-stage link timings from raw flight events: one
    ``(link, nbytes, dur_s)`` tuple per COMPLETED ``plan_stage`` span
    with a link class and a positive payload.  This is the export the
    online tuner's observation window eats (``planner.online``) — the
    per-link transfer evidence, stripped of plan/step structure."""
    out = []
    for sp in pair_events(list(events)):
        if sp.kind != "plan_stage":
            continue
        link, nbytes = sp.meta.get("link"), sp.meta.get("nbytes")
        if link and nbytes:
            out.append((str(link), int(nbytes), sp.dur_s))
    return out


def step_windows(events: List[dict], rank: int = 0) -> List[Span]:
    """Step root spans.  ``step`` events are END-stamped (the updater
    records ``dur_s`` at step completion), so each window is
    ``[ts - dur_s, ts]``.  Serving runs have no ``step`` events — their
    ``serving serving_step`` spans become the roots instead."""
    out = []
    for ev in events:
        if ev.get("kind") == "step":
            t1 = ev.get("ts", 0.0)
            dur = float(ev.get("dur_s", 0.0))
            out.append(Span(name=f"step #{ev.get('iteration', '?')}",
                            kind="step", rank=rank, t0=t1 - dur, t1=t1,
                            meta={"iteration": ev.get("iteration"),
                                  "dur_s": dur}))
    if not out:
        for sp in pair_events(events, rank=rank):
            if sp.kind == "serving" and sp.meta.get("op") == "serving_step":
                out.append(Span(name=f"step #{sp.meta.get('step', '?')}",
                                kind="step", rank=rank, t0=sp.t0, t1=sp.t1,
                                meta=dict(sp.meta,
                                          iteration=sp.meta.get("step"))))
    out.sort(key=lambda s: s.t0)
    return out


def phase_spans(events: List[dict], steps: List[Span],
                rank: int = 0) -> List[Span]:
    """Turn ``phase`` markers (recorded at phase START) into spans: each
    phase runs until the next phase marker of the same iteration, else
    to its enclosing step window's end."""
    markers = [ev for ev in events if ev.get("kind") == "phase"]
    out: List[Span] = []
    for i, ev in enumerate(markers):
        t0 = ev.get("ts", 0.0)
        nxt = markers[i + 1] if i + 1 < len(markers) else None
        t1 = None
        if nxt is not None and nxt.get("iteration") == ev.get("iteration"):
            t1 = nxt.get("ts", 0.0)
        if t1 is None:
            for st in steps:
                if st.t0 - _EPS <= t0 <= st.t1 + _EPS:
                    t1 = st.t1
                    break
        if t1 is None:
            t1 = nxt.get("ts", t0) if nxt is not None else t0
        out.append(Span(name=f"phase:{ev.get('phase', '?')}", kind="phase",
                        rank=rank, t0=t0, t1=max(t1, t0),
                        meta={"phase": ev.get("phase"),
                              "iteration": ev.get("iteration")}))
    return out


def _nest(parent: Span, spans: List[Span]) -> None:
    """Nest ``spans`` (pre-sorted by (t0, -t1)) under ``parent`` by
    interval containment — the classic stack sweep."""
    stack = [parent]
    for s in spans:
        while len(stack) > 1 and not (
                s.t0 >= stack[-1].t0 - _EPS and s.t1 <= stack[-1].t1 + _EPS):
            stack.pop()
        stack[-1].children.append(s)
        stack.append(s)


def build_step_trees(events: List[dict], rank: int = 0,
                     offset: float = 0.0) -> List[Span]:
    """The tree builder: step roots, phases + paired spans nested inside
    by containment.  ``offset`` (seconds) is added to every timestamp —
    the attribution merge passes each rank's clock-handshake offset so
    all trees land in the reference rank's timebase."""
    has_step_events = any(ev.get("kind") == "step" for ev in events)
    steps = step_windows(events, rank=rank)
    leaves = phase_spans(events, steps, rank=rank)
    # In the serving fallback the serving_step spans ARE the roots —
    # keep them out of the leaf set so a root never nests under itself.
    leaves.extend(
        sp for sp in pair_events(events, rank=rank)
        if has_step_events or not (sp.kind == "serving"
                                   and sp.meta.get("op") == "serving_step"))
    leaves.sort(key=lambda s: (s.t0, -s.t1))
    for st in steps:
        inside = [s for s in leaves
                  if st.t0 - _EPS <= 0.5 * (s.t0 + s.t1) <= st.t1 + _EPS]
        _nest(st, inside)
    if offset:
        for st in steps:
            for sp in st.walk():
                sp.t0 += offset
                sp.t1 += offset
    return steps


# ---------------------------------------------------------------------------
# PlanObs — the compiler-side per-stage span hooks
# ---------------------------------------------------------------------------

class PlanObs:
    """Begin/end edges for each emitted plan stage, called by
    ``planner/compiler``'s stage hook after it synchronized the stream.

    ``rep_rank`` is the representative rank (JAX's gate): here every
    process is one GPU and its own representative, so ``get_plan_obs``
    sets it to this process's rank and each process's flight recorder
    carries its own stage stream -- the attribution merge needs
    per-controller events to see cross-host skew.

    Metric family (labels ``plan``/``stage``/``op``/``scope``/``link``/
    ``group`` — ``group`` is the concurrent stripe index of a striped
    plan, ``"-"`` for plain plans):

    * ``plan_stage_seconds`` (histogram) — host-observed latency between
      a stage's begin and end edges (both stamped after a stream
      synchronize on the card);
    * ``plan_stage_bytes`` (counter) — wire bytes the stage moved
      (``_stage_wire_elem_bytes`` pricing, compression included).
    """

    def __init__(self, flight, registry, rep_rank: int = 0):
        self.flight = flight
        self.registry = registry
        self.rep_rank = int(rep_rank)
        self._begin: dict = {}
        if registry is not None:
            self._seconds = registry.histogram(
                "plan_stage_seconds",
                "host-observed per-stage latency of an executed plan")
            self._bytes = registry.counter(
                "plan_stage_bytes",
                "wire bytes moved per executed plan stage")

    def edge(self, edge: str, plan: str, stage: int, op: str, scope: str,
             link: str, nbytes: int, group: Optional[int] = None) -> None:
        now = time.perf_counter()
        key = (plan, group, stage)
        if self.flight is not None:
            kw = dict(plan=plan, stage=stage, op=op, scope=scope,
                      link=link, nbytes=nbytes)
            if group is not None:
                kw["group"] = group
            self.flight.record(f"plan_stage_{edge}", **kw)
        if self.registry is not None:
            labels = {"plan": plan, "stage": str(stage), "op": op,
                      "scope": scope, "link": link,
                      "group": str(group) if group is not None else "-"}
            if edge == "begin":
                self._begin[key] = now
            else:
                t0 = self._begin.pop(key, None)
                if t0 is not None:
                    self._seconds.observe(now - t0, **labels)
                self._bytes.inc(nbytes, **labels)


def get_plan_obs(comm=None) -> Optional[PlanObs]:
    """The build-time hook: ``None`` while observability is off (a
    disabled ``execute_plan`` makes no observability call).  With a
    communicator, the representative rank is its own rank (one process
    per GPU)."""
    from chainermn_tpu_torch.observability import flight_recorder as _flight
    from chainermn_tpu_torch.observability import registry as _registry

    fr = _flight.get_flight_recorder()
    reg = _registry.get_registry() if _registry.enabled() else None
    if fr is None and reg is None:
        return None
    rep = int(getattr(comm, "rank", 0) or 0) if comm is not None else 0
    return PlanObs(fr, reg, rep_rank=rep)


__all__ = [
    "LINK_ALIASES",
    "PlanObs",
    "Span",
    "build_step_trees",
    "get_plan_obs",
    "link_class",
    "pair_events",
    "phase_spans",
    "stage_link_timings",
    "step_windows",
]
