"""Session-affine routing over N inference-engine replicas.

Counterpart of ``chainermn_tpu/serving/router.py``: host logic over
:class:`~chainermn_tpu_torch.serving.engine.InferenceEngine` s.  One
replica is one lockstep serving world; the router spreads *requests*
(never tokens) across replicas by two rules:

* **Session affinity** -- every turn of a session lands on the replica that
  served its first turn, whose prefix cache already holds the session's
  shared prompt pages.
* **Least load** -- a session's FIRST turn goes to the replica with the
  lowest load signal: queue depth + active slots + page pressure (``1 -
  free/total``), ties to the lower index, so every controller that replays
  the same submits picks the same replica.

:meth:`Router.distribute_weights` is
:func:`~chainermn_tpu_torch.serving.weights.broadcast_inference_params`
through a planner multicast plan (hierarchical when the world spans
several nodes).  With observability on (bound at construction) the router
keeps JAX's ``serving_router_*`` metrics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Hashable, List, Optional, Tuple

from chainermn_tpu_torch.serving.engine import Completion, InferenceEngine


@dataclasses.dataclass
class ReplicaStatus:
    """One replica's load signals (the dispatch inputs)."""

    replica: int
    queue_depth: int
    active: int
    free_pages: int
    num_pages: int

    @property
    def page_pressure(self) -> float:
        return 1.0 - self.free_pages / max(self.num_pages, 1)

    @property
    def load(self) -> float:
        return self.queue_depth + self.active + self.page_pressure


class Router:
    """Session-affine dispatch over ``engines`` (one per replica).

    ``submit()`` returns a router-scoped request id; ``step()`` advances
    every busy replica one engine step; ``run_until_idle()`` drains the
    fleet.  Completions aggregate in :attr:`completions` as
    ``(replica, session, Completion)`` triples.
    """

    def __init__(self, engines: List[InferenceEngine]):
        if not engines:
            raise ValueError("Router needs at least one engine replica")
        self.engines = list(engines)
        self._session_replica: Dict[Hashable, int] = {}
        self._rid_map: Dict[int, Tuple[int, int]] = {}  # router -> (rep, rid)
        self._session_of: Dict[Tuple[int, int], Hashable] = {}
        self._next_rid = 0
        self.dispatch_log: List[Tuple[int, Hashable, int]] = []
        self.completions: List[Tuple[int, Hashable, Completion]] = []
        self._claimed: Dict[int, int] = {}  # per-replica completions seen
        # elastic bookkeeping: what each live rid asked for (so a lost
        # replica's in-flight requests can be replayed), which replicas
        # are drained out of dispatch, and the work each drain stranded
        self._requests: Dict[int, Tuple[object, int, Optional[Hashable]]] = {}
        self._drained: set = set()
        self._lost: Dict[int, List[int]] = {}

        from chainermn_tpu_torch.observability.registry import (
            enabled, get_registry)
        self._m = None
        if enabled():
            reg = get_registry()
            self._m = {
                "dispatched": reg.counter(
                    "serving_router_dispatched",
                    "requests dispatched to replicas"),
                "sessions": reg.gauge(
                    "serving_router_sessions", "distinct sessions seen"),
                "load": reg.gauge(
                    "serving_router_replica_load",
                    "per-replica load signal at last dispatch"),
            }

    # -- load signals --------------------------------------------------------
    def status(self) -> List[ReplicaStatus]:
        out = []
        for i, eng in enumerate(self.engines):
            if i in self._drained:
                # a drained replica's engine may be a dead world — it
                # must neither be probed nor dispatched to
                out.append(ReplicaStatus(replica=i, queue_depth=0,
                                         active=0, free_pages=0,
                                         num_pages=0))
                continue
            sched = eng.scheduler
            out.append(ReplicaStatus(
                replica=i, queue_depth=sched.queue_depth,
                active=sched.active_count,
                free_pages=sched.allocator.num_free,
                num_pages=sched.num_pages))
        return out

    def _pick_replica(self, session: Optional[Hashable]) -> int:
        if session is not None and session in self._session_replica:
            rep = self._session_replica[session]
            if rep not in self._drained:
                return rep
            del self._session_replica[session]  # re-route the session
        st = [s for s in self.status() if s.replica not in self._drained]
        if not st:
            raise RuntimeError(
                "every replica is drained — readmit one "
                "(Router.readmit_replica) before submitting")
        best = min(st, key=lambda s: (s.load, s.replica))
        if session is not None:
            self._session_replica[session] = best.replica
        return best.replica

    # -- client side ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               session: Optional[Hashable] = None,
               arrival: Optional[float] = None) -> int:
        """Dispatch a request; same ``session`` -> same replica."""
        arrival = time.perf_counter() if arrival is None else arrival
        rep = self._pick_replica(session)
        eng_rid = self.engines[rep].submit(prompt, max_new_tokens,
                                           arrival=arrival)
        rid = self._next_rid
        self._next_rid += 1
        self._rid_map[rid] = (rep, eng_rid)
        self._session_of[(rep, eng_rid)] = session
        self._requests[rid] = (prompt, max_new_tokens, session)
        self.dispatch_log.append((rid, session, rep))
        if self._m is not None:
            self._m["dispatched"].inc(replica=str(rep))
            self._m["sessions"].set(len(self._session_replica))
            self._m["load"].set(self.status()[rep].load,
                                replica=str(rep))
        return rid

    def replica_of(self, rid: int) -> int:
        return self._rid_map[rid][0]

    def idle(self) -> bool:
        return all(e.idle() for i, e in enumerate(self.engines)
                   if i not in self._drained)

    # -- the fleet step loop -------------------------------------------------
    def _collect(self, rep: int) -> None:
        comps = self.engines[rep].completions
        seen = self._claimed.get(rep, 0)
        for comp in comps[seen:]:
            self.completions.append(
                (rep, self._session_of.get((rep, comp.rid)), comp))
        self._claimed[rep] = len(comps)

    def step(self) -> int:
        """Step every busy replica once; returns how many stepped."""
        stepped = 0
        for i, eng in enumerate(self.engines):
            if i in self._drained:
                continue
            if not eng.idle():
                eng.step()
                self._collect(i)
                stepped += 1
        return stepped

    def run_until_idle(self, max_steps: int = 10_000) \
            -> List[Tuple[int, Hashable, Completion]]:
        start = len(self.completions)
        for _ in range(max_steps):
            if self.idle():
                break
            self.step()
        else:
            raise RuntimeError(
                f"fleet still busy after {max_steps} steps: "
                f"{[(s.replica, s.queue_depth, s.active) for s in self.status()]}")
        return self.completions[start:]

    # -- elastic fleet membership --------------------------------------------
    def drain_replica(self, rep: int) -> Dict[str, object]:
        """Take a lost replica out of dispatch (supervisor ``on_incident``
        hook).

        Its session affinities are forgotten — the next turn of each
        session re-routes by least load, re-prefilling on the new home —
        and every request the replica had not completed is replayed onto
        a surviving replica under the SAME router rid, so callers'
        handles stay valid and at most the lost replica's in-flight
        decode work is repeated, never dropped.  Returns a summary dict
        (``sessions_rerouted``, ``requests_replayed``).
        """
        if not (0 <= rep < len(self.engines)):
            raise ValueError(f"no replica {rep} (fleet size "
                             f"{len(self.engines)})")
        self._drained.add(rep)

        done = {(r, c.rid) for r, _s, c in self.completions if r == rep}
        stranded = [rid for rid, (r, erid) in self._rid_map.items()
                    if r == rep and (r, erid) not in done]
        self._lost[rep] = list(stranded)

        moved_sessions = [s for s, r in self._session_replica.items()
                          if r == rep]
        for s in moved_sessions:
            del self._session_replica[s]

        replayed = 0
        for rid in stranded:
            prompt, max_new, session = self._requests[rid]
            old_rep, old_erid = self._rid_map[rid]
            self._session_of.pop((old_rep, old_erid), None)
            new_rep = self._pick_replica(session)
            new_erid = self.engines[new_rep].submit(prompt, max_new)
            self._rid_map[rid] = (new_rep, new_erid)
            self._session_of[(new_rep, new_erid)] = session
            self.dispatch_log.append((rid, session, new_rep))
            replayed += 1
            if self._m is not None:
                self._m["dispatched"].inc(replica=str(new_rep))
        return {"replica": rep, "sessions_rerouted": len(moved_sessions),
                "requests_replayed": replayed}

    def readmit_replica(self, rep: int, engine=None) -> None:
        """Return a drained replica to dispatch (supervisor
        ``on_recovered`` hook).  Pass ``engine`` when the restarted world
        came back as a fresh :class:`InferenceEngine` — its completion
        list starts empty, so the claim cursor resets with it.  New
        first-turn sessions may now land on it; replayed requests stay
        where the drain put them.
        """
        if rep not in self._drained:
            raise ValueError(f"replica {rep} is not drained")
        if engine is not None:
            self.engines[rep] = engine
            self._claimed[rep] = 0
        self._drained.discard(rep)
        self._lost.pop(rep, None)

    @property
    def drained(self) -> frozenset:
        return frozenset(self._drained)

    # -- fleet weight distribution -------------------------------------------
    @staticmethod
    def distribute_weights(comm, params, root: int = 0, *, plan=None):
        """Root's params on every rank of ``comm`` (bit for bit), through a
        planner multicast plan: by default hierarchical multicast (an intra
        stage, then one inter-node crossing a node) when the world spans
        several nodes, flat multicast otherwise."""
        from chainermn_tpu_torch.serving.weights import (
            broadcast_inference_params, weights_multicast_plan)

        if plan is None:
            topo = comm.plan_topology()
            hier = any(n == "inter" and size > 1 for n, size in topo.axes)
            plan = weights_multicast_plan(root=root, hierarchical=hier,
                                          topology=topo,
                                          name="router_weights")
        return broadcast_inference_params(comm, params, root=root,
                                          plan=plan)


__all__ = ["ReplicaStatus", "Router"]
