"""Distributed flight recorder — the always-on event ring behind hang dumps.

Counterpart of ``chainermn_tpu/observability/flight_recorder.py``: the
same ring, event kinds and dump schema (:data:`DUMP_SCHEMA`).

The failure mode that kills multi-process runs is one rank wedged inside
a collective or a control-plane transfer while every other rank blocks
forever; steady-state metrics show *nothing* because nothing is
progressing.  Production collective stacks answer this with a bounded
per-process ring of structured events plus a watchdog that dumps the ring
when progress stalls (the NCCL / PyTorch "flight recorder" design).  This
module is the ring; :mod:`chainermn_tpu_torch.observability.watchdog` is
the watchdog.

What rides the ring (each event one small dict, O(1) to record):

* collective entry/exit — per-op sequence number, op, comm name, payload
  bytes (recorded by :class:`~chainermn_tpu_torch.observability.instrument.
  InstrumentedCommunicator`);
* transport frames — control-plane send/recv with peer, tag, byte count
  (:class:`~chainermn_tpu_torch.runtime.transport.PyTransport`);
* step-phase transitions and step completions (``StandardUpdater``);
* per-stage plan edges, FSDP bucket edges, serving spans and compression
  compute spans (their seams' observers).

Zero-cost-when-disabled: call sites obtain a recorder ONCE at
construction via :func:`get_flight_recorder`, which returns ``None``
while observability is off — a disabled hot loop carries a dormant
``None`` and performs no recording calls at all (same contract as the
metrics registry).

The dump (``flight_<rank>.json``, next to metrics.jsonl) carries the
ring, the per-op collective state (last-completed seq + open spans), the
Python stacks of every thread, and — when peers' states are given —
their collective states plus a desync analysis from
:func:`identify_desync`.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

from chainermn_tpu_torch.observability import registry as _registry
from chainermn_tpu_torch.observability.sinks import atomic_write_json

DUMP_SCHEMA = 1

_DEFAULT_CAPACITY = 4096


def _capacity_from_env() -> int:
    raw = os.environ.get("CHAINERMN_TPU_FLIGHT_CAPACITY")
    if not raw:
        return _DEFAULT_CAPACITY
    try:
        val = int(raw)
    except ValueError:
        return _DEFAULT_CAPACITY
    return val if val > 0 else _DEFAULT_CAPACITY


def thread_stacks() -> List[dict]:
    """Python stacks of every live thread (``sys._current_frames``), as
    plain data so they serialize into the dump.  The complementary
    ``faulthandler`` wiring in ``runtime/bootstrap.py`` covers crashes
    where the interpreter itself cannot run this."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        t = names.get(ident)
        out.append({
            "thread": t.name if t else f"thread-{ident}",
            "ident": ident,
            "daemon": bool(t.daemon) if t else None,
            "stack": [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)],
        })
    return out


class FlightRecorder:
    """Bounded ring of structured events + per-op collective state.

    Thread-safe; a record is a dict build plus a list store under a lock
    (the same overhead class as a Counter.inc).  ``capacity`` bounds
    memory no matter how long the run (oldest events overwritten).

    Spans (collective/p2p/transport-recv/checkpoint) are recorded as a
    ``*_begin`` event plus a ``*_end`` event and tracked in an
    open-span table while in flight — the watchdog's "collective open
    longer than the deadline" predicate reads that table, and the dump's
    desync analysis compares per-op last-completed sequence numbers
    across ranks.
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity if capacity else _capacity_from_env()
        self._buf: List[Optional[dict]] = [None] * self.capacity
        self._pos = 0
        self._event_seq = 0
        # ring-overflow accounting: every record() that overwrites a
        # still-live slot bumps this, so dumps can say how many events
        # the ring LOST instead of silently presenting a truncated
        # history as complete.
        self.dropped_events = 0
        self._lock = threading.Lock()
        self._span_seq = 0
        # per-op collective sequence numbers (key: op name) — the
        # cross-rank comparable state.  A collective is "completed" when
        # its end event records; an entry sits in _open until then.
        self._op_seq: Dict[str, int] = {}
        self._last_completed: Dict[str, int] = {}
        self._open: Dict[int, dict] = {}
        # step progress (trailing window for the watchdog's k x median)
        self._step_durations: List[float] = []
        self._step_window = 64
        self.steps = 0
        self.last_step_end: Optional[float] = None

    # ---- core recording ----------------------------------------------------
    def record(self, kind: str, **fields) -> dict:
        # both clocks: ``ts`` (wall) for cross-rank merging after offset
        # correction, ``mono`` (monotonic) for drift-immune local ages
        ev = {"kind": kind, "ts": time.time(), "mono": time.monotonic(),
              **fields}
        with self._lock:
            ev["seq"] = self._event_seq
            self._event_seq += 1
            if self._buf[self._pos] is not None:
                self.dropped_events += 1
            self._buf[self._pos] = ev
            self._pos = (self._pos + 1) % self.capacity
        return ev

    def events_since(self, seq: int) -> List[dict]:
        """Events with ``seq`` strictly greater than ``seq``, oldest
        first — the incremental slice online consumers (the attribution
        watch) pull per emit without re-walking the whole ring."""
        return [ev for ev in self.snapshot() if ev.get("seq", -1) > seq]

    def span_begin(self, kind: str, op: str, **fields) -> int:
        """Open a tracked span (collective / p2p / transport recv /
        checkpoint).  Returns a token for :meth:`span_end`.  ``op`` keys
        the per-op sequence numbering used for cross-rank desync
        comparison, so it must be identical on every rank for symmetric
        collectives."""
        with self._lock:
            self._span_seq += 1
            token = self._span_seq
            op_seq = self._op_seq.get(op, 0) + 1
            self._op_seq[op] = op_seq
        ev = self.record(f"{kind}_begin", op=op, op_seq=op_seq, **fields)
        with self._lock:
            self._open[token] = {"kind": kind, "op": op, "op_seq": op_seq,
                                 "ts": ev["ts"], "mono": ev["mono"],
                                 **fields}
        return token

    def span_end(self, token: int, **fields) -> None:
        with self._lock:
            open_rec = self._open.pop(token, None)
        if open_rec is None:
            return
        self.record(f"{open_rec['kind']}_end", op=open_rec["op"],
                    op_seq=open_rec["op_seq"],
                    dur_s=time.monotonic() - open_rec["mono"], **fields)
        with self._lock:
            prev = self._last_completed.get(open_rec["op"], 0)
            if open_rec["op_seq"] > prev:
                self._last_completed[open_rec["op"]] = open_rec["op_seq"]

    # ---- convenience entry points ------------------------------------------
    def collective_begin(self, op: str, comm: str = "",
                         nbytes: int = 0) -> int:
        return self.span_begin("collective", op, comm=comm, nbytes=nbytes)

    def collective_end(self, token: int) -> None:
        self.span_end(token)

    def record_step(self, duration_s: float, iteration: int) -> None:
        """One completed train step — the watchdog's progress heartbeat
        and the trailing-median baseline for the step-stall predicate."""
        self.record("step", iteration=iteration, dur_s=duration_s)
        with self._lock:
            self._step_durations.append(float(duration_s))
            if len(self._step_durations) > self._step_window:
                self._step_durations.pop(0)
            self.steps += 1
            self.last_step_end = time.time()

    def record_phase(self, phase: str, iteration: int) -> None:
        self.record("phase", phase=phase, iteration=iteration)

    # ---- state views -------------------------------------------------------
    def snapshot(self) -> List[dict]:
        """Ring contents, oldest first."""
        with self._lock:
            tail = [e for e in self._buf[self._pos:] if e is not None]
            head = [e for e in self._buf[:self._pos] if e is not None]
        return tail + head

    def open_spans(self, now: Optional[float] = None) -> List[dict]:
        """Currently-open spans with ``age_s``.  Ages come from the
        MONOTONIC clock (``now`` is only the wall-clock fallback for
        legacy records without a ``mono`` stamp) — an NTP step or
        cross-host drift can no longer mint phantom stragglers or
        phantom collective timeouts."""
        now = time.time() if now is None else now
        mono_now = time.monotonic()
        with self._lock:
            out = [dict(rec, age_s=(mono_now - rec["mono"])
                        if "mono" in rec else (now - rec["ts"]))
                   for rec in self._open.values()]
        return sorted(out, key=lambda r: r["ts"])

    def trailing_step_median(self) -> Optional[float]:
        with self._lock:
            w = sorted(self._step_durations)
        if not w:
            return None
        n = len(w)
        return w[n // 2] if n % 2 else 0.5 * (w[n // 2 - 1] + w[n // 2])

    def collective_state(self) -> dict:
        """The cross-rank comparable summary: per-op last-completed
        sequence numbers plus currently-open spans.  This is what the
        watchdog exchanges between ranks and what
        :func:`identify_desync` consumes."""
        with self._lock:
            last = dict(self._last_completed)
            steps = self.steps
            event_seq = self._event_seq
            dropped = self.dropped_events
        return {"last_completed": last, "open": self.open_spans(),
                "steps": steps, "event_seq": event_seq,
                "dropped_events": dropped, "ts": time.time(),
                "mono": time.monotonic()}

    # ---- the dump ----------------------------------------------------------
    def dump(self, out_dir: str = ".", rank: int = 0, reason: str = "",
             peers: Optional[Dict[int, dict]] = None,
             extra: Optional[dict] = None) -> str:
        """Write ``flight_<rank>.json`` (atomic rename; a crashed dumper
        never leaves a torn file).  Returns the path."""
        local_state = self.collective_state()
        doc = {
            "kind": "flight_dump",
            "schema": DUMP_SCHEMA,
            "rank": int(rank),
            "ts": time.time(),
            "reason": reason,
            # events the ring overwrote before this dump — a nonzero
            # count means the timeline below is missing its oldest part
            # (the restart-manifest evidence stamp reads all three)
            "dropped_events": int(self.dropped_events),
            "ring_capacity": int(self.capacity),
            "evidence_truncated": bool(self.dropped_events),
            "collective_state": local_state,
            "events": self.snapshot(),
            "threads": thread_stacks(),
        }
        if peers:
            doc["peers"] = {str(r): s for r, s in peers.items()}
            states = dict(peers)
            states[int(rank)] = local_state
            doc["analysis"] = identify_desync(states)
        if extra:
            doc.update(extra)
        os.makedirs(out_dir or ".", exist_ok=True)
        path = os.path.join(out_dir or ".", f"flight_{int(rank)}.json")
        atomic_write_json(path, doc)
        return path


# ---- cross-rank desync analysis (pure function; obs_report shares it) ------

def identify_desync(states: Dict[int, dict]) -> dict:
    """Name the desynchronized rank(s) from per-rank collective states.

    ``states`` maps rank -> ``collective_state()`` dict.  For every op
    with an open span anywhere, take the highest open sequence number N:
    the ranks blocked inside (op, N) are *waiting*; a rank whose position
    for that op (its open seq, else its last-completed seq) is behind N
    never entered the collective — it is the desynchronized one the
    others are waiting for.  Only collective/object spans participate
    (transport/p2p/checkpoint spans are local diagnostics, not symmetric
    across ranks).

    Open ``kind="compute"`` spans (e.g. the compression subsystem's
    compress/decompress regions) are reported separately as
    ``compute_stragglers``: a rank stuck in local compute is the CAUSE of
    a stall, not a wedged collective, and must not be misattributed to
    the wire — the slow-quantizer-looks-like-a-hang failure mode.
    """
    states = {int(r): s for r, s in states.items()}
    stalls: List[dict] = []
    desynced: set = set()
    compute_stragglers: List[dict] = []
    for r, s in states.items():
        for rec in s.get("open", ()):
            if rec.get("kind") == "compute":
                compute_stragglers.append({
                    "op": rec.get("op"),
                    "rank": r,
                    "age_s": float(rec.get("age_s", 0.0)),
                })
    compute_stragglers.sort(key=lambda x: -x["age_s"])
    ops = set()
    for s in states.values():
        for rec in s.get("open", ()):
            if rec.get("kind") in ("collective", "object"):
                ops.add(rec["op"])
    for op in sorted(ops):
        open_seqs = {}
        positions = {}
        for r, s in states.items():
            open_here = [rec for rec in s.get("open", ())
                         if rec.get("kind") in ("collective", "object")
                         and rec.get("op") == op]
            completed = int(s.get("last_completed", {}).get(op, 0))
            if open_here:
                open_seqs[r] = max(int(rec["op_seq"]) for rec in open_here)
                positions[r] = open_seqs[r]
            else:
                positions[r] = completed
        if not open_seqs:
            continue
        front = max(open_seqs.values())
        waiting = sorted(r for r, s in open_seqs.items() if s == front)
        behind = sorted(r for r, p in positions.items() if p < front)
        stalls.append({
            "op": op,
            "seq": front,
            "waiting_ranks": waiting,
            "desynced_ranks": behind,
            "positions": {str(r): positions[r] for r in sorted(positions)},
        })
        desynced.update(behind)
    return {
        "stalled_collectives": stalls,
        "desynced_ranks": sorted(desynced),
        "compute_stragglers": compute_stragglers,
        "n_ranks": len(states),
    }


# ---- process-wide recorder (same gating contract as the registry) ----------

_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_flight_recorder() -> Optional[FlightRecorder]:
    """The process-wide recorder, or ``None`` while observability is
    disabled.  Call sites bind the result ONCE at construction — a
    ``None`` handle is the zero-cost disabled path.  Lazily created on
    first enabled call, so ``observability.enable()`` before building
    communicators/updaters is the whole wiring."""
    if _RECORDER is not None:
        return _RECORDER
    if not _registry.enabled():
        return None
    return install_flight_recorder()


def install_flight_recorder(
        recorder: Optional[FlightRecorder] = None) -> FlightRecorder:
    """Force-install a recorder (tests; or recording while the metrics
    switch stays off).  Idempotent when one already exists and no
    replacement is given."""
    global _RECORDER
    with _RECORDER_LOCK:
        if recorder is not None:
            _RECORDER = recorder
        elif _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def reset_flight_recorder() -> None:
    """Drop the process-wide recorder (tests)."""
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = None


__all__ = [
    "DUMP_SCHEMA",
    "FlightRecorder",
    "get_flight_recorder",
    "identify_desync",
    "install_flight_recorder",
    "reset_flight_recorder",
    "thread_stacks",
]
