"""Collective hang watchdog — turns a silent wedge into a dump.

Counterpart of ``chainermn_tpu/observability/watchdog.py``: the same
predicates, knobs (``CHAINERMN_TPU_WATCHDOG_*``), peer exchange and dump
(:meth:`~chainermn_tpu_torch.observability.FlightRecorder.dump`, JAX's
schema).

Companion to :mod:`chainermn_tpu_torch.observability.flight_recorder`: a
daemon thread that watches the recorder for no-progress conditions and,
when one fires, writes ``flight_<rank>.json`` (ring buffer + all-thread
stacks + cross-rank collective state) instead of letting the run hold
its cards silently.

Three stall predicates (all knobs are env-tunable, see
:class:`WatchdogConfig`):

* **collective deadline** — any tracked span (collective, object op,
  control-plane recv) open longer than ``deadline_s``.  On the card an
  NCCL collective's span closes once the call is enqueued, so this sees
  the host-blocking operations: the object plane, the host-staged
  flavors and waits;
* **step stall** — no step completed for ``step_stall_factor`` x the
  trailing-median step time (after 5 steps).  This is what catches a
  device-side hang: the host then sits in the step's synchronize with no
  span open;
* **heartbeat loss** — a peer stopped sending watchdog heartbeats over
  the socket control plane (its process died or wedged below the GIL).

The monitor, heartbeat and listen threads are daemon threads: the main
thread blocked in ``torch.cuda.synchronize`` or in a gloo call releases
the GIL, so they keep running and the watchdog's own thread writes the
dump (a Python signal handler would wait for the blocked call to
return).

On stall the watchdog broadcasts its collective state to every peer on
the reserved ``flight`` tag of the control plane's transport, collects
their states for a bounded window, and dumps with a desync analysis
naming the rank(s) the world is waiting for.  A rank *receiving* a
peer's stall notice replies with its own state and dumps too, so every
reachable rank leaves an artifact.  Without a socket control plane (a
transport with a timed recv) the dump is local-only and says so
(``"exchange": "local-only"``).

Start it with :func:`start_watchdog`, which returns ``None`` when
observability is disabled: a disabled run starts **zero** watchdog
threads.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

from chainermn_tpu_torch.observability import flight_recorder as _flight
from chainermn_tpu_torch.runtime.control_plane import reserved_tag

# Dedicated control-plane tag namespace for watchdog traffic, claimed as
# the "flight" band in runtime.control_plane.RESERVED_TAG_BANDS.  Far
# above the collective tags (tag<~1000), the p2p grad tags (1<<20) and
# meta tags (1<<21), so watchdog messages never collide with training
# traffic; the transport keeps it out of the flight ring.
FLIGHT_TAG = reserved_tag("flight")

_THREAD_PREFIX = "chainermn-tpu-watchdog"


def _env_float(env: Dict[str, str], name: str, default: float) -> float:
    raw = env.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclass(frozen=True)
class WatchdogConfig:
    """Watchdog knobs; each maps 1:1 to an env var so a launcher can tune
    a fleet without code changes (``CHAINERMN_TPU_WATCHDOG_*``,
    ``CHAINERMN_TPU_FLIGHT_DIR``).  ``from_env``/``to_env`` round-trip,
    so a launcher can hand a config to its ranks."""

    deadline_s: float = 300.0           # CHAINERMN_TPU_WATCHDOG_DEADLINE
    step_stall_factor: float = 8.0      # CHAINERMN_TPU_WATCHDOG_STEP_K
    heartbeat_interval_s: float = 10.0  # CHAINERMN_TPU_WATCHDOG_HEARTBEAT
    heartbeat_timeout_s: float = 30.0   # CHAINERMN_TPU_WATCHDOG_HB_TIMEOUT
    poll_interval_s: float = 1.0        # CHAINERMN_TPU_WATCHDOG_POLL
    collect_window_s: float = 2.0       # CHAINERMN_TPU_WATCHDOG_COLLECT
    max_dumps: int = 3                  # CHAINERMN_TPU_WATCHDOG_MAX_DUMPS
    out_dir: str = "."                  # CHAINERMN_TPU_FLIGHT_DIR

    _ENV = {
        "deadline_s": "CHAINERMN_TPU_WATCHDOG_DEADLINE",
        "step_stall_factor": "CHAINERMN_TPU_WATCHDOG_STEP_K",
        "heartbeat_interval_s": "CHAINERMN_TPU_WATCHDOG_HEARTBEAT",
        "heartbeat_timeout_s": "CHAINERMN_TPU_WATCHDOG_HB_TIMEOUT",
        "poll_interval_s": "CHAINERMN_TPU_WATCHDOG_POLL",
        "collect_window_s": "CHAINERMN_TPU_WATCHDOG_COLLECT",
        "max_dumps": "CHAINERMN_TPU_WATCHDOG_MAX_DUMPS",
        "out_dir": "CHAINERMN_TPU_FLIGHT_DIR",
    }

    # Timeout/interval knobs that must be > 0: a launcher exporting a
    # zero or negative value would not "turn the check off", it would
    # silently break the predicate (a <=0 deadline fires on every open
    # span; a <=0 heartbeat timeout declares every peer dead).  The
    # deliberate off-switch is CHAINERMN_TPU_WATCHDOG_HEARTBEAT<=0
    # (heartbeat_interval_s), which start() honors by not spawning the
    # heartbeat thread — so that one knob stays out of this set.
    _POSITIVE = ("deadline_s", "step_stall_factor",
                 "heartbeat_timeout_s", "poll_interval_s",
                 "collect_window_s")

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None,
                 **overrides) -> "WatchdogConfig":
        env = os.environ if env is None else env
        base = cls()
        kw = {}
        for field, var in cls._ENV.items():
            if field == "out_dir":
                kw[field] = env.get(var) or base.out_dir
            elif field == "max_dumps":
                kw[field] = int(_env_float(env, var, base.max_dumps))
            else:
                val = _env_float(env, var, getattr(base, field))
                if field in cls._POSITIVE and val <= 0:
                    raise ValueError(
                        f"{var}={env.get(var)!r} parses to {val:g} — a "
                        f"non-positive value would silently break the "
                        f"{field} stall predicate instead of disabling "
                        f"it; set {var} to a positive number or unset "
                        f"it to use the default "
                        f"({getattr(base, field):g})")
                kw[field] = val
        kw.update(overrides)
        return cls(**kw)

    def to_env(self) -> Dict[str, str]:
        """The env mapping that reproduces this config via ``from_env``
        (``from_env(env=cfg.to_env()) == cfg``)."""
        out = {}
        for field, var in self._ENV.items():
            v = getattr(self, field)
            out[var] = v if isinstance(v, str) else repr(v)
        return out

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self._ENV}


class Watchdog:
    """The watchdog threads.  Use :func:`start_watchdog` rather than
    constructing directly — it owns the observability gating."""

    def __init__(self, recorder: _flight.FlightRecorder,
                 config: WatchdogConfig,
                 control_plane=None, rank: Optional[int] = None):
        self._rec = recorder
        self._cfg = config
        self._plane = control_plane
        self.rank = int(rank if rank is not None
                        else getattr(control_plane, "rank", 0) or 0)
        self.size = int(getattr(control_plane, "size", 1) or 1)
        # Peer exchange needs a transport with timed recv (the socket
        # control plane); anything else degrades to local-only dumps,
        # which say so.
        self._tp = getattr(control_plane, "_tp", None)
        self._peers = [r for r in range(self.size) if r != self.rank] \
            if (self._tp is not None and self.size > 1) else []
        self._closed = threading.Event()
        self._threads: List[threading.Thread] = []
        self._trigger_lock = threading.Lock()
        self._incidents: set = set()
        self._peer_states: Dict[int, dict] = {}
        self._hb_seen: Dict[int, float] = {}
        # clock handshake state: per-peer (t_send, t_peer_wall, t_recv)
        # NTP samples collected by the listen threads, and the offsets
        # clock_sync() last derived from them (embedded in every dump so
        # attribution can merge cross-host timelines drift-corrected)
        self._clock_samples: Dict[int, List[tuple]] = {}
        self.clock_offsets: Dict[int, dict] = {}
        self._started_at = time.time()
        self.dump_paths: List[str] = []
        self.incidents: List[dict] = []

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> "Watchdog":
        self._started_at = time.time()
        self._spawn(self._monitor_loop, f"{_THREAD_PREFIX}-monitor")
        for src in self._peers:
            self._spawn(lambda s=src: self._listen_loop(s),
                        f"{_THREAD_PREFIX}-listen-{src}")
        if self._peers and self._cfg.heartbeat_interval_s > 0:
            self._spawn(self._heartbeat_loop, f"{_THREAD_PREFIX}-heartbeat")
        return self

    def _spawn(self, target, name):
        t = threading.Thread(target=target, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self, join_timeout: float = 5.0) -> None:
        self._closed.set()
        for t in self._threads:
            t.join(timeout=join_timeout)

    @property
    def stopped(self) -> bool:
        return self._closed.is_set()

    # ---- stall predicates --------------------------------------------------
    def _check(self) -> Optional[str]:
        now = time.time()
        for rec in self._rec.open_spans(now):
            if rec["age_s"] > self._cfg.deadline_s:
                label = ("collective_timeout"
                         if rec["kind"] in ("collective", "object")
                         else "span_timeout")
                return (f"{label}:{rec['op']} seq={rec['op_seq']} "
                        f"open {rec['age_s']:.1f}s "
                        f"(deadline {self._cfg.deadline_s:.1f}s)")
        med = self._rec.trailing_step_median()
        last_end = self._rec.last_step_end
        if (med is not None and last_end is not None
                and self._rec.steps >= 5):
            quiet = now - last_end
            limit = max(self._cfg.step_stall_factor * med,
                        2 * self._cfg.poll_interval_s)
            if quiet > limit:
                return (f"step_stall: no step for {quiet:.1f}s "
                        f"({self._cfg.step_stall_factor:g}x trailing "
                        f"median {med:.3f}s)")
        if self._peers and self._cfg.heartbeat_interval_s > 0:
            for src in self._peers:
                seen = self._hb_seen.get(src, self._started_at)
                if now - seen > self._cfg.heartbeat_timeout_s:
                    return (f"heartbeat_loss:rank{src} "
                            f"last seen {now - seen:.1f}s ago")
        return None

    # ---- threads -----------------------------------------------------------
    def _monitor_loop(self):
        while not self._closed.wait(self._cfg.poll_interval_s):
            try:
                reason = self._check()
            except Exception:
                continue
            if reason is not None:
                self._trigger(reason, broadcast=True)

    def _heartbeat_loop(self):
        while not self._closed.wait(self._cfg.heartbeat_interval_s):
            self._send_all({"kind": "hb", "rank": self.rank,
                            "ts": time.time()})

    def _listen_loop(self, src: int):
        while not self._closed.is_set():
            try:
                payload = self._tp.recv(src, FLIGHT_TAG,
                                        timeout=self._cfg.poll_interval_s)
            except TimeoutError:
                continue
            except Exception:
                if self._closed.is_set():
                    return
                time.sleep(self._cfg.poll_interval_s)
                continue
            try:
                msg = pickle.loads(payload)
            except Exception:
                continue
            kind = msg.get("kind")
            if kind == "hb":
                self._hb_seen[src] = time.time()
            elif kind == "stall":
                self._hb_seen[src] = time.time()
                self._peer_states[src] = msg.get("state", {})
                self._send(src, {"kind": "state_reply",
                                 "incident": msg.get("incident"),
                                 "rank": self.rank,
                                 "state": self._rec.collective_state()})
                self._trigger(f"peer_stall:rank{src} ({msg.get('reason')})",
                              broadcast=False,
                              incident=msg.get("incident"))
            elif kind == "state_reply":
                self._peer_states[src] = msg.get("state", {})
            elif kind == "clock_probe":
                self._send(src, {"kind": "clock_reply", "rank": self.rank,
                                 "probe": msg.get("probe"),
                                 "wall": time.time()})
            elif kind == "clock_reply":
                probe = msg.get("probe") or {}
                t_send = probe.get("t_send")
                if t_send is not None:
                    self._clock_samples.setdefault(src, []).append(
                        (float(t_send), float(msg.get("wall", 0.0)),
                         time.time()))

    # ---- the control-plane clock handshake ---------------------------------
    def clock_sync(self, rounds: int = 4,
                   window_s: Optional[float] = None) -> Dict[int, dict]:
        """Estimate per-peer wall-clock offsets over the watchdog's
        control-plane tag: each round sends a ``clock_probe`` stamped
        with the local send time, peers echo it back in a
        ``clock_reply`` carrying their wall clock, and the listen
        threads bank the ``(t_send, t_peer, t_recv)`` samples.  The NTP
        midpoint of the min-RTT sample per peer
        (:func:`~chainermn_tpu_torch.observability.attribution.
        offset_from_samples`) gives ``local_ts + offset_s`` ≈ the same
        instant on that peer's clock — what the attribution merge and
        the straggler detector use instead of trusting raw wall clocks
        across hosts.  Best-effort: unreachable peers simply stay
        absent from the result."""
        from chainermn_tpu_torch.observability.attribution import \
            offset_from_samples

        if not self._peers:
            self.clock_offsets = {}
            return {}
        if window_s is None:
            window_s = self._cfg.collect_window_s
        rounds = max(int(rounds), 1)
        for _ in range(rounds):
            self._send_all({"kind": "clock_probe", "rank": self.rank,
                            "probe": {"t_send": time.time()}})
            time.sleep(min(max(window_s, 0.05) / rounds, 0.25))
        deadline = time.time() + window_s
        while (time.time() < deadline and not self._closed.is_set()
               and any(not self._clock_samples.get(p)
                       for p in self._peers)):
            time.sleep(0.02)
        out: Dict[int, dict] = {}
        for p in self._peers:
            samples = self._clock_samples.get(p)
            if samples:
                off, rtt = offset_from_samples(samples)
                out[p] = {"offset_s": off, "rtt_s": rtt,
                          "samples": len(samples)}
        self.clock_offsets = out
        return out

    # ---- messaging (best-effort: a dead peer must not kill the dump) -------
    def _send(self, dest: int, msg: dict):
        try:
            self._tp.send(dest, FLIGHT_TAG,
                          pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))
        except Exception:
            pass

    def _send_all(self, msg: dict):
        for dest in self._peers:
            self._send(dest, msg)

    # ---- the dump ----------------------------------------------------------
    def _trigger(self, reason: str, broadcast: bool,
                 incident: Optional[str] = None) -> Optional[str]:
        with self._trigger_lock:
            if len(self.dump_paths) >= self._cfg.max_dumps:
                return None
            if incident is None:
                incident = f"{self.rank}:{len(self._incidents)}"
            if incident in self._incidents:
                return None
            self._incidents.add(incident)
        state = self._rec.collective_state()
        if broadcast and self._peers:
            self._send_all({"kind": "stall", "incident": incident,
                            "rank": self.rank, "reason": reason,
                            "state": state})
        if self._peers:
            # Collect peer states for a bounded window — every reachable
            # peer replied or the window closed; either way we dump.
            deadline = time.time() + self._cfg.collect_window_s
            while (time.time() < deadline
                   and len(self._peer_states) < len(self._peers)
                   and not self._closed.is_set()):
                time.sleep(0.05)
        if self._peers and not self.clock_offsets:
            try:  # best-effort: the dump must not hang on a dead peer
                self.clock_sync(
                    rounds=2,
                    window_s=min(1.0, self._cfg.collect_window_s))
            except Exception:
                pass
        extra = {"incident": incident, "world_size": self.size,
                 "exchange": "peers" if self._peers else "local-only",
                 "watchdog": self._cfg.as_dict()}
        if self.clock_offsets:
            extra["clock"] = {"rank": self.rank,
                              "offsets": {str(r): dict(d) for r, d in
                                          self.clock_offsets.items()}}
        path = self._rec.dump(
            out_dir=self._cfg.out_dir, rank=self.rank, reason=reason,
            peers=dict(self._peer_states) or None, extra=extra)
        self.dump_paths.append(path)
        self.incidents.append({"incident": incident, "reason": reason,
                               "path": path, "ts": time.time()})
        return path

    def dump_now(self, reason: str = "manual") -> Optional[str]:
        """Force a dump through the full cross-rank exchange path (crash
        handlers and tests)."""
        return self._trigger(reason, broadcast=bool(self._peers))


def watchdog_thread_count() -> int:
    """Live watchdog threads in this process (zero when observability is
    disabled, and after :meth:`Watchdog.stop`)."""
    return sum(1 for t in threading.enumerate()
               if t.name.startswith(_THREAD_PREFIX))


def start_watchdog(recorder: Optional[_flight.FlightRecorder] = None,
                   control_plane=None,
                   config: Optional[WatchdogConfig] = None,
                   out_dir: Optional[str] = None,
                   force: bool = False, rank: Optional[int] = None,
                   **overrides) -> Optional[Watchdog]:
    """Start the hang watchdog; returns ``None`` (and starts **zero**
    threads) when observability is disabled and ``force`` is not set.

    ``overrides`` are :class:`WatchdogConfig` fields (e.g.
    ``deadline_s=30``); ``out_dir`` is where ``flight_<rank>.json``
    lands (next to metrics.jsonl when started by ``MetricsReport``);
    ``rank`` names the dump when there is no control plane to take it
    from (one process per GPU: each rank's own).
    """
    rec = recorder if recorder is not None else _flight.get_flight_recorder()
    if rec is None:
        if not force:
            return None
        rec = _flight.install_flight_recorder()
    cfg = config or WatchdogConfig.from_env(**overrides)
    if config is not None and overrides:
        cfg = replace(cfg, **overrides)
    if out_dir is not None:
        cfg = replace(cfg, out_dir=out_dir)
    return Watchdog(rec, cfg, control_plane=control_plane,
                    rank=rank).start()


__all__ = [
    "FLIGHT_TAG",
    "Watchdog",
    "WatchdogConfig",
    "start_watchdog",
    "watchdog_thread_count",
]
