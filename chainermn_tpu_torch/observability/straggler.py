"""Cross-rank straggler telemetry.

Counterpart of ``chainermn_tpu/observability/straggler.py``. Every
controller (here: every process, one GPU each) keeps a rolling window of
its step wall times; on demand the per-rank summaries are allgathered
over the communicator's object plane (the gloo side group or a socket
control plane; a world of one is one summary) and ranks whose mean step
time exceeds ``threshold x median`` are flagged. This is the always-on
signal large runs need: a slow host (thermal throttle, noisy neighbor,
failing NIC) drags EVERY rank's step time under synchronous data
parallelism, and only a per-rank view says which one.

All participants must call :meth:`StragglerDetector.report` at the same
cadence (it is a collective over the control plane) — the
``MetricsReport`` extension drives it from iteration/epoch triggers,
which fire identically on every rank.
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import List, Optional


def summarize_durations(durations) -> dict:
    """Order statistics of a duration window: count/mean/p50/p95/max (and
    total) in seconds.  Pure function — the unit the cross-rank report
    aggregates."""
    ds = sorted(float(d) for d in durations)
    if not ds:
        return {"count": 0, "total_s": 0.0, "mean_s": None, "p50_s": None,
                "p95_s": None, "max_s": None}

    def q(p):
        pos = p * (len(ds) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(ds) - 1)
        return ds[lo] + (ds[hi] - ds[lo]) * (pos - lo)

    return {
        "count": len(ds),
        "total_s": sum(ds),
        "mean_s": sum(ds) / len(ds),
        "p50_s": q(0.5),
        "p95_s": q(0.95),
        "max_s": ds[-1],
    }


def straggler_report(summaries: List[dict], threshold: float = 1.5) -> dict:
    """Flag ranks whose mean step time exceeds ``threshold x median`` of
    the per-rank means.  ``summaries``: one :func:`summarize_durations`
    dict per rank, each carrying a ``rank`` key.  Pure function, so the
    aggregation is testable without a multi-host world."""
    if threshold <= 1.0:
        raise ValueError(f"threshold must be > 1 (got {threshold}): at 1.0 "
                         "every above-median rank would be a 'straggler'")
    means = [s["mean_s"] for s in summaries if s.get("mean_s") is not None]
    median = statistics.median(means) if means else None
    stragglers = []
    if median and median > 0:
        for s in summaries:
            if s.get("mean_s") is not None and s["mean_s"] > threshold * median:
                stragglers.append({
                    "rank": s.get("rank"),
                    "mean_s": s["mean_s"],
                    "ratio_vs_median": s["mean_s"] / median,
                })
    compute = []
    for s in summaries:
        compute.extend(s.get("compute_open", ()))
    compute.sort(key=lambda x: -float(x.get("age_s", 0.0)))
    return {
        "kind": "straggler_report",
        "n_ranks": len(summaries),
        "median_step_s": median,
        "threshold": threshold,
        "ranks": summaries,
        "stragglers": stragglers,
        "compute_stragglers": compute,
    }


class StragglerDetector:
    """Rolling per-rank step-time window + the cross-rank collective report.

    ``comm=None`` (or a single-host world) degrades to a local-only
    report — same schema, one rank.

    ``clock`` is an optional control-plane clock-handshake result
    (:func:`~chainermn_tpu_torch.observability.attribution.clock_handshake`,
    or one peer entry of ``Watchdog.clock_sync``): when present, the
    summaries carry offset-corrected global timestamps.  Compute
    straggler AGES never touch wall clocks at all — they come from each
    rank's monotonic clock via ``FlightRecorder.open_spans`` — so
    cross-host drift cannot mint phantom stragglers; the offset only
    places them on the shared timeline.
    """

    def __init__(self, comm=None, threshold: float = 1.5,
                 window_size: int = 512, clock: Optional[dict] = None):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        self._comm = comm
        self.threshold = float(threshold)
        self._durations = collections.deque(maxlen=int(window_size))
        self.clock = dict(clock) if clock else None

    def record(self, seconds: float) -> None:
        self._durations.append(float(seconds))

    def sync_clock(self, rounds: int = 8) -> dict:
        """Run the object-plane clock handshake (COLLECTIVE — every rank
        at the same point) and keep the result for timestamp
        correction."""
        from chainermn_tpu_torch.observability.attribution import clock_handshake

        self.clock = clock_handshake(self._comm, rounds=rounds)
        return self.clock

    def compute_stragglers(self, min_age_s: float = 0.0) -> List[dict]:
        """THIS rank's currently-open ``kind="compute"`` spans (e.g. a
        wedged quantizer), tagged with monotonic-clock ages and — when a
        clock handshake ran — offset-corrected global start stamps."""
        from chainermn_tpu_torch.observability import flight_recorder as _flight

        fr = _flight.get_flight_recorder()
        if fr is None:
            return []
        rank = self._comm.rank if self._comm is not None else 0
        offset = float((self.clock or {}).get("offset_s", 0.0))
        out = []
        for rec in fr.open_spans():
            if rec.get("kind") != "compute":
                continue
            age = float(rec.get("age_s", 0.0))
            if age < min_age_s:
                continue
            entry = {"op": rec.get("op"), "rank": rank, "age_s": age,
                     "clock": "monotonic"}
            if self.clock is not None:
                entry["t0_global"] = float(rec.get("ts", 0.0)) + offset
            out.append(entry)
        out.sort(key=lambda x: -x["age_s"])
        return out

    def local_summary(self) -> dict:
        s = summarize_durations(self._durations)
        s["rank"] = self._comm.rank if self._comm is not None else 0
        s["ts"] = time.time()
        s["mono_ts"] = time.monotonic()
        if self.clock is not None:
            s["clock_offset_s"] = float(self.clock.get("offset_s", 0.0))
            s["ts_global"] = s["ts"] + s["clock_offset_s"]
        open_compute = self.compute_stragglers()
        if open_compute:
            s["compute_open"] = open_compute
        return s

    def report(self, reset: bool = False) -> dict:
        """Allgather per-rank summaries and flag stragglers.

        COLLECTIVE over the control plane when the world has more than
        one controller: every rank must call it at the same point (drive
        it from a trainer trigger, which fires identically everywhere).
        """
        local = self.local_summary()
        if self._comm is not None and getattr(self._comm, "host_size", 1) > 1:
            summaries = self._comm.allgather_obj(local)
            summaries = sorted(summaries, key=lambda s: s.get("rank", 0))
        else:
            summaries = [local]
        if reset:
            self._durations.clear()
        return straggler_report(summaries, threshold=self.threshold)


class AttributionWatch:
    """Online per-bucket regression detection over step attributions.

    Feed it one :func:`~chainermn_tpu_torch.observability.attribution.
    attribute_step` result per completed step (``MetricsReport`` builds
    them from the flight recorder's incremental event slice).  Per
    bucket it keeps a rolling median baseline and:

    * sets ``attribution_bucket_seconds{bucket=...}`` gauges every step;
    * on ``value > factor x baseline`` (and above ``min_seconds``, with
      at least ``min_baseline`` steps banked) bumps
      ``attribution_regressions_total{bucket=...}``, records an
      ``attribution_regression`` flight event, and — when
      ``profile_dir`` is set — snapshots the flagged step with
      ``torch.profiler`` (CPU and CUDA activity, a Chrome trace written
      into ``profile_dir``): the capture starts at detection and stops
      after the NEXT observed step, so the trace brackets one regressed
      iteration.
    """

    def __init__(self, registry=None, flight=None, window: int = 64,
                 factor: float = 2.0, min_seconds: float = 1e-3,
                 min_baseline: int = 8,
                 profile_dir: Optional[str] = None):
        from chainermn_tpu_torch.observability import attribution as _attr
        from chainermn_tpu_torch.observability import flight_recorder as _flight
        from chainermn_tpu_torch.observability import registry as _registry

        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        self.buckets = _attr.BUCKETS
        self.factor = float(factor)
        self.min_seconds = float(min_seconds)
        self.min_baseline = int(min_baseline)
        self.profile_dir = profile_dir
        self._flight = flight if flight is not None \
            else _flight.get_flight_recorder()
        reg = registry if registry is not None else \
            (_registry.get_registry() if _registry.enabled() else None)
        self._reg = reg
        self._windows = {b: collections.deque(maxlen=int(window))
                         for b in self.buckets}
        self._profiling = False
        self._profiler = None
        self._profile_iter = None
        self.regressions: List[dict] = []
        if reg is not None:
            self._gauge = reg.gauge(
                "attribution_bucket_seconds",
                "per-step step-time attribution bucket (compute / "
                "ici_comm / dcn_comm / host_input / checkpoint / stall)")
            self._sum_frac = reg.gauge(
                "attribution_sum_frac",
                "sum of attribution buckets over measured step time "
                "(should stay within tolerance of 1.0)")
            self._regs = reg.counter(
                "attribution_regressions_total",
                "bucket regressions flagged by the rolling-baseline "
                "attribution watch")

    def _baseline(self, bucket: str) -> Optional[float]:
        w = sorted(self._windows[bucket])
        if len(w) < self.min_baseline:
            return None
        n = len(w)
        return w[n // 2] if n % 2 else 0.5 * (w[n // 2 - 1] + w[n // 2])

    def _profile_start(self, iteration) -> None:
        if self.profile_dir is None or self._profiling:
            return
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.__enter__()
            self._profile_iter = iteration
            self._profiling = True
        except Exception:
            self._profiling = False

    def _profile_stop(self) -> None:
        if not self._profiling:
            return
        try:
            import os
            self._profiler.__exit__(None, None, None)
            os.makedirs(self.profile_dir, exist_ok=True)
            self._profiler.export_chrome_trace(os.path.join(
                self.profile_dir,
                f"regression_{self._profile_iter}.trace.json"))
        except Exception:
            pass
        self._profiling = False
        self._profiler = None

    def observe(self, attribution: dict) -> List[dict]:
        """Bank one step's attribution; returns the regressions flagged
        on THIS step (empty list when healthy)."""
        buckets = attribution.get("buckets", {})
        iteration = attribution.get("iteration")
        # a capture started by the previous step's regression ends here,
        # having bracketed the flagged iteration
        self._profile_stop()
        if self._reg is not None:
            for b in self.buckets:
                self._gauge.set(float(buckets.get(b, 0.0)), bucket=b)
            self._sum_frac.set(float(attribution.get("sum_frac", 1.0)))
        flagged = []
        for b in self.buckets:
            val = float(buckets.get(b, 0.0))
            base = self._baseline(b)
            if (base is not None and val > self.factor * base
                    and val - base > self.min_seconds):
                reg = {"bucket": b, "value_s": val, "baseline_s": base,
                       "ratio": val / base if base > 0 else float("inf"),
                       "iteration": iteration}
                flagged.append(reg)
                if self._reg is not None:
                    self._regs.inc(1, bucket=b)
                if self._flight is not None:
                    self._flight.record("attribution_regression", **reg)
            self._windows[b].append(val)
        if flagged:
            self.regressions.extend(flagged)
            self._profile_start(iteration)
        return flagged


class StepTelemetry:
    """Per-step timing breakdown recorder the updaters drive.

    Installed on an updater (``updater.telemetry = StepTelemetry(...)``,
    normally by the ``MetricsReport`` extension); when it is ``None`` the
    updater takes its untimed fast path, so a disabled run makes zero
    observability calls per iteration.

    Phases per step (host clock, monotonic):

    * ``data_load``    — pulling the batch from the iterator (masked time
                         when a PrefetchIterator is in front);
    * ``host_put``     — assembling/sharding the global device batch;
    * ``dispatch``     — the step call returning (forward, backward and
                         the update enqueued on the card; on the CPU it
                         is the whole step);
    * ``device_block`` — waiting for the device to finish the step (a
                         stream synchronize on the card), i.e. time the
                         host waits on the device.
    """

    PHASES = ("data_load", "host_put", "dispatch", "device_block")

    def __init__(self, registry=None, comm=None,
                 straggler_threshold: float = 1.5,
                 window_size: int = 512):
        from chainermn_tpu_torch.observability import registry as _registry

        reg = registry or _registry.get_registry()
        self.registry = reg
        self._phase_hist = reg.histogram(
            "step_phase_seconds", "per-step phase breakdown")
        self._step_hist = reg.histogram(
            "step_seconds", "full host-visible step wall time")
        self._examples = reg.counter(
            "train_examples", "global examples consumed")
        self._iterations = reg.counter("train_iterations", "optimizer steps")
        self.straggler = StragglerDetector(
            comm, threshold=straggler_threshold, window_size=window_size)
        self.last: Optional[dict] = None

    def record_step(self, data_load: float, host_put: float, dispatch: float,
                    device_block: float, examples: int) -> None:
        total = data_load + host_put + dispatch + device_block
        self._phase_hist.observe(data_load, phase="data_load")
        self._phase_hist.observe(host_put, phase="host_put")
        self._phase_hist.observe(dispatch, phase="dispatch")
        self._phase_hist.observe(device_block, phase="device_block")
        self._step_hist.observe(total)
        self._examples.inc(examples)
        self._iterations.inc()
        self.straggler.record(total)
        self.last = {
            "data_load_s": data_load,
            "host_put_s": host_put,
            "dispatch_s": dispatch,
            "device_block_s": device_block,
            "step_s": total,
            "examples": examples,
        }
