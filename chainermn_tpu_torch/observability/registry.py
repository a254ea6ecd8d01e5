"""Process-wide metrics registry: counters, gauges, histograms, timers.

Counterpart of ``chainermn_tpu/observability/registry.py``, the same
classes, metric kinds and snapshot records.  Design constraints:

* **low overhead** — a metric update is a dict lookup plus a float add
  under a lock that is only ever contended by the prefetch thread;
  histogram quantiles come from a bounded reservoir, so memory is O(1)
  per series no matter how long the run;
* **labels** — every update may carry keyword labels; each distinct
  label combination is its own series (the Prometheus data model);
* **zero-cost-when-disabled** — the registry itself is always live
  (tests and tools use it directly), but the trainer/communicator call
  sites consult :func:`enabled` once at construction and keep a
  ``None`` handle when it is off, so a disabled hot loop performs no
  observability work at all.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared per-series bookkeeping: ``self._series[label_key] -> state``."""

    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[_LabelKey, object] = {}
        self._lock = threading.Lock()

    def labels_seen(self) -> List[dict]:
        with self._lock:
            return [dict(k) for k in self._series]

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    """Monotonically increasing value (calls, bytes, examples)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [{"name": self.name, "type": "counter",
                     "labels": dict(k), "value": float(v)}
                    for k, v in self._series.items()]


class Gauge(_Metric):
    """Last-write-wins value (queue depth, devices, epoch)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [{"name": self.name, "type": "gauge",
                     "labels": dict(k), "value": float(v)}
                    for k, v in self._series.items()]


class Histogram(_Metric):
    """Distribution summary: exact count/sum/min/max plus quantiles over a
    bounded ring of the most recent ``window_size`` observations (recency
    beats exactness for runtime telemetry — a straggler shows up in the
    last 1024 steps, not in the run-lifetime distribution)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", window_size: int = 1024):
        super().__init__(name, help)
        self._window_size = int(window_size)
        self._pos: Dict[_LabelKey, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        value = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"count": 0, "sum": 0.0, "min": math.inf,
                     "max": -math.inf, "window": []}
                self._series[key] = s
                self._pos[key] = 0
            s["count"] += 1
            s["sum"] += value
            if value < s["min"]:
                s["min"] = value
            if value > s["max"]:
                s["max"] = value
            w = s["window"]
            if len(w) < self._window_size:
                w.append(value)
            else:  # ring overwrite: keep the most recent window_size values
                w[self._pos[key] % self._window_size] = value
            self._pos[key] = (self._pos.get(key, 0) + 1) % max(
                self._window_size, 1)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return int(s["count"]) if s else 0

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return float(s["sum"]) if s else 0.0

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Linear-interpolated quantile over the recent window (None when
        no observations)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            s = self._series.get(_label_key(labels))
            if not s or not s["window"]:
                return None
            w = sorted(s["window"])
        if len(w) == 1:
            return w[0]
        pos = q * (len(w) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(w) - 1)
        return w[lo] + (w[hi] - w[lo]) * (pos - lo)

    _QUANTILES = (0.5, 0.9, 0.99)

    def snapshot(self) -> List[dict]:
        with self._lock:
            items = [(dict(k), dict(s, window=list(s["window"])))
                     for k, s in self._series.items()]
        out = []
        for labels, s in items:
            w = sorted(s["window"])

            def q(p):
                if not w:
                    return None
                pos = p * (len(w) - 1)
                lo = int(math.floor(pos))
                hi = min(lo + 1, len(w) - 1)
                return w[lo] + (w[hi] - w[lo]) * (pos - lo)

            out.append({
                "name": self.name, "type": "histogram", "labels": labels,
                "count": int(s["count"]), "sum": float(s["sum"]),
                "min": None if s["count"] == 0 else float(s["min"]),
                "max": None if s["count"] == 0 else float(s["max"]),
                "quantiles": {str(p): q(p) for p in self._QUANTILES},
            })
        return out


class StreamingHistogram(_Metric):
    """Mergeable latency distribution over FIXED log-spaced buckets —
    the fleet-telemetry metric kind.

    A :class:`Histogram` keeps a reservoir of raw values, which cannot
    be combined across ranks; this kind keeps per-bucket counts on a
    log grid fixed at construction, so rank 0 merges peers' shipped
    states with an elementwise add (:meth:`merge`) and percentiles of
    the FLEET distribution stay exact to bucket resolution.  Exported
    quantiles are p50/p95/p99 (the serving SLO gauges); the Prometheus
    sink renders the buckets as a native cumulative histogram.

    Bucket ``i`` counts observations in ``(bounds[i-1], bounds[i]]``
    (bucket 0: ``(-inf, bounds[0]]``); one overflow bucket past
    ``hi``.  ``buckets_per_decade`` sets resolution (~29% relative
    error at the default 9/decade).
    """

    kind = "streaming_histogram"

    _QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, name: str, help: str = "", lo: float = 1e-5,
                 hi: float = 1e3, buckets_per_decade: int = 9):
        super().__init__(name, help)
        if not (lo > 0.0 and hi > lo):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.buckets_per_decade = int(buckets_per_decade)
        decades = math.log10(self.hi) - math.log10(self.lo)
        n = int(math.ceil(decades * self.buckets_per_decade)) + 1
        self.bounds: Tuple[float, ...] = tuple(
            self.lo * 10.0 ** (i / self.buckets_per_decade)
            for i in range(n))

    def _new_series(self) -> dict:
        return {"counts": [0] * (len(self.bounds) + 1),
                "sum": 0.0, "count": 0}

    def _bucket_index(self, value: float) -> int:
        return bisect.bisect_left(self.bounds, value)

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        value = float(value)
        idx = self._bucket_index(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._new_series()
                self._series[key] = s
            s["counts"][idx] += 1
            s["sum"] += value
            s["count"] += 1

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return int(s["count"]) if s else 0

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return float(s["sum"]) if s else 0.0

    def state(self, **labels) -> dict:
        """Shippable series state (the compact per-rank summary the
        telemetry aggregator sends to rank 0): bucket counts + sum +
        count, stamped with the grid config so :meth:`merge` can refuse
        a mismatched peer."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            counts = list(s["counts"]) if s else \
                [0] * (len(self.bounds) + 1)
            return {"counts": counts,
                    "sum": float(s["sum"]) if s else 0.0,
                    "count": int(s["count"]) if s else 0,
                    "lo": self.lo, "hi": self.hi,
                    "buckets_per_decade": self.buckets_per_decade}

    def merge(self, state: dict, **labels) -> None:
        """Elementwise-add a peer's :meth:`state` into this series —
        the rank-0 fleet merge.  Raises on a bucket-grid mismatch."""
        counts = list(state.get("counts") or [])
        if len(counts) != len(self.bounds) + 1:
            raise ValueError(
                f"streaming histogram {self.name!r}: peer state has "
                f"{len(counts)} buckets, this grid has "
                f"{len(self.bounds) + 1}")
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._new_series()
                self._series[key] = s
            for i, c in enumerate(counts):
                s["counts"][i] += int(c)
            s["sum"] += float(state.get("sum", 0.0))
            s["count"] += int(state.get("count", 0))

    def _quantile_from_counts(self, counts, q: float) -> Optional[float]:
        total = sum(counts)
        if total <= 0:
            return None
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c <= 0:
                continue
            prev = cum
            cum += c
            if cum >= target:
                lo = self.bounds[i - 1] if i >= 1 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1]
                frac = (target - prev) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.bounds[-1]

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Bucket-interpolated quantile (``None`` with no data)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            s = self._series.get(_label_key(labels))
            counts = list(s["counts"]) if s else []
        return self._quantile_from_counts(counts, q)

    def snapshot(self) -> List[dict]:
        with self._lock:
            items = [(dict(k), {"counts": list(s["counts"]),
                                "sum": float(s["sum"]),
                                "count": int(s["count"])})
                     for k, s in self._series.items()]
        out = []
        for labels, s in items:
            cum, cum_counts = 0, []
            for c in s["counts"]:
                cum += c
                cum_counts.append(cum)
            out.append({
                "name": self.name, "type": "streaming_histogram",
                "labels": labels,
                "count": s["count"], "sum": s["sum"],
                "quantiles": {
                    str(p): self._quantile_from_counts(s["counts"], p)
                    for p in self._QUANTILES},
                "le": list(self.bounds),
                "bucket_counts": cum_counts,  # cumulative, +Inf last
            })
        return out


class _Timer:
    """Context manager recording monotonic elapsed seconds into a histogram."""

    __slots__ = ("_hist", "_labels", "_t0", "elapsed")

    def __init__(self, hist: Histogram, labels: dict):
        self._hist = hist
        self._labels = labels
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        self._hist.observe(self.elapsed, **self._labels)
        return False


class MetricsRegistry:
    """Name -> metric table.  ``counter()`` / ``gauge()`` / ``histogram()``
    are get-or-create (the Prometheus client idiom), so call sites never
    coordinate registration."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  window_size: int = 1024) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   window_size=window_size)

    def streaming_histogram(self, name: str, help: str = "",
                            lo: float = 1e-5, hi: float = 1e3,
                            buckets_per_decade: int = 9
                            ) -> StreamingHistogram:
        return self._get_or_create(StreamingHistogram, name, help,
                                   lo=lo, hi=hi,
                                   buckets_per_decade=buckets_per_decade)

    def timer(self, name: str, help: str = "", **labels) -> _Timer:
        """``with registry.timer("step_seconds", phase="dispatch"): ...``"""
        return _Timer(self.histogram(name, help), labels)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> List[dict]:
        """All series of all metrics as plain dict records (the one schema
        shared by the JSONL sink, the Prometheus sink, and tools/obs_report)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: List[dict] = []
        for m in sorted(metrics, key=lambda m: m.name):
            out.extend(m.snapshot())
        return out

    def reset(self) -> None:
        """Drop every metric (tests; a trainer restart in one process)."""
        with self._lock:
            self._metrics.clear()


# ---- process-wide switch + default registry --------------------------------

_ENABLED = bool(os.environ.get("CHAINERMN_TPU_OBSERVABILITY", "")
                not in ("", "0", "false", "off"))
_REGISTRY = MetricsRegistry()


def enable() -> None:
    """Turn observability on process-wide.  Call-sites bind at construction
    time, so enable() before building communicators/updaters."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (always live; the switch gates the
    hot-path call sites, not the registry)."""
    return _REGISTRY
