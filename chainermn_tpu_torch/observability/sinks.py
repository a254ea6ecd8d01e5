"""Metric sinks: JSONL (append-only) and Prometheus text exposition.

Counterpart of ``chainermn_tpu/observability/sinks.py``: the same record
schema everywhere (the registry's ``snapshot()`` dicts ride both sinks
unchanged; ``MetricsReport`` and the benchmarks append their own records
with a ``kind`` discriminator) and byte-for-byte the same Prometheus
exposition text.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Iterable, List, Optional


def append_jsonl(path: str, record: dict) -> None:
    """Append one JSON record as a single line (O(record), not O(file);
    the write is a single ``write`` call of one line, which POSIX appends
    atomically for sane line sizes)."""
    line = json.dumps(record, default=float, separators=(",", ":"))
    with open(path, "a") as f:
        f.write(line + "\n")


def append_metrics(path: str, row: dict, kind: str) -> None:
    """One benchmark ``--metrics`` record: ``row`` with its ``kind``, a
    time stamp and the common envelope (device, commit)."""
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    append_jsonl(path, stamp_envelope(dict(row, kind=kind, ts=time.time())))


def read_jsonl(path: str) -> List[dict]:
    """Load every record of a JSONL file (tools / tests; tolerant of a
    trailing partial line from a crashed writer)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn final line from an interrupted run
    return out


def atomic_write_json(path: str, obj, indent: Optional[int] = 1) -> None:
    """Write JSON via tmp-file + rename, so readers never observe a torn
    file and a crash never truncates the previous version (also used for
    snapshot-style artifacts)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=indent, default=float)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_snapshot_jsonl(path: str, snapshot: Iterable[dict],
                         ts: Optional[float] = None, **extra) -> int:
    """Append a registry snapshot: one line per series, each stamped with
    the same ``ts`` (seconds since epoch) and any extra fields (e.g.
    ``rank``).  Returns the number of records written."""
    ts = time.time() if ts is None else ts
    n = 0
    lines = []
    for rec in snapshot:
        rec = dict(rec)
        rec.setdefault("kind", "metric")
        rec["ts"] = ts
        rec.update(extra)
        lines.append(json.dumps(rec, default=float, separators=(",", ":")))
        n += 1
    if lines:
        with open(path, "a") as f:
            f.write("\n".join(lines) + "\n")
    return n


# ---- Prometheus text exposition (format 0.0.4) -----------------------------

#: metric names must match [a-zA-Z_:][a-zA-Z0-9_:]*, label names
#: [a-zA-Z_][a-zA-Z0-9_]* — anything else (a "plan:inter" seam leaking
#: into a metric name, a "wire-dtype" label key) would emit lines every
#: scraper rejects, taking the WHOLE exposition file down with it.
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize_metric_name(name: str) -> str:
    out = _NAME_BAD.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _sanitize_label_name(name: str) -> str:
    out = _LABEL_BAD.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _escape_label(v: str) -> str:
    # order matters: escape the escape character first, or the
    # backslashes introduced for newline/quote get doubled
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _labels_text(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(
        f'{_sanitize_label_name(k)}="{_escape_label(str(v))}"'
        for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _num(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(snapshot: Iterable[dict],
                    namespace: str = "chainermn_tpu") -> str:
    """Render registry snapshot records in the Prometheus text exposition
    format.  Counters get the ``_total`` suffix, histograms are exposed as
    summaries (``_count`` / ``_sum`` + ``quantile`` series) — the scrape-
    side convention for client-computed quantiles."""
    by_name: dict = {}
    for rec in snapshot:
        by_name.setdefault(rec["name"], []).append(rec)
    lines: List[str] = []
    for name in sorted(by_name):
        recs = by_name[name]
        kind = recs[0].get("type", "gauge")
        full = _sanitize_metric_name(
            f"{namespace}_{name}" if namespace else name)
        if kind == "counter":
            lines.append(f"# TYPE {full}_total counter")
            for r in recs:
                lines.append(
                    f"{full}_total{_labels_text(r['labels'])} "
                    f"{_num(r['value'])}")
        elif kind == "histogram":
            lines.append(f"# TYPE {full} summary")
            for r in recs:
                for q, v in sorted(r.get("quantiles", {}).items()):
                    lines.append(
                        f"{full}{_labels_text(r['labels'], {'quantile': q})}"
                        f" {_num(v)}")
                lines.append(
                    f"{full}_sum{_labels_text(r['labels'])} {_num(r['sum'])}")
                lines.append(
                    f"{full}_count{_labels_text(r['labels'])} "
                    f"{_num(r['count'])}")
        elif kind == "streaming_histogram":
            # fixed log-spaced buckets -> a native Prometheus histogram
            # (cumulative le series), plus explicit p50/p95/p99 gauges
            # (the SLO percentile export obs_report renders)
            lines.append(f"# TYPE {full} histogram")
            lines.append(f"# TYPE {full}_quantile gauge")
            for r in recs:
                le = r.get("le") or []
                cum = r.get("bucket_counts") or []
                for bound, c in zip(le, cum):
                    lines.append(
                        f"{full}_bucket"
                        f"{_labels_text(r['labels'], {'le': _num(bound)})}"
                        f" {_num(c)}")
                total = cum[-1] if cum else r.get("count", 0)
                lines.append(
                    f"{full}_bucket"
                    f"{_labels_text(r['labels'], {'le': '+Inf'})} "
                    f"{_num(total)}")
                lines.append(
                    f"{full}_sum{_labels_text(r['labels'])} {_num(r['sum'])}")
                lines.append(
                    f"{full}_count{_labels_text(r['labels'])} "
                    f"{_num(r['count'])}")
                for q, v in sorted((r.get("quantiles") or {}).items()):
                    lines.append(
                        f"{full}_quantile"
                        f"{_labels_text(r['labels'], {'quantile': q})}"
                        f" {_num(v)}")
        else:
            lines.append(f"# TYPE {full} gauge")
            for r in recs:
                lines.append(
                    f"{full}{_labels_text(r['labels'])} {_num(r['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str, snapshot: Iterable[dict],
                     namespace: str = "chainermn_tpu") -> None:
    """Atomically publish the exposition text (node-exporter textfile-
    collector style: scrapers read a complete file or the previous one)."""
    text = prometheus_text(snapshot, namespace=namespace)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
