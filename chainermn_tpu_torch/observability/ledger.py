"""Run ledger -- the longitudinal layer over the repo's run artifacts.

Counterpart of ``chainermn_tpu/observability/ledger.py``.  Every bench,
train or serving run publishes a JSON artifact; this module supplies:

* :func:`stamp_envelope` -- the common artifact envelope (``schema``,
  ``schema_version``, ``device_kind``, ``n_devices``, ``backend``,
  ``git_sha``) every writer stamps on its document; on the card the
  device kind is ``torch.cuda.get_device_name(0)``;
* :func:`classify_artifact` -- maps any committed artifact, enveloped or
  legacy (``suite``-keyed, ``bench``-keyed, bare driver logs), to a
  registered schema name (:data:`KNOWN_SCHEMAS`, which also names every
  schema the port's own writers stamp); unknown shapes return ``None``;
* :class:`RunLedger` -- an append-only JSONL ledger of ``run_manifest/v1``
  records (one per artifact: schema, device kind, git sha, topology,
  plan-table hash, modeled and measured link rates, headline metrics),
  with :func:`ingest_artifacts` backfilling the committed artifacts and
  per-``(device_kind, schema)`` baseline selection for the perf gate's
  ``--ledger`` mode.  An H100 record sits in its own cell: a baseline is
  only ever chosen among records of the same device kind, so a card's run
  is never held to a TPU's or a CPU host's floor, nor the other way.

``python -m chainermn_tpu_torch.tools.ledger`` is the CLI (``ingest`` /
``diff`` / ``trend``); :mod:`~chainermn_tpu_torch.observability.diffing`
localizes a regression between two runs' flight spans.
"""

from __future__ import annotations

import fnmatch
import glob
import hashlib
import json
import os
import re
import subprocess
from typing import Dict, Iterable, List, Optional, Tuple

SCHEMA = "run_manifest/v1"
LEDGER_SCHEMA = "run_ledger/v1"

#: the uniform envelope every JSON writer stamps 
ENVELOPE_FIELDS = ("schema", "schema_version", "device_kind",
                   "n_devices", "backend", "git_sha")

#: every schema a committed artifact may declare.  Adding a writer means
#: adding its schema here — the artifact-census test walks the repo root
#: and fails on any artifact that maps to nothing.
KNOWN_SCHEMAS = {
    # enveloped (modern) writers, both packages
    "allreduce_sweep/v1",
    "alltoall_sweep/v1",
    "plan_table/v1",
    "planner_gate/v1",
    "online_tune/v1",
    "tracing_overhead/v1",
    "bench_serving/v1",
    "bench_serving/v2",
    "moe_sweep/v1",
    "moe_bench/v1",
    "moe_gate/v1",
    "remat_tune/v1",
    "resnet_probe/v1",
    "perf_budgets/v1",
    "perf_gate/v1",
    "ledger_gate/v1",
    "flight_recorder/v1",
    "fleet_telemetry/v1",
    "contention/v1",
    "contention_smoke/v1",
    "joint_sweep/v1",
    "joint_plan_table/v1",
    "step_workload/v1",
    "attribution_smoke/v1",
    "bench_headline/v1",
    "cmn_lint/v1",
    "protocol_lint/v1",
    "db_overlap_check/v1",
    "restart_manifest/v1",
    "elastic_smoke/v1",
    # the longitudinal layer itself
    "run_manifest/v1",
    "run_ledger/v1",
    "run_diff/v1",
    # legacy (pre-envelope) shapes, named retroactively
    "tpu_smoke/v1",
    "convergence_ledger/v1",
    "collective_census/v1",
    "pallas_conv_probe/v1",
    "flash_64k_probe/v1",
    "bench_lm/v1",
    "bench_vit/v1",
    "bench_driver/v1",
    "multichip_log/v1",
    "run_configs/v1",
    # the PyTorch port's own writers
    "bench_transport/v1",
    "conv_probe_torch/v1",
    "gpu_smoke/v1",
    # the static protocol model (``analysis.protocol.ProtocolModel.
    # to_json``; JAX's tag), written out whole on request
    "protocol_model/v1",
}

#: legacy ``suite`` marker -> retroactive schema name
_LEGACY_SUITES = {
    "tpu_smoke": "tpu_smoke/v1",
    "convergence_ledger": "convergence_ledger/v1",
    "collective_census": "collective_census/v1",
    "pallas_conv_probe": "pallas_conv_probe/v1",
    "flash_64k_probe": "flash_64k_probe/v1",
    "cmn_lint": "cmn_lint/v1",
}

#: legacy ``bench`` marker -> retroactive schema name
_LEGACY_BENCHES = {
    "benchmarks/bench_lm.py": "bench_lm/v1",
    "benchmarks/bench_vit.py": "bench_vit/v1",
}

#: repo-root filename globs the backfill ingester walks
ARTIFACT_PATTERNS = ("*_r*.json", "BENCH_*.json")

#: headline metric extraction per artifact schema — dotted paths into
#: the document.  Only scalars listed here become ledger ``metrics``
#: (trend/baseline material); everything else stays in the artifact.
_METRIC_PATHS: Dict[str, Dict[str, str]] = {
    "tracing_overhead/v1": {
        "tracing_overhead_pct": "tracing_overhead_pct"},
    "online_tune/v1": {"retune_speedup": "retune.best_speedup"},
    "bench_serving/v1": {
        "serving_tokens_per_sec": "continuous.tokens_per_sec",
        "serving_speedup": "speedup"},
    "bench_serving/v2": {
        "serving_tokens_per_sec": "continuous.tokens_per_sec",
        "serving_speedup": "speedup"},
    "moe_bench/v1": {"moe_final_loss": "moe.final_loss",
                     "dense_final_loss": "dense.final_loss"},
    "moe_gate/v1": {"moe_final_loss": "moe.final_loss"},
    "planner_gate/v1": {"tuned_wins": "tuned_wins", "cells": "cells"},
    "bench_driver/v1": {"headline": "parsed.value"},
    "bench_headline/v1": {"headline": "value"},
    "bench_vit/v1": {"vit_throughput": "official.value"},
    "bench_lm/v1": {"lm_throughput": "official.value"},
    "remat_tune/v1": {"fused_norm_speedup": "fused_norm.speedup"},
    "joint_sweep/v1": {
        "joint_schedule_speedup": "comparison.speedup"},
    "elastic_smoke/v1": {
        "async_ckpt_stall_ms": "async_ckpt.stall_ms",
        "elastic_resume_lost_steps": "chaos.lost_steps"},
}


# ---------------------------------------------------------------------------
# envelope
# ---------------------------------------------------------------------------

def schema_version(schema: Optional[str]) -> Optional[int]:
    """The integer version of a ``name/v<N>`` schema string."""
    if not schema:
        return None
    m = re.search(r"/v(\d+)$", schema)
    return int(m.group(1)) if m else None


_SHA_CACHE: Dict[str, Optional[str]] = {}


def git_sha(root: Optional[str] = None) -> Optional[str]:
    """HEAD commit of the repo at ``root`` (default: this file's repo);
    ``None`` outside a checkout or without git — the envelope is then
    stamped without provenance rather than the writer failing."""
    root = os.path.abspath(root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    if root not in _SHA_CACHE:
        try:
            out = subprocess.run(
                ["git", "-C", root, "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=10)
            _SHA_CACHE[root] = out.stdout.strip() \
                if out.returncode == 0 and out.stdout.strip() else None
        except (OSError, subprocess.SubprocessError):
            _SHA_CACHE[root] = None
    return _SHA_CACHE[root]


def detect_device_kind() -> Optional[str]:
    """The name of CUDA device 0, or ``None`` without a card.  Used only
    as the stamp's fallback: a writer that knows better passes
    ``device_kind=``."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def stamp_envelope(doc: dict, schema: Optional[str] = None, *,
                   device_kind: Optional[str] = None,
                   n_devices: Optional[int] = None,
                   backend: Optional[str] = None,
                   root: Optional[str] = None) -> dict:
    """Stamp the common envelope onto ``doc`` in place (and return it).

    Present fields are never clobbered — a writer that already records
    ``backend``/``n_devices`` keeps its values; the stamp fills the
    gaps (``schema_version`` from the schema string, ``device_kind``
    from the card, ``git_sha`` from the checkout)."""
    if schema and not doc.get("schema"):
        doc["schema"] = schema
    if doc.get("schema") and doc.get("schema_version") is None:
        doc["schema_version"] = schema_version(doc["schema"])
    if device_kind is not None and doc.get("device_kind") is None:
        doc["device_kind"] = device_kind
    if doc.get("device_kind") is None:
        doc["device_kind"] = detect_device_kind()
    if n_devices is not None and doc.get("n_devices") is None:
        doc["n_devices"] = int(n_devices)
    if backend is not None and doc.get("backend") is None:
        doc["backend"] = backend
    if doc.get("git_sha") is None:
        doc["git_sha"] = git_sha(root)
    return doc


# ---------------------------------------------------------------------------
# classification — every committed artifact maps to a registered schema
# ---------------------------------------------------------------------------

def classify_artifact(doc, path: str = "") -> Optional[dict]:
    """Map one parsed artifact to its registered schema.

    Returns ``{"schema", "schema_version", "legacy"}`` — ``legacy`` is
    true when the artifact predates the envelope (its schema is
    inferred from shape, or it declares a schema but carries no
    ``git_sha``).  Unknown shapes and undeclared schemas return
    ``None``: the caller (census test, backfill, artifact-drift lint)
    decides how loudly to complain."""
    if isinstance(doc, list):
        # RUN_CONFIGS_r05.json — a bare list of config rows
        if doc and isinstance(doc[0], dict) \
                and {"config", "metric", "value"} <= set(doc[0]):
            return {"schema": "run_configs/v1", "schema_version": 1,
                    "legacy": True}
        return None
    if not isinstance(doc, dict):
        return None
    declared = doc.get("schema")
    if declared:
        if declared not in KNOWN_SCHEMAS:
            return None
        return {"schema": declared,
                "schema_version": doc.get("schema_version")
                or schema_version(declared),
                "legacy": doc.get("git_sha") is None}
    for marker, table in (("kind", None), ("suite", _LEGACY_SUITES),
                          ("bench", _LEGACY_BENCHES)):
        val = doc.get(marker)
        if not isinstance(val, str):
            continue
        if table is None:           # "kind": already a schema-shaped name
            schema = val if val in KNOWN_SCHEMAS else None
        else:
            schema = table.get(val)
        if schema:
            return {"schema": schema,
                    "schema_version": schema_version(schema),
                    "legacy": True}
    keys = set(doc)
    if {"n", "cmd", "rc", "tail"} <= keys:
        return {"schema": "bench_driver/v1", "schema_version": 1,
                "legacy": True}
    if {"n_devices", "rc", "ok", "tail"} <= keys:
        return {"schema": "multichip_log/v1", "schema_version": 1,
                "legacy": True}
    return None


# ---------------------------------------------------------------------------
# manifest extraction
# ---------------------------------------------------------------------------

def _round_of(path: str) -> Optional[str]:
    m = re.search(r"_r(\d+)", os.path.basename(path))
    return f"r{int(m.group(1)):02d}" if m else None


def _dig(doc, dotted: str):
    cur = doc
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _modeled_rates(doc: dict) -> Dict[str, float]:
    rates: Dict[str, float] = {}
    lg = doc.get("link_gbps")
    if isinstance(lg, dict):
        rates.update({str(k): float(v) for k, v in lg.items()
                      if isinstance(v, (int, float))})
    if isinstance(doc.get("dcn_gbps"), (int, float)):
        rates.setdefault("dcn", float(doc["dcn_gbps"]))
    rep = doc.get("report")
    if isinstance(rep, dict):
        for link, row in (rep.get("rates") or {}).items():
            if isinstance(row, dict) \
                    and isinstance(row.get("modeled_gbps"), (int, float)):
                rates.setdefault(str(link), float(row["modeled_gbps"]))
    return rates


def _measured_rates(doc: dict) -> Dict[str, float]:
    rates: Dict[str, float] = {}
    obs = doc.get("observed_gbps")
    if isinstance(obs, dict):
        rates.update({str(k): float(v) for k, v in obs.items()
                      if isinstance(v, (int, float))})
    rep = doc.get("report")
    if isinstance(rep, dict):
        for link, row in (rep.get("rates") or {}).items():
            if isinstance(row, dict) \
                    and isinstance(row.get("effective_gbps"),
                                   (int, float)):
                rates.setdefault(str(link), float(row["effective_gbps"]))
    return rates


def _plan_table_hash(doc: dict) -> Optional[str]:
    h = _dig(doc, "retune.table_hash")
    if isinstance(h, str):
        return h
    if doc.get("schema") == "plan_table/v1":
        blob = json.dumps(doc.get("entries"), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]
    return None


def _device_kind_of(doc: dict) -> Optional[str]:
    dk = doc.get("device_kind")
    if isinstance(dk, str):
        return dk
    backend = doc.get("backend")
    if backend == "cpu":
        # every CPU-backend artifact shares one substrate; a TPU
        # artifact without a device_kind stays unresolved (v4 vs v5
        # baselines must never cross)
        return "cpu"
    return None


def build_manifest(doc, path: str, *, root: Optional[str] = None,
                   classification: Optional[dict] = None) -> dict:
    """One ``run_manifest/v1`` record for a parsed artifact.

    ``git_sha`` prefers the artifact's own stamp (``git_sha_source:
    "artifact"``); a legacy artifact gets the ingesting checkout's HEAD
    (``"ingest"``) so the record is at least anchored to when it was
    registered, never silently unanchored."""
    cls = classification or classify_artifact(doc, path)
    rel = os.path.relpath(os.path.abspath(path),
                          os.path.abspath(root)) if root else path
    d = doc if isinstance(doc, dict) else {}
    own_sha = d.get("git_sha")
    manifest = {
        "schema": SCHEMA,
        "schema_version": 1,
        "artifact": rel,
        "round": _round_of(path),
        "artifact_schema": cls["schema"] if cls else None,
        "artifact_schema_version": cls["schema_version"] if cls else None,
        "legacy_envelope": bool(cls["legacy"]) if cls else True,
        "device_kind": _device_kind_of(d),
        "n_devices": d.get("n_devices")
        if isinstance(d.get("n_devices"), int) else None,
        "backend": d.get("backend"),
        "git_sha": own_sha or git_sha(root),
        "git_sha_source": "artifact" if own_sha else "ingest",
        "topology": d.get("topology") or _dig(d, "meta.topology"),
        "plan_table_hash": _plan_table_hash(d),
        "link_gbps_modeled": _modeled_rates(d),
        "link_gbps_measured": _measured_rates(d),
        "metrics": {},
        "timestamp": d.get("timestamp"),
    }
    if d.get("noise_dominated") is not None:
        # a noise-guarded measurement (bench_allreduce --traced): the
        # record stays in the trend, but baseline() skips it
        manifest["noise_dominated"] = bool(d["noise_dominated"])
    if cls:
        for metric, dotted in _METRIC_PATHS.get(cls["schema"],
                                                {}).items():
            val = _dig(d, dotted)
            if isinstance(val, (int, float)) \
                    and not isinstance(val, bool):
                manifest["metrics"][metric] = float(val)
        if cls["schema"] == "tracing_overhead/v1" \
                and "noise_dominated" not in manifest \
                and manifest["metrics"].get(
                    "tracing_overhead_pct", 0.0) < 0:
            # pre-guard artifact publishing a negative overhead: hooks
            # cannot speed a program up, so the value is measurement
            # noise — keep it out of baseline selection
            manifest["noise_dominated"] = True
    slo = d.get("slo")
    if isinstance(slo, dict):
        manifest["histograms"] = {
            name: row.get("quantiles", {})
            for name, row in slo.items() if isinstance(row, dict)}
    return manifest


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

class RunLedger:
    """Append-only run ledger.

    ``path=None`` keeps the ledger in memory (tests, one-shot
    snapshots); with a path every :meth:`append` also appends one JSON
    line to the file, and construction replays existing lines — the
    file IS the ledger, restarts lose nothing."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._records: List[dict] = []
        if path and os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        self._records.append(json.loads(line))

    def __len__(self) -> int:
        return len(self._records)

    def append(self, manifest: dict) -> dict:
        if manifest.get("schema") != SCHEMA:
            raise ValueError(
                f"ledger records must be {SCHEMA} documents, got "
                f"schema={manifest.get('schema')!r}")
        self._records.append(manifest)
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(self.path, "a") as fh:
                fh.write(json.dumps(manifest, sort_keys=True) + "\n")
        return manifest

    # -- queries ---------------------------------------------------------

    def records(self, artifact_schema: Optional[str] = None,
                device_kind: Optional[str] = None) -> List[dict]:
        out = list(self._records)
        if artifact_schema is not None:
            out = [r for r in out
                   if r.get("artifact_schema") == artifact_schema]
        if device_kind is not None:
            out = [r for r in out
                   if r.get("device_kind") == device_kind]
        return out

    @staticmethod
    def _order(rec: dict) -> tuple:
        return (rec.get("round") or "", rec.get("timestamp") or "")

    def latest(self, artifact_schema: str,
               device_kind: Optional[str] = None) -> Optional[dict]:
        rows = self.records(artifact_schema, device_kind)
        return max(rows, key=self._order) if rows else None

    def baseline(self, artifact_schema: str, device_kind: Optional[str],
                 metric: str, direction: str = "higher",
                 exclude_artifact: Optional[str] = None
                 ) -> Optional[dict]:
        """The baseline record for one ``(device_kind, schema)`` cell:
        among that cell's records carrying ``metric``, the best value
        seen (``direction`` as in perf_budgets: the side that counts as
        good).  ``exclude_artifact`` keeps the run under test from
        being its own baseline; records flagged ``noise_dominated``
        stay in the trend but never become the bar other runs are held
        to."""
        rows = [r for r in self.records(artifact_schema, device_kind)
                if metric in r.get("metrics", {})
                and r.get("artifact") != exclude_artifact
                and not r.get("noise_dominated")]
        if not rows:
            return None
        key = (lambda r: r["metrics"][metric])
        return (max if direction == "higher" else min)(rows, key=key)

    def trend(self, metric: str,
              artifact_schema: Optional[str] = None,
              device_kind: Optional[str] = None) -> List[dict]:
        rows = [r for r in self.records(artifact_schema, device_kind)
                if metric in r.get("metrics", {})]
        rows.sort(key=self._order)
        return [{"round": r.get("round"), "artifact": r.get("artifact"),
                 "device_kind": r.get("device_kind"),
                 "artifact_schema": r.get("artifact_schema"),
                 "git_sha": r.get("git_sha"),
                 "value": r["metrics"][metric]} for r in rows]

    def cells(self) -> Dict[Tuple[Optional[str], Optional[str]], int]:
        """Record counts per ``(device_kind, artifact_schema)`` — the
        baseline-selection grid."""
        out: Dict[Tuple[Optional[str], Optional[str]], int] = {}
        for r in self._records:
            k = (r.get("device_kind"), r.get("artifact_schema"))
            out[k] = out.get(k, 0) + 1
        return out

    # -- snapshot --------------------------------------------------------

    def to_doc(self) -> dict:
        doc = {
            "schema": LEDGER_SCHEMA,
            "schema_version": 1,
            "n_records": len(self._records),
            "cells": [{"device_kind": dk, "artifact_schema": s,
                       "n": n}
                      for (dk, s), n in sorted(
                          self.cells().items(),
                          key=lambda kv: (str(kv[0][0]),
                                          str(kv[0][1])))],
            "records": list(self._records),
        }
        return stamp_envelope(doc)

    @classmethod
    def from_doc(cls, doc: dict) -> "RunLedger":
        if doc.get("schema") != LEDGER_SCHEMA:
            raise ValueError(
                f"not a {LEDGER_SCHEMA} document: "
                f"schema={doc.get('schema')!r}")
        led = cls()
        led._records = list(doc.get("records", []))
        return led

    @classmethod
    def load(cls, path: str) -> "RunLedger":
        """A ledger from either its JSONL file or a committed
        ``run_ledger/v1`` snapshot document."""
        with open(path) as fh:
            head = fh.read(1)
        if not head:
            return cls(path)
        with open(path) as fh:
            first_line = fh.readline()
        try:
            first = json.loads(first_line)
        except json.JSONDecodeError:
            first = None
        if isinstance(first, dict) and first.get("schema") == SCHEMA:
            return cls(path)            # JSONL of manifests
        with open(path) as fh:
            return cls.from_doc(json.load(fh))


# ---------------------------------------------------------------------------
# backfill
# ---------------------------------------------------------------------------

def iter_artifacts(root: str,
                   patterns: Iterable[str] = ARTIFACT_PATTERNS
                   ) -> List[str]:
    """Committed artifact paths under ``root`` (non-recursive — the
    convention is repo-root artifacts), sorted, deduplicated."""
    seen = {}
    for pat in patterns:
        for p in glob.glob(os.path.join(root, pat)):
            if os.path.isfile(p):
                seen[os.path.abspath(p)] = None
    return sorted(seen)


def ingest_artifacts(root: str, ledger: Optional[RunLedger] = None,
                     patterns: Iterable[str] = ARTIFACT_PATTERNS
                     ) -> Tuple[List[dict], List[dict]]:
    """Backfill: register every committed artifact under ``root``.

    Returns ``(manifests, problems)`` — a problem row is an unreadable
    or unknown-schema artifact (``{"artifact", "reason"}``).  Problems
    are reported, never appended: the ledger stays a registry of
    classified runs."""
    ledger = ledger if ledger is not None else RunLedger()
    manifests: List[dict] = []
    problems: List[dict] = []
    for path in iter_artifacts(root, patterns):
        rel = os.path.relpath(path, root)
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except Exception as e:  # noqa: BLE001 — unreadable is a finding
            problems.append({"artifact": rel,
                             "reason": f"unreadable: {e}"})
            continue
        cls = classify_artifact(doc, path)
        if cls is None:
            declared = doc.get("schema") if isinstance(doc, dict) \
                else None
            problems.append({
                "artifact": rel,
                "reason": (f"undeclared schema {declared!r}"
                           if declared else "unknown artifact shape")})
            continue
        manifests.append(ledger.append(
            build_manifest(doc, path, root=root, classification=cls)))
    return manifests, problems


def matches_patterns(path: str,
                     patterns: Iterable[str] = ARTIFACT_PATTERNS) -> bool:
    name = os.path.basename(path)
    return any(fnmatch.fnmatch(name, pat) for pat in patterns)


__all__ = [
    "ARTIFACT_PATTERNS",
    "ENVELOPE_FIELDS",
    "KNOWN_SCHEMAS",
    "LEDGER_SCHEMA",
    "RunLedger",
    "SCHEMA",
    "build_manifest",
    "classify_artifact",
    "detect_device_kind",
    "git_sha",
    "ingest_artifacts",
    "iter_artifacts",
    "matches_patterns",
    "schema_version",
    "stamp_envelope",
]
