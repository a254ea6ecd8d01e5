"""Runtime observability -- an always-on (but switchable) view of what the
communicators, the trainer, the planner, FSDP, the compressors and the
serving engine are doing while a job runs.

Counterpart of ``chainermn_tpu/observability/__init__.py``:

* :mod:`.registry` -- the process-wide metrics registry (counters,
  gauges, histograms and streaming histograms with labels, monotonic
  timers) and the master switch;
* :mod:`.sinks` -- the JSONL sink and reader, atomic JSON writes, and the
  Prometheus text exposition;
* :mod:`.flight_recorder` -- the bounded event ring, its dumps and the
  cross-rank desync analysis;
* :mod:`.instrument` -- instrumented communicators: per-collective call
  counts, payload bytes, wire dtype and host-side latency, under
  ``torch.profiler.record_function`` ranges named ``chainermn_tpu.<op>``;
* :mod:`.spans` and :mod:`.attribution` -- span trees from flight
  events, step-time attribution, the cross-rank merge and critical path,
  the clock handshake and the Perfetto export; :class:`PlanObs`, the
  planner's per-stage hook;
* :mod:`.straggler` -- step telemetry and the cross-rank straggler report
  that ``training.extensions.MetricsReport`` drives;
* :mod:`.watchdog` -- the hang watchdog: step-stall, collective-deadline
  and heartbeat predicates, the cross-rank state exchange over the
  socket control plane, ``flight_<rank>.json`` dumps;
* :mod:`.contention` -- per-link-class occupancy timelines, the overlap
  matrix, effective against modeled link rates, the ``contention/v1``
  document;
* :mod:`.streaming` -- the per-window rank summaries folded on rank 0
  into ``fleet_telemetry/v1`` (straggler flags, fleet serving
  percentiles);
* :mod:`.diffing` -- run profiles and the ``run_diff/v1`` document that
  names the regressed bucket;
* :mod:`.ledger` -- the common envelope of result documents, the schema
  registry and artifact classification, and the run ledger
  (``RunLedger``, ``build_manifest``, ``ingest_artifacts``) that keeps
  one device kind's records apart from another's.

The master switch is process-wide: :func:`enable` / :func:`disable` /
:func:`enabled`, or the ``CHAINERMN_TPU_OBSERVABILITY`` environment
variable (any non-empty value other than ``0``/``false``/``off``), read
at import.  Every data-path seam checks it ONCE at construction, so a
disabled run makes no observability call per iteration.

The report tools that read these documents are
``chainermn_tpu_torch.tools`` (``obs_report``, ``ledger``, ``perf_gate``).
"""

from chainermn_tpu_torch.observability.attribution import (
    BUCKETS, attribute_step, attribution_report, classify_span,
    clock_handshake, critical_path, merge_ranks, offset_from_samples,
    span_summary, to_trace_events)
from chainermn_tpu_torch.observability.contention import (
    attribution_consistency, contention_report, feed_link_observations,
    leaf_comm_spans, link_rates, occupancy_from_events, occupancy_timelines,
    overlap_matrix, plan_identity, span_link, span_owner)
from chainermn_tpu_torch.observability.diffing import (
    diff_histograms, diff_manifests, diff_profiles, diff_runs, load_run,
    run_profile)
from chainermn_tpu_torch.observability.flight_recorder import (
    DUMP_SCHEMA, FlightRecorder, get_flight_recorder, identify_desync,
    install_flight_recorder, reset_flight_recorder, thread_stacks)
from chainermn_tpu_torch.observability.instrument import (
    InstrumentedCommunicator, instrument_communicator)
from chainermn_tpu_torch.observability.ledger import (
    RunLedger, build_manifest, classify_artifact, detect_device_kind, git_sha,
    ingest_artifacts, iter_artifacts, schema_version, stamp_envelope)
from chainermn_tpu_torch.observability.registry import (
    Counter, Gauge, Histogram, MetricsRegistry, StreamingHistogram, disable,
    enable, enabled, get_registry)
from chainermn_tpu_torch.observability.sinks import (
    append_jsonl, atomic_write_json, prometheus_text, read_jsonl,
    write_prometheus, write_snapshot_jsonl)
from chainermn_tpu_torch.observability.spans import (
    PlanObs, Span, build_step_trees, get_plan_obs, pair_events,
    phase_spans, stage_link_timings, step_windows)
from chainermn_tpu_torch.observability.straggler import (
    AttributionWatch, StepTelemetry, StragglerDetector, straggler_report,
    summarize_durations)
from chainermn_tpu_torch.observability.streaming import TelemetryAggregator
from chainermn_tpu_torch.observability.watchdog import (
    Watchdog, WatchdogConfig, start_watchdog, watchdog_thread_count)

__all__ = [
    "AttributionWatch", "BUCKETS", "Counter", "DUMP_SCHEMA", "FlightRecorder",
    "Gauge", "Histogram", "InstrumentedCommunicator", "MetricsRegistry",
    "PlanObs", "RunLedger", "Span", "StepTelemetry", "StragglerDetector",
    "StreamingHistogram", "TelemetryAggregator", "Watchdog", "WatchdogConfig",
    "append_jsonl", "atomic_write_json", "attribute_step",
    "attribution_consistency", "attribution_report", "build_manifest",
    "build_step_trees", "classify_artifact", "classify_span",
    "clock_handshake", "contention_report", "critical_path",
    "detect_device_kind", "diff_histograms", "diff_manifests",
    "diff_profiles", "diff_runs", "disable", "enable", "enabled",
    "feed_link_observations", "get_flight_recorder", "get_plan_obs",
    "get_registry", "git_sha", "identify_desync", "ingest_artifacts",
    "install_flight_recorder", "instrument_communicator", "iter_artifacts",
    "leaf_comm_spans", "link_rates", "load_run",
    "merge_ranks", "occupancy_from_events", "occupancy_timelines",
    "offset_from_samples", "overlap_matrix", "pair_events", "phase_spans",
    "plan_identity", "prometheus_text", "read_jsonl", "reset_flight_recorder",
    "run_profile", "schema_version", "span_link", "span_owner",
    "span_summary", "stage_link_timings", "stamp_envelope", "start_watchdog",
    "step_windows", "straggler_report", "summarize_durations",
    "thread_stacks", "to_trace_events", "watchdog_thread_count",
    "write_prometheus", "write_snapshot_jsonl",
]
