"""Trainer extensions (the Chainer ``training.extensions`` role).

Counterpart of ``chainermn_tpu/training/extensions.py``: ``LogReport``,
``PrintReport``, ``MetricsReport``, ``Evaluator`` and ``Snapshot``; the
examples' own ``StepTimer``.  The reference gates the reports to rank 0 in
every example (``if comm.rank == 0: trainer.extend(...)``); the same
pattern applies here, except ``MetricsReport``, which goes on every rank
(its straggler report is a collective) and writes on rank 0 only.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, List, Optional

import torch

from chainermn_tpu_torch.training.trainer import _trigger_fires, to_device


def _to_float(v):
    return float(v) if isinstance(v, (torch.Tensor, int, float)) else v


class LogReport:
    """Aggregate per-iteration observations; emit one averaged record per
    emit ``trigger`` into ``log`` (a list), and into the JSON file
    ``filename`` under ``trainer.out`` when both are set (written whole
    each time, through a temporary file and a rename).

    Runs every iteration (it must see each observation); ``trigger`` is the
    emit cadence, as in Chainer.  Observations stay tensors until an emit,
    so the loop does not wait on the device every step.
    """

    priority = 50
    name = "LogReport"
    trigger = (1, "iteration")  # called every iteration; emits on _emit

    def __init__(self, trigger=(1, "epoch"),
                 filename: Optional[str] = "log"):
        self._emit = trigger
        self._filename = filename
        self._accum: dict = {}
        self._counts: dict = {}
        self.log: List[dict] = []

    def __call__(self, trainer):
        for k, v in trainer.observation.items():
            self._accum[k] = (self._accum[k] + v) if k in self._accum else v
            self._counts[k] = self._counts.get(k, 0) + 1
        if not _trigger_fires(self._emit, trainer.updater):
            return
        record = {k: _to_float(self._accum[k]) / self._counts[k]
                  for k in self._accum}
        record.update({
            "epoch": trainer.updater.epoch,
            "iteration": trainer.updater.iteration,
            "elapsed_time": trainer.elapsed_time,
        })
        self.log.append(record)
        self._accum, self._counts = {}, {}
        if trainer.out is not None and self._filename is not None:
            path = os.path.join(trainer.out, self._filename)
            with open(path + ".tmp", "w") as f:
                json.dump(self.log, f, indent=1)
            os.replace(path + ".tmp", path)


class PrintReport:
    """Print the chosen entries of ``LogReport``'s newest record, as a
    table, each time the log grows, to ``out`` (default: the
    ``sys.stdout`` of the time the report is built)."""

    priority = 40

    def __init__(self, entries: List[str], log_report: str = "LogReport",
                 out=None):
        self.trigger = (1, "epoch")
        self._entries = entries
        self._log_report = log_report
        self._out = out if out is not None else sys.stdout
        self._header_done = False

    def __call__(self, trainer):
        lr = trainer.get_extension(self._log_report)
        if not lr.log:
            return
        rec = lr.log[-1]
        if not self._header_done:
            self._out.write("  ".join(f"{e:>16}" for e in self._entries)
                            + "\n")
            self._header_done = True
        row = []
        for e in self._entries:
            v = rec.get(e, "")
            row.append(f"{v:16.6g}" if isinstance(v, float) else f"{v!s:>16}")
        self._out.write("  ".join(row) + "\n")
        self._out.flush()


class MetricsReport:
    """Runtime-observability extension: per-step timing breakdown,
    communicator counters, and the periodic cross-rank straggler report,
    all appended to one metrics JSONL (``<out>/metrics.jsonl``; the JAX
    package's records and keys).

    On ``initialize`` it installs a
    :class:`~chainermn_tpu_torch.observability.StepTelemetry` on the
    updater -- but only when observability is enabled
    (``chainermn_tpu_torch.observability.enable()`` or the
    ``CHAINERMN_TPU_OBSERVABILITY`` environment variable); otherwise the
    extension is inert and the trainer's loop stays untimed.  With a
    flight recorder installed (``attribution=True``), every completed
    step's span tree is attributed and watched for bucket regressions
    (``profile_dir`` arms a ``torch.profiler`` capture of a flagged step).

    Add it on **every** rank: the straggler report allgathers summaries
    over the communicator's object plane, so all ranks must reach the same
    trigger; only rank 0 writes files (none when ``trainer.out`` is
    ``None``).

    ``watchdog=True`` (``None``: the ``CHAINERMN_TPU_WATCHDOG`` variable
    decides) starts the hang watchdog on the communicator's socket control
    plane (``_cp``; local-only dumps without one), its dumps next to the
    metrics file; ``finalize`` stops it, so a healthy run leaves no
    ``flight_*.json``.  ``online_tune=True`` feeds an
    :class:`~chainermn_tpu_torch.planner.online.OnlineTuner` from the
    plan-stage spans and the attribution watch and hot-swaps the
    communicator's plan table at an emit boundary (``online_tune_threshold``,
    ``online_tune_link_gbps`` for links not observed yet, ``fsdp_prefetch=
    (depth, buckets)`` for the advisory prefetch records).
    ``stream_telemetry=True`` gathers every rank's window to rank 0 at each
    emit and appends the ``fleet_telemetry/v1`` document.
    """

    priority = 45
    name = "MetricsReport"
    trigger = (1, "iteration")  # called every iteration; emits on _emit

    def __init__(self, trigger=(1, "epoch"), filename: str = "metrics.jsonl",
                 straggler_every: int = 1, straggler_threshold: float = 1.5,
                 prometheus: Optional[str] = None, registry=None,
                 tokens_per_example: Optional[int] = None,
                 watchdog: Optional[bool] = None,
                 attribution: bool = True,
                 attribution_factor: float = 2.0,
                 profile_dir: Optional[str] = None,
                 online_tune: bool = False,
                 online_tune_threshold: float = 1.05,
                 online_tune_link_gbps: Optional[dict] = None,
                 fsdp_prefetch: Optional[tuple] = None,
                 stream_telemetry: bool = False):
        if straggler_every < 1:
            raise ValueError(f"straggler_every must be >= 1, got "
                             f"{straggler_every}")
        self._emit = trigger
        self._filename = filename
        self._straggler_every = straggler_every
        self._straggler_threshold = straggler_threshold
        self._prometheus = prometheus
        self._registry = registry
        self._tokens_per_example = tokens_per_example
        # watchdog=True starts the hang watchdog (flight dumps land next
        # to the metrics JSONL); None defers to CHAINERMN_TPU_WATCHDOG.
        self._want_watchdog = watchdog
        self._watchdog = None
        self._want_attribution = attribution
        self._attribution_factor = attribution_factor
        self._profile_dir = profile_dir
        self._attr = None
        # online_tune=True closes the attribution loop: plan-stage spans
        # feed an OnlineTuner and a flagged ici/dcn_comm regression
        # re-tunes the communicator's PlanTable against the observed link
        # rates, hot-swapping it at the next emit boundary (rank-0
        # decision broadcast, so all ranks flip on the same step).
        self._want_online_tune = online_tune
        self._online_tune_threshold = online_tune_threshold
        self._online_tune_link_gbps = online_tune_link_gbps
        self._fsdp_prefetch = fsdp_prefetch
        self._tuner = None
        # stream_telemetry=True ships each rank's compact window summary
        # to rank 0 at every emit and appends the folded fleet_telemetry
        # document; the aggregator exists only with observability on.
        self._want_stream = stream_telemetry
        self._stream = None
        self._active = False

    def initialize(self, trainer):
        from chainermn_tpu_torch import observability as obs

        self._active = obs.enabled()
        if not self._active:
            return
        reg = self._registry if self._registry is not None else \
            obs.get_registry()
        comm = trainer.updater.comm
        self._reg = reg
        self._comm = comm
        self._tele = obs.StepTelemetry(
            registry=reg, comm=comm,
            straggler_threshold=self._straggler_threshold)
        trainer.updater.telemetry = self._tele
        self._is_writer = getattr(comm, "rank", 0) == 0 and \
            trainer.out is not None
        self._path = os.path.join(trainer.out or ".", self._filename)
        self._win = {"steps": 0, "examples": 0,
                     **{p: 0.0 for p in self._tele.PHASES}}
        self._t_last_emit = time.perf_counter()
        self._emits = 0
        self._fr = obs.get_flight_recorder()
        self._attr_seq = -1
        self._last_attr = None
        if self._want_attribution and self._fr is not None:
            self._attr = obs.AttributionWatch(
                registry=reg, flight=self._fr,
                factor=self._attribution_factor,
                profile_dir=self._profile_dir)
        if self._want_online_tune and self._attr is not None:
            from chainermn_tpu_torch.planner.online import OnlineTuner
            self._tuner = OnlineTuner(
                comm=comm, registry=reg, flight=self._fr,
                threshold=self._online_tune_threshold,
                fallback_gbps=self._online_tune_link_gbps)
        if self._want_stream:
            self._stream = obs.TelemetryAggregator(comm)
        want_wd = self._want_watchdog
        if want_wd is None:
            want_wd = os.environ.get("CHAINERMN_TPU_WATCHDOG", "") \
                not in ("", "0", "false", "off")
        if want_wd and self._watchdog is None:
            self._watchdog = obs.start_watchdog(
                control_plane=getattr(comm, "_cp", None),
                out_dir=trainer.out, rank=getattr(comm, "rank", 0))

    def _observe_attribution(self) -> None:
        """Feed every newly-completed step's span tree to the attribution
        watch (incremental: only events past the last consumed step are
        re-read from the ring)."""
        if self._attr is None:
            return
        evs = self._fr.events_since(self._attr_seq)
        step_evs = [e for e in evs if e.get("kind") == "step"]
        if not step_evs:
            return
        last_seq = step_evs[-1].get("seq", self._attr_seq)
        window = [e for e in evs if e.get("seq", 0) <= last_seq]
        from chainermn_tpu_torch.observability import (
            attribution as _attribution, spans as _spans)
        if self._tuner is not None:
            self._tuner.ingest(window)
        for tree in _spans.build_step_trees(
                window, rank=getattr(self._comm, "rank", 0)):
            self._last_attr = _attribution.attribute_step(tree)
            flagged = self._attr.observe(self._last_attr)
            if self._tuner is not None:
                self._tuner.observe_attribution(self._last_attr)
                self._tuner.on_regression(flagged)
        self._attr_seq = last_seq

    def _emit_record(self, trainer) -> dict:
        now = time.perf_counter()
        dt = max(now - self._t_last_emit, 1e-9)
        self._t_last_emit = now
        w = self._win
        n = max(w["steps"], 1)
        record = {
            "kind": "step_report",
            "ts": time.time(),
            "iteration": trainer.updater.iteration,
            "epoch": trainer.updater.epoch,
            "elapsed_time": trainer.elapsed_time,
            "steps": w["steps"],
            "examples_per_sec": w["examples"] / dt,
            "steps_per_sec": w["steps"] / dt,
        }
        if self._tokens_per_example:
            record["tokens_per_sec"] = (
                w["examples"] * self._tokens_per_example / dt)
        for p in self._tele.PHASES:
            record[f"{p}_s_mean"] = w[p] / n
        record["step_s_mean"] = sum(w[p] for p in self._tele.PHASES) / n
        self._win = {"steps": 0, "examples": 0,
                     **{p: 0.0 for p in self._tele.PHASES}}
        return record

    def __call__(self, trainer):
        from chainermn_tpu_torch.observability import (
            append_jsonl, write_prometheus, write_snapshot_jsonl)

        if not self._active:
            return
        last = self._tele.last
        if last is not None:
            w = self._win
            w["steps"] += 1
            w["examples"] += last["examples"]
            for p in self._tele.PHASES:
                w[p] += last[f"{p}_s"]
            self._tele.last = None
        self._observe_attribution()
        if not _trigger_fires(self._emit, trainer.updater):
            return
        record = self._emit_record(trainer)
        self._emits += 1
        straggler = None
        if self._emits % self._straggler_every == 0:
            # COLLECTIVE over the object plane -- every rank reaches this
            # at the same trigger; do not gate it on the writer rank.
            straggler = self._tele.straggler.report()
        swap = None
        if self._tuner is not None:
            # COLLECTIVE (rank-0 decision broadcast): every rank calls
            # maybe_swap at this trigger so all ranks swap the plan table
            # on the SAME step boundary; the communicator's next
            # allreduce_grad selects from the new table.
            swap = self._tuner.maybe_swap(trainer.updater.iteration)
        fleet = None
        if self._stream is not None:
            # COLLECTIVE (gather to rank 0): every rank ships its
            # telemetry window at this trigger.
            fleet = self._stream.collect(trainer.updater.iteration)
        if not self._is_writer:
            return
        append_jsonl(self._path, record)
        write_snapshot_jsonl(self._path, self._reg.snapshot(),
                             rank=self._comm.rank)
        if fleet is not None:
            append_jsonl(self._path, dict(fleet, ts=time.time()))
        if straggler is not None:
            straggler = dict(straggler,
                             iteration=trainer.updater.iteration)
            append_jsonl(self._path, straggler)
        if self._last_attr is not None:
            append_jsonl(self._path, dict(self._last_attr,
                                          kind="step_attribution",
                                          ts=time.time()))
            self._last_attr = None
        if self._tuner is not None:
            if swap is not None:
                # JSONL copy of the swap (minus the full table/comparison
                # payloads — the flight event and sidecar pin carry the
                # hash)
                slim = {k: v for k, v in swap.items()
                        if k not in ("table", "comparison")}
                append_jsonl(self._path, dict(
                    slim, kind="plan_table_swap",
                    iteration=trainer.updater.iteration, ts=time.time()))
            append_jsonl(self._path, dict(
                self._tuner.state(),
                iteration=trainer.updater.iteration, ts=time.time()))
            if self._fsdp_prefetch is not None:
                cur, nbuckets = self._fsdp_prefetch
                rec = self._tuner.recommend_prefetch(int(cur),
                                                     int(nbuckets))
                if rec != int(cur):
                    append_jsonl(self._path, {
                        "kind": "fsdp_prefetch_recommendation",
                        "current": int(cur), "recommended": rec,
                        "iteration": trainer.updater.iteration,
                        "ts": time.time()})
        if self._prometheus:
            write_prometheus(self._prometheus, self._reg.snapshot())

    def finalize(self, trainer):
        from chainermn_tpu_torch.observability import (
            append_jsonl, write_snapshot_jsonl)

        if self._watchdog is not None:
            # stop before the run goes quiet — a finished trainer must
            # not read as a step stall
            self._watchdog.stop()
            self._watchdog = None
        if not self._active or self._win["steps"] == 0:
            return
        record = self._emit_record(trainer)
        straggler = self._tele.straggler.report()
        if not self._is_writer:
            return
        append_jsonl(self._path, record)
        write_snapshot_jsonl(self._path, self._reg.snapshot(),
                             rank=self._comm.rank)
        append_jsonl(self._path, dict(straggler,
                                      iteration=trainer.updater.iteration))


class Evaluator:
    """Run ``eval_fn`` over a validation iterator; put the mean metrics in
    ``trainer.observation`` under ``validation/<key>``.

    ``eval_fn(batch) -> dict`` of scalars, the batch already on
    ``comm.device`` (build it with
    :func:`chainermn_tpu_torch.extensions.make_eval_fn`; wrap the evaluator
    with :func:`~chainermn_tpu_torch.extensions.create_multi_node_evaluator`
    for the world average).  The iterator is rewound every time, so it must
    be rewindable (a ``SerialIterator`` with ``repeat=False``), and every
    rank must see as many batches (``scatter_dataset`` shards are of equal
    length), since ``eval_fn`` may run collectives.
    """

    priority = 60
    trigger = (1, "epoch")
    name = "validation"

    def __init__(self, iterator, eval_fn: Callable, comm,
                 prefix: str = "validation"):
        if not hasattr(iterator, "reset") or \
                not getattr(iterator, "rewindable", True):
            raise ValueError(
                f"Evaluator needs a rewindable iterator, got "
                f"{type(iterator).__name__} (evaluation calls reset() every "
                f"epoch); use a SerialIterator, not a PrefetchIterator")
        self.iterator = iterator
        self.eval_fn = eval_fn
        self.comm = comm
        self.prefix = prefix

    def evaluate(self) -> dict:
        totals: dict = {}
        count = 0
        self.iterator.reset()
        for batch in self.iterator:
            metrics = self.eval_fn(to_device(batch, self.comm.device))
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + _to_float(v)
            count += 1
        return {k: v / max(count, 1) for k, v in totals.items()}

    def __call__(self, trainer):
        result = self.evaluate()
        trainer.observation.update(
            {f"{self.prefix}/{k}": v for k, v in result.items()})


class Snapshot:
    """Periodic checkpoint through a checkpointer (see
    :mod:`chainermn_tpu_torch.extensions.checkpoint`): at each ``trigger``
    save ``state_getter(trainer)`` as generation ``updater.iteration``.
    It runs after the other extensions of the same iteration (priority
    30), so it saves what they left."""

    priority = 30

    def __init__(self, checkpointer, state_getter: Callable,
                 trigger=(1, "epoch")):
        self.trigger = trigger
        self._ckpt = checkpointer
        self._get = state_getter

    def __call__(self, trainer):
        self._ckpt.save(self._get(trainer), trainer.updater.iteration)


class StepTimer:
    """Every iteration: the step's loss, and the host's clock once the
    device has finished the step.  Call :meth:`start` right before
    ``trainer.run()`` and :meth:`result` after it."""

    trigger = (1, "iteration")

    def __init__(self, device):
        self.device = device
        self.losses: List = []
        self.marks: List[float] = []  # marks[i]: after step i (0: start)

    def _mark(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.marks.append(time.perf_counter())

    def start(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self._mark()

    def __call__(self, trainer):
        self.losses.append(trainer.observation["main/loss"])
        self._mark()

    def result(self, images_per_step: int, warmup: int):
        """``(losses, images_per_sec, peak_gb)``: every step's loss as a
        float, ``images_per_step`` over the steps after ``warmup`` (None
        when there are none), and the device's peak memory since
        :meth:`start` (None on the CPU)."""
        losses = [float(v) for v in self.losses]
        ips = None
        if len(losses) > warmup:
            ips = (images_per_step * (len(losses) - warmup)
                   / (self.marks[-1] - self.marks[warmup]))
        peak = (torch.cuda.max_memory_allocated(self.device) / 1e9
                if self.device.type == "cuda" else None)
        return losses, ips, peak


__all__ = ["Evaluator", "LogReport", "MetricsReport", "PrintReport",
           "Snapshot", "StepTimer"]
