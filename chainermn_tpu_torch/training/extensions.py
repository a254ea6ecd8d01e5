"""Trainer extensions (the Chainer ``training.extensions`` role).

Counterpart of ``chainermn_tpu/training/extensions.py``: ``LogReport``,
``PrintReport``, ``Evaluator`` and ``Snapshot``; the examples' own
``StepTimer``.  The reference gates the
reports to rank 0 in every example (``if comm.rank == 0:
trainer.extend(...)``); the same pattern applies here.  ``MetricsReport``
waits for observability (ROADMAP.md, Queue A13).
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
    table, each time the log grows."""

    priority = 40

    def __init__(self, entries: List[str], log_report: str = "LogReport",
                 out=sys.stdout):
        self.trigger = (1, "epoch")
        self._entries = entries
        self._log_report = log_report
        self._out = out
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


__all__ = ["Evaluator", "LogReport", "PrintReport", "Snapshot", "StepTimer"]
