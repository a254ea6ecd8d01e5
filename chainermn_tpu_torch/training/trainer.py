"""Minimal trainer loop.

Counterpart of ``chainermn_tpu/training/trainer.py``.  In the reference the
loop (``Trainer`` / ``StandardUpdater`` / trigger-driven extensions) is
Chainer's, and ChainerMN interposes at the dataset, the optimizer and the
extensions.  The same script shape works here:

    updater = StatefulUpdater(train_iter, step, model, comm)
    trainer = Trainer(updater, (args.epoch, "epoch"))
    trainer.run()

The step is :func:`chainermn_tpu_torch.optimizers.make_train_step`.  The
reports of the JAX package (``LogReport``/``PrintReport``) are a plain
print on rank 0 here; the other extensions are not ported yet
(ROADMAP.md, Queue A4).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _trigger_fires(trigger: Tuple[int, str], updater) -> bool:
    n, unit = trigger
    if unit == "iteration":
        return updater.iteration % n == 0
    if unit == "epoch":
        return updater.is_new_epoch and updater.epoch % n == 0
    raise ValueError(f"unknown trigger unit {unit!r}")


def to_device(batch, device):
    """numpy arrays (or a tuple of them) -> tensors on ``device``."""
    if isinstance(batch, tuple):
        return tuple(to_device(b, device) for b in batch)
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)


class StandardUpdater:
    """Pulls this rank's batch, moves it to the device, runs the step.

    ``step_fn(batch) -> loss`` or ``(loss, aux)`` with aux a dict of
    scalars, typically from
    :func:`chainermn_tpu_torch.optimizers.make_train_step`; aux lands in
    the observation as ``main/<key>``.
    """

    def __init__(self, iterator, step_fn: Callable, comm,
                 convert_batch: Optional[Callable] = None):
        self.iterator = iterator
        self.step_fn = step_fn
        self.comm = comm
        self._convert = convert_batch
        self.iteration = 0

    @property
    def epoch(self):
        return self.iterator.epoch

    @property
    def is_new_epoch(self):
        return self.iterator.is_new_epoch

    @property
    def epoch_detail(self):
        return self.iterator.epoch_detail

    def update(self) -> dict:
        batch = self.iterator.next()
        if self._convert is not None:
            batch = self._convert(batch)
        batch = to_device(batch, self.comm.device)
        out = self.step_fn(batch)
        self.iteration += 1
        if not isinstance(out, tuple):
            return {"main/loss": out}
        obs = {"main/loss": out[0]}
        obs.update({f"main/{k}": v for k, v in out[1].items()})
        return obs


class StatefulUpdater(StandardUpdater):
    """StandardUpdater over a model with mutable, rank-local state (the
    BatchNorm running buffers), as the JAX package's ``StatefulUpdater``
    carries flax ``batch_stats``.  The state lives in ``model``; the step
    updates it."""

    def __init__(self, iterator, step_fn: Callable, model, comm,
                 convert_batch: Optional[Callable] = None):
        super().__init__(iterator, step_fn, comm, convert_batch)
        self.model = model


class Trainer:
    """Trigger-driven training loop (the Chainer ``Trainer`` role).

    ``log_trigger``: when rank 0 prints the iteration, epoch, elapsed time
    and observation (``None``: never)."""

    def __init__(self, updater, stop_trigger: Tuple[int, str] = (20, "epoch"),
                 log_trigger: Optional[Tuple[int, str]] = (1, "epoch")):
        self.updater = updater
        self.stop_trigger = stop_trigger
        self.log_trigger = log_trigger
        self.observation: dict = {}
        self._extensions = []  # (ext, trigger)
        self.elapsed_time = 0.0

    def extend(self, extension: Callable,
               trigger: Tuple[int, str] = (1, "epoch")):
        """Call ``extension(trainer)`` whenever ``trigger`` fires."""
        self._extensions.append((extension, trigger))

    def _stop(self) -> bool:
        n, unit = self.stop_trigger
        if unit == "epoch":
            return self.updater.epoch >= n
        return self.updater.iteration >= n

    def run(self):
        start = time.perf_counter()
        while not self._stop():
            self.observation = self.updater.update()
            self.elapsed_time = time.perf_counter() - start
            for ext, trigger in self._extensions:
                if _trigger_fires(trigger, self.updater):
                    ext(self)
            if self.log_trigger is not None and \
                    self.updater.comm.rank == 0 and \
                    _trigger_fires(self.log_trigger, self.updater):
                self.print_report()

    def print_report(self):
        vals = " ".join(f"{k}={float(v):.6g}"
                        for k, v in self.observation.items())
        print(f"epoch={self.updater.epoch} "
              f"iteration={self.updater.iteration} {vals} "
              f"elapsed_time={self.elapsed_time:.3f}", flush=True)
