"""Minimal trainer loop.

Counterpart of ``chainermn_tpu/training/trainer.py``.  In the reference the
loop (``Trainer`` / ``StandardUpdater`` / trigger-driven extensions) is
Chainer's, and ChainerMN interposes at the dataset, the optimizer and the
extensions.  The same script shape works here:

    updater = StatefulUpdater(train_iter, step, model, comm)
    trainer = Trainer(updater, (args.epoch, "epoch"))
    trainer.run()

The step is :func:`chainermn_tpu_torch.optimizers.make_train_step`.
Extensions (``training/extensions.py``: ``LogReport``, ``PrintReport``,
``Evaluator``) run in order of their ``priority``, each when its
``trigger`` fires; the trainer also keeps a plain rank-0 print on
``log_trigger``.  ``Snapshot`` and ``MetricsReport`` are not ported yet
(ROADMAP.md, Queues A4 and A13).
"""

from __future__ import annotations

import os
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

    def finalize(self) -> None:
        """End of training: let the step finish what it left in flight."""
        getattr(self.step_fn, "finalize", lambda: None)()


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

    ``out``: directory for the extensions' files (``None``: they write
    none).  ``log_trigger``: when rank 0 prints the iteration, epoch,
    elapsed time and observation (``None``: never).  When the loop ends,
    the updater's ``finalize`` runs (the double-buffered optimizer's last
    gradient mean completes there)."""

    def __init__(self, updater, stop_trigger: Tuple[int, str] = (20, "epoch"),
                 log_trigger: Optional[Tuple[int, str]] = (1, "epoch"),
                 out: Optional[str] = None):
        self.updater = updater
        self.stop_trigger = stop_trigger
        self.log_trigger = log_trigger
        self.out = out
        self.observation: dict = {}
        self._extensions = []  # (name, ext, trigger, priority)
        self.elapsed_time = 0.0

    def extend(self, extension: Callable,
               trigger: Optional[Tuple[int, str]] = None,
               name: Optional[str] = None, priority: Optional[int] = None):
        """Call ``extension(trainer)`` whenever ``trigger`` fires (default:
        the extension's own ``trigger``, else every epoch), higher
        ``priority`` first (default: its own, else 100)."""
        trigger = trigger or getattr(extension, "trigger", (1, "epoch"))
        priority = priority if priority is not None else getattr(
            extension, "priority", 100)
        name = name or getattr(extension, "name", None) or \
            type(extension).__name__
        self._extensions.append((name, extension, trigger, priority))
        self._extensions.sort(key=lambda t: -t[3])

    def get_extension(self, name: str):
        for n, ext, _, _ in self._extensions:
            if n == name:
                return ext
        raise KeyError(name)

    def _stop(self) -> bool:
        n, unit = self.stop_trigger
        if unit == "epoch":
            return self.updater.epoch >= n
        return self.updater.iteration >= n

    def run(self):
        if self.out is not None:
            os.makedirs(self.out, exist_ok=True)
        start = time.perf_counter()
        while not self._stop():
            self.observation = self.updater.update()
            self.elapsed_time = time.perf_counter() - start
            for _, ext, trigger, _ in self._extensions:
                if _trigger_fires(trigger, self.updater):
                    ext(self)
            if self.log_trigger is not None and \
                    self.updater.comm.rank == 0 and \
                    _trigger_fires(self.log_trigger, self.updater):
                self.print_report()
        self.updater.finalize()

    def print_report(self):
        vals = " ".join(f"{k}={float(v):.6g}"
                        for k, v in self.observation.items())
        print(f"epoch={self.updater.epoch} "
              f"iteration={self.updater.iteration} {vals} "
              f"elapsed_time={self.elapsed_time:.3f}", flush=True)
