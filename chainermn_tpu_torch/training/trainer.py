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
``log_trigger``.  ``MetricsReport`` installs a
:class:`~chainermn_tpu_torch.observability.StepTelemetry` on the updater
(``updater.telemetry``), whose phases the updater then times.
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
    """numpy arrays (or a tuple of them) -> tensors on ``device``.  A uint8
    array (the real-image path's batch) goes to a card through pinned
    memory, without blocking the host."""
    if isinstance(batch, tuple):
        return tuple(to_device(b, device) for b in batch)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if t.dtype == torch.uint8 and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _batch_examples(batch) -> int:
    """Examples in a device batch (leading dim of the first tensor)."""
    while isinstance(batch, (tuple, list)) and batch:
        batch = batch[0]
    shape = getattr(batch, "shape", ())
    return int(shape[0]) if len(shape) else 0


class StandardUpdater:
    """Pulls this rank's batch, moves it to the device, runs the step.

    ``step_fn(batch) -> loss`` or ``(loss, aux)`` with aux a dict of
    scalars, typically from
    :func:`chainermn_tpu_torch.optimizers.make_train_step`; aux lands in
    the observation as ``main/<key>``.

    **Observability seam** (JAX's): :attr:`telemetry` is ``None`` by
    default and the flight recorder is bound once here (``None`` while
    observability is off), so the plain loop makes no observability call.
    When a :class:`~chainermn_tpu_torch.observability.StepTelemetry` is
    installed (normally by ``MetricsReport``), :meth:`update` times each
    phase: data-load (the iterator), host-put (to the device), dispatch
    (the step call) and device-block (a synchronize of the device's
    current stream, so the step has finished).  The synchronize trades the
    overlap of the host with the card for the breakdown; the values the
    step computes are the same.  ``examples`` counts the global batch
    (this rank's times the world size).
    """

    def __init__(self, iterator, step_fn: Callable, comm,
                 convert_batch: Optional[Callable] = None):
        self.iterator = iterator
        self.step_fn = step_fn
        self.comm = comm
        self._convert = convert_batch
        self.iteration = 0
        self.telemetry = None
        from chainermn_tpu_torch.observability import (
            flight_recorder as _flight)
        self._flight = _flight.get_flight_recorder()

    @property
    def epoch(self):
        return self.iterator.epoch

    @property
    def is_new_epoch(self):
        return self.iterator.is_new_epoch

    @property
    def epoch_detail(self):
        return self.iterator.epoch_detail

    def _put(self, batch):
        if self._convert is not None:
            batch = self._convert(batch)
        return to_device(batch, self.comm.device)

    def _apply_step(self, batch) -> dict:
        out = self.step_fn(batch)
        if not isinstance(out, tuple):
            return {"main/loss": out}
        obs = {"main/loss": out[0]}
        obs.update({f"main/{k}": v for k, v in out[1].items()})
        return obs

    def update(self) -> dict:
        tele = self.telemetry
        fl = self._flight
        if tele is None and fl is None:
            # fast path: no timing, no observability calls
            obs = self._apply_step(self._put(self.iterator.next()))
            self.iteration += 1
            return obs
        t0 = time.perf_counter()
        if fl is not None:
            fl.record_phase("data_load", self.iteration)
        raw = self.iterator.next()
        t1 = time.perf_counter()
        if fl is not None:
            fl.record_phase("host_put", self.iteration)
        batch = self._put(raw)
        t2 = time.perf_counter()
        if fl is not None:
            fl.record_phase("dispatch", self.iteration)
        obs = self._apply_step(batch)
        t3 = time.perf_counter()
        if tele is not None:
            # device_block only under telemetry: the flight recorder alone
            # keeps the host ahead of the card (the step event still
            # marks progress)
            if fl is not None:
                fl.record_phase("device_block", self.iteration)
            device = torch.device(self.comm.device)
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        t4 = time.perf_counter()
        self.iteration += 1
        if fl is not None:
            fl.record_step(t4 - t0, iteration=self.iteration)
        if tele is not None:
            tele.record_step(data_load=t1 - t0, host_put=t2 - t1,
                             dispatch=t3 - t2, device_block=t4 - t3,
                             examples=_batch_examples(batch)
                             * int(self.comm.size))
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


class FsdpUpdater(StandardUpdater):
    """Updater over a ZeRO-3/FSDP train step
    (:func:`~chainermn_tpu_torch.parallel.make_fsdp_train_step`).

    The :class:`~chainermn_tpu_torch.parallel.FsdpState` rides the updater
    as ``fsdp_state`` (the step updates it in place), and ``.params`` is a
    property that materializes the full parameters on demand
    (:func:`~chainermn_tpu_torch.parallel.fsdp_full_params`, a collective:
    every rank reads it together), so code written against
    ``updater.params`` keeps working.  Assigning to it raises
    ``AttributeError``: the parameters are derived from the shards.
    """

    def __init__(self, iterator, step_fn: Callable, fsdp_state, meta, comm,
                 convert_batch: Optional[Callable] = None):
        super().__init__(iterator, step_fn, comm, convert_batch)
        self.fsdp_state = fsdp_state
        self._meta = meta

    @property
    def params(self) -> dict:
        from chainermn_tpu_torch.parallel.fsdp import fsdp_full_params
        return fsdp_full_params(self.fsdp_state, self._meta, self.comm)

    @params.setter
    def params(self, value):
        raise AttributeError(
            "FsdpUpdater.params is derived from the sharded FsdpState "
            "(fsdp_state); restore the state instead")


class FsdpStatefulUpdater(FsdpUpdater):
    """FsdpUpdater over a model with rank-local mutable state (the
    BatchNorm running buffers), as :class:`StatefulUpdater`: the state
    lives in ``model`` and the step updates it."""

    def __init__(self, iterator, step_fn: Callable, fsdp_state, meta, model,
                 comm, convert_batch: Optional[Callable] = None):
        super().__init__(iterator, step_fn, fsdp_state, meta, comm,
                         convert_batch)
        self.model = model


class Trainer:
    """Trigger-driven training loop (the Chainer ``Trainer`` role).

    ``out``: directory for the extensions' files (``None``: they write
    none).  ``log_trigger``: when rank 0 prints the iteration, epoch,
    elapsed time and observation (``None``: never).  Before the loop each
    extension's ``initialize(trainer)`` runs, where it has one; when the
    loop ends, the updater's ``finalize`` runs (the double-buffered
    optimizer's last gradient mean completes there), then each extension's
    ``finalize(trainer)``."""

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
        for _, ext, _, _ in self._extensions:
            if hasattr(ext, "initialize"):
                ext.initialize(self)
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
        for _, ext, _, _ in self._extensions:
            if hasattr(ext, "finalize"):
                ext.finalize(self)

    def print_report(self):
        vals = " ".join(f"{k}={float(v):.6g}"
                        for k, v in self.observation.items())
        print(f"epoch={self.updater.epoch} "
              f"iteration={self.updater.iteration} {vals} "
              f"elapsed_time={self.elapsed_time:.3f}", flush=True)
