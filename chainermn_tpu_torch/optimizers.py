"""Multi-node optimizer — gradient allreduce woven into the update step.

Counterpart of ``chainermn_tpu/optimizers.py`` (the reference's
``create_multi_node_optimizer``): wrap any optimizer so that its step runs
``comm.allreduce_grad`` on the gradients of the local forward/backward,
then the inner update.  Here the wrapped object is a ``torch.optim``
optimizer (the JAX package wraps an optax transformation).

``double_buffering=True`` is the fork's double-buffered optimizer.  ZeRO-1
and compressed gradients are not ported yet (ROADMAP.md, Queue A3); asking
for them raises.
"""

from __future__ import annotations

from typing import Callable

import torch


class _MultiNodeOptimizer:
    """``step()`` = allreduce-mean the gradients, then the inner step.

    Every other attribute (``param_groups``, ``state``, ``zero_grad``,
    ``state_dict``...) is the wrapped optimizer's, as in the reference.
    """

    def __init__(self, actual_optimizer: torch.optim.Optimizer, comm):
        self.actual_optimizer = actual_optimizer
        self.communicator = comm

    def __getattr__(self, name):
        return getattr(self.actual_optimizer, name)

    def allreduce_grad(self) -> None:
        params = [p for g in self.actual_optimizer.param_groups
                  for p in g["params"] if p.grad is not None]
        reduced = self.communicator.allreduce_grad([p.grad for p in params])
        for p, g in zip(params, reduced):
            p.grad = g

    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError(
                "a closure would re-run forward/backward after the "
                "gradients were averaged; call backward, then step()")
        self.allreduce_grad()
        return self.actual_optimizer.step()


class _DoubleBufferingOptimizer(_MultiNodeOptimizer):
    """The fork's double-buffered optimizer (JAX ``optimizers.py:120``).

    Update t applies the world mean of step t-1's local gradients (one
    step of staleness); update 0 applies zeros, through the inner step, so
    Adam's step count and SGD's momentum buffer advance as optax's do.

    The mean of step t's gradients starts at update t: they are packed
    (copied, so ``zero_grad(set_to_none=True)`` may free them) and the
    communicator leaves the all-reduce in flight -- the ``xla`` flavor
    casts to its wire dtype and issues it with ``async_op=True``.  Update
    t+1 waits for it, so on the card it overlaps step t+1's forward and
    backward, which is what the reference's side stream bought.  The
    closure that finishes it holds the buffers and the work handles until
    then.  Flavors of several collectives reduce at once (no overlap, the
    same values).
    """

    def __init__(self, actual_optimizer: torch.optim.Optimizer, comm):
        super().__init__(actual_optimizer, comm)
        self._pending = None  # finish() of the previous step's mean

    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError(
                "a closure would re-run forward/backward after the "
                "gradients were averaged; call backward, then step()")
        params = [p for g in self.actual_optimizer.param_groups
                  for p in g["params"]]
        if self._pending is None:
            stale = [torch.zeros_like(p) for p in params]
        else:
            stale = self._pending()
        # an unused parameter's local gradient is zero, as JAX's is
        self._pending = self.communicator._allreduce_grad_start(
            [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params])
        for p, g in zip(params, stale):
            p.grad = g
        return self.actual_optimizer.step()

    def _drain(self) -> None:
        """Wait for the mean in flight; the next update applies it as it
        would have.  For the end of training: no collective is left
        running."""
        if self._pending is not None:
            done = self._pending()
            self._pending = lambda: done


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator, double_buffering: bool = False,
                                zero: bool = False, compression=None):
    """Reference signature: ``create_multi_node_optimizer(optimizer, comm,
    double_buffering)``; ``actual_optimizer`` is a ``torch.optim``
    optimizer over the model's parameters."""
    for flag, what in ((zero, "zero=True"),
                       (compression is not None, "compression=")):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet; see ROADMAP.md Queue A3")
    if double_buffering:
        return _DoubleBufferingOptimizer(actual_optimizer, communicator)
    return _MultiNodeOptimizer(actual_optimizer, communicator)


def make_train_step(communicator, loss_fn: Callable, optimizer,
                    has_aux: bool = False):
    """The train step (the hot loop): forward/backward on the local batch,
    ``allreduce_grad``, then the inner update.

    ``loss_fn(batch) -> loss`` (or ``(loss, aux)`` with ``has_aux``, aux a
    dict of scalar tensors) runs the caller's module on this rank's local
    batch, as a reference rank ran its local minibatch.  The module's
    BatchNorm running statistics are buffers that the step never reduces:
    they stay rank-local, as ``make_train_step(with_model_state=True)``
    keeps them in the JAX package.  ``optimizer`` is from
    :func:`create_multi_node_optimizer`.

    Returns ``step(batch) -> loss`` (``(loss, aux)`` with ``has_aux``):
    the loss, and aux, averaged over the world.  ``step.finalize()`` waits
    for a gradient mean the double-buffered optimizer still has in flight
    (the trainer calls it when training ends).
    """
    comm = communicator

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(batch)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        optimizer.step()
        loss = comm.allreduce(loss.detach(), "mean")
        if not has_aux:
            return loss
        return loss, comm.allreduce(
            {k: v.detach() for k, v in aux.items()}, "mean")

    step.finalize = getattr(optimizer, "_drain", lambda: None)
    return step
