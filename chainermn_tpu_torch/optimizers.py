"""Multi-node optimizer — gradient allreduce woven into the update step.

Counterpart of ``chainermn_tpu/optimizers.py`` (the reference's
``create_multi_node_optimizer``): wrap any optimizer so that its step runs
``comm.allreduce_grad`` on the gradients of the local forward/backward,
then the inner update.  Here the wrapped object is a ``torch.optim``
optimizer (the JAX package wraps an optax transformation).

The fork's double-buffered optimizer, ZeRO-1 and compressed gradients are
not ported yet (ROADMAP.md, Queue A3); asking for them raises.
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


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator, double_buffering: bool = False,
                                zero: bool = False, compression=None):
    """Reference signature: ``create_multi_node_optimizer(optimizer, comm,
    double_buffering)``; ``actual_optimizer`` is a ``torch.optim``
    optimizer over the model's parameters."""
    for flag, what in ((double_buffering, "double_buffering=True"),
                       (zero, "zero=True"),
                       (compression is not None, "compression=")):
        if flag:
            raise NotImplementedError(
                f"{what} is not ported yet; see ROADMAP.md Queue A3")
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
    the loss, and aux, averaged over the world.
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

    return step
