"""Multi-node evaluator.

Counterpart of ``chainermn_tpu/extensions/multi_node_evaluator.py`` (the
reference's ``create_multi_node_evaluator(evaluator, comm)``, which
subclasses the wrapped evaluator at run time so that ``evaluate()`` runs on
the local validation shard and then all-reduce-averages the observation
dict; every rank reports the global validation metrics).

Two helpers, as in the JAX package: :func:`make_eval_fn` builds the eval
step (no autograd, the metrics of this rank's batch, averaged over the
world with ``comm.allreduce``), and :func:`create_multi_node_evaluator`
wraps an evaluator so that its result dict is averaged over the world
(``allreduce_obj``).
"""

from __future__ import annotations

from typing import Callable

import torch


def make_eval_fn(communicator, metrics_fn: Callable):
    """``eval_fn(batch) -> dict``: ``metrics_fn(batch)`` (a dict of scalar
    tensors for this rank's batch) under ``torch.no_grad``, averaged over
    the world.  Every rank must call it the same number of times."""
    comm = communicator

    def eval_fn(batch):
        with torch.no_grad():
            m = metrics_fn(batch)
        return comm.allreduce({k: v.detach() for k, v in m.items()}, "mean")

    return eval_fn


def create_multi_node_evaluator(actual_evaluator, communicator):
    """Wrap an evaluator so ``evaluate()`` returns world-averaged metrics.

    The wrapped object keeps its class's behaviour (the reference does this
    by dynamic subclassing, and so does this): only ``evaluate`` is
    overridden, to average its result dict over the world."""
    comm = communicator
    base = type(actual_evaluator)

    class _MultiNodeEvaluator(base):
        def evaluate(self, *args, **kwargs):
            local = base.evaluate(self, *args, **kwargs)
            summed = comm.allreduce_obj(local, op="sum")
            return {k: v / comm.size for k, v in summed.items()}

    actual_evaluator.__class__ = _MultiNodeEvaluator
    return actual_evaluator
