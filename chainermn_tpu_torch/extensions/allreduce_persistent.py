"""Persistent-value (BatchNorm statistics) synchronization.

Counterpart of ``chainermn_tpu/extensions/allreduce_persistent.py`` (the
reference's ``AllreducePersistent``): a trainer extension that replaces the
persistent, non-gradient arrays -- the BatchNorm running mean and variance,
which flax keeps in ``batch_stats`` -- by their mean over the ranks, so
snapshots and evaluation see the same statistics everywhere.  Training
keeps its rank-local BatchNorm; this averages on demand, as in the
reference.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch.communicators import _packing

# the buffers averaged on a module (torch's BatchNorm names, which the
# port's norm layers keep)
PERSISTENT = ("running_mean", "running_var")


def persistent_buffers(model: nn.Module):
    """``[(name, buffer)]`` of the model's BatchNorm running statistics."""
    return [(n, b) for n, b in model.named_buffers()
            if n.rsplit(".", 1)[-1] in PERSISTENT]


def allreduce_persistent(stats, communicator):
    """The world mean of persistent state.

    ``stats``: a module, whose running statistics are replaced in place by
    their mean (returns the module), or a tree of tensors (returns the tree
    of means).  One all-reduce per dtype over the packed buffers, then
    ``/ size``, as the JAX package's ``psum / size``.
    """
    comm = communicator
    is_module = isinstance(stats, nn.Module)
    tree = [b for _, b in persistent_buffers(stats)] if is_module else stats
    bufs, meta = _packing.pack(tree)
    for b in bufs:
        dist.all_reduce(b, dist.ReduceOp.SUM, group=comm.group)
        b.div_(comm.size)
    means = _packing.unpack(bufs, meta)
    if not is_module:
        return means
    with torch.no_grad():
        for b, m in zip(tree, means):
            b.copy_(m)
    return stats


class AllreducePersistent:
    """Trainer-extension form (the reference class name): at each trigger
    (every epoch by default) average ``model``'s running statistics over
    the world."""

    priority = 70
    trigger = (1, "epoch")

    def __init__(self, communicator, model: nn.Module):
        self._comm = communicator
        self._model = model

    def __call__(self, trainer):
        allreduce_persistent(self._model, self._comm)


__all__ = ["AllreducePersistent", "allreduce_persistent"]
