"""Synchronized (multi-node) batch normalization.

Counterpart of ``chainermn_tpu/links/multi_node_batch_normalization.py``
(the reference's ``MultiNodeBatchNormalization``, which the JAX package
builds as flax ``nn.BatchNorm`` with the communicator's data axes bound):
BatchNorm whose batch mean and variance are those of the global batch.
Each rank takes the mean of x and of x^2 over its batch, the two are
averaged over the world in one all-reduce, and var = mean(x^2) - mean^2,
clipped at 0 (flax's fast variance).  The ranks' batches must be of one
size (a mean of means, as ``pmean`` takes).

The all-reduce is an autograd function whose backward all-reduces the
cotangent too, so every rank's input gradient is its slice of the gradient
over the global batch.  The running statistics follow flax, not
``nn.BatchNorm2d``: ``momentum * running + (1 - momentum) * batch`` with
the biased batch variance, momentum 0.9 and epsilon 2e-5 by default (the
reference's decay and eps).  The model zoo keeps its local BatchNorm and
``AllreducePersistent``, the reference's default; use this layer where
per-rank batches are too small for local statistics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn


class _AllreduceMean(torch.autograd.Function):
    """The world mean of a tensor; its backward is the world mean of the
    cotangent (each rank's loss reaches every rank's statistics)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        y = x.clone()
        dist.all_reduce(y, dist.ReduceOp.SUM, group=comm.group)
        return y / comm.size

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        g = g.contiguous().clone()
        dist.all_reduce(g, dist.ReduceOp.SUM, group=comm.group)
        return g / comm.size, None


class MultiNodeBatchNormalization(nn.Module):
    """BatchNorm over the world's batch (reference signature:
    ``MultiNodeBatchNormalization(size, comm, decay, eps)``).

    Takes ``[N, C]`` or ``[N, C, H, W]``; the statistics are taken over
    every axis but the channel axis, in float32; the output is in
    ``dtype`` (default: the promotion of the input's dtype with float32).
    Train or eval mode follows ``self.training``.
    """

    def __init__(self, size: int, communicator, momentum: float = 0.9,
                 eps: float = 2e-5, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.comm = communicator
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        f32 = {"dtype": torch.float32, "device": device}
        self.weight = nn.Parameter(torch.ones((size,), **f32))
        self.bias = nn.Parameter(torch.zeros((size,), **f32))
        self.register_buffer("running_mean", torch.zeros((size,), **f32))
        self.register_buffer("running_var", torch.ones((size,), **f32))

    def forward(self, x):
        odt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        xf = x.float()
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            moments = torch.stack([xf.mean(axes), (xf * xf).mean(axes)])
            mean, mean2 = _AllreduceMean.apply(moments, self.comm)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
        return y.to(odt)


__all__ = ["MultiNodeBatchNormalization"]
