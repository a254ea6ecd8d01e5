"""Tensor (Megatron-style intra-layer) parallelism.

Counterpart of ``chainermn_tpu/parallel/tensor.py``: the two sharded
linear layers and the MLP built from them, over the ranks of a
communicator where the JAX layers take a mesh ``axis_name``.

* :class:`ColumnParallelDense` -- the weight's output features sharded
  over the ranks; each rank computes its slice of the output.  The result
  stays feature-sharded (``gather_output=False``, to feed a
  :class:`RowParallelDense`) or is gathered to the full width on every
  rank, rank ``i``'s slice at columns ``[i f, (i + 1) f)``: JAX builds it
  as a psum of a position-scattered buffer, which is this all-gather's
  value, and whose transpose hands each rank its own columns of the
  cotangent (the backward here);
* :class:`RowParallelDense` -- the weight's input features sharded; each
  rank multiplies its slice of the input, one all-reduce sums the partial
  products (backward: the cotangent passed through, JAX's transpose of a
  psum to a replicated value), and the replicated bias is added once,
  after the sum;
* :class:`TensorParallelMLP` -- Column -> tanh GELU -> Row, one
  all-reduce a block.

The layers are ``nn.Module`` s whose parameters are the LOCAL shards:
``weight`` ``[out, in]`` as the port's ``Dense`` (flax ``kernel`` is
``[in, out]``), ``bias``.  Each computes in ``dtype`` from float32
parameters, the input and weight cast first and the bias added in
``dtype``, as flax's ``jnp.dot`` then ``+ b``.  ``comm=None`` is a world
of one (no collective).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch import functions
from chainermn_tpu_torch.models.resnet import _lecun_normal_
from chainermn_tpu_torch.parallel.topology import resolve_device


def _size(comm) -> int:
    return 1 if comm is None else comm.size


class _GatherLast(torch.autograd.Function):
    """Every rank's ``y [..., f]`` concatenated on the last axis in rank
    order; backward: this rank's columns of the cotangent."""

    @staticmethod
    def forward(ctx, comm, y):
        ctx.comm, ctx.f = comm, y.shape[-1]
        stack = comm.allgather(y.contiguous())          # [P, ..., f]
        return torch.movedim(stack, 0, -2).reshape(
            y.shape[:-1] + (comm.size * ctx.f,))

    @staticmethod
    def backward(ctx, g):
        r, f = ctx.comm.rank, ctx.f
        return None, g[..., r * f:(r + 1) * f]


def _param(shape, fan_in, device, generator, init):
    w = nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))
    if init == "zeros":
        nn.init.zeros_(w)
    else:
        _lecun_normal_(w, fan_in, generator)
    return w


class ColumnParallelDense(nn.Module):
    """Output-feature-sharded dense layer: the full input -> this rank's
    ``features`` output columns (``features`` is the LOCAL count, the
    global width over the world size); ``gather_output`` gathers the full
    width on every rank."""

    def __init__(self, in_features: int, features: int, comm=None, *,
                 gather_output: bool = False, use_bias: bool = True,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.comm, self.gather_output, self.dtype = comm, gather_output, dtype
        self.weight = _param((features, in_features), in_features, device,
                             generator, "lecun")
        self.bias = _param((features,), 0, device, None, "zeros") \
            if use_bias else None

    def forward(self, x):
        dt = self.dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        if self.gather_output and _size(self.comm) > 1:
            y = _GatherLast.apply(self.comm, y)
        return y


class RowParallelDense(nn.Module):
    """Input-feature-sharded dense layer: this rank's ``in_features``
    slice of the input -> the full ``features`` output, the partial
    products summed over the ranks (one all-reduce) and the replicated
    bias added after the sum."""

    def __init__(self, in_features: int, features: int, comm=None, *,
                 use_bias: bool = True, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.comm, self.dtype = comm, dtype
        self.weight = _param((features, in_features), in_features, device,
                             generator, "lecun")
        self.bias = _param((features,), 0, device, None, "zeros") \
            if use_bias else None

    def forward(self, x):
        dt = self.dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        if _size(self.comm) > 1:
            y = functions.allreduce(self.comm, y)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class TensorParallelMLP(nn.Module):
    """Column -> ``activation`` -> Row, the Megatron MLP block.
    ``hidden`` is the GLOBAL hidden width, which the world size must
    divide (JAX's ``ValueError``); the output width is ``d_model``."""

    def __init__(self, d_model: int, hidden: int, comm=None, *,
                 activation: Callable = gelu, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        size = _size(comm)
        if hidden % size:
            raise ValueError(
                f"hidden ({hidden}) must divide by the tp axis size "
                f"({size})")
        self.activation = activation
        self.up = ColumnParallelDense(d_model, hidden // size, comm,
                                      dtype=dtype, device=device,
                                      generator=generator)
        self.down = RowParallelDense(hidden // size, d_model, comm,
                                     dtype=dtype, device=device,
                                     generator=generator)

    def forward(self, x):
        return self.down(self.activation(self.up(x)))


__all__ = ["ColumnParallelDense", "RowParallelDense", "TensorParallelMLP"]
