"""Differentiable collective communication.

Counterpart of ``chainermn_tpu/functions/collective_communication.py`` (the
reference's ``AllGather``, ``AllToAll``, ``Bcast``, ``Gather`` and
``Scatter`` Chainer Functions): each collective of the communicator wrapped
in a ``torch.autograd.Function`` whose backward is the transposed
collective.  JAX derives those transposes from XLA's collectives; here they
are written out:

* ``allgather`` -> reduce-scatter of every rank's cotangent;
* ``alltoall`` -> ``alltoall`` (its own transpose);
* ``bcast`` -> every rank's cotangent summed onto the root (zeros
  elsewhere);
* ``gather`` (every rank gets the stack, as in the JAX package) ->
  as ``allgather``: the scatter of the cotangents summed over the ranks;
* ``scatter`` -> the gather of the cotangents onto the root (zeros
  elsewhere);
* ``allreduce`` ``"sum"`` -> the identity of the cotangent, ``"mean"`` ->
  the cotangent over ``size``: the cotangent of an all-reduced value is the
  same on every rank, so each rank's input takes it once.  This is the
  documented contract of the JAX file (``:66-81``), not what a jax version
  that transposes ``psum`` to ``psum`` returns (``size`` times it).
  ``"max"``/``"min"`` are not differentiable.

Every rank must call each function, in the same order, and run backward
through the same calls: the backward issues the transposed collectives.
``x`` may be a tensor or a dict / list / tuple of tensors.
"""

from __future__ import annotations

import torch

from chainermn_tpu_torch.communicators import _packing


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.allgather(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.reduce_scatter(g).squeeze(0)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, xs):
        ctx.comm = comm
        return comm.alltoall(xs)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.alltoall(g)


def _on_root(comm, root, g):
    """``g`` on ``root``, zeros on the other ranks."""
    return g if comm.rank == root else torch.zeros_like(g)


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, root):
        ctx.comm, ctx.root = comm, root
        return comm.bcast(x, root=root)

    @staticmethod
    def backward(ctx, g):
        total = ctx.comm.allreduce(g, op="sum")
        return None, _on_root(ctx.comm, ctx.root, total), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, root):
        ctx.comm, ctx.root = comm, root
        return comm.scatter(x, root=root)

    @staticmethod
    def backward(ctx, g):
        stack = ctx.comm.allgather(g.contiguous())
        return None, _on_root(ctx.comm, ctx.root, stack), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, op):
        ctx.scale = 1.0 / comm.size if op == "mean" else None
        return comm.allreduce(x, op=op)

    @staticmethod
    def backward(ctx, g):
        return None, g if ctx.scale is None else g * ctx.scale, None


def allgather(communicator, x):
    """Every rank's ``x``, stacked ``[size, ...]`` in rank order, on every
    rank.  Backward: each rank's ``x`` gets the sum over the ranks of its
    slot of their cotangents (reduce-scatter)."""
    return _packing.tree_map(lambda v: _AllGather.apply(communicator, v), x)


def alltoall(communicator, xs):
    """Transposed exchange of per-peer slots (leading axis == size): slot
    ``q`` of the result is rank ``q``'s slot ``rank``.  Backward:
    ``alltoall`` of the cotangent."""
    return _packing.tree_map(lambda v: _AllToAll.apply(communicator, v), xs)


def bcast(communicator, x, root: int = 0):
    """``root``'s ``x`` on every rank.  Backward: the cotangents of every
    rank summed onto ``root``; the other ranks' ``x`` get zeros."""
    return _packing.tree_map(lambda v: _Bcast.apply(communicator, v, root),
                             x)


def gather(communicator, x, root: int = 0):
    """Gather onto ``root``; every rank gets the stack, as in the JAX
    package (an SPMD program has one output shape on every device), so
    this is :func:`allgather` and ``root`` is kept for the reference
    signature.  Backward: a scatter of the cotangent summed over the ranks
    (the reference's scatter of root's cotangent when only root's stack
    reaches the loss)."""
    del root
    return allgather(communicator, x)


def scatter(communicator, x, root: int = 0):
    """Rank r takes slot r of ``root``'s stacked ``[size, ...]`` value (the
    other ranks pass a tensor of its shape).  Backward: ``root``'s ``x``
    gets the stack of every rank's cotangent; the others get zeros."""
    return _packing.tree_map(lambda v: _Scatter.apply(communicator, v, root),
                             x)


def allreduce(communicator, x, op: str = "sum"):
    """All-reduce with the documented backward: ``"sum"`` passes the
    cotangent through, ``"mean"`` divides it by ``size``; ``"max"`` and
    ``"min"`` are the communicator's, not differentiable."""
    if op in ("sum", "mean"):
        return _packing.tree_map(
            lambda v: _AllReduce.apply(communicator, v, op), x)
    return communicator.allreduce(x, op=op)


__all__ = ["allgather", "allreduce", "alltoall", "bcast", "gather",
           "scatter"]
