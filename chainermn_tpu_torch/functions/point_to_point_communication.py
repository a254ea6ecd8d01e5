"""Differentiable point-to-point communication inside one SPMD world.

Counterpart of ``spmd_send_recv`` in
``chainermn_tpu/functions/point_to_point_communication.py`` (``:142``):
each rank ships its tensors along ``(src, dst)`` pairs of ranks
(:meth:`MeshCommunicator.ppermute_async`, one ``batch_isend_irecv`` for
every tensor); a rank that receives nothing gets zeros.  The backward
ships the cotangents along the reversed pairs.

:func:`spmd_send_recv_async` splits the exchange into a start and a
wait, so that work issued in between overlaps the transfer, in the
forward pass and again in the backward pass (where the reversed exchange
starts in the wait's backward and completes in the start's).

The JAX file's cross-process ``send``/``recv``/``pseudo_connect`` and
``cross_send``/``cross_recv`` (the reference's model-parallel channels)
are not ported yet: ROADMAP.md Queue A7.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


class _Exchange:
    """The state one exchange's two autograd nodes share."""

    def __init__(self, comm, pairs):
        self.comm, self.pairs = comm, pairs
        self.back = [(b, a) for a, b in pairs]
        self.wait = self.grads = self.wait_back = None


class _Start(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ex, *xs):
        ctx.ex = ex
        outs, ex.wait = ex.comm.ppermute_async(list(xs), ex.pairs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        # gs are the cotangents _Wait.backward has already shipped
        ex = ctx.ex
        ex.wait_back()
        grads, ex.grads = ex.grads, None
        return (None,) + tuple(grads)


class _Wait(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ex, *ys):
        ctx.ex = ex
        ex.wait()
        return tuple(y.view_as(y) for y in ys)

    @staticmethod
    def backward(ctx, *gs):
        ex = ctx.ex
        ex.grads, ex.wait_back = ex.comm.ppermute_async(list(gs), ex.back)
        return (None,) + gs


class Pending:
    """An exchange in flight: :meth:`wait` returns what this rank
    receives."""

    def __init__(self, ex, outs, structure):
        self._ex, self._outs, self._structure = ex, outs, structure

    def wait(self):
        got = _Wait.apply(self._ex, *self._outs)
        if self._structure is None:
            return got[0]
        return self._structure(got)


def spmd_send_recv_async(x, communicator,
                         pairs: Sequence[Tuple[int, int]]) -> Pending:
    """Start shipping this rank's ``x`` (a tensor, or a list / tuple of
    tensors) along ``pairs`` of ranks of ``communicator``; the returned
    :class:`Pending`'s ``wait()`` gives what this rank receives, in
    ``x``'s structure (zeros if no pair names it as the destination).
    Every rank calls it with the same pairs, and reads nothing it
    received before ``wait()``."""
    pairs: List[Tuple[int, int]] = [(int(a), int(b)) for a, b in pairs]
    ex = _Exchange(communicator, pairs)
    if isinstance(x, torch.Tensor):
        return Pending(ex, _Start.apply(ex, x), None)
    return Pending(ex, _Start.apply(ex, *x), type(x))


def spmd_send_recv(x, communicator, pairs: Sequence[Tuple[int, int]]):
    """:func:`spmd_send_recv_async` waited for at once."""
    return spmd_send_recv_async(x, communicator, pairs).wait()


__all__ = ["Pending", "spmd_send_recv", "spmd_send_recv_async"]
