"""Differentiable point-to-point communication.

Counterpart of ``chainermn_tpu/functions/point_to_point_communication.py``
(the reference's ``Send``/``Recv`` functions).  Three kinds of transfer:

* :func:`send` / :func:`recv` / :func:`pseudo_connect` (JAX ``:80``,
  ``:93``, ``:115``): the in-process channel between model-parallel stages
  that live in one process.  ``send`` records ``x`` under ``(src, dst,
  tag)`` and returns a zero-size *delegate* that depends on ``x``; ``recv``
  pops it (a recv before its send raises); ``pseudo_connect`` ties a
  delegate into other values with a zero add, so that one ``backward()``
  reaches the send.  Nothing is copied: the received tensor is the sent one.
* :func:`cross_send` / :func:`cross_recv` (JAX ``:198``, ``:274``): between
  ranks, one process a GPU -- the reference's own deployment.  Each is a
  ``torch.autograd.Function`` over ``dist.send``/``dist.recv`` on the
  communicator's process group (NCCL on the card): the send's backward
  receives the cotangent from the destination, the recv's backward sends it
  back.  The shape/dtype/structure of a ``(peer, tag)`` channel is
  exchanged once on the object plane (``send_obj``/``recv_obj``, the gloo
  side group) and cached; a later payload of another shape raises
  ``ValueError``.
* :func:`spmd_send_recv` / :func:`spmd_send_recv_async` (JAX ``:142``):
  a permute inside one SPMD world; every rank ships its tensors along
  ``(src, dst)`` pairs of ranks (:meth:`MeshCommunicator.ppermute_async`,
  one ``batch_isend_irecv`` for every tensor) and a rank that receives
  nothing gets zeros; the backward ships the cotangents along the reversed
  pairs.  The async form splits the exchange into a start and a wait, so
  that work issued in between overlaps the transfer, in the forward pass
  and again in the backward pass.

Where torch differs from JAX:

* JAX's ``cross_recv`` needs an ``anchor`` (a differentiated array) or its
  reverse transfer is pruned.  torch runs the backward of every node that
  reaches the loss, so both Functions here take a zero-size leaf that
  requires grad: their outputs require grad and their backwards always run
  once the output (or the delegate, through :func:`pseudo_connect` or
  ``links.pseudo_loss``) reaches the loss.  ``anchor=`` is accepted for
  the signature and not needed.  A received value that never reaches the
  loss leaves its sender waiting for a cotangent, as in the reference.
* NCCL ignores ``tag``: the transfers between two ranks match by the order
  in which both ends issue them.  ``tag`` therefore names a channel for the
  handshake only; the handshake of a channel checks that the peer's next
  transfer was sent under the same tag and raises ``RuntimeError`` naming
  both tags where they differ, rather than let the data land in the wrong
  buffer.  The backward transfers pair in the reverse order of the forward
  ones on both ends (the autograd engine runs a device's nodes in reverse
  creation order), so a forward order that matches gives a backward order
  that matches.  ``MultiNodeChainList`` issues in registration order and
  checks the whole order before its first transfer.
* NCCL moves contiguous device memory only: every leaf is sent as a
  contiguous tensor on the communicator's device, and received there.
* The first transfer between two ranks creates their NCCL communicator;
  time steps after it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators._packing import (
    dtype_name, tree_flatten, tree_map, tree_unflatten)

# The object-plane tag of every handshake (the JAX package's "p2p_meta"
# band base); the channel's own tag travels inside the message.
_META_TAG = 1 << 21


class _ChannelState:
    """In-flight in-process sends keyed by ``(src, dst, tag)``; lives on
    the communicator."""

    def __init__(self):
        self.slots = {}

    def put(self, key, value):
        self.slots.setdefault(key, []).append(value)

    def pop(self, key):
        q = self.slots.get(key)
        if not q:
            raise RuntimeError(
                f"recv before matching send for channel {key}; model-parallel "
                "stages must send before the consumer stage runs")
        return q.pop(0)


def _channels(comm) -> _ChannelState:
    ch = getattr(comm, "_p2p_channels", None)
    if ch is None:
        ch = comm._p2p_channels = _ChannelState()
    return ch


def _delegate_of(x) -> torch.Tensor:
    """A zero-size float32 tensor that depends on every float leaf of
    ``x``: the reference's delegate variable."""
    leaves = [l for l in tree_flatten(x)[0]
              if isinstance(l, torch.Tensor) and l.is_floating_point()]
    dev = leaves[0].device if leaves else None
    return torch.cat([l.reshape(-1)[:0].float() for l in leaves]
                     + [torch.zeros(0, device=dev)])


def send(x, communicator, rank: int, tag: int = 0,
         self_rank: Optional[int] = None) -> torch.Tensor:
    """Ship ``x`` (a tensor or a tree of them) toward model-parallel stage
    ``rank`` of this process; returns the delegate.

    Reference: ``chainermn.functions.send(x, comm, rank)``."""
    src = self_rank if self_rank is not None else getattr(
        communicator, "_mp_rank", 0)
    _channels(communicator).put((src, rank, tag), x)
    return _delegate_of(x)


def recv(communicator, rank: int, delegate_variable=None, tag: int = 0,
         self_rank: Optional[int] = None, device_put=None):
    """The value stage ``rank`` of this process sent to this stage
    (``device_put(x)`` applied if given, then tied to
    ``delegate_variable``).

    Reference: ``chainermn.functions.recv(comm, rank, delegate_variable)``."""
    dst = self_rank if self_rank is not None else getattr(
        communicator, "_mp_rank", 0)
    x = _channels(communicator).pop((rank, dst, tag))
    if device_put is not None:
        x = device_put(x)
    if delegate_variable is not None:
        x = pseudo_connect(delegate_variable, x)
    return x


def pseudo_connect(delegate_variable, *actual_vars):
    """``actual_vars``, each float leaf plus a zero that depends on
    ``delegate_variable``: the values are unchanged and one backward from
    them reaches the delegate.  Integer and bool leaves pass through untied
    (they carry no gradient), as in JAX.

    Reference: ``chainermn.functions.pseudo_connect``."""
    d = delegate_variable
    pad = torch.cat([d.reshape(-1).float(),
                     torch.zeros(1, device=d.device)]).sum()

    def tie(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v + pad.to(v.device, v.dtype)
        return v

    out = tuple(tree_map(tie, v) for v in actual_vars)
    return out[0] if len(out) == 1 else out


# ---------------------------------------------------------------------------
# between ranks
# ---------------------------------------------------------------------------

def _meta_cache(communicator) -> dict:
    """The handshakes done, by ``("send"|"recv", peer, tag)``: a channel's
    structure, shapes and dtypes are fixed after its first transfer."""
    cache = getattr(communicator, "_p2p_meta_cache", None)
    if cache is None:
        cache = communicator._p2p_meta_cache = {}
    return cache


def _metas(leaves) -> list:
    return [(tuple(l.shape), dtype_name(l.dtype)) for l in leaves]


def _is_float(meta) -> bool:
    return getattr(torch, meta[1]).is_floating_point


class _Peer:
    """One direction of a ``(peer, tag)`` channel: the data and cotangent
    transfers on the communicator's process group."""

    def __init__(self, comm, peer: int, metas):
        self.comm, self.metas = comm, metas
        self.dst = comm._global_rank(peer)

    def send(self, tensors) -> None:
        for t in tensors:
            dist.send(t.detach().to(self.comm.device).contiguous(), self.dst,
                      group=self.comm.group)

    def recv(self, metas) -> List[torch.Tensor]:
        out = []
        for shape, dtype in metas:
            t = torch.empty(shape, dtype=getattr(torch, dtype),
                            device=self.comm.device)
            dist.recv(t, self.dst, group=self.comm.group)
            out.append(t)
        return out

    @property
    def float_metas(self):
        return [m for m in self.metas if _is_float(m)]


class _CrossSend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, peer, anchor, *leaves):
        peer.send(leaves)
        ctx.peer = peer
        ctx.devices = [l.device for l in leaves]
        ctx.set_materialize_grads(False)
        return anchor.new_zeros(0)

    @staticmethod
    def backward(ctx, _):
        peer = ctx.peer
        grads = iter(peer.recv(peer.float_metas))
        out = [next(grads).to(dev) if _is_float(m) else None
               for m, dev in zip(peer.metas, ctx.devices)]
        return (None, None) + tuple(out)


class _CrossRecv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, peer, anchor):
        outs = peer.recv(peer.metas)
        ctx.peer = peer
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        floats = [g for g, m in zip(grads, ctx.peer.metas) if _is_float(m)]
        ctx.peer.send(floats)
        return None, None


def _anchor(communicator) -> torch.Tensor:
    return torch.zeros(0, device=communicator.device, requires_grad=True)


def cross_send(x, communicator, dest_process: int, tag: int = 0):
    """Ship ``x`` (a tensor or a tree of them) to rank ``dest_process`` of
    ``communicator``; returns the delegate.  Its backward receives the
    cotangent of ``x``'s float leaves back from ``dest_process`` (the
    reference's ``Send.backward -> comm.recv(grad)``)."""
    leaves, treedef = tree_flatten(x)
    metas = _metas(leaves)
    cache = _meta_cache(communicator)
    key = ("send", dest_process, tag)
    if key not in cache:
        communicator.send_obj(("p2p-meta", tag, treedef, metas),
                              dest_process, tag=_META_TAG)
        cache[key] = (treedef, metas)
    elif cache[key] != (treedef, metas):
        raise ValueError(
            f"cross_send tag {tag} to process {dest_process} was first used "
            f"with a different payload structure/shape; a channel's shape is "
            "fixed after the first exchange — use a distinct tag per shape")
    peer = _Peer(communicator, dest_process, metas)
    return _CrossSend.apply(peer, _anchor(communicator), *leaves)


def cross_recv(communicator, source_process: int, tag: int = 0,
               delegate_variable=None, device_put=None, anchor=None):
    """The tree ``cross_send`` on rank ``source_process`` sent under
    ``tag``; its backward ships the float leaves' cotangent back
    (``Recv.backward -> comm.send(grad)``).  ``anchor`` is accepted for
    the JAX signature and not needed (see the module docstring);
    ``device_put`` places the received leaves, ``delegate_variable`` is
    tied in with :func:`pseudo_connect`."""
    del anchor
    cache = _meta_cache(communicator)
    key = ("recv", source_process, tag)
    if key in cache:
        treedef, metas = cache[key]
    else:
        kind, sent_tag, treedef, metas = communicator.recv_obj(
            source_process, tag=_META_TAG)
        if kind != "p2p-meta":
            raise RuntimeError(f"out-of-order p2p handshake: got {kind!r}")
        if sent_tag != tag:
            raise RuntimeError(
                f"cross_recv from process {source_process} under tag {tag}, "
                f"but that process's next transfer here was sent under tag "
                f"{sent_tag}: transfers between two ranks match by the order "
                "both ends issue them (NCCL has no tags), so they must issue "
                "them in the same order")
        cache[key] = (treedef, metas)
    peer = _Peer(communicator, source_process, metas)
    leaves = list(_CrossRecv.apply(peer, _anchor(communicator)))
    if device_put is not None:
        leaves = [device_put(l) for l in leaves]
    x = tree_unflatten(treedef, leaves)
    if delegate_variable is not None:
        x = pseudo_connect(delegate_variable, x)
    return x


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


__all__ = ["Pending", "cross_recv", "cross_send", "pseudo_connect", "recv",
           "send", "spmd_send_recv", "spmd_send_recv_async"]
