"""Host-level object transport -- the control plane.

Counterpart of ``chainermn_tpu/runtime/control_plane.py``, the same tag
bands, the same binomial trees (each rank sends and receives the same
``(op, peer, tag)`` sequence as there) and the same pickled objects on
the wire: the MPI side of the reference -- pickled object
``send/recv/bcast/gather/scatter/allreduce_obj`` between ranks, plus the
bootstrap handshake.

The data plane (gradients, activations) is NCCL and never touches this
module.  The control plane carries *small Python objects* between the
processes of a run (one per GPU): dataset shards, metric dicts, seeds,
barrier tokens, straggler summaries.  It rides a socket transport (a C++
framing core in ``csrc/dcn_transport.cpp``, or the pure-Python transport
when ``CHAINERMN_TPU_PURE_PY_TRANSPORT=1`` asks for it -- see
``transport.py``).  A communicator uses it when it is given one
(``create_communicator(..., control_plane=)``); its default object plane
is a gloo side group (``communicators/mesh_communicator_base.py``).

A world of one gets :class:`SingleProcessControlPlane`, where every op is
local.
"""

from __future__ import annotations

import abc
import os
import pickle
from typing import Any, Callable, List, Optional

def _np():
    import numpy
    return numpy


def _pair_max(a, b):
    if hasattr(a, "shape") or hasattr(b, "shape"):
        return _np().maximum(a, b)
    return max(a, b)


def _pair_min(a, b):
    if hasattr(a, "shape") or hasattr(b, "shape"):
        return _np().minimum(a, b)
    return min(a, b)


# Pairwise reducers applied structurally (dicts / lists / scalars / ndarrays).
# The reference's allreduce_obj handled arbitrary reducibles over MPI ops
# 〔communicator_base.py〕; names map to the MPI op set, and any binary
# callable is accepted for custom reductions (applied at the object level —
# the caller owns the structure in that case).
_PAIR_OPS = {
    "sum": lambda a, b: a + b,
    "prod": lambda a, b: a * b,
    "max": _pair_max,
    "min": _pair_min,
}


def _structural(op):
    def apply(a, b):
        if isinstance(a, dict):
            return {k: apply(a[k], b[k]) for k in a}
        if isinstance(a, (list, tuple)):
            return type(a)(apply(x, y) for x, y in zip(a, b))
        return op(a, b)
    return apply


class TagBand:
    """One reserved slice of the control-plane tag space.

    ``base`` is the first tag in the band and ``width`` the number of
    consecutive tags the owner may consume starting there.  Width matters
    because the tree collectives are *arithmetic* consumers: a call to
    :meth:`ControlPlane.allgather_obj` or :meth:`ControlPlane.allreduce_obj`
    at ``tag`` uses both ``tag`` (the fold/gather leg) and ``tag + 1``
    (the broadcast leg), so every band they ride needs width >= 2.
    """

    __slots__ = ("name", "base", "width", "owner", "doc")

    def __init__(self, name: str, base: int, width: int, owner: str,
                 doc: str = ""):
        self.name = name
        self.base = base
        self.width = width
        self.owner = owner
        self.doc = doc

    @property
    def stop(self) -> int:
        """One past the last tag in the band."""
        return self.base + self.width

    def __contains__(self, tag: int) -> bool:
        return self.base <= tag < self.stop

    def as_dict(self) -> dict:
        return {"name": self.name, "base": self.base, "width": self.width,
                "owner": self.owner, "doc": self.doc}

    def __repr__(self):
        return (f"TagBand({self.name!r}, base={self.base}, "
                f"width={self.width}, owner={self.owner!r})")


#: Central registry of every reserved control-plane tag band.  Subsystems
#: that need a private tag namespace MUST claim a band here instead of
#: picking a magic number — ``cmn_lint --protocol`` (tag-band-collision)
#: cross-checks every static call site against this table.
RESERVED_TAG_BANDS = {band.name: band for band in (
    TagBand("default", 0, 2, "runtime",
            "The tag=0 object plane every collective defaults to; "
            "allgather/allreduce consume tags 0 and 1."),
    TagBand("telemetry", 770, 2, "observability",
            "Streaming fleet-telemetry gathers "
            "(ControlPlane.gather_telemetry)."),
    TagBand("barrier", 900, 2, "runtime",
            "ControlPlane.barrier rides an allgather at 900, "
            "so it consumes 900 and 901."),
    TagBand("p2p_grad", 1 << 20, 1 << 20, "functions",
            "Reverse-transfer (cotangent) namespace for cross-process "
            "p2p: user tag t maps to (1<<20) + t."),
    TagBand("p2p_meta", 1 << 21, 1 << 20, "functions",
            "Trace-time shape/treedef handshake namespace for "
            "cross-process p2p: user tag t maps to (1<<21) + t."),
    TagBand("flight", (1 << 28) + 7, 1, "observability",
            "Watchdog flight-dump solicitation over the raw transport."),
)}


def reserved_tag(name: str) -> int:
    """Base tag of the named reserved band (KeyError on unknown names)."""
    return RESERVED_TAG_BANDS[name].base


def band_of(tag: int):
    """The :class:`TagBand` covering ``tag``, or None if unreserved."""
    for band in RESERVED_TAG_BANDS.values():
        if tag in band:
            return band
    return None


#: Reserved tag band for the streaming fleet-telemetry aggregator
#: (observability/streaming.py).  Kept far from the default tag=0 object
#: plane and the barrier band (900) so per-step telemetry gathers can
#: never cross wires with user sends in flight on the same edge.
TELEMETRY_TAG = reserved_tag("telemetry")

#: Default barrier tag — barrier() is an allgather at this tag, so it
#: consumes BARRIER_TAG and BARRIER_TAG + 1 (see the "barrier" band).
BARRIER_TAG = reserved_tag("barrier")


def _resolve_op(op):
    if callable(op):
        return op  # custom binary reducible — object-level
    try:
        return _structural(_PAIR_OPS[op])
    except KeyError:
        raise ValueError(f"unknown op {op!r} "
                         f"(expected one of {sorted(_PAIR_OPS)} or a callable)")


class ControlPlane(abc.ABC):
    """Abstract host-level object transport (the reference's MPI role)."""

    rank: int
    size: int

    @abc.abstractmethod
    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None: ...

    @abc.abstractmethod
    def recv_obj(self, source: int, tag: int = 0) -> Any: ...

    def bcast_obj(self, obj: Any, root: int = 0, tag: int = 0) -> Any:
        """Binomial-tree broadcast: O(log n) DCN hops on the critical path
        (the reference got this for free from MPI's tree collectives
        〔mpi_communicator_base.py〕; a rank-0-serial loop would be O(n))."""
        if self.size == 1:
            return obj
        vrank = (self.rank - root) % self.size
        mask = 1
        while mask < self.size:
            if vrank & mask:
                src = ((vrank ^ mask) + root) % self.size
                obj = self.recv_obj(src, tag=tag)
                break
            mask <<= 1
        # children: vrank + m for each power of two m below our receive bit
        mask >>= 1
        while mask > 0:
            if vrank + mask < self.size:
                dst = ((vrank + mask) + root) % self.size
                self.send_obj(obj, dst, tag=tag)
            mask >>= 1
        return obj

    def _tree_fold(self, obj: Any, root: int, tag: int,
                   fold: Optional[Callable]) -> Optional[dict]:
        """Binomial-tree combine toward ``root``.

        With ``fold=None`` accumulates a {vrank: obj} dict (gather); with a
        binary ``fold`` combines payloads pairwise at each hop (reduce) so
        every edge carries one object, not a subtree list.
        Returns the combined payload on root, None elsewhere.
        """
        vrank = (self.rank - root) % self.size
        acc = obj if fold is not None else {vrank: obj}
        mask = 1
        while mask < self.size:
            if vrank & mask:
                dst = ((vrank ^ mask) + root) % self.size
                self.send_obj(acc, dst, tag=tag)
                return None
            src_v = vrank + mask
            if src_v < self.size:
                got = self.recv_obj((src_v + root) % self.size, tag=tag)
                acc = fold(acc, got) if fold is not None else {**acc, **got}
            mask <<= 1
        return acc

    def gather_obj(self, obj: Any, root: int = 0, tag: int = 0) -> Optional[List[Any]]:
        if self.size == 1:
            return [obj]
        acc = self._tree_fold(obj, root, tag, fold=None)
        if acc is None:
            return None
        return [acc[(r - root) % self.size] for r in range(self.size)]

    def allgather_obj(self, obj: Any, tag: int = 0) -> List[Any]:
        # Arithmetic tag consumer: the gather leg runs at ``tag`` and the
        # broadcast leg at ``tag + 1`` — callers must own BOTH tags (see
        # RESERVED_TAG_BANDS; every band an allgather rides needs width 2).
        gathered = self.gather_obj(obj, root=0, tag=tag)
        return self.bcast_obj(gathered, root=0, tag=tag + 1)

    def scatter_obj(self, objs: Optional[List[Any]], root: int = 0, tag: int = 0) -> Any:
        """Binomial-tree scatter: root hands each subtree its slice of the
        list, so the root sends O(log n) messages instead of n-1 (total
        payload-hops grow by the tree depth — the standard MPI small-message
        trade of bytes for latency)."""
        if self.size == 1:
            return objs[0]
        vrank = (self.rank - root) % self.size
        if self.rank == root:
            assert objs is not None and len(objs) == self.size
            sub = {i: objs[(i + root) % self.size] for i in range(self.size)}
            mask = 1
            while mask < self.size:
                mask <<= 1
            mask >>= 1
        else:
            sub = None
            mask = 1
            while mask < self.size:
                if vrank & mask:
                    sub = self.recv_obj(((vrank ^ mask) + root) % self.size,
                                        tag=tag)
                    break
                mask <<= 1
            mask >>= 1
        # forward each child its half of our subtree {vrank: obj} table
        # (invariant: sub holds exactly [vrank, vrank + 2*mask) ∩ [0, size))
        while mask > 0:
            child = vrank + mask
            if child < self.size:
                child_share = {i: o for i, o in sub.items()
                               if child <= i < child + mask}
                self.send_obj(child_share, ((child + root) % self.size),
                              tag=tag)
                sub = {i: o for i, o in sub.items() if i not in child_share}
            mask >>= 1
        return sub[vrank]

    def allreduce_obj(self, obj: Any, op="sum", tag: int = 0) -> Any:
        """Reference analogue: ``allreduce_obj`` on the communicator base —
        reduce pickled objects (numbers / dicts / nested ndarrays) across
        hosts.  ``op`` is "sum"/"prod"/"max"/"min" (applied structurally
        through dicts/lists, ndarray-aware) or any binary callable for
        custom reducibles.  Tree-reduce up + tree-bcast down: each DCN edge
        carries ONE combined object and the critical path is O(log n).

        Note: tree order ≠ serial left-fold order, so float sums can differ
        in the last ulp across world sizes (deterministic for a fixed
        size/topology) — same caveat as MPI's tree allreduce.
        """
        # Arithmetic tag consumer like allgather_obj: fold at ``tag``,
        # broadcast at ``tag + 1``.
        fold = _resolve_op(op)
        acc = self._tree_fold(obj, 0, tag, fold=fold)
        return self.bcast_obj(acc, root=0, tag=tag + 1)

    def barrier(self, tag: int = BARRIER_TAG) -> None:
        self.allgather_obj(None, tag=tag)

    def gather_telemetry(self, summary: Any, root: int = 0) -> Optional[List[Any]]:
        """Ship one compact per-step telemetry summary to ``root`` on the
        reserved :data:`TELEMETRY_TAG` band.  Collective: every rank must
        call it on the same step (the aggregator's emit trigger guarantees
        this).  Returns the rank-ordered list on root, None elsewhere."""
        return self.gather_obj(summary, root=root, tag=TELEMETRY_TAG)


class SingleProcessControlPlane(ControlPlane):
    """Degenerate world: one controller process (the usual single-host case)."""

    def __init__(self):
        self.rank = 0
        self.size = 1
        self._loopback: dict = {}

    def send_obj(self, obj, dest, tag=0):
        if dest != 0:
            raise ValueError(f"invalid dest {dest} in a single-process world")
        # Loopback send-to-self: buffer it (used by tests / rank-agnostic code)
        self._loopback.setdefault(tag, []).append(pickle.dumps(obj))

    def recv_obj(self, source, tag=0):
        if source != 0 or not self._loopback.get(tag):
            raise ValueError("nothing to receive in a single-process world")
        return pickle.loads(self._loopback[tag].pop(0))


class SocketControlPlane(ControlPlane):
    """Multi-process control plane over the socket transport.

    Bootstrap mirrors the reference's ``init_ranks`` handshake: every
    process registers its listen address with the coordinator (rank 0),
    which broadcasts the full peer table -- the "hostname allgather" of
    the MPI world, done over TCP.
    """

    def __init__(self, rank: int, size: int, coordinator: str, transport=None):
        from chainermn_tpu_torch.runtime import transport as transport_mod

        self.rank = rank
        self.size = size
        self._tp = transport or transport_mod.create_transport(rank, size, coordinator)
        # Observability seam, bound once at construction (None when off, so
        # the wire path adds no per-message work): pickled wire bytes and
        # message counts by direction -- the straggler traffic and
        # object-plane payloads of a multi-process run.
        self._obs_msgs = self._obs_bytes = None
        from chainermn_tpu_torch.observability.registry import (
            enabled, get_registry)
        if enabled():
            reg = get_registry()
            self._obs_msgs = reg.counter(
                "control_plane_messages", "DCN control-plane messages")
            self._obs_bytes = reg.counter(
                "control_plane_bytes", "pickled DCN control-plane bytes")

    def send_obj(self, obj, dest, tag=0):
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        if self._obs_msgs is not None:
            self._obs_msgs.inc(direction="send")
            self._obs_bytes.inc(len(payload), direction="send")
        self._tp.send(dest, tag, payload)

    def recv_obj(self, source, tag=0):
        payload = self._tp.recv(source, tag)
        if self._obs_msgs is not None:
            self._obs_msgs.inc(direction="recv")
            self._obs_bytes.inc(len(payload), direction="recv")
        return pickle.loads(payload)

    def shutdown(self):
        self._tp.close()


_DEFAULT_PLANE: Optional[ControlPlane] = None


def get_control_plane() -> ControlPlane:
    """Return the process-wide default control plane (memoized -- the socket
    bootstrap must run exactly once per process, like ``MPI_Init``).

    Env contract (JAX's): ``CHAINERMN_TPU_COORDINATOR=host:port``,
    ``CHAINERMN_TPU_NUM_PROCESSES``, ``CHAINERMN_TPU_PROCESS_ID`` come
    first; else, when ``torch.distributed`` is initialized with a world of
    more than one and ``MASTER_ADDR``/``MASTER_PORT`` are set (what
    ``torchrun`` exports), a socket world at ``MASTER_PORT + 1`` with
    ``dist``'s rank and size; else a world of one.
    """
    global _DEFAULT_PLANE
    if _DEFAULT_PLANE is None:
        _DEFAULT_PLANE = _create_control_plane()
    return _DEFAULT_PLANE


def _create_control_plane() -> ControlPlane:
    coord = os.environ.get("CHAINERMN_TPU_COORDINATOR")
    if coord:
        rank = int(os.environ["CHAINERMN_TPU_PROCESS_ID"])
        size = int(os.environ["CHAINERMN_TPU_NUM_PROCESSES"])
        return SocketControlPlane(rank, size, coord)
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        # the process group is up; put a socket world on the same hosts by
        # the coordinator address convention (JAX's: the port after it)
        host, port = os.environ.get("MASTER_ADDR"), \
            os.environ.get("MASTER_PORT")
        if host and port:
            return SocketControlPlane(dist.get_rank(), dist.get_world_size(),
                                      f"{host}:{int(port) + 1}")
    return SingleProcessControlPlane()


def reset_control_plane() -> None:
    """Shut down and forget the process-wide default plane (tests; a
    process that builds a new world)."""
    global _DEFAULT_PLANE
    plane, _DEFAULT_PLANE = _DEFAULT_PLANE, None
    if plane is not None and hasattr(plane, "shutdown"):
        plane.shutdown()


__all__ = ["BARRIER_TAG", "ControlPlane", "RESERVED_TAG_BANDS",
           "SingleProcessControlPlane", "SocketControlPlane",
           "TELEMETRY_TAG", "TagBand", "band_of", "get_control_plane",
           "reserved_tag", "reset_control_plane"]
