"""Process-group communicator machinery shared by every flavor.

Counterpart of ``chainermn_tpu/communicators/mesh_communicator_base.py``
(the reference's ``MpiCommunicatorBase``).  The JAX class binds a mesh and
traces its collectives into an SPMD program; this one binds a
``torch.distributed`` process group (NCCL on a GPU, gloo on the CPU) and
calls its collectives eagerly, one process per rank.

The JAX mesh has two axes, ``inter`` (across nodes) and ``intra`` (within
one); here they are two families of process groups, built in the
constructor: the intra group of this rank's node (``intra_size``
consecutive ranks) and the inter group of the ranks that hold its place on
every node.

Objects (pickled) travel on a gloo side group of the same ranks (the
world's own group when it is gloo already): NCCL has no tags and moves
only device memory, while the JAX package's object plane is a socket
control plane with tags.  Point-to-point objects (``send_obj``/
``recv_obj``/``gather_obj``/``scatter_obj``/``barrier``) share one ordered
gloo channel per pair of ranks; each message carries its ``tag``, and a
receiver keeps messages of other tags until they are asked for, so tags
may interleave as on the JAX control plane.  Sends do not block.

Given a :class:`~chainermn_tpu_torch.runtime.control_plane.ControlPlane`
(``control_plane=``, JAX's argument), every object op goes through it
instead, with its ``tag`` honored: the JAX package's socket control plane
and its binomial trees.  The gloo plane stays the default (a communicator
never mixes the two): it needs no second listener per process and rides
the process group the launcher already built.  ``split``/``split_axes`` of
a communicator on a control plane give the sub-world JAX's
``_SplitControlPlane`` (parent ranks ordered by ``(key, rank)``, tags
namespaced as ``(color + 1) * 100003 + tag``).

The gradient decomposition is what tells the flavors apart.  The bodies
here are the JAX package's pre-planner ones (``_legacy_allreduce_grad_traced``,
which its tests pin bit-exact with the plan path): the base class is the
naive per-leaf all-reduce.  Each flavor's :meth:`MeshCommunicator.plan` is
its decomposition as plan data (:mod:`chainermn_tpu_torch.planner`), and
``execute_plan(comm.plan(), comm, grads)`` gives the bits of the flavor's
own ``allreduce_grad`` (``tests/test_torch_auto_communicator.py``);
:meth:`MeshCommunicator.plan_topology` is ``(("inter", inter_size),
("intra", intra_size))``.

Gradient compression (JAX ``allreduce_grad(compressor=, state=)``) runs
on every flavor: ``NoCompression(wire_dtype)`` is the ``allreduce_grad_dtype``
program (:meth:`MeshCommunicator._allreduce_grad_wire`, the cast kernel on
the card), and a quantizer packs one float32 buffer, encodes it with error
feedback, sums the codes over the world in wire arithmetic (int8: the
backend's sum; fp8: bytes through ``all_to_all_single``, a float16 sum in
rank order and an all-gather, :mod:`~chainermn_tpu_torch.compression.quantize`),
decodes and unpacks the mean (:meth:`MeshCommunicator._allreduce_grad_compressed`).
A :class:`~chainermn_tpu_torch.planner.Plan` as the ``compressor`` runs
per-hop compression: only the plan's quantized stages carry codes, each
with its own EF state (:meth:`MeshCommunicator._allreduce_grad_plan`).
"""

from __future__ import annotations

import collections
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.communicator_base import (
    CommunicatorBase)
from chainermn_tpu_torch.parallel.topology import Topology, init_topology
from chainermn_tpu_torch.runtime.control_plane import ControlPlane

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
# allreduce_obj's reductions, applied through dicts, lists and tuples (the
# JAX control plane's structural ops)
_PAIR_OPS = {"sum": lambda a, b: a + b, "prod": lambda a, b: a * b,
             "max": lambda a, b: np.maximum(a, b),
             "min": lambda a, b: np.minimum(a, b)}


# the gloo tag of the object channel between two ranks (the message's own
# tag travels in its header)
_CHANNEL = 7

# torch renamed reduce_scatter_tensor (same signature) and deprecated the
# old name; take whichever this torch has
reduce_scatter_tensor = getattr(dist, "reduce_scatter_single",
                                dist.reduce_scatter_tensor)
all_gather_tensor = getattr(dist, "all_gather_single",
                            dist.all_gather_into_tensor)


def _module_grads(params) -> list:
    """Each parameter's gradient, zeros where backward left None."""
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


def _structural(op):
    def apply(a, b):
        if isinstance(a, dict):
            return {k: apply(a[k], b[k]) for k in a}
        if isinstance(a, (list, tuple)):
            return type(a)(apply(x, y) for x, y in zip(a, b))
        return op(a, b)
    return apply


class _SplitControlPlane(ControlPlane):
    """Sub-world view over a parent control plane (JAX's, for
    ``mpi_comm.Split``): tags are namespaced per split group, so a split
    sends under the tags JAX's does."""

    def __init__(self, parent: ControlPlane, members: List[int], color: int):
        self._parent = parent
        self._members = members  # parent ranks, ordered by (key, rank)
        self._color = color
        self.rank = members.index(parent.rank)
        self.size = len(members)

    def _tag(self, tag: int) -> int:
        return (self._color + 1) * 100003 + tag

    def send_obj(self, obj, dest, tag=0):
        self._parent.send_obj(obj, self._members[dest], tag=self._tag(tag))

    def recv_obj(self, source, tag=0):
        return self._parent.recv_obj(self._members[source],
                                     tag=self._tag(tag))


def as_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from a torch dtype or its name (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", dtype)  # numpy dtypes
    if not isinstance(name, str) or not isinstance(
            getattr(torch, name, None), torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return getattr(torch, name)


class MeshCommunicator(CommunicatorBase):
    """Communicator bound to a process group and this process's topology.

    ``group=None`` is the default (world) group.  Collectives run on the
    current CUDA stream of the process's device (NCCL) or on the CPU
    (gloo).  ``control_plane``: the object plane (default: the gloo side
    group; see the module note); its rank and size must be this
    communicator's.
    """

    # Only the xla (pure_nccl) communicator accepts a communication dtype,
    # as in the reference factory.
    supports_allreduce_grad_dtype = False
    flavor = "naive"
    #: this flavor moves leaves packed, one collective per dtype group; a
    #: leaf plan run on it (planner.execute_plan) does the same
    packs_leaf_plans = False

    def __init__(self, topology: Optional[Topology] = None, group=None,
                 allreduce_grad_dtype=None, device=None,
                 intra_size: Optional[int] = None, compression=None,
                 control_plane: Optional[ControlPlane] = None,
                 _groups=None):
        if topology is None:
            topology = init_topology(device, intra_size=intra_size)
        from chainermn_tpu_torch.compression import (
            NoCompression, resolve_compressor)
        # compression= subsumes the dtype knob: a NoCompression wire folds
        # INTO allreduce_grad_dtype, a quantizer is kept for allreduce_grad
        self.compression = resolve_compressor(compression)
        if isinstance(self.compression, NoCompression) \
                and self.compression.wire is not None:
            wire = self.compression.wire
            if allreduce_grad_dtype is not None and \
                    as_dtype(allreduce_grad_dtype) != wire:
                raise ValueError(
                    f"conflicting wire dtypes: allreduce_grad_dtype="
                    f"{allreduce_grad_dtype} vs compression="
                    f"{self.compression!r} -- pass only "
                    f"compression=NoCompression(wire_dtype=...)")
            allreduce_grad_dtype = wire
        if allreduce_grad_dtype is not None and \
                not self.supports_allreduce_grad_dtype:
            raise ValueError(
                f"{type(self).__name__} does not support allreduce_grad_dtype "
                "(only the 'xla'/'pure_nccl' communicator does)")
        self._topology = topology
        self._group = group
        self.allreduce_grad_dtype = as_dtype(allreduce_grad_dtype)
        if _groups is None:  # the world: its ranks are the global ranks
            _groups = self._make_groups(list(range(topology.size)),
                                        topology.intra_size, group)
            _groups = _groups[topology.rank]
        self._groups = _groups
        # the object plane: messages received for a tag not yet asked for,
        # by (source, tag), and the sends still in flight
        self._inbox: dict = collections.defaultdict(collections.deque)
        self._sends: list = []
        if control_plane is not None and (
                control_plane.rank != topology.rank
                or control_plane.size != topology.size):
            raise ValueError(
                f"control plane of rank {control_plane.rank} in a world of "
                f"{control_plane.size} does not match this communicator "
                f"(rank {topology.rank} of {topology.size})")
        #: the object plane when one was given (None: the gloo plane)
        self._cp = control_plane

    def _make_groups(self, members: List[int], intra_size: int,
                     world) -> dict:
        """This flavor's process groups of the world whose global ranks are
        ``members`` (process group ``world``): ``{global rank: {"intra":
        group, "inter": group}}``.

        Collective over the default group: every process calls it, for
        every world being built, in the same order (``new_group``'s rule),
        and every group is created in the same order everywhere.  A level
        that spans the whole world reuses ``world``; a level of one rank
        gets ``None`` (its reduction is the identity and is skipped).
        ``"obj"`` is the object plane's gloo group of the whole world:
        ``world`` itself when the default group is gloo (or the fake group
        of a dry run, which issues nothing), else a gloo group of the same
        ranks.
        """
        n = len(members)
        inter_size = n // intra_size
        obj = world
        if dist.is_initialized() and \
                dist.get_backend() not in ("gloo", "fake"):
            obj = dist.new_group(members, backend="gloo")
        out = {r: {"intra": None, "inter": None, "obj": obj}
               for r in members}
        levels = (("intra", intra_size,
                   [members[k * intra_size:(k + 1) * intra_size]
                    for k in range(inter_size)]),
                  ("inter", inter_size,
                   [members[i::intra_size] for i in range(intra_size)]))
        for name, level_size, blocks in levels:
            if level_size == 1:
                continue
            for ranks in blocks:
                g = world if level_size == n else dist.new_group(ranks)
                for r in ranks:
                    out[r][name] = g
        return out

    def _plan_all_reduce(self, buf: torch.Tensor, group, scope: str):
        """Sum ``buf`` in place over ``group`` (the process group of plan
        scope ``scope``): the planner executor's all-reduce."""
        del scope
        dist.all_reduce(buf, dist.ReduceOp.SUM, group=group)

    def _reduce_level(self, buf: torch.Tensor, level: str) -> torch.Tensor:
        """Sum ``buf`` in place over this rank's ``"intra"`` or ``"inter"``
        group (nothing to do over a level of one rank)."""
        group = self._groups[level]
        if getattr(self, f"{level}_size") > 1:
            dist.all_reduce(buf, dist.ReduceOp.SUM, group=group)
        return buf

    # ---- topology ----------------------------------------------------------
    @property
    def topology(self) -> Topology:
        return self._topology

    @property
    def group(self):
        return self._group

    @property
    def rank(self) -> int:
        return self._topology.rank

    @property
    def size(self) -> int:
        return self._topology.size

    @property
    def intra_rank(self) -> int:
        return self._topology.intra_rank

    @property
    def intra_size(self) -> int:
        return self._topology.intra_size

    @property
    def inter_rank(self) -> int:
        return self._topology.inter_rank

    @property
    def inter_size(self) -> int:
        return self._topology.inter_size

    @property
    def device(self) -> torch.device:
        return self._topology.device

    @property
    def host_size(self) -> int:
        """Controller processes in the world: one per GPU here, so the
        size (JAX: ``jax.process_count()`` of the mesh)."""
        return self._topology.size

    def plan_topology(self):
        """This communicator's levels as a
        :class:`~chainermn_tpu_torch.planner.PlanTopology`: ``(("inter",
        inter_size), ("intra", intra_size))``, the last axis the intra
        (NVLink) level, as the JAX mesh's data axes."""
        from chainermn_tpu_torch.planner.ir import PlanTopology
        return PlanTopology(axes=(("inter", self.inter_size),
                                  ("intra", self.intra_size)))

    def plan(self):
        """The fixed plan this flavor executes (xla threads its wire dtype
        in as the plan's wire dtype)."""
        from chainermn_tpu_torch.planner.plans import flavor_plan
        wire = None
        if self.supports_allreduce_grad_dtype and \
                self.allreduce_grad_dtype is not None:
            wire = _packing.dtype_name(self.allreduce_grad_dtype)
        return flavor_plan(self.flavor, wire_dtype=wire)

    def _global_rank(self, rank: int) -> int:
        if self._group is None:
            return rank
        return dist.get_global_rank(self._group, rank)

    # ---- object plane ------------------------------------------------------
    @property
    def _obj_group(self):
        return self._groups["obj"]

    def bcast_obj(self, obj, root: int = 0, tag: int = 0):
        """Root's object on every rank.  Collective: on the gloo plane
        ranks match calls by their order, so ``tag`` (the reference
        signature's) selects nothing; a control plane honors it."""
        if self._cp is not None:
            return self._cp.bcast_obj(obj, root=root, tag=tag)
        box = [obj]
        dist.broadcast_object_list(box, src=self._global_rank(root),
                                   group=self._obj_group)
        return box[0]

    def allgather_obj(self, obj, tag: int = 0) -> List:
        """Every rank's object, in rank order, on every rank (collective;
        ``tag`` as in :meth:`bcast_obj`)."""
        if self._cp is not None:
            return self._cp.allgather_obj(obj, tag=tag)
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._obj_group)
        return out

    def allreduce_obj(self, obj, op="sum", tag: int = 0):
        """Reduce picklable objects over the world; every rank gets the
        result.  ``op``: "sum", "prod", "max" or "min", applied through
        dicts, lists and tuples (numpy-aware), or any binary callable.
        Folded in rank order, so every rank computes the same value (on a
        control plane: its tree order, as JAX's)."""
        if self._cp is not None:
            return self._cp.allreduce_obj(obj, op=op, tag=tag)
        if callable(op):
            fold = op
        elif op in _PAIR_OPS:
            fold = _structural(_PAIR_OPS[op])
        else:
            raise ValueError(f"unknown op {op!r} (expected one of "
                             f"{sorted(_PAIR_OPS)} or a callable)")
        objs = self.allgather_obj(obj)
        acc = objs[0]
        for o in objs[1:]:
            acc = fold(acc, o)
        return acc

    def send_obj(self, obj, dest: int, tag: int = 0) -> None:
        """Send a picklable object to rank ``dest`` under ``tag``; returns
        at once (the transfer completes when ``dest`` receives it, and
        only while the process group lives).  A rank may send to
        itself."""
        if self._cp is not None:
            self._cp.send_obj(obj, dest, tag=tag)
            return
        self._isend_obj(obj, dest, tag)

    def _isend_obj(self, obj, dest: int, tag: int) -> list:
        """:meth:`send_obj`; returns the transfer's work handles."""
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        if dest == self.rank:
            self._inbox[(dest, tag)].append(payload)
            return []
        head = torch.tensor([tag, len(payload)], dtype=torch.int64)
        body = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        dst = self._global_rank(dest)
        works = [dist.isend(t, dst, group=self._obj_group, tag=_CHANNEL)
                 for t in (head, body)]
        # the tensors stay referenced until their sends complete
        self._sends = [s for s in self._sends
                       if not all(w.is_completed() for w in s[0])]
        self._sends.append((works, head, body))
        return works

    def recv_obj(self, source: int, tag: int = 0):
        """The oldest object rank ``source`` sent this rank under ``tag``;
        messages of other tags that arrive first are kept for later
        calls."""
        if self._cp is not None:
            return self._cp.recv_obj(source, tag=tag)
        box = self._inbox[(source, tag)]
        src = self._global_rank(source)
        while not box:
            if source == self.rank:
                raise ValueError(f"no object sent to self under tag {tag}")
            head = torch.empty(2, dtype=torch.int64)
            dist.recv(head, src, group=self._obj_group, tag=_CHANNEL)
            body = torch.empty(int(head[1]), dtype=torch.uint8)
            dist.recv(body, src, group=self._obj_group, tag=_CHANNEL)
            self._inbox[(source, int(head[0]))].append(body.numpy().tobytes())
        return pickle.loads(box.popleft())

    def gather_obj(self, obj, root: int = 0, tag: int = 0):
        """Every rank's object, in rank order, on ``root``; None on the
        other ranks."""
        if self._cp is not None:
            return self._cp.gather_obj(obj, root=root, tag=tag)
        if self.rank != root:
            self.send_obj(obj, root, tag=tag)
            return None
        return [obj if r == root else self.recv_obj(r, tag=tag)
                for r in range(self.size)]

    def scatter_obj(self, objs, root: int = 0, tag: int = 0):
        """Rank r gets ``objs[r]`` of root's list (``objs`` is read on
        ``root`` only).  The root returns once every rank holds its
        object, so the root may tear its process group down after it."""
        if self._cp is not None:
            return self._cp.scatter_obj(objs, root=root, tag=tag)
        if self.rank == root:
            if len(objs) != self.size:
                raise ValueError(f"scatter_obj: {len(objs)} objects for "
                                 f"{self.size} ranks")
            works = [w for r, o in enumerate(objs) if r != root
                     for w in self._isend_obj(o, r, tag)]
            for w in works:
                w.wait()
            return objs[root]
        return self.recv_obj(root, tag=tag)

    def barrier(self, tag: int = 900) -> None:
        """Return once every rank has entered: a gather to rank 0 under
        ``tag`` and a release under ``tag + 1`` (the JAX control plane's
        two tags).  Rank 0 returns once every rank has its release.  On a
        control plane: its barrier (an allgather at ``tag``)."""
        if self._cp is not None:
            self._cp.barrier(tag=tag)
            return
        self.gather_obj(None, 0, tag=tag)
        self.scatter_obj([None] * self.size, 0, tag=tag + 1)

    # ---- tensor collectives ------------------------------------------------
    def allreduce(self, x, op: str = "sum"):
        """Reduce a tensor (or tree) over the world; returns new tensors.
        ``op``: "sum", "mean", "max" or "min"."""
        if op not in _OPS and op != "mean":
            raise ValueError(f"unknown op {op!r}")

        def one(v):
            v = v.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(v, _OPS.get(op, dist.ReduceOp.SUM),
                            group=self._group)
            return v / self.size if op == "mean" else v

        return _packing.tree_map(one, x)

    def bcast(self, x, root: int = 0):
        """Root's tensor (or tree) on every rank; returns new tensors."""
        src = self._global_rank(root)

        def one(v):
            v = v.clone(memory_format=torch.contiguous_format)
            dist.broadcast(v, src=src, group=self._group)
            return v

        return _packing.tree_map(one, x)

    def allgather(self, x):
        """This rank's tensor (or tree) -> every rank's, stacked
        ``[size, ...]`` in rank order, on every rank."""
        def one(v):
            out = v.new_empty((self.size,) + tuple(v.shape))
            all_gather_tensor(out.view(-1), v.contiguous().view(-1),
                              group=self._group)
            return out

        return _packing.tree_map(one, x)

    def gather(self, x, root: int = 0):
        """The JAX package's ``gather``: every rank gets the stack (an SPMD
        program has one output shape on every device), so it is
        :meth:`allgather`; ``root`` is kept for the reference signature.
        Root-only gathers of objects are :meth:`gather_obj`."""
        del root
        return self.allgather(x)

    def alltoall(self, xs):
        """``xs[p]`` goes to rank p (leading axis == size); returns
        ``out`` with ``out[q]`` = rank q's ``xs[rank]``."""
        def one(v):
            if v.shape[0] != self.size:
                raise ValueError(f"alltoall: leading axis {v.shape[0]}, "
                                 f"expected the world size {self.size}")
            # the buffers in row-major order: empty_like would keep a
            # permuted view's strides, which the collective ignores
            v = v.contiguous()
            out = torch.empty_like(v)
            dist.all_to_all_single(out, v, group=self._group)
            return out

        return _packing.tree_map(one, xs)

    def scatter(self, x, root: int = 0):
        """Root's stacked ``[size, ...]`` tensor (or tree) -> this rank's
        slice (``x`` is read on root; the others pass one of its shape)."""
        src = self._global_rank(root)

        def one(v):
            out = torch.empty(tuple(v.shape[1:]), dtype=v.dtype,
                              device=v.device)
            parts = list(v.contiguous().unbind(0)) if self.rank == root \
                else None
            dist.scatter(out, parts, src=src, group=self._group)
            return out

        return _packing.tree_map(one, x)

    def reduce_scatter(self, x):
        """Sum over the world, then this rank's block of the leading axis
        (which ``size`` must divide): JAX ``psum_scatter(tiled=True)``."""
        def one(v):
            if v.shape[0] % self.size:
                raise ValueError(f"reduce_scatter: leading axis "
                                 f"{v.shape[0]} is not a multiple of the "
                                 f"world size {self.size}")
            out = v.new_empty((v.shape[0] // self.size,) + tuple(v.shape[1:]))
            reduce_scatter_tensor(out, v.contiguous(), dist.ReduceOp.SUM,
                                  group=self._group)
            return out

        return _packing.tree_map(one, x)

    def ppermute(self, x, perm: Sequence[Tuple[int, int]]):
        """Send this rank's tensor (or tree) along ``(src, dst)`` pairs of
        ranks; a rank that receives nothing gets zeros.  The sends and
        receives of every leaf go out as one batch
        (``dist.batch_isend_irecv``), so a ring cannot deadlock."""
        out, wait = self.ppermute_async(x, perm)
        wait()
        return out

    def ppermute_async(self, x, perm: Sequence[Tuple[int, int]]):
        """:meth:`ppermute` started but not waited for: ``(out, wait)``.
        ``out`` may be read only after ``wait()``, which makes the current
        stream wait for the transfers (on NCCL; gloo blocks the host), so
        work queued between the two overlaps them."""
        perm = [(int(a), int(b)) for a, b in perm]
        for pos in (0, 1):
            ends = [p[pos] for p in perm]
            if len(set(ends)) != len(ends):
                raise ValueError(f"ppermute: {perm} is not a permutation")
        me = self.rank
        dst = [b for a, b in perm if a == me]
        src = [a for a, b in perm if b == me]
        leaves, treedef = _packing.tree_flatten(x)
        leaves = [v.contiguous() for v in leaves]
        if src and src[0] == me:
            outs = [v.clone() for v in leaves]
        elif src:
            outs = [torch.empty_like(v) for v in leaves]
        else:
            outs = [torch.zeros_like(v) for v in leaves]
        ops = []
        if not (src and src[0] == me):
            for v, o in zip(leaves, outs):
                ops += [dist.P2POp(dist.isend, v, self._global_rank(d),
                                   group=self._group) for d in dst]
                ops += [dist.P2POp(dist.irecv, o, self._global_rank(s),
                                   group=self._group) for s in src]
        works = dist.batch_isend_irecv(ops) if ops else []

        def wait():
            for w in works:
                w.wait()

        return _packing.tree_unflatten(treedef, outs), wait

    # ---- gradient entry points ---------------------------------------------
    def allreduce_grad(self, grads, *, compressor=None, state=None):
        """Average gradients over the world.

        ``grads``: a module, whose parameters' ``.grad`` are replaced by
        the mean in place (a parameter without one counts as zeros;
        returns the module), or a tree of gradient
        tensors (returns the tree of means).

        ``compressor`` picks the wire codec of this call (default: a
        quantizer given as the communicator's ``compression=``):

        * ``None`` / ``NoCompression()`` -- this flavor's decomposition;
        * ``NoCompression(wire_dtype=...)`` -- pack, cast, all-reduce in
          the wire dtype, cast back with the 1/size mean: bit for bit the
          ``allreduce_grad_dtype`` program, on any flavor;
        * a quantizer (``"int8"`` / ``"fp8"``) -- error-feedback
          compression: pass ``state`` (from
          :meth:`init_compression_state`), and the call returns ``(mean,
          new_state)``; the new state is a new object (the caller's is left
          as it was, as JAX's functional state is);
        * a :class:`~chainermn_tpu_torch.planner.Plan` -- executed as the
          mean (per-hop ``Stage.compression`` quantizes only those hops).
          ``state`` is then the ``{hop: CompressionState}`` dict from
          :meth:`init_compression_state` (the call returns ``(mean,
          new_states)``); with ``state=None`` quantized hops run from a
          cold state.  A hop-keyed ``state`` dict with ``compressor=None``
          runs this communicator's own :meth:`plan` per hop.
        """
        from chainermn_tpu_torch.compression import (
            is_quantizing, resolve_compressor)
        from chainermn_tpu_torch.planner.ir import Plan
        plan = compressor if isinstance(compressor, Plan) else None
        if plan is None and isinstance(state, dict):
            plan = self.plan()
        if plan is not None:
            if isinstance(grads, nn.Module):
                raise TypeError(
                    "a plan's allreduce_grad takes the gradients as a tree "
                    "of tensors (it returns them, with the new states)")
            return self._allreduce_grad_plan(grads, plan, state)
        comp = (resolve_compressor(compressor) if compressor is not None
                else (self.compression if is_quantizing(self.compression)
                      else None))
        if is_quantizing(comp):
            if state is None:
                raise ValueError(
                    f"compressor {comp.name!r} keeps error-feedback state: "
                    "pass state=comm.init_compression_state(grads, "
                    "compressor) and thread the returned new state into "
                    "the next call")
            if isinstance(grads, nn.Module):
                raise TypeError(
                    "a quantized allreduce_grad takes the gradients as a "
                    "tree of tensors (it returns them with the new state)")
            return self._allreduce_grad_compressed(grads, comp, state)
        wire = getattr(comp, "wire", None)
        if isinstance(grads, nn.Module):
            # every parameter: one that this rank's backward did not reach
            # contributes zeros (its JAX gradient), so every rank issues
            # the same collectives
            params = list(grads.parameters())
            tree = _module_grads(params)
            out = self._allreduce_grad_wire(tree, wire) if wire is not None \
                else self._allreduce_grad_traced(tree)
            for p, g in zip(params, out):
                p.grad = g
            return grads
        if wire is not None:
            return self._allreduce_grad_wire(grads, wire)
        return self._allreduce_grad_traced(grads)

    def init_compression_state(self, tree, compressor=None):
        """A fresh error-feedback state for quantized
        :meth:`allreduce_grad` over ``tree``-shaped gradients, on this
        communicator's device; ``None`` for a stateless codec.  Sized for
        the one packed float32 buffer the compressed path exchanges."""
        from chainermn_tpu_torch.compression import (
            is_quantizing, resolve_compressor)
        from chainermn_tpu_torch.planner.ir import Plan
        n = sum(int(l.numel()) for l in _packing.tree_flatten(tree)[0])
        if isinstance(compressor, Plan):
            from chainermn_tpu_torch.planner.compiler import (
                init_plan_compression_states)
            return init_plan_compression_states(
                compressor, self.plan_topology(), n, device=self.device)
        comp = (resolve_compressor(compressor) if compressor is not None
                else self.compression)
        if not is_quantizing(comp):
            return None
        return comp.init_state(n, self.size, device=self.device)

    def _allreduce_grad_plan(self, grads, plan, states):
        """Execute ``plan`` as the mean, with one EF state per quantized
        hop (``states`` keyed by hop).  Returns ``(mean_grads,
        new_states)`` when ``states`` is given, ``mean_grads`` for the
        stateless one-shot path."""
        from chainermn_tpu_torch.planner.compiler import (
            execute_plan, plan_compressed_hops)
        if states is not None:
            hops = plan_compressed_hops(plan, self.plan_topology())
            missing = sorted(set(hops) - set(states), key=repr)
            if missing:
                raise ValueError(
                    f"per-hop compression states missing for stage(s) "
                    f"{missing} of plan {plan.name!r}: build them with "
                    "comm.init_compression_state(grads, plan)")
        return execute_plan(plan, self, grads, states=states)

    def _allreduce_grad_wire_start(self, grads, wire):
        """The ``allreduce_grad_dtype`` program, started: pack per dtype
        group, :func:`~chainermn_tpu_torch.ops.cast_scale` each buffer into
        ``wire`` (scale 1), all-reduce in the wire dtype (left in flight),
        and ``finish()`` casts back with scale 1/size and unpacks."""
        from chainermn_tpu_torch.ops.cast_scale import cast_scale
        buffers, meta = _packing.pack(grads)
        _, group_dtypes, _ = meta
        buffers = [cast_scale(b, wire, 1.0) for b in buffers]
        works = [dist.all_reduce(b, dist.ReduceOp.SUM, group=self._group,
                                 async_op=True) for b in buffers]
        scale = 1.0 / self.size

        def finish():
            for w in works:
                w.wait()
            out = [cast_scale(b, getattr(torch, k), scale)
                   for b, k in zip(buffers, group_dtypes)]
            return _packing.unpack(out, meta, scale=None)

        return finish

    def _allreduce_grad_wire(self, grads, wire):
        """``NoCompression(wire_dtype)``: the exact cast-allreduce-cast
        program of the ``allreduce_grad_dtype`` knob (the ``xla`` flavor's
        wire route), on any flavor."""
        return self._allreduce_grad_wire_start(grads, as_dtype(wire))()

    def _sum_codes(self, codes: torch.Tensor,
                   scope: str = "all") -> torch.Tensor:
        """The sum of this rank's wire ``codes`` over the ranks of plan
        scope ``scope`` (the world by default), in wire arithmetic (see the
        module note): int8 through the backend's sum all-reduce;
        float8_e4m3fn as bytes, an all-to-all, each rank's float16 sum of
        its shard in rank order, and an all-gather.  Any other wire dtype
        raises (no fallback to a wider wire)."""
        from chainermn_tpu_torch.compression.quantize import sum_wire
        group, n = {"all": (self._group, self.size),
                    "intra": (self._groups["intra"], self.intra_size),
                    "inter": (self._groups["inter"], self.inter_size)}[scope]
        if n == 1:
            return codes
        if codes.dtype == torch.int8:
            codes = codes.clone()
            dist.all_reduce(codes, dist.ReduceOp.SUM, group=group)
            return codes
        if codes.dtype != torch.float8_e4m3fn:
            raise TypeError(f"no in-wire sum for {codes.dtype}")
        # float8 moves as bytes (int8: the dtype every backend takes)
        b, strip = _packing.pad_to_multiple(codes.view(torch.int8), n)
        recv = torch.empty_like(b)
        dist.all_to_all_single(recv, b, group=group)
        shard = sum_wire(recv.view(torch.float8_e4m3fn).view(n, -1),
                         torch.float8_e4m3fn).view(torch.int8)
        out = torch.empty_like(b)
        all_gather_tensor(out, shard, group=group)
        return strip(out).view(torch.float8_e4m3fn)

    def _allreduce_grad_compressed(self, grads, comp, state):
        """Quantized exchange: pack one float32 buffer, EF-encode it,
        SUM the codes in wire arithmetic, decode with the delayed-scale
        update, unpack the mean.  Returns ``(mean_grads, new_state)``."""
        n = self.size
        buffers, meta = _packing.pack(grads, comm_dtype=torch.float32)
        buf = buffers[0]
        m = int(buf.shape[0])
        if int(state.ef.shape[0]) != comp._padded(m):
            raise ValueError(
                f"compression state sized for ef={state.ef.shape[0]} "
                f"does not match this gradient tree (needs "
                f"{comp._padded(m)}): build it with "
                "comm.init_compression_state(grads, compressor)")
        from chainermn_tpu_torch.compression import observe as _cobs
        obs = _cobs.get_compression_obs()
        if obs is not None:
            from chainermn_tpu_torch.compression.quantize import (
                wire_bits_per_param)
            tags = ("allreduce", 0, comp.name,
                    wire_bits_per_param(comp, m, n),
                    m * 4 - (comp._padded(m) + comp.n_chunks(m))
                    * comp.wire_dtype.itemsize)
            obs.device_edge(self.rank, "compress", "begin", *tags, dep=buf)
        codes, state = comp.compress(buf, state, rank=self.rank,
                                     world_size=n)
        if obs is not None:
            obs.device_edge(self.rank, "compress", "end", *tags,
                            residual=state.ef, dep=codes)
        summed = self._sum_codes(codes)
        if obs is not None:
            obs.device_edge(self.rank, "decompress", "begin", *tags,
                            dep=summed)
        out, state = comp.decompress(summed, state, world_size=n)
        if obs is not None:
            obs.device_edge(self.rank, "decompress", "end", *tags, dep=out)
        return _packing.unpack([out[:m]], meta, scale=1.0 / n), state

    def _all_reduce_sum(self, buf: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(buf, dist.ReduceOp.SUM, group=self._group)
        return buf

    def _allreduce_grad_traced(self, grads):
        """Naive decomposition: one all-reduce per leaf, then ``/ size``
        (the JAX package's ``_legacy_allreduce_grad_traced``)."""
        n = self.size
        return _packing.tree_map(
            lambda g: self._all_reduce_sum(g.clone()) / n, grads)

    def _allreduce_grad_start(self, grads):
        """Begin the mean of ``grads``; returns ``finish()``, which waits
        and returns what ``allreduce_grad`` would.  ``grads`` may be freed
        once this returns.  Here the whole decomposition runs at once;
        a flavor whose reduction is one collective leaves it in flight
        (the double-buffered optimizer overlaps it with the next step)."""
        out = self._allreduce_grad_traced(grads)
        return lambda: out

    def bcast_data(self, params):
        """Broadcast model parameters from rank 0 to the whole world —
        called once after model init so every worker starts from the same
        weights.  A module is updated in place (parameters and buffers)
        and returned; a tree comes back as a new tree."""
        if isinstance(params, nn.Module):
            with torch.no_grad():
                for t in list(params.parameters()) + list(params.buffers()):
                    dist.broadcast(t.data, src=self._global_rank(0),
                                   group=self._group)
            return params
        return self.bcast(params, root=0)

    # ---- sub-communicators -------------------------------------------------
    def split(self, color: int, key: int) -> "MeshCommunicator":
        """Ranks sharing ``color`` form a new world, ordered by
        ``(key, rank)`` (reference: ``mpi_comm.Split``).  Every rank of
        this communicator must call it."""
        return self._split(color, key)

    def _split(self, color: int, key: int, fallback: bool = False):
        """:meth:`split`; with ``fallback``, a flavor that refuses the
        sub-world (single_node on several nodes) gives way to the naive
        per-leaf communicator, as the JAX ``split_axes`` does."""
        infos = self.allgather_obj((color, key, self._global_rank(self.rank),
                                    self.rank))
        me = self._global_rank(self.rank)
        mine = None
        # on a control plane the order is JAX's (key, control-plane rank),
        # which makes the sub-world's rank its sub-plane's rank
        order = 3 if self._cp is not None else 2
        # collective: every rank builds every color's groups, in one order
        for c in sorted({t[0] for t in infos}):
            members = [t[2] for t in sorted(
                (t for t in infos if t[0] == c),
                key=lambda t: (t[1], t[order]))]
            group = dist.new_group(members)
            intra_size = self._sub_intra_size(members)
            groups = self._make_groups(members, intra_size, group)
            if c == color:
                mine = (members, group, intra_size, groups[me])
        members, group, intra_size, groups = mine
        sub_cp = None
        if self._cp is not None:
            sub_cp = _SplitControlPlane(self._cp, [t[3] for t in sorted(
                (t for t in infos if t[0] == color),
                key=lambda t: (t[1], t[3]))], color)
        topo = Topology(rank=members.index(me), size=len(members),
                        intra_rank=members.index(me) % intra_size,
                        intra_size=intra_size, device=self.device)
        wire = self.allreduce_grad_dtype \
            if self.supports_allreduce_grad_dtype else None
        from chainermn_tpu_torch.compression import is_quantizing
        # quantizers ride the generic pack/sum path: any sub-world keeps
        # them (JAX split_axes)
        comp = self.compression if is_quantizing(self.compression) else None
        try:
            return type(self)(topology=topo, group=group,
                              allreduce_grad_dtype=wire, compression=comp,
                              control_plane=sub_cp, _groups=groups)
        except ValueError:
            if not fallback:
                raise
            return MeshCommunicator(topology=topo, group=group,
                                    compression=comp, control_plane=sub_cp,
                                    _groups=groups)

    def split_axes(self, axes: Sequence[str]) -> "MeshCommunicator":
        """A communicator over a subset of the world's levels, keeping this
        flavor: ``("intra",)`` the ranks of this rank's node, ``("inter",)``
        the ranks that hold this rank's place on every node, both the whole
        world.  Every rank must call it (it builds process groups)."""
        axes = tuple(axes)
        if not axes or set(axes) - {"inter", "intra"} or \
                len(set(axes)) != len(axes):
            raise ValueError(f"split_axes: axes {axes!r} are not a subset "
                             "of ('inter', 'intra')")
        if len(axes) == 2:
            color = 0
        else:
            color = self.inter_rank if axes == ("intra",) else \
                self.intra_rank
        return self._split(color, self.rank, fallback=True)

    def _sub_intra_size(self, members: List[int]) -> int:
        """Intra level of a sub-world: its members on one node, when every
        node holds the same number of them (else 1)."""
        per_node: dict = {}
        for r in members:
            node = r // self.intra_size
            per_node[node] = per_node.get(node, 0) + 1
        counts = set(per_node.values())
        return counts.pop() if len(counts) == 1 else 1
