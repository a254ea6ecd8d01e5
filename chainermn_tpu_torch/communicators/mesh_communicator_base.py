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

The gradient decomposition is what tells the flavors apart.  The bodies
here are the JAX package's pre-planner ones (``_legacy_allreduce_grad_traced``,
which its tests pin bit-exact with the plan path): the base class is the
naive per-leaf all-reduce.  The collective planner is not ported yet
(ROADMAP.md, Queue A11).
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


def _structural(op):
    def apply(a, b):
        if isinstance(a, dict):
            return {k: apply(a[k], b[k]) for k in a}
        if isinstance(a, (list, tuple)):
            return type(a)(apply(x, y) for x, y in zip(a, b))
        return op(a, b)
    return apply


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
    (gloo).
    """

    # Only the xla (pure_nccl) communicator accepts a communication dtype,
    # as in the reference factory.
    supports_allreduce_grad_dtype = False
    flavor = "naive"

    def __init__(self, topology: Optional[Topology] = None, group=None,
                 allreduce_grad_dtype=None, device=None,
                 intra_size: Optional[int] = None, _groups=None):
        if topology is None:
            topology = init_topology(device, intra_size=intra_size)
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
        ``world`` itself when the default group is gloo, else a gloo group
        of the same ranks.
        """
        n = len(members)
        inter_size = n // intra_size
        obj = world
        if dist.is_initialized() and dist.get_backend() != "gloo":
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

    def _global_rank(self, rank: int) -> int:
        if self._group is None:
            return rank
        return dist.get_global_rank(self._group, rank)

    # ---- object plane ------------------------------------------------------
    @property
    def _obj_group(self):
        return self._groups["obj"]

    def bcast_obj(self, obj, root: int = 0, tag: int = 0):
        """Root's object on every rank.  Collective: ranks match calls by
        their order, so ``tag`` (the reference signature's) selects
        nothing."""
        box = [obj]
        dist.broadcast_object_list(box, src=self._global_rank(root),
                                   group=self._obj_group)
        return box[0]

    def allgather_obj(self, obj, tag: int = 0) -> List:
        """Every rank's object, in rank order, on every rank (collective;
        ``tag`` as in :meth:`bcast_obj`)."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._obj_group)
        return out

    def allreduce_obj(self, obj, op="sum", tag: int = 0):
        """Reduce picklable objects over the world; every rank gets the
        result.  ``op``: "sum", "prod", "max" or "min", applied through
        dicts, lists and tuples (numpy-aware), or any binary callable.
        Folded in rank order, so every rank computes the same value."""
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
        if self.rank != root:
            self.send_obj(obj, root, tag=tag)
            return None
        return [obj if r == root else self.recv_obj(r, tag=tag)
                for r in range(self.size)]

    def scatter_obj(self, objs, root: int = 0, tag: int = 0):
        """Rank r gets ``objs[r]`` of root's list (``objs`` is read on
        ``root`` only).  The root returns once every rank holds its
        object, so the root may tear its process group down after it."""
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
        two tags).  Rank 0 returns once every rank has its release."""
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
    def allreduce_grad(self, grads):
        """Average gradients over the world.

        ``grads``: a module, whose parameters' ``.grad`` are replaced by
        the mean in place (a parameter without one counts as zeros;
        returns the module), or a tree of gradient
        tensors (returns the tree of means).
        """
        if isinstance(grads, nn.Module):
            # every parameter: one that this rank's backward did not reach
            # contributes zeros (its JAX gradient), so every rank issues
            # the same collectives
            params = list(grads.parameters())
            for p, g in zip(params, self._allreduce_grad_traced(
                    [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params])):
                p.grad = g
            return grads
        return self._allreduce_grad_traced(grads)

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
        infos = self.allgather_obj((color, key, self._global_rank(self.rank)))
        me = self._global_rank(self.rank)
        mine = None
        # collective: every rank builds every color's groups, in one order
        for c in sorted({t[0] for t in infos}):
            members = [t[2] for t in sorted(
                (t for t in infos if t[0] == c), key=lambda t: (t[1], t[2]))]
            group = dist.new_group(members)
            intra_size = self._sub_intra_size(members)
            groups = self._make_groups(members, intra_size, group)
            if c == color:
                mine = (members, group, intra_size, groups[me])
        members, group, intra_size, groups = mine
        topo = Topology(rank=members.index(me), size=len(members),
                        intra_rank=members.index(me) % intra_size,
                        intra_size=intra_size, device=self.device)
        wire = self.allreduce_grad_dtype \
            if self.supports_allreduce_grad_dtype else None
        try:
            return type(self)(topology=topo, group=group,
                              allreduce_grad_dtype=wire, _groups=groups)
        except ValueError:
            if not fallback:
                raise
            return MeshCommunicator(topology=topo, group=group,
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
