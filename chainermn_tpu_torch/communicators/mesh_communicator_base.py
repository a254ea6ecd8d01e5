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

The gradient decomposition is what tells the flavors apart.  The bodies
here are the JAX package's pre-planner ones (``_legacy_allreduce_grad_traced``,
which its tests pin bit-exact with the plan path): the base class is the
naive per-leaf all-reduce.  The collective planner is not ported yet
(ROADMAP.md, Queue A11).
"""

from __future__ import annotations

from typing import List, Optional

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
        """
        n = len(members)
        inter_size = n // intra_size
        out = {r: {"intra": None, "inter": None} for r in members}
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
    def bcast_obj(self, obj, root: int = 0):
        box = [obj]
        dist.broadcast_object_list(box, src=self._global_rank(root),
                                   group=self._group, device=self._obj_dev())
        return box[0]

    def allgather_obj(self, obj) -> List:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._group)
        return out

    def allreduce_obj(self, obj, op="sum"):
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

    def _obj_dev(self):
        return self.device if self.device.type == "cuda" else None

    # ---- tensor collectives ------------------------------------------------
    def allreduce(self, x, op: str = "sum"):
        """Reduce a tensor (or tree) over the world; returns new tensors.
        ``op``: "sum", "mean", "max" or "min"."""
        if op not in _OPS and op != "mean":
            raise ValueError(f"unknown op {op!r}")

        def one(v):
            v = v.clone()
            dist.all_reduce(v, _OPS.get(op, dist.ReduceOp.SUM),
                            group=self._group)
            return v / self.size if op == "mean" else v

        return _packing.tree_map(one, x)

    def bcast(self, x, root: int = 0):
        """Root's tensor (or tree) on every rank; returns new tensors."""
        src = self._global_rank(root)

        def one(v):
            v = v.clone()
            dist.broadcast(v, src=src, group=self._group)
            return v

        return _packing.tree_map(one, x)

    # ---- gradient entry points ---------------------------------------------
    def allreduce_grad(self, grads):
        """Average gradients over the world.

        ``grads``: a module, whose parameters' ``.grad`` are replaced by
        the mean in place (returns the module), or a tree of gradient
        tensors (returns the tree of means).
        """
        if isinstance(grads, nn.Module):
            params = [p for p in grads.parameters() if p.grad is not None]
            for p, g in zip(params, self._allreduce_grad_traced(
                    [p.grad for p in params])):
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
        return type(self)(topology=topo, group=group,
                          allreduce_grad_dtype=self.allreduce_grad_dtype
                          if self.supports_allreduce_grad_dtype else None,
                          _groups=groups)

    def _sub_intra_size(self, members: List[int]) -> int:
        """Intra level of a sub-world: its members on one node, when every
        node holds the same number of them (else 1)."""
        per_node: dict = {}
        for r in members:
            node = r // self.intra_size
            per_node[node] = per_node.get(node, 0) + 1
        counts = set(per_node.values())
        return counts.pop() if len(counts) == 1 else 1
