"""Process-group communicator machinery shared by every flavor.

Counterpart of ``chainermn_tpu/communicators/mesh_communicator_base.py``
(the reference's ``MpiCommunicatorBase``).  The JAX class binds a mesh and
traces its collectives into an SPMD program; this one binds a
``torch.distributed`` process group (NCCL on a GPU, gloo on the CPU) and
calls its collectives eagerly, one process per rank.

The gradient decomposition is what tells the flavors apart.  The bodies
here are the JAX package's pre-planner ones (``_legacy_allreduce_grad_traced``,
which its tests pin bit-exact with the plan path): the base class is the
naive per-leaf all-reduce.  The collective planner is not ported yet
(ROADMAP.md, Queue A11).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.communicator_base import (
    CommunicatorBase)
from chainermn_tpu_torch.parallel.topology import Topology, init_topology

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


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
                 intra_size: Optional[int] = None):
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
        mine = None
        for c in sorted({t[0] for t in infos}):
            members = [t[2] for t in sorted(
                (t for t in infos if t[0] == c), key=lambda t: (t[1], t[2]))]
            group = dist.new_group(members)  # collective: every rank calls
            if c == color:
                mine = (members, group)
        members, group = mine
        me = self._global_rank(self.rank)
        # intra level of the sub-world: its members on this node, when
        # every node holds the same number of them
        node = lambda r: r // self.intra_size  # noqa: E731
        per_node = {}
        for r in members:
            per_node[node(r)] = per_node.get(node(r), 0) + 1
        counts = set(per_node.values())
        intra_size = counts.pop() if len(counts) == 1 else 1
        topo = Topology(rank=members.index(me), size=len(members),
                        intra_rank=members.index(me) % intra_size,
                        intra_size=intra_size, device=self.device)
        return type(self)(topology=topo, group=group,
                          allreduce_grad_dtype=self.allreduce_grad_dtype
                          if self.supports_allreduce_grad_dtype else None)
