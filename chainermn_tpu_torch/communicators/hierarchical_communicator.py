"""Hierarchical communicator — reduce within the node, then across nodes.

Counterpart of ``chainermn_tpu/communicators/hierarchical_communicator.py``
(the reference's ``HierarchicalCommunicator``: intra-node NCCL reduce,
inter-node all-reduce, intra-node broadcast).  Here, as in the JAX package,
the first leg is an all-reduce over the intra group (reduce and broadcast
in one), the second an all-reduce over the inter group, then ``/ size``.
The gradients are packed into one buffer per dtype first: each element
still sees the same two sums and the same division, in fewer collectives.
A level of one rank (``inter_size == 1`` on a single node) is skipped.
"""

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)


class HierarchicalCommunicator(MeshCommunicator):
    flavor = "hierarchical"
    packs_leaf_plans = True

    def _allreduce_grad_traced(self, grads):
        buffers, meta = _packing.pack(grads)
        for b in buffers:
            self._reduce_level(b, "intra")   # NVLink leg
            self._reduce_level(b, "inter")   # network leg
            b.div_(self.size)
        return _packing.unpack(buffers, meta)
