"""Single-node communicator — the intra level alone.

Counterpart of ``chainermn_tpu/communicators/single_node_communicator.py``
(the reference's ``SingleNodeCommunicator``: NCCL only, for a world that is
one node).  Refuses a world of several nodes; reduces over the intra group,
then ``/ size``.
"""

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)


class SingleNodeCommunicator(MeshCommunicator):
    flavor = "single_node"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.inter_size != 1:
            raise ValueError(
                f"single_node communicator requires inter_size == 1, got "
                f"{self.inter_size}; use 'hierarchical' for multi-node "
                "worlds")

    def _allreduce_grad_traced(self, grads):
        buffers, meta = _packing.pack(grads)
        for b in buffers:
            self._reduce_level(b, "intra")
            b.div_(self.size)
        return _packing.unpack(buffers, meta)
