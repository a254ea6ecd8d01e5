"""Flat communicator — one all-reduce over a packed buffer per dtype.

Counterpart of ``chainermn_tpu/communicators/flat_communicator.py`` (the
reference's ``FlatCommunicator``): pack every gradient into one contiguous
buffer, one all-reduce over it, unpack with the 1/size mean.
"""

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)


class FlatCommunicator(MeshCommunicator):
    flavor = "flat"

    def _allreduce_grad_traced(self, grads):
        buffers, meta = _packing.pack(grads)
        buffers = [self._all_reduce_sum(b) for b in buffers]
        return _packing.unpack(buffers, meta, scale=1.0 / self.size)
