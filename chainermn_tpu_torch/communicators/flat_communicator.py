"""Flat communicator — one all-reduce over a packed buffer per dtype.

Counterpart of ``chainermn_tpu/communicators/flat_communicator.py`` (the
reference's ``FlatCommunicator``): pack every gradient into one contiguous
buffer, one all-reduce over it, unpack with the 1/size mean.
"""

import torch.distributed as dist

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)


class FlatCommunicator(MeshCommunicator):
    flavor = "flat"

    def _allreduce_grad_traced(self, grads):
        return self._allreduce_grad_start(grads)()

    def _allreduce_grad_start(self, grads):
        buffers, meta = _packing.pack(grads)
        works = [dist.all_reduce(b, dist.ReduceOp.SUM, group=self._group,
                                 async_op=True) for b in buffers]

        def finish():
            for w in works:
                w.wait()
            return _packing.unpack(buffers, meta, scale=1.0 / self.size)

        return finish
