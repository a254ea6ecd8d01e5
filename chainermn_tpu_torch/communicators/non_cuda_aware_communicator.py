"""Host-staged communicator.

Counterpart of ``chainermn_tpu/communicators/non_cuda_aware_communicator.py``
(the reference's ``NonCudaAwareCommunicator``: the flat decomposition for
MPI builds that cannot read GPU memory, staged through pinned host
buffers).  On a GPU that is once more its literal meaning: pack, copy
the buffer to pinned host memory, all-reduce it over the CPU on the
object plane's gloo group, ``/ size``, copy back.  (The JAX package
stages through the host in eager mode and falls back to the flat psum
inside a traced program.)
"""

import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)


class NonCudaAwareCommunicator(MeshCommunicator):
    flavor = "non_cuda_aware"

    def _allreduce_grad_traced(self, grads):
        buffers, meta = _packing.pack(grads)
        out = []
        for b in buffers:
            host = torch.empty(b.shape, dtype=b.dtype, device="cpu",
                               pin_memory=b.is_cuda)
            host.copy_(b)
            dist.all_reduce(host, dist.ReduceOp.SUM,
                            group=self._obj_group)
            host.div_(self.size)
            out.append(host.to(b.device, non_blocking=True))
        return _packing.unpack(out, meta)
