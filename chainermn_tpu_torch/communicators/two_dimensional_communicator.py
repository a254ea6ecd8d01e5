"""Two-dimensional communicator — reduce-scatter, all-reduce, all-gather.

Counterpart of ``chainermn_tpu/communicators/two_dimensional_communicator.py``
(the reference's ``TwoDimensionalCommunicator``): on each packed buffer,
padded to a multiple of ``intra_size``, a reduce-scatter over the intra
group leaves each rank of a node one summed shard; an all-reduce over the
inter group sums that shard across nodes, so the network carries only
1/intra_size of the gradients; an all-gather over the intra group puts the
shards back together.  Then the padding is stripped and unpack takes the
1/size mean.  (The JAX package's gather-back is a masked psum, a typing
device of JAX's with the same values.)
"""

import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator, all_gather_tensor, reduce_scatter_tensor)


class TwoDimensionalCommunicator(MeshCommunicator):
    flavor = "two_dimensional"

    def _allreduce_grad_traced(self, grads):
        buffers, meta = _packing.pack(grads)
        m = self.intra_size
        out = []
        for buf in buffers:
            if m == 1:
                self._reduce_level(buf, "inter")
                out.append(buf)
                continue
            buf, strip = _packing.pad_to_multiple(buf, m)
            shard = torch.empty(buf.shape[0] // m, dtype=buf.dtype,
                                device=buf.device)
            group = self._groups["intra"]
            reduce_scatter_tensor(shard, buf, dist.ReduceOp.SUM, group=group)
            self._reduce_level(shard, "inter")
            all_gather_tensor(buf, shard, group=group)
            out.append(strip(buf))
        return _packing.unpack(out, meta, scale=1.0 / self.size)
