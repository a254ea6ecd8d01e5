"""XLA communicator — the ``pure_nccl`` data path.

Counterpart of ``chainermn_tpu/communicators/xla_communicator.py`` (the
reference's ``PureNcclCommunicator``, the fork's flagship): pack the
gradients into one flat buffer per dtype (or one buffer in
``allreduce_grad_dtype``, the wire dtype), one NCCL all-reduce per buffer,
then cast back and scale by 1/size while unpacking.

``use_pallas_cast=True`` selects the hand-written cast+scale kernel in the
JAX package; its port is slice 2 of ROADMAP.md (Queue B1), so here it
raises.
"""

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)


class XlaCommunicator(MeshCommunicator):
    supports_allreduce_grad_dtype = True
    flavor = "xla"

    def __init__(self, *args, use_pallas_cast: bool = False, **kwargs):
        if use_pallas_cast:
            raise NotImplementedError(
                "use_pallas_cast=True needs the cast_scale kernel, which is "
                "not ported yet (ROADMAP.md Queue B1, slice 2)")
        super().__init__(*args, **kwargs)

    def _allreduce_grad_traced(self, grads):
        buffers, meta = _packing.pack(grads,
                                      comm_dtype=self.allreduce_grad_dtype)
        buffers = [self._all_reduce_sum(b) for b in buffers]
        return _packing.unpack(buffers, meta, scale=1.0 / self.size)


# The reference name.
PureNcclCommunicator = XlaCommunicator
