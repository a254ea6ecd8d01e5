"""XLA communicator — the ``pure_nccl`` data path.

Counterpart of ``chainermn_tpu/communicators/xla_communicator.py`` (the
reference's ``PureNcclCommunicator``, the fork's flagship).  Without a wire
dtype it is the flat decomposition: one packed buffer per dtype, one NCCL
all-reduce each, unpack with the 1/size mean.

With ``allreduce_grad_dtype`` (the wire dtype, e.g. float16) it runs the
JAX package's cast-kernel sequence (``_pallas_allreduce_grad_traced``;
the base class's ``_allreduce_grad_wire_start``, which
``allreduce_grad(compressor=NoCompression(wire))`` runs on every flavor):
pack per dtype group; :func:`~chainermn_tpu_torch.ops.cast_scale` each
buffer into the wire dtype with scale 1; all-reduce in the wire dtype;
``cast_scale`` back to the group's dtype with scale 1/size; unpack.  That is
the only wire route, on the card and on the CPU alike: the JAX default
leaves the fusion of cast and scale to XLA, and eager PyTorch has no
compiler to fuse them.  On float32 leaves it gives the bits of the JAX
default route (the cast in with scale 1 is the plain ``astype``, and
``f32(sum) * (1/size)`` is unpack's cast-then-scale).  ``use_pallas_cast``,
the JAX switch between the two routes, is accepted and changes nothing.
"""

from chainermn_tpu_torch.communicators.flat_communicator import (
    FlatCommunicator)


class XlaCommunicator(FlatCommunicator):
    supports_allreduce_grad_dtype = True
    flavor = "xla"

    def __init__(self, *args, use_pallas_cast: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_pallas_cast = use_pallas_cast

    def _allreduce_grad_start(self, grads):
        wire = self.allreduce_grad_dtype
        if wire is None:
            return super()._allreduce_grad_start(grads)
        return self._allreduce_grad_wire_start(grads, wire)


# The reference name.
PureNcclCommunicator = XlaCommunicator
