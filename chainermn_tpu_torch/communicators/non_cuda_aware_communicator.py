"""Host-staged communicator.

Counterpart of ``chainermn_tpu/communicators/non_cuda_aware_communicator.py``
(the reference's ``NonCudaAwareCommunicator``: the flat decomposition for
MPI builds that cannot read GPU memory, staged through pinned host
buffers).  On a GPU that is once more its literal meaning: pack, copy
the buffer to pinned host memory, all-reduce it over the CPU on the
object plane's gloo group, ``/ size``, copy back.  (The JAX package
stages through the host in eager mode and falls back to the flat psum
inside a traced program.)

``allreduce_grad(compressor=...)`` as in JAX's class: a quantizer takes
the base class's compressed path (it rides the in-wire sum, not the host);
``NoCompression(wire_dtype)`` rounds each gradient through the wire dtype
and back, then stages the mean through the host.
"""

import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)


class NonCudaAwareCommunicator(MeshCommunicator):
    flavor = "non_cuda_aware"

    def allreduce_grad(self, grads, *, compressor=None, state=None):
        from chainermn_tpu_torch.compression import (
            NoCompression, resolve_compressor)
        from chainermn_tpu_torch.planner.ir import Plan
        if isinstance(compressor, Plan) or isinstance(state, dict):
            return super().allreduce_grad(grads, compressor=compressor,
                                          state=state)
        comp = resolve_compressor(compressor)
        if isinstance(comp, NoCompression) and comp.wire is not None:
            wire = comp.wire
            if isinstance(grads, nn.Module):
                for p in grads.parameters():
                    if p.grad is not None:
                        p.grad = p.grad.to(wire).to(p.grad.dtype)
            else:
                grads = _packing.tree_map(
                    lambda g: g.to(wire).to(g.dtype), grads)
            comp = None
        return super().allreduce_grad(grads, compressor=comp, state=state)

    def _plan_all_reduce(self, buf, group, scope):
        """A plan's world-scope all-reduce stages through the host, as this
        flavor's own mean does (its ``plan()`` is the flat plan); the
        intra and inter scopes use the communicator's groups."""
        if scope != "all":
            return super()._plan_all_reduce(buf, group, scope)
        host = torch.empty(buf.shape, dtype=buf.dtype, device="cpu",
                           pin_memory=buf.is_cuda)
        host.copy_(buf)
        dist.all_reduce(host, dist.ReduceOp.SUM, group=self._obj_group)
        buf.copy_(host)

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
