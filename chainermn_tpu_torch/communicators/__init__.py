"""Communicator factory.

Counterpart of ``chainermn_tpu/communicators/__init__.py`` (the reference's
``create_communicator``): string -> class dispatch, where only
``xla``/``pure_nccl`` accept ``allreduce_grad_dtype``.  Every flavor of the
reference is here; ``auto``, the JAX package's planner-tuned flavor, raises
until the collective planner is ported (ROADMAP.md, Queue A11).
"""

from typing import Optional

from chainermn_tpu_torch.communicators.communicator_base import (
    CommunicatorBase)
from chainermn_tpu_torch.communicators.flat_communicator import (
    FlatCommunicator)
from chainermn_tpu_torch.communicators.hierarchical_communicator import (
    HierarchicalCommunicator)
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)
from chainermn_tpu_torch.communicators.naive_communicator import (
    NaiveCommunicator)
from chainermn_tpu_torch.communicators.non_cuda_aware_communicator import (
    NonCudaAwareCommunicator)
from chainermn_tpu_torch.communicators.single_node_communicator import (
    SingleNodeCommunicator)
from chainermn_tpu_torch.communicators.two_dimensional_communicator import (
    TwoDimensionalCommunicator)
from chainermn_tpu_torch.communicators.xla_communicator import (
    XlaCommunicator)

_COMMUNICATORS = {
    "naive": NaiveCommunicator,
    "flat": FlatCommunicator,
    "hierarchical": HierarchicalCommunicator,
    "two_dimensional": TwoDimensionalCommunicator,
    "single_node": SingleNodeCommunicator,
    "non_cuda_aware": NonCudaAwareCommunicator,
    "xla": XlaCommunicator,
    "pure_nccl": XlaCommunicator,
}


def create_communicator(communicator_name: str = "hierarchical",
                        allreduce_grad_dtype=None,
                        intra_size: Optional[int] = None, device=None,
                        **kwargs) -> CommunicatorBase:
    """Create a communicator by name (reference signature:
    ``create_communicator(communicator_name, mpi_comm,
    allreduce_grad_dtype)``; the process group takes ``mpi_comm``'s place).

    Initializes the default process group first if it is not yet
    (:func:`~chainermn_tpu_torch.runtime.bootstrap.init_distributed`, from
    the environment).  ``device``: CUDA unless ``"cpu"`` is asked for.
    ``intra_size``: ranks per node (default ``LOCAL_WORLD_SIZE``).  Every
    rank must call this, in the same order: it builds process groups.
    """
    if communicator_name == "auto":
        raise NotImplementedError(
            "communicator 'auto' needs the collective planner, which is not "
            "ported yet; see ROADMAP.md Queue A11")
    try:
        cls = _COMMUNICATORS[communicator_name]
    except KeyError:
        raise ValueError(
            f"unknown communicator {communicator_name!r}; available: "
            f"{sorted(_COMMUNICATORS)}") from None
    if allreduce_grad_dtype is not None and \
            not cls.supports_allreduce_grad_dtype:
        raise ValueError(
            "allreduce_grad_dtype is only supported by the "
            "'xla'/'pure_nccl' communicator")
    from chainermn_tpu_torch.parallel.topology import init_topology
    from chainermn_tpu_torch.runtime.bootstrap import init_distributed
    init_distributed(device)
    topo = init_topology(device, intra_size=intra_size)
    if allreduce_grad_dtype is not None:
        kwargs["allreduce_grad_dtype"] = allreduce_grad_dtype
    return cls(topology=topo, **kwargs)


__all__ = [
    "CommunicatorBase",
    "MeshCommunicator",
    "NaiveCommunicator",
    "FlatCommunicator",
    "HierarchicalCommunicator",
    "TwoDimensionalCommunicator",
    "SingleNodeCommunicator",
    "NonCudaAwareCommunicator",
    "XlaCommunicator",
    "create_communicator",
]
