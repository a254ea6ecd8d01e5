"""Communicator factory.

Counterpart of ``chainermn_tpu/communicators/__init__.py`` (the reference's
``create_communicator``): string -> class dispatch, where only
``xla``/``pure_nccl`` accept ``allreduce_grad_dtype``.  This slice of the
port has ``naive``, ``flat`` and ``xla`` (``pure_nccl`` is its alias); the
other names of the JAX package raise until they are ported.
"""

from typing import Optional

from chainermn_tpu_torch.communicators.communicator_base import (
    CommunicatorBase)
from chainermn_tpu_torch.communicators.flat_communicator import (
    FlatCommunicator)
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)
from chainermn_tpu_torch.communicators.naive_communicator import (
    NaiveCommunicator)
from chainermn_tpu_torch.communicators.xla_communicator import (
    XlaCommunicator)

_COMMUNICATORS = {
    "naive": NaiveCommunicator,
    "flat": FlatCommunicator,
    "xla": XlaCommunicator,
    "pure_nccl": XlaCommunicator,
}
# names of the JAX package still to be ported (ROADMAP.md, Queue A2)
_NOT_PORTED = ("hierarchical", "two_dimensional", "single_node",
               "non_cuda_aware", "auto")


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
    """
    if communicator_name in _NOT_PORTED:
        raise NotImplementedError(
            f"communicator {communicator_name!r} is not ported yet; see "
            "ROADMAP.md Queue A2 (available: "
            f"{sorted(_COMMUNICATORS)})")
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
    "XlaCommunicator",
    "create_communicator",
]
