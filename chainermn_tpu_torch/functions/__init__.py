"""Differentiable communication: collectives, the SPMD permute, and the
model-parallel point-to-point channels.

Counterpart of ``chainermn_tpu/functions``.
"""

from chainermn_tpu_torch.functions.collective_communication import (
    allgather,
    allreduce,
    alltoall,
    bcast,
    gather,
    scatter,
)
from chainermn_tpu_torch.functions.point_to_point_communication import (
    cross_recv,
    cross_send,
    pseudo_connect,
    recv,
    send,
    spmd_send_recv,
    spmd_send_recv_async,
)

__all__ = ["allgather", "allreduce", "alltoall", "bcast", "cross_recv",
           "cross_send", "gather", "pseudo_connect", "recv", "scatter",
           "send", "spmd_send_recv", "spmd_send_recv_async"]
