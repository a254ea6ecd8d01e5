"""Differentiable communication: collectives and the SPMD permute.

Counterpart of ``chainermn_tpu/functions``; the cross-process
``send``/``recv``/``pseudo_connect``/``cross_send``/``cross_recv`` wait for
ROADMAP.md Queue A7.
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
    spmd_send_recv,
    spmd_send_recv_async,
)

__all__ = ["allgather", "allreduce", "alltoall", "bcast", "gather",
           "scatter", "spmd_send_recv", "spmd_send_recv_async"]
