"""Naive communicator — one all-reduce per gradient tensor.

Counterpart of ``chainermn_tpu/communicators/naive_communicator.py`` (the
reference's ``NaiveCommunicator``: one ``MPI.Allreduce`` per parameter).
The base class's per-leaf body is this decomposition.
"""

from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    MeshCommunicator)


class NaiveCommunicator(MeshCommunicator):
    flavor = "naive"
