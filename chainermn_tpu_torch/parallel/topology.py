"""Process topology: rank bookkeeping and the device of this process.

Counterpart of ``chainermn_tpu/parallel/topology.py``.  The JAX package
arranges devices into a mesh whose ``inter`` axis crosses hosts and whose
``intra`` axis stays on one.  Here one process drives one GPU, as one MPI
rank drove one GPU in the reference: ``rank``/``size`` come from
``torch.distributed`` (or the launcher's environment), the ``intra`` level
is the ranks of one node (``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, NVLink) and
the ``inter`` level is the set of nodes.  The device is
``cuda:LOCAL_RANK`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Topology:
    """Where this process sits in the data-parallel world."""

    rank: int
    size: int
    intra_rank: int
    intra_size: int
    device: torch.device

    @property
    def inter_rank(self) -> int:
        return self.rank // self.intra_size

    @property
    def inter_size(self) -> int:
        return self.size // self.intra_size


def env_int(*names: str) -> Optional[int]:
    """The first of the environment variables ``names`` that is set."""
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def resolve_device(device=None, local_rank: int = 0) -> torch.device:
    """``device``, or ``cuda:{local_rank}`` when it is None.

    Raises when a CUDA device is wanted (explicitly or by default) and
    there is none: the port never falls back to the CPU on its own; pass
    ``device="cpu"`` for that.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but no CUDA "
                               "device is available")
        if device.index is None:
            device = torch.device("cuda", local_rank)
    return device


def init_topology(device=None, intra_size: Optional[int] = None,
                  rank: Optional[int] = None,
                  size: Optional[int] = None) -> Topology:
    """Discover this process's place in the world.

    ``rank``/``size`` default to the initialized process group's, else to
    ``RANK``/``WORLD_SIZE`` (or ``CHAINERMN_TPU_PROCESS_ID``/
    ``CHAINERMN_TPU_NUM_PROCESSES``), else to a world of one.

    A given ``intra_size`` splits the world into nodes of that many
    consecutive ranks, so ``intra_rank = rank % intra_size``, as the JAX
    package takes the position on the mesh's last axis (one node can so
    stand in for several).  Without it, ``LOCAL_WORLD_SIZE``/``LOCAL_RANK``
    (else the whole world as one node).  The device is ``cuda:LOCAL_RANK``
    whichever way the levels are cut (``cuda:{intra_rank}`` when
    ``LOCAL_RANK`` is unset).
    """
    if rank is None or size is None:
        if dist.is_initialized():
            rank, size = dist.get_rank(), dist.get_world_size()
        else:
            rank = env_int("RANK", "CHAINERMN_TPU_PROCESS_ID") or 0
            size = env_int("WORLD_SIZE", "CHAINERMN_TPU_NUM_PROCESSES") or 1
    local_rank = env_int("LOCAL_RANK")
    if intra_size is None:
        intra_size = env_int("LOCAL_WORLD_SIZE") or size
        intra_rank = local_rank
    else:
        intra_rank = None
    if intra_size < 1 or size % intra_size:
        raise ValueError(f"world size {size} is not divisible by "
                         f"intra_size {intra_size}")
    if intra_rank is None:
        intra_rank = rank % intra_size
    return Topology(rank=rank, size=size, intra_rank=intra_rank,
                    intra_size=intra_size,
                    device=resolve_device(
                        device, intra_rank if local_rank is None
                        else local_rank))
