"""Process-group bootstrap from arguments or the launcher's environment.

Counterpart of ``chainermn_tpu/runtime/bootstrap.py`` (``init_distributed``).
The JAX package starts its multi-controller runtime from the
``CHAINERMN_TPU_*`` variables; here ``torch.distributed`` starts from the
names ``torchrun`` exports (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), with the JAX
contract's names accepted in their place:

==============================  ==================================
torch.distributed               JAX contract
==============================  ==================================
``RANK``                        ``CHAINERMN_TPU_PROCESS_ID``
``WORLD_SIZE``                  ``CHAINERMN_TPU_NUM_PROCESSES``
``MASTER_ADDR:MASTER_PORT``     ``CHAINERMN_TPU_COORDINATOR``
==============================  ==================================

NCCL is the backend on a GPU and gloo on the CPU.  A single process with
none of these set is a world of one, with an in-process store.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from chainermn_tpu_torch.parallel.topology import (
    Topology, env_int, init_topology)


def _coordinator() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if addr and port:
        return f"{addr}:{port}"
    return os.environ.get("CHAINERMN_TPU_COORDINATOR") or None


def init_distributed(device=None, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Topology:
    """Initialize the default process group and return this process's
    :class:`Topology`.

    Args and environment as in the module docstring; ``device`` as in
    :func:`~chainermn_tpu_torch.parallel.topology.resolve_device` (CUDA
    unless ``"cpu"`` is asked for).  If the group is already initialized
    it is kept and only the topology is returned.
    """
    if dist.is_initialized():
        return init_topology(device)
    size = num_processes or env_int("WORLD_SIZE",
                                    "CHAINERMN_TPU_NUM_PROCESSES") or 1
    rank = process_id
    if rank is None:
        rank = env_int("RANK", "CHAINERMN_TPU_PROCESS_ID") or 0
    coordinator = coordinator or _coordinator()
    topo = init_topology(device, rank=rank, size=size)
    backend = "nccl" if topo.device.type == "cuda" else "gloo"
    if topo.device.type == "cuda":
        torch.cuda.set_device(topo.device)
    if coordinator is None:
        if size != 1:
            raise ValueError(
                "a multi-process world needs a coordinator: set MASTER_ADDR "
                "and MASTER_PORT (or CHAINERMN_TPU_COORDINATOR=host:port) "
                "or pass coordinator=")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                rank=rank, world_size=size)
    return topo


__all__ = ["init_distributed"]
