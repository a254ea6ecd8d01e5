"""chainermn_tpu_torch — the ChainerMN programming model on PyTorch and
NVIDIA GPUs.

The PyTorch port of ``chainermn_tpu`` (which stays as the JAX reference):
one process per GPU, NCCL process groups for the collectives, and the JAX
package's Pallas kernels written again by hand for Hopper.  This package
imports neither JAX nor ``chainermn_tpu``.
"""

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.datasets import scatter_dataset
from chainermn_tpu_torch.optimizers import (
    create_multi_node_optimizer, make_train_step)
from chainermn_tpu_torch.runtime.bootstrap import init_distributed

__all__ = ["create_communicator", "create_multi_node_optimizer",
           "init_distributed", "make_train_step", "scatter_dataset"]
