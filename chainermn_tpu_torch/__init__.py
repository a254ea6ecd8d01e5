"""chainermn_tpu_torch — the ChainerMN programming model on PyTorch and
NVIDIA GPUs.

The PyTorch port of ``chainermn_tpu`` (which stays as the JAX reference):
one process per GPU, NCCL process groups for the collectives, and the JAX
package's Pallas kernels written again by hand for Hopper.  This package
imports neither JAX nor ``chainermn_tpu``.
"""

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.compression import (
    CompressionState, Compressor, Fp8Compressor, Int8Compressor,
    NoCompression, available_compressors, resolve_compressor)
from chainermn_tpu_torch.extensions.checkpoint import (
    consolidate_fsdp_checkpoint)
from chainermn_tpu_torch.datasets import (
    Augment, ImageFolderDataset, NpzImageDataset, TransformDataset,
    normalize_image, scatter_dataset)
from chainermn_tpu_torch.links import MultiNodeChainList, pseudo_loss
from chainermn_tpu_torch.models.vit import ViT, ViT_B16, ViT_S16
from chainermn_tpu_torch.optimizers import (
    create_multi_node_optimizer, create_per_stage_optimizer, make_train_step)
from chainermn_tpu_torch.parallel import (
    ColumnParallelDense, ExpertParallelMLP, RowParallelDense,
    TensorParallelMLP, make_pipeline_fn, make_pipeline_train_fn, moe_apply,
    pipeline_1f1b, pipeline_apply)
from chainermn_tpu_torch.parallel.sequence import (
    attention, ring_attention, ulysses_attention)
from chainermn_tpu_torch.runtime.bootstrap import init_distributed

__all__ = ["Augment", "ColumnParallelDense", "CompressionState",
           "Compressor", "ExpertParallelMLP", "Fp8Compressor",
           "ImageFolderDataset", "Int8Compressor", "MultiNodeChainList",
           "NoCompression", "NpzImageDataset", "RowParallelDense",
           "TensorParallelMLP", "TransformDataset", "ViT", "ViT_B16",
           "ViT_S16", "attention", "available_compressors",
           "consolidate_fsdp_checkpoint", "create_communicator",
           "create_multi_node_optimizer", "create_per_stage_optimizer",
           "init_distributed", "make_pipeline_fn", "make_pipeline_train_fn",
           "make_train_step", "moe_apply", "normalize_image",
           "pipeline_1f1b", "pipeline_apply", "pseudo_loss",
           "resolve_compressor", "ring_attention", "scatter_dataset",
           "ulysses_attention"]
