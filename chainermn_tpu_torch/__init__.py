"""chainermn_tpu_torch — the ChainerMN programming model on PyTorch and
NVIDIA GPUs.

The PyTorch port of ``chainermn_tpu`` (which stays as the JAX reference):
one process per GPU, NCCL process groups for the collectives, and the JAX
package's Pallas kernels written again by hand for Hopper.  This package
imports neither JAX nor ``chainermn_tpu``.
"""

from chainermn_tpu_torch import observability
from chainermn_tpu_torch.communicators import (
    CommunicatorBase, create_communicator)
from chainermn_tpu_torch.compression import (
    CompressionState, Compressor, Fp8Compressor, Int8Compressor,
    NoCompression, available_compressors, resolve_compressor)
from chainermn_tpu_torch.datasets import (
    Augment, ImageFolderDataset, NpzImageDataset, PrefetchIterator,
    TransformDataset, normalize_image, scatter_dataset, scatter_index)
from chainermn_tpu_torch.extensions import (
    AllreducePersistent, consolidate_fsdp_checkpoint,
    create_multi_node_checkpointer, create_multi_node_evaluator)
from chainermn_tpu_torch.iterators import (
    create_multi_node_iterator, create_synchronized_iterator)
from chainermn_tpu_torch.links import (
    MultiNodeBatchNormalization, MultiNodeChainList, pseudo_loss)
from chainermn_tpu_torch.models.vit import ViT, ViT_B16, ViT_S16
from chainermn_tpu_torch.observability import instrument_communicator
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.optimizers import (
    create_multi_node_optimizer, create_per_stage_optimizer, make_train_step)
from chainermn_tpu_torch.parallel import (
    ColumnParallelDense, ExpertParallelMLP, RowParallelDense,
    TensorParallelMLP, make_pipeline_fn, make_pipeline_train_fn, moe_apply,
    pipeline_1f1b, pipeline_apply)
from chainermn_tpu_torch.parallel.sequence import (
    attention, ring_attention, ulysses_attention)
from chainermn_tpu_torch.parallel.topology import Topology, init_topology
from chainermn_tpu_torch.planner import (
    Plan, PlanTable, PlanTopology, Stage, autotune_from_rows,
    candidate_plans, execute_plan, flavor_plan, plan_census_kinds)
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from chainermn_tpu_torch.runtime.control_plane import (
    ControlPlane, SocketControlPlane, get_control_plane, reserved_tag)
from chainermn_tpu_torch.serving import (
    AdmissionScheduler, InferenceEngine, KvCache, PageAllocator,
    ServingConfig, load_inference_params, paged_attention)

#: cmn-lint (``chainermn_tpu_torch.analysis``), imported at first use as
#: JAX's facade does: the recorder pulls in ``torch.testing``'s fake
#: process group only when a lint runs
_LAZY = {
    "lint_step": "chainermn_tpu_torch.analysis",
    "LintError": "chainermn_tpu_torch.analysis",
    "LintReport": "chainermn_tpu_torch.analysis",
    "extract_schedule": "chainermn_tpu_torch.analysis",
    "CollectiveSchedule": "chainermn_tpu_torch.analysis",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        val = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = val
        return val
    raise AttributeError(
        f"module 'chainermn_tpu_torch' has no attribute {name!r}")


__all__ = ["AdmissionScheduler", "AllreducePersistent", "Augment",
           "CollectiveSchedule", "ColumnParallelDense", "CommunicatorBase",
           "CompressionState",
           "Compressor", "ControlPlane", "ExpertParallelMLP",
           "Fp8Compressor", "ImageFolderDataset", "InferenceEngine",
           "Int8Compressor", "KvCache", "MultiNodeBatchNormalization",
           "MultiNodeChainList", "NoCompression", "NpzImageDataset",
           "PageAllocator", "Plan", "PlanTable", "PlanTopology",
           "PrefetchIterator", "RowParallelDense", "ServingConfig",
           "SocketControlPlane", "Stage", "TensorParallelMLP", "Topology",
           "TransformDataset", "ViT", "ViT_B16", "ViT_S16", "attention",
           "autotune_from_rows", "available_compressors", "candidate_plans",
           "consolidate_fsdp_checkpoint", "create_communicator",
           "create_multi_node_checkpointer", "create_multi_node_evaluator",
           "create_multi_node_iterator", "create_multi_node_optimizer",
           "create_per_stage_optimizer", "create_synchronized_iterator",
           "execute_plan", "flash_attention", "flavor_plan",
           "get_control_plane", "init_distributed", "init_topology",
           "instrument_communicator", "LintError", "LintReport",
           "lint_step", "extract_schedule", "load_inference_params",
           "make_pipeline_fn", "make_pipeline_train_fn", "make_train_step",
           "moe_apply", "normalize_image", "observability",
           "paged_attention", "pipeline_1f1b", "pipeline_apply",
           "plan_census_kinds", "pseudo_loss", "reserved_tag",
           "resolve_compressor", "ring_attention", "scatter_dataset",
           "scatter_index", "ulysses_attention"]
