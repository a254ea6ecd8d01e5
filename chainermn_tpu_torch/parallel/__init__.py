from chainermn_tpu_torch.parallel.fsdp import (
    BucketLayout, FsdpMeta, FsdpState, fsdp_full_params, fsdp_init,
    fsdp_layout, iter_fsdp_states, make_fsdp_meta, make_fsdp_train_step)
from chainermn_tpu_torch.parallel.pipeline import (
    make_pipeline_fn, make_pipeline_train_fn, module_stage_fn,
    pipeline_1f1b, pipeline_apply)
from chainermn_tpu_torch.parallel.sequence import (
    attention, ring_attention, ulysses_attention)
from chainermn_tpu_torch.parallel.topology import (
    Topology, init_topology, resolve_device)
from chainermn_tpu_torch.parallel.tensor import (
    ColumnParallelDense, RowParallelDense, TensorParallelMLP)
from chainermn_tpu_torch.parallel.expert import ExpertParallelMLP, moe_apply

__all__ = ["BucketLayout", "ColumnParallelDense", "ExpertParallelMLP",
           "FsdpMeta", "FsdpState", "RowParallelDense", "TensorParallelMLP",
           "Topology", "attention", "fsdp_full_params", "fsdp_init",
           "fsdp_layout", "init_topology", "iter_fsdp_states",
           "make_fsdp_meta", "make_fsdp_train_step", "make_pipeline_fn",
           "make_pipeline_train_fn", "module_stage_fn", "moe_apply",
           "pipeline_1f1b", "pipeline_apply", "resolve_device",
           "ring_attention", "ulysses_attention"]
