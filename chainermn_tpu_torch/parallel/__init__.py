from chainermn_tpu_torch.parallel.fsdp import (
    BucketLayout, FsdpMeta, FsdpState, fsdp_full_params, fsdp_init,
    fsdp_layout, iter_fsdp_states, make_fsdp_meta, make_fsdp_train_step)
from chainermn_tpu_torch.parallel.sequence import (
    attention, ring_attention, ulysses_attention)
from chainermn_tpu_torch.parallel.topology import (
    Topology, init_topology, resolve_device)

__all__ = ["BucketLayout", "FsdpMeta", "FsdpState", "Topology", "attention",
           "fsdp_full_params", "fsdp_init", "fsdp_layout", "init_topology",
           "iter_fsdp_states", "make_fsdp_meta", "make_fsdp_train_step",
           "resolve_device", "ring_attention", "ulysses_attention"]
