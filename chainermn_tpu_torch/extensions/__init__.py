from chainermn_tpu_torch.extensions.allreduce_persistent import (
    AllreducePersistent, allreduce_persistent)
from chainermn_tpu_torch.extensions.checkpoint import (
    consolidate_fsdp_checkpoint, create_multi_node_checkpointer)
from chainermn_tpu_torch.extensions.multi_node_evaluator import (
    create_multi_node_evaluator, make_eval_fn)

__all__ = ["AllreducePersistent", "allreduce_persistent",
           "consolidate_fsdp_checkpoint", "create_multi_node_checkpointer",
           "create_multi_node_evaluator", "make_eval_fn"]
