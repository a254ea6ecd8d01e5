from chainermn_tpu_torch.extensions.multi_node_evaluator import (
    create_multi_node_evaluator, make_eval_fn)

__all__ = ["create_multi_node_evaluator", "make_eval_fn"]
