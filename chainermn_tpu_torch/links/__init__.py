from chainermn_tpu_torch.links.multi_node_batch_normalization import (
    MultiNodeBatchNormalization)

__all__ = ["MultiNodeBatchNormalization"]
