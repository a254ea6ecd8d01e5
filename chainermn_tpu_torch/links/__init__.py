from chainermn_tpu_torch.links.multi_node_batch_normalization import (
    MultiNodeBatchNormalization)
from chainermn_tpu_torch.links.multi_node_chain_list import (
    MultiNodeChainList, pseudo_loss)

__all__ = ["MultiNodeBatchNormalization", "MultiNodeChainList",
           "pseudo_loss"]
