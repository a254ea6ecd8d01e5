from chainermn_tpu_torch.iterators.multi_node_iterator import (
    create_multi_node_iterator, create_synchronized_iterator)
from chainermn_tpu_torch.iterators.serial_iterator import SerialIterator

__all__ = ["SerialIterator", "create_multi_node_iterator",
           "create_synchronized_iterator"]
