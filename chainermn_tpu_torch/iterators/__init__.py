from chainermn_tpu_torch.iterators.serial_iterator import SerialIterator

__all__ = ["SerialIterator"]
