from chainermn_tpu_torch.datasets.scatter_dataset import (
    SubDataset, TupleDataset, scatter_dataset, scatter_index)

__all__ = ["SubDataset", "TupleDataset", "scatter_dataset", "scatter_index"]
