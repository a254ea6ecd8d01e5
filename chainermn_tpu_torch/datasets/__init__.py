from chainermn_tpu_torch.datasets.image_pipeline import PrefetchIterator
from chainermn_tpu_torch.datasets.scatter_dataset import (
    SubDataset, TupleDataset, scatter_dataset, scatter_index)
from chainermn_tpu_torch.datasets.synthetic import make_classification

__all__ = ["PrefetchIterator", "SubDataset", "TupleDataset",
           "make_classification", "scatter_dataset", "scatter_index"]
