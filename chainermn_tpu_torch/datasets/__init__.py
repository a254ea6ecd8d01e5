from chainermn_tpu_torch.datasets.image_pipeline import (
    IMAGENET_MEAN, IMAGENET_STD, Augment, ImageFolderDataset, NpzImageDataset,
    PrefetchIterator, TransformDataset, center_crop, normalize_image,
    random_crop, random_flip, random_sized_crop, resize_short_side)
from chainermn_tpu_torch.datasets.nmt import (
    Vocab, bleu, bucket_batches, encode_pairs, load_corpus)
from chainermn_tpu_torch.datasets.scatter_dataset import (
    SubDataset, TupleDataset, scatter_dataset, scatter_index)
from chainermn_tpu_torch.datasets.synthetic import (
    make_classification, write_image_folder)

__all__ = ["Augment", "IMAGENET_MEAN", "IMAGENET_STD", "ImageFolderDataset",
           "NpzImageDataset", "PrefetchIterator", "SubDataset",
           "TransformDataset", "TupleDataset", "Vocab", "bleu",
           "bucket_batches", "center_crop", "encode_pairs", "load_corpus",
           "make_classification", "normalize_image", "random_crop",
           "random_flip", "random_sized_crop", "resize_short_side",
           "scatter_dataset", "scatter_index", "write_image_folder"]
