"""Synthetic datasets for the examples.

Counterpart of ``chainermn_tpu/datasets/synthetic.py``, numpy only, so the
same arguments give the same bits as the JAX package's.  The reference
examples download MNIST; without a network the examples train on
class-dependent Gaussian blobs of the same shapes, which a model can learn.
"""

from __future__ import annotations

import numpy as np

from chainermn_tpu_torch.datasets.scatter_dataset import TupleDataset


def make_classification(
    n: int = 60000,
    dim: int = 784,
    n_classes: int = 10,
    *,
    scale: float = 1.0,
    noise: float = 1.0,
    seed: int = 0,
    class_seed: int = 1234,
    image_shape=None,
):
    """Gaussian-blob classification dataset: x = mu[y] + noise*N(0, I).

    ``class_seed`` fixes the class means independently of ``seed`` so a
    train split (seed=0) and a test split (seed=1) sample the *same* task.
    """
    mus = (np.random.RandomState(class_seed)
           .randn(n_classes, dim).astype(np.float32) * scale)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    x = mus[y] + noise * rng.randn(n, dim).astype(np.float32)
    if image_shape is not None:
        x = x.reshape((n,) + tuple(image_shape))
    return TupleDataset(x, y)
