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


_IMAGE_CLASS_SEED = 1234


def write_image_folder(root: str, n_images: int, n_classes: int, *,
                       min_side: int = 300, max_side: int = 500,
                       seed: int = 0, ext: str = ".jpg") -> str:
    """Write an ImageFolder tree for the real-image path: ``n_images`` RGB
    files (Pillow, ``ext`` picks the format) spread round-robin over
    ``n_classes`` folders ``root/class_{k:03d}/``, each side drawn in
    ``[min_side, max_side]``.  An image is its class's mean colour (drawn
    from a fixed seed, so a training and a validation folder written from
    two values of ``seed`` hold the same classes) plus a smooth random
    field (a coarse grid upsampled bilinearly), so a model can learn the
    classes and JPEG keeps the files small.  Returns ``root``."""
    import os

    from PIL import Image

    means = np.random.RandomState(_IMAGE_CLASS_SEED).randint(
        48, 208, size=(n_classes, 3))
    rng = np.random.RandomState(seed)
    for k in range(n_classes):
        os.makedirs(os.path.join(root, f"class_{k:03d}"), exist_ok=True)
    for i in range(n_images):
        k = i % n_classes
        h, w = (int(s) for s in rng.randint(min_side, max_side + 1, size=2))
        coarse = rng.randint(-48, 49, size=(max(2, h // 32), max(2, w // 32),
                                            3)) + means[k]
        img = Image.fromarray(np.clip(coarse, 0, 255).astype(np.uint8))
        img.resize((w, h), Image.BILINEAR).save(
            os.path.join(root, f"class_{k:03d}", f"img_{i:05d}{ext}"))
    return root
