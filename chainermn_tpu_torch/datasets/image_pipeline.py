"""Host-side input pipeline: datasets, augmentation, prefetch.

Counterpart of ``chainermn_tpu/datasets/image_pipeline.py``.  The host
does uint8 work (decode, crop, flip: numpy and PIL, copied call for call
from the JAX module so the same ``RandomState`` draws give the same
bytes); the device does the float work (:func:`normalize_image`, a torch
op at the head of the loss).  :class:`PrefetchIterator` overlaps the two.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


class ImageFolderDataset:
    """``root/<class_name>/<image>`` tree, lazily decoded with PIL.

    ``__getitem__`` returns ``(uint8 [H, W, 3], int32 label)``; classes are
    the sorted subdirectory names.  ``resize`` (int) resizes the short side
    before any augmentation (the usual decode-time downscale).
    """

    def __init__(self, root: str, resize: Optional[int] = None):
        self.root = root
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise ValueError(f"no class subdirectories under {root!r}")
        self.samples: list = []
        for label, cls in enumerate(self.classes):
            cdir = os.path.join(root, cls)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(_IMG_EXTS):
                    self.samples.append((os.path.join(cdir, fn), label))
        if not self.samples:
            raise ValueError(f"no images found under {root!r}")
        self.resize = resize

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image

        path, label = self.samples[i]
        with Image.open(path) as im:
            im = im.convert("RGB")
            if self.resize:
                w, h = im.size
                s = self.resize / min(w, h)
                if s != 1.0:
                    im = im.resize((max(1, round(w * s)),
                                    max(1, round(h * s))))
            arr = np.asarray(im, dtype=np.uint8)
        return arr, np.int32(label)


class NpzImageDataset:
    """npz/dict with image + label arrays (``x``/``y`` or
    ``x_train``/``y_train``); images uint8 or float, NHWC."""

    def __init__(self, path_or_arrays, x_key: Optional[str] = None,
                 y_key: Optional[str] = None):
        if isinstance(path_or_arrays, (str, os.PathLike)):
            data = np.load(path_or_arrays)
        else:
            data = path_or_arrays
        keys = set(getattr(data, "files", None) or data.keys())
        xk = x_key or ("x" if "x" in keys else "x_train")
        yk = y_key or ("y" if "y" in keys else "y_train")
        if xk not in keys or yk not in keys:
            raise KeyError(f"need {xk!r}/{yk!r} arrays, found {sorted(keys)}")
        self.x = np.asarray(data[xk])
        self.y = np.asarray(data[yk]).astype(np.int32)
        if len(self.x) != len(self.y):
            raise ValueError(f"x/y length mismatch: {len(self.x)} vs "
                             f"{len(self.y)}")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


# ---------------------------------------------------------------------------
# augmentation (host side, uint8 in -> uint8 out)
# ---------------------------------------------------------------------------

def random_crop(img: np.ndarray, size: int, rng: np.random.RandomState,
                pad: int = 0) -> np.ndarray:
    """Random ``size``×``size`` crop, optionally after zero-padding ``pad``
    on each side (the CIFAR recipe)."""
    if pad:
        img = np.pad(img, ((pad, pad), (pad, pad), (0, 0)))
    h, w = img.shape[:2]
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    top = rng.randint(h - size + 1)
    left = rng.randint(w - size + 1)
    return img[top:top + size, left:left + size]


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return img[top:top + size, left:left + size]


def resize_short_side(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the short side equals ``size``, preserving aspect ratio.

    Used by the eval path to upscale images smaller than the crop size —
    without it an undersized image would pass through ``center_crop``
    unchanged and later break batch collation with a ragged ``np.stack``.
    """
    from PIL import Image

    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    if img.dtype != np.uint8:
        raise ValueError(
            f"cannot resize non-uint8 image (dtype={img.dtype}, "
            f"shape={img.shape}); resize before converting")
    scale = size / min(h, w)
    nh = max(size, int(round(h * scale)))
    nw = max(size, int(round(w * scale)))
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))


def random_flip(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    return img[:, ::-1] if rng.rand() < 0.5 else img


def random_sized_crop(img: np.ndarray, size: int,
                      rng: np.random.RandomState,
                      scale: Tuple[float, float] = (0.3, 1.0),
                      ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
    """Inception-style random-area crop resized to ``size``×``size``
    (the reference era's GoogLeNet/ResNet train-time augmentation)."""
    from PIL import Image

    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            top = rng.randint(h - ch + 1)
            left = rng.randint(w - cw + 1)
            crop = img[top:top + ch, left:left + cw]
            break
    else:
        crop = center_crop(img, min(h, w))
    if crop.shape[:2] != (size, size):
        crop = np.asarray(
            Image.fromarray(crop).resize((size, size)), dtype=np.uint8)
    return crop


class Augment:
    """Composable train/eval transform: ``Augment(image_size, train=True)``.

    Train: random-sized crop (or pad-and-crop when ``pad`` given, the
    CIFAR recipe) + horizontal flip.  Eval: center crop.  Seeded per
    instance; every sample draw advances the stream.
    """

    def __init__(self, image_size: int, train: bool = True,
                 pad: Optional[int] = None, flip: bool = True,
                 seed: int = 0):
        self.image_size = image_size
        self.train = train
        self.pad = pad
        self.flip = flip
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()

    def __call__(self, sample):
        img, label = sample
        img = np.asarray(img)
        with self._lock:  # RandomState is not thread-safe
            seed = self._rng.randint(2 ** 31)
        rng = np.random.RandomState(seed)
        if self.train:
            if self.pad is not None:
                img = random_crop(img, self.image_size, rng, pad=self.pad)
            elif img.shape[0] != self.image_size or \
                    img.shape[1] != self.image_size:
                img = random_sized_crop(img, self.image_size, rng)
            if self.flip:
                img = random_flip(img, rng)
        else:
            if min(img.shape[0], img.shape[1]) < self.image_size:
                img = resize_short_side(img, self.image_size)
            if img.shape[0] != self.image_size or \
                    img.shape[1] != self.image_size:
                img = center_crop(img, self.image_size)
        return np.ascontiguousarray(img), label


# ImageNet channel statistics (uint8 scale) — the reference subtracted a
# mean image; per-channel mean/std is the modern equivalent.
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize_image(x: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
                    std: Sequence[float] = IMAGENET_STD,
                    dtype: Optional[torch.dtype] = None,
                    channel_dim: int = -1) -> torch.Tensor:
    """Device-side uint8 -> float normalize, called at the head of the loss
    so the host ships uint8 and the device does the float work.

    ``channel_dim`` names the axis of the three channels: -1 for NHWC (as
    in JAX), 1 for an NCHW view.  The op order is JAX's, ``(x - m) / s`` in
    ``dtype``.
    """
    dt = dtype or torch.float32
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    m = torch.tensor(mean, dtype=dt, device=x.device).reshape(shape)
    s = torch.tensor(std, dtype=dt, device=x.device).reshape(shape)
    return (x.to(dt) - m) / s


class TransformDataset:
    """Apply a per-sample transform at access time (``dataset[i] ->
    transform(dataset[i])``) — the collation-friendly shape for EVAL
    iterators, which must rewind every epoch and therefore cannot sit
    behind a :class:`PrefetchIterator` (no reset)."""

    def __init__(self, dataset, transform: Callable):
        self.dataset = dataset
        self.transform = transform

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self.transform(self.dataset[i])


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

class PrefetchIterator:
    """Wrap a batch iterator; decode/augment/collate ahead in threads.

    ``inner`` yields batches of samples (what :class:`SerialIterator`
    produces: a collated tuple OR a list of per-sample tuples — both are
    handled).  ``transform`` is applied per SAMPLE in a thread pool.  Up
    to ``prefetch`` finished batches wait in a bounded queue, so the
    device step and the host input work overlap.

    The iterator protocol (``next``, ``epoch``, ``is_new_epoch``,
    ``epoch_detail``, ``iteration``) matches ``SerialIterator``; epoch
    state is captured with each produced batch and restored when that
    batch is CONSUMED, so trainer triggers fire at the right step even
    with look-ahead.  Call :meth:`close` (or let the training process
    exit — the threads are daemons) to shut down.

    When ``inner`` has ``state_dict()`` (a ``SerialIterator``), its state
    is taken with each produced batch too, and :meth:`state_dict` returns
    the state after the last CONSUMED batch: a checkpoint of the wrapper
    resumes at the batch the trainer would have taken next, whatever the
    producer had drawn ahead.
    """

    # the producer thread cannot rewind, so evaluation must not use it
    rewindable = False

    def __init__(self, inner, transform: Optional[Callable] = None,
                 prefetch: int = 2, workers: int = 4):
        self.inner = inner
        self.transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers))
        self._stop = threading.Event()
        self.epoch = getattr(inner, "epoch", 0)
        self.is_new_epoch = False
        self.iteration = 0
        self._epoch_detail = float(self.epoch)
        self._has_state = hasattr(inner, "state_dict")
        self._state = inner.state_dict() if self._has_state else None
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._producer.start()

    # -- producer side ------------------------------------------------------
    def _prepare(self, batch):
        if isinstance(batch, tuple) and self.transform is None:
            return batch                      # collated already
        if isinstance(batch, tuple):          # collated arrays -> per-sample
            samples = list(zip(*batch))
        else:
            samples = list(batch)
        if self.transform is not None:
            samples = list(self._pool.map(self.transform, samples))
        first = samples[0]
        if isinstance(first, tuple):
            return tuple(np.stack([s[i] for s in samples])
                         for i in range(len(first)))
        return np.stack(samples)

    def _produce(self):
        try:
            while not self._stop.is_set():
                try:
                    batch = self.inner.next()
                except StopIteration:
                    self._q.put(("stop", None, None))
                    return
                meta = (getattr(self.inner, "epoch", 0),
                        getattr(self.inner, "is_new_epoch", False),
                        getattr(self.inner, "epoch_detail", 0.0),
                        self.inner.state_dict() if self._has_state
                        else None)
                out = self._prepare(batch)
                self._q.put(("batch", out, meta))
        except Exception as e:  # surface worker errors at the consumer
            self._q.put(("error", e, None))

    # -- consumer side ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        kind, payload, meta = self._q.get()
        if kind == "stop":
            raise StopIteration
        if kind == "error":
            self.close()
            raise payload
        (self.epoch, self.is_new_epoch, self._epoch_detail,
         self._state) = meta
        self.iteration += 1
        return payload

    next = __next__

    @property
    def epoch_detail(self):
        return self._epoch_detail

    def state_dict(self) -> dict:
        """The inner iterator's state after the last consumed batch."""
        if not self._has_state:
            raise AttributeError(
                f"{type(self.inner).__name__} has no state_dict()")
        return self._state

    def reset(self):
        raise NotImplementedError(
            "PrefetchIterator cannot rewind its producer; create a new one")

    def close(self):
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._pool.shutdown(wait=False)


__all__ = [
    "Augment",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ImageFolderDataset",
    "NpzImageDataset",
    "PrefetchIterator",
    "TransformDataset",
    "center_crop",
    "normalize_image",
    "random_crop",
    "random_flip",
    "random_sized_crop",
    "resize_short_side",
]
