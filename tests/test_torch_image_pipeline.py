"""The image data path, port vs JAX (``datasets/image_pipeline.py``).

* Every numpy/PIL transform gives the same bytes as JAX's on the same
  ``RandomState`` draws (exact): ``random_crop`` (with and without the
  CIFAR padding), ``center_crop``, ``resize_short_side``, ``random_flip``
  and ``random_sized_crop`` (a crop that is resized, one at the size, and
  the center-crop fallback).
* ``Augment``'s train and eval streams equal JAX's per seed, sample by
  sample in call order (one worker: with several, the per-sample seeds
  follow the threads' order, in JAX too).
* ``ImageFolderDataset`` on a Pillow-written tree (JPEG, PNG, an upper-case
  extension, a file that is not an image, a folder that is empty) gives
  JAX's classes, samples, uint8 arrays and int32 labels, decoded as they
  are and at a short side; a root without class folders or without images
  raises ``ValueError``.
* ``NpzImageDataset``: both key pairs, a dict, ``KeyError`` and the length
  mismatch; ``TransformDataset``; ``normalize_image`` within one float32
  ulp of JAX's, NHWC and as an NCHW view.
* ``PrefetchIterator``'s ``state_dict`` is the inner iterator's state
  after the last CONSUMED batch, whatever the producer drew ahead.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chainermn_tpu.datasets import image_pipeline as jip
from chainermn_tpu_torch.datasets import image_pipeline as tip
from chainermn_tpu_torch.iterators import SerialIterator


def _img(seed, h, w):
    return np.random.RandomState(seed).randint(
        0, 256, size=(h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("seed,h,w,size,pad", [
    (0, 40, 50, 32, 0), (1, 32, 32, 32, 4), (2, 33, 70, 17, 0)])
def test_random_crop_exact(seed, h, w, size, pad):
    img = _img(seed, h, w)
    got = tip.random_crop(img, size, np.random.RandomState(seed), pad=pad)
    want = jip.random_crop(img, size, np.random.RandomState(seed), pad=pad)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="smaller than crop"):
        tip.random_crop(img, max(h, w) + 2 * pad + 1,
                        np.random.RandomState(0), pad=pad)


@pytest.mark.parametrize("h,w,size", [(40, 50, 32), (31, 31, 32),
                                      (100, 64, 64)])
def test_center_crop_and_resize_exact(h, w, size):
    img = _img(h * w, h, w)
    np.testing.assert_array_equal(tip.center_crop(img, size),
                                  jip.center_crop(img, size))
    np.testing.assert_array_equal(tip.resize_short_side(img, size),
                                  jip.resize_short_side(img, size))
    same = _img(1, size, size + 7)
    assert tip.resize_short_side(same, size) is same
    with pytest.raises(ValueError, match="non-uint8"):
        tip.resize_short_side(img.astype(np.float32), size + 1)


@pytest.mark.parametrize("seed", range(6))
def test_random_flip_exact(seed):
    img = _img(seed, 9, 11)
    np.testing.assert_array_equal(
        tip.random_flip(img, np.random.RandomState(seed)),
        jip.random_flip(img, np.random.RandomState(seed)))


@pytest.mark.parametrize("seed,h,w,size,scale", [
    (0, 300, 400, 64, (0.3, 1.0)),     # a random crop, resized
    (1, 64, 64, 64, (1.0, 1.0)),       # the whole image at the size
    (2, 200, 20, 32, (0.9, 1.0)),      # no draw fits: the center fallback
    (3, 120, 90, 48, (0.08, 1.0))])
def test_random_sized_crop_exact(seed, h, w, size, scale):
    img = _img(seed, h, w)
    got = tip.random_sized_crop(img, size, np.random.RandomState(seed),
                                scale=scale)
    want = jip.random_sized_crop(img, size, np.random.RandomState(seed),
                                 scale=scale)
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(train=True), dict(train=False),
                                dict(train=True, pad=4),
                                dict(train=True, flip=False)],
                         ids=["train", "eval", "train_pad", "train_noflip"])
def test_augment_streams_exact(kw):
    sizes = [(48, 40), (32, 32), (20, 28), (64, 33), (32, 32), (70, 50)]
    samples = [(_img(i, h, w), np.int32(i)) for i, (h, w) in
               enumerate(sizes)]
    got_aug = tip.Augment(32, seed=7, **kw)
    want_aug = jip.Augment(32, seed=7, **kw)
    for s in samples:
        if kw.get("pad") and s[0].shape[:2] != (32, 32):
            continue  # the CIFAR recipe takes images at the size
        (gx, gy), (wx, wy) = got_aug(s), want_aug(s)
        assert gx.shape == (32, 32, 3) and gx.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy


def _write_tree(root):
    rng = np.random.RandomState(0)
    files = {"cat": ["a.jpg", "b.PNG", "c.JPEG", "notes.txt"],
             "dog": ["x.png", "y.jpg"], "empty": []}
    for cls, names in files.items():
        os.makedirs(os.path.join(root, cls))
        for n in names:
            path = os.path.join(root, cls, n)
            if n.endswith(".txt"):
                with open(path, "w") as f:
                    f.write("not an image")
                continue
            h, w = rng.randint(20, 60, size=2)
            arr = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
            Image.fromarray(arr).save(
                path, format="PNG" if n.lower().endswith("png") else "JPEG")
    with open(os.path.join(root, "README"), "w") as f:
        f.write("a file at the root is not a class")


@pytest.mark.parametrize("resize", [None, 24, 37])
def test_image_folder_equals_jax(tmp_path, resize):
    root = str(tmp_path / "tree")
    _write_tree(root)
    got = tip.ImageFolderDataset(root, resize=resize)
    want = jip.ImageFolderDataset(root, resize=resize)
    assert got.classes == want.classes == ["cat", "dog", "empty"]
    assert got.samples == want.samples and len(got) == 5
    for i in range(len(got)):
        (gx, gy), (wx, wy) = got[i], want[i]
        assert gx.dtype == np.uint8 and gy.dtype == np.int32
        if resize:
            assert min(gx.shape[:2]) == resize
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy


def test_image_folder_refusals(tmp_path):
    with pytest.raises(ValueError, match="no class subdirectories"):
        tip.ImageFolderDataset(str(tmp_path))
    os.makedirs(tmp_path / "cls")
    (tmp_path / "cls" / "x.txt").write_text("nope")
    with pytest.raises(ValueError, match="no images found"):
        tip.ImageFolderDataset(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tip.ImageFolderDataset(str(tmp_path / "missing"))


def test_npz_dataset(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, size=(6, 8, 8, 3)).astype(np.uint8)
    y = np.arange(6, dtype=np.int64)
    for keys in (("x", "y"), ("x_train", "y_train")):
        path = str(tmp_path / f"{keys[0]}.npz")
        np.savez(path, **{keys[0]: x, keys[1]: y})
        got, want = tip.NpzImageDataset(path), jip.NpzImageDataset(path)
        assert len(got) == len(want) == 6 and got.y.dtype == np.int32
        for i in range(6):
            np.testing.assert_array_equal(got[i][0], want[i][0])
            assert got[i][1] == want[i][1]
    d = tip.NpzImageDataset({"x": x.astype(np.float32), "y": y})
    assert d.x.dtype == np.float32 and d[5][1] == 5
    with pytest.raises(KeyError, match="need 'x'/'labels'"):
        tip.NpzImageDataset({"x": x, "y": y}, y_key="labels")
    with pytest.raises(ValueError, match="length mismatch"):
        tip.NpzImageDataset({"x": x, "y": y[:5]})


def test_transform_dataset():
    base = [(np.full((2, 2, 3), i, np.uint8), np.int32(i)) for i in range(3)]
    ds = tip.TransformDataset(base, lambda s: (s[0] * 2, s[1] + 10))
    assert len(ds) == 3
    x, y = ds[2]
    assert int(x[0, 0, 0]) == 4 and y == 12


def test_normalize_image_within_one_ulp():
    x = np.random.RandomState(0).randint(0, 256, size=(3, 5, 7, 3)) \
        .astype(np.uint8)
    want = np.asarray(jip.normalize_image(jnp.asarray(x)))
    got = tip.normalize_image(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    nchw = tip.normalize_image(torch.from_numpy(x).permute(0, 3, 1, 2),
                               channel_dim=1)
    np.testing.assert_array_max_ulp(nchw.permute(0, 2, 3, 1).numpy(), want,
                                    maxulp=1)
    assert nchw.is_contiguous(memory_format=torch.channels_last)


def test_prefetch_state_is_the_consumed_position():
    data = [(np.full((2,), i, np.float32), np.int32(i)) for i in range(10)]
    serial = SerialIterator(data, 3, shuffle=True, seed=1)
    ref = SerialIterator(data, 3, shuffle=True, seed=1)
    pre = tip.PrefetchIterator(serial, prefetch=4, workers=2)
    try:
        for _ in range(5):
            got = next(pre)
            want = ref.next()
            np.testing.assert_array_equal(got[1], want[1])
            state, ref_state = pre.state_dict(), ref.state_dict()
            assert state.keys() == ref_state.keys()
            for k in ref_state:
                np.testing.assert_array_equal(state[k], ref_state[k], k)
            assert pre.epoch == ref.epoch
    finally:
        pre.close()
