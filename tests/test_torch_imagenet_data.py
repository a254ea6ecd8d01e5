"""The ImageNet example's real-data path and this slice's entry points, at
toy size on the CPU.

* ``train_imagenet --data`` on a Pillow-written ImageFolder (4 classes:
  ``--n-classes`` is taken from it) with ``--val-data`` at the epoch end;
  with one loader worker the first batch the step sees is the JAX
  pipeline's (``Augment(train=True, seed)`` over the same scattered order,
  uint8 NHWC, normalized on the device); ``--loader-workers 2`` trains too.
* ``--train-root``: a uint8 npz at another size (augmented), a float32 npz
  at the size (as it is) with ``--prefetch 0``; the synthetic set trains to
  the same losses with and without the loader thread.
* ``--accum-steps 2`` on the ResNet and on ``--arch vit_s16`` (image 32),
  and one step of ``--arch vit_b16``: finite losses.

The slice's benchmarks' CPU smokes are in ``test_torch_imagenet_benches.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chainermn_tpu.datasets import image_pipeline as jip
from chainermn_tpu_torch.datasets import write_image_folder
from chainermn_tpu_torch.examples import train_imagenet
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = ("--device cpu --width 8 --image-size 32 --batchsize 4 "
         "--dtype float32 --log-interval 100 --warmup-steps 0 --lr 0.01 "
         "--seed 1").split()


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    return (write_image_folder(str(root / "train"), 16, 4, min_side=36,
                               max_side=60),
            write_image_folder(str(root / "val"), 8, 4, min_side=30,
                               max_side=44, seed=1, ext=".png"))


def _run(*flags):
    return train_imagenet.main(SMALL + [str(f) for f in flags])


def test_image_folder_trains_and_validates(world1, folders, monkeypatch):
    seen = []
    real = train_imagenet.model_input

    def spy(x, nhwc):
        seen.append(x.clone())
        return real(x, nhwc)

    monkeypatch.setattr(train_imagenet, "model_input", spy)
    res = _run("--data", folders[0], "--val-data", folders[1],
               "--loader-workers", "1", "--iterations", "4")
    assert res["model"].dense.weight.shape[0] == 4  # classes of the folder
    assert len(res["losses"]) == 4 and np.all(np.isfinite(res["losses"]))
    assert "validation/accuracy" in res["log"][0]
    # the first step's batch: the JAX pipeline over the same order
    first = seen[0]
    assert first.dtype == torch.uint8 and first.shape == (4, 32, 32, 3)
    train = jip.ImageFolderDataset(folders[0], resize=37)
    order = np.random.RandomState(1).permutation(16)   # scatter, world 1
    pick = np.random.RandomState(1).permutation(16)[:4]  # the iterator
    aug = jip.Augment(32, train=True, seed=1)
    want = np.stack([aug(train[int(order[i])])[0] for i in pick])
    np.testing.assert_array_equal(first.numpy(), want)


def test_image_folder_with_several_loader_workers(world1, folders):
    res = _run("--data", folders[0], "--loader-workers", "2",
               "--prefetch", "3", "--iterations", "3")
    assert np.all(np.isfinite(res["losses"]))


@pytest.mark.parametrize("kind", ["uint8_other_size", "float32_at_size"])
def test_train_root(world1, tmp_path, kind):
    rng = np.random.RandomState(0)
    if kind == "uint8_other_size":
        x = rng.randint(0, 256, size=(12, 40, 40, 3)).astype(np.uint8)
        flags = []
    else:
        x = rng.randn(12, 32, 32, 3).astype(np.float32)
        flags = ["--prefetch", "0"]
    path = tmp_path / "data.npz"
    np.savez(path, x_train=x, y_train=rng.randint(0, 10, size=12))
    res = _run("--train-root", path, "--n-classes", 10, "--iterations", 3,
               *flags)
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))


def test_loader_thread_keeps_the_losses(world1):
    flags = ["--train-size", 16, "--val-size", 0, "--n-classes", 10,
             "--iterations", 5]
    a = _run(*flags, "--prefetch", 0)
    b = _run(*flags, "--prefetch", 2, "--loader-workers", 3)
    assert a["losses"] == b["losses"]


# the ViTs take no --width
VIT_SMALL = [f for f in SMALL if f not in ("--width", "8")]


@pytest.mark.parametrize("arch", ["resnet50", "vit_s16"])
def test_accum_steps_train(world1, arch):
    flags = ["--arch", arch, "--accum-steps", "2", "--train-size", "8",
             "--val-size", "4", "--n-classes", "10", "--iterations", "2"]
    res = train_imagenet.main((SMALL if arch == "resnet50" else VIT_SMALL)
                              + flags)
    assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))


def test_vit_b16_builds_and_steps(world1):
    res = train_imagenet.main(VIT_SMALL + ["--arch", "vit_b16",
                                           "--train-size", "4", "--val-size",
                                           "0", "--n-classes", "10",
                                           "--iterations", "1"])
    assert np.isfinite(res["losses"][0])
    assert sum(p.numel() for p in res["model"].parameters()) > 80e6
