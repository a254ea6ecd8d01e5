"""``examples/train_imagenet.py`` with the reference's other architectures,
at a small size on the CPU (64x64 images, 10 classes, batch 4, float32).

* The synthetic set is the JAX example's ``make_synthetic_imagenet`` from
  the same seed, transposed to NCHW (the same labels, the same pixels).
* ``alex``, ``nin``, ``googlenet`` and ``googlenetbn`` (the GoogLeNets
  with ``--aux-loss``) train through an epoch end and the evaluator with
  finite losses; a run with dropout resumed from a snapshot equals the
  uninterrupted run bit for bit (the masks are reseeded from the
  iteration).
* The JAX example's refusals raise: ``--aux-loss`` with another arch,
  the ResNet-only ``--width`` (also beside a ViT), ``--prefetch 0`` with
  an augmented folder, an ``--accum-steps`` that does not divide the
  batch, and a ``--val-data`` folder that is not there; ``--intra-size``
  is taken.
* ``--profile-steps``' categories file the optimizers' foreach kernels
  (``multi_tensor_apply_kernel``, SGD's and Adam's update) under "other",
  not with the Triton BatchNorm passes whose name they contain.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chainermn_tpu_torch.examples import train_imagenet
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from chainermn_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ("--device cpu --image-size 64 --n-classes 10 --batchsize 4 "
         "--train-size 8 --val-size 4 --dtype float32 --log-interval 100 "
         "--warmup-steps 0 --lr 0.01 --seed 5").split()


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_imagenet",
        os.path.join(REPO, "examples", "imagenet", "train_imagenet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,image,classes,seed", [(6, 16, 1000, 0),
                                                  (5, 9, 10, 3)])
def test_synthetic_set_is_the_jax_examples(n, image, classes, seed):
    want = _jax_example().make_synthetic_imagenet(n, image, classes, seed)
    got = train_imagenet.make_synthetic_imagenet(n, image, classes, seed)
    wx, wy = want[np.arange(n)]
    gx, gy = got[np.arange(n)]
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(gx, wx.transpose(0, 3, 1, 2))
    assert gx.dtype == np.float32 and gx.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("arch", ["alex", "nin", "googlenet", "googlenetbn"])
def test_arch_trains_through_an_epoch_end(world1, arch):
    extra = ["--aux-loss"] if arch.startswith("google") else []
    res = train_imagenet.main(SMALL + ["--arch", arch, "--iterations", "3"]
                              + extra)
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert np.isfinite(res["log"][0]["validation/loss"])
    has_bn = arch == "googlenetbn"
    assert any("running_mean" in k for k in res["model"].state_dict()) \
        == has_bn
    if arch.startswith("google"):
        assert set(res["model"].aux) == {"aux4a", "aux4d"}


def test_dropout_run_resumes_bit_for_bit(world1, tmp_path):
    flags = SMALL + ["--arch", "alex", "--checkpoint-freq", "2"]
    straight = train_imagenet.main(flags + ["--iterations", "4",
                                            "--checkpoint",
                                            str(tmp_path / "a")])
    train_imagenet.main(flags + ["--iterations", "2", "--checkpoint",
                                 str(tmp_path / "b")])
    resumed = train_imagenet.main(flags + ["--iterations", "4",
                                           "--checkpoint",
                                           str(tmp_path / "b")])
    assert resumed["resumed_from"] == 2
    assert resumed["losses"] == straight["losses"][2:]
    for k, v in straight["model"].state_dict().items():
        assert torch.equal(resumed["model"].state_dict()[k], v), k
    # a fresh run from the same seed draws the same masks
    again = train_imagenet.main(flags + ["--iterations", "4"])
    assert again["losses"] == straight["losses"]


@pytest.mark.parametrize("flags,err,match", [
    ("--arch alex --aux-loss", SystemExit, None),
    ("--arch nin --width 8", SystemExit, None),
    # the ViTs and the image pipeline are ported: what stays refused is
    # what the JAX example refuses (or cannot open)
    ("--arch vit_s16 --width 8", SystemExit, None),
    ("--arch vit_b16 --aux-loss", SystemExit, None),
    ("--val-data x", FileNotFoundError, "'x'"),
    ("--prefetch 0 --data {images}", SystemExit,
     "requires collatable data"),
    ("--loader-workers 2 --accum-steps 0", SystemExit, None)])
def test_refusals(world1, tmp_path, flags, err, match):
    from chainermn_tpu_torch.datasets import write_image_folder
    images = write_image_folder(str(tmp_path / "images"), 4, 2, min_side=8,
                                max_side=12)
    with pytest.raises(err, match=match):
        train_imagenet.main(SMALL + flags.format(images=images).split())


def test_intra_size_is_taken(world1):
    res = train_imagenet.main(SMALL + ["--arch", "nin", "--iterations", "1",
                                       "--intra-size", "1",
                                       "--communicator", "hierarchical"])
    assert len(res["losses"]) == 1


@pytest.mark.parametrize("name,cat", [
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at"
     "::native::(anonymous namespace)::TensorListMetadata<3>", None),
    ("apply_kernel", "fused_norm (Triton)"),
    ("bwd_dx_kernel", "fused_norm (Triton)")])
def test_profile_categories_keep_the_optimizer_out_of_the_norm(name, cat):
    assert trace.kernel_category(name) == (cat or trace.OTHER_CATEGORY)
