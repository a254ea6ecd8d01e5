"""``examples/train_imagenet.py`` with the JAX example's training flags, at a
small size on the CPU: ResNet-50's depth at width 8, 32x32 images, batch
4, float32, a 20-example training set (5 iterations an epoch), an
8-example validation set, SGD momentum with a half-epoch warmup.

* 6 iterations straight, snapshotting every 3 (epoch 1 ends at 5:
  ``AllreducePersistent``, the evaluator and the log fire);
* 3 iterations into another directory, then a run to 6 that resumes from
  the snapshot at 3: its losses are the straight run's last 3 and its
  parameters and BatchNorm buffers the straight run's, bit for bit (also
  with ``--double-buffering``, whose pending gradient mean the snapshot
  keeps, and with ``--zero --optimizer adam``);
* ``--zero`` on a 2-process gloo world (``torch_dist_worker.py`` mode
  ``imagenet``) against the plain optimizer, SGD momentum and Adam: the
  same losses and parameters bit for bit (with two ranks the
  reduce-scatter's sum is the all-reduce's one rounding, and the update is
  the same elementwise arithmetic on a flat shard);
* LARS and Adam under the schedule give finite losses; the refusals of
  the JAX example (``--fsdp`` beside ``--zero``, a bad ``--accum-steps``,
  a missing ``--data`` folder or ``--train-root`` file) raise.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu_torch.examples import train_imagenet
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = ("--device cpu --width 8 --image-size 32 --n-classes 10 "
         "--batchsize 4 --train-size 20 --val-size 8 --dtype float32 "
         "--log-interval 100 --warmup-steps 0 --warmup-epochs 0.5 "
         "--epoch 2 --seed 3").split()


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def _run(*extra):
    return train_imagenet.main(SMALL + [str(a) for a in extra])


def _state(res):
    return {k: v.detach().clone()
            for k, v in res["model"].state_dict().items()}


@pytest.mark.parametrize("flags", [(), ("--double-buffering",),
                                   ("--zero", "--optimizer", "adam")],
                         ids=["plain", "double_buffering", "zero_adam"])
def test_resume_is_bit_for_bit(world1, tmp_path, flags):
    straight = _run("--iterations", 6, "--checkpoint", tmp_path / "a",
                    "--checkpoint-freq", 3, *flags)
    assert straight["resumed_from"] is None
    assert sorted(os.listdir(tmp_path / "a")) == [
        "imagenet-resnet50.3.rank0.npz", "imagenet-resnet50.6.rank0.npz"]
    assert len(straight["save_seconds"]) == 2
    first = _run("--iterations", 3, "--checkpoint", tmp_path / "b",
                 "--checkpoint-freq", 3, *flags)
    assert first["losses"] == straight["losses"][:3]
    resumed = _run("--iterations", 6, "--checkpoint", tmp_path / "b",
                   "--checkpoint-freq", 3, *flags)
    assert resumed["resumed_from"] == 3 and resumed["iterations"] == 6
    assert resumed["losses"] == straight["losses"][3:]
    assert all(np.isfinite(straight["losses"]))
    want, got = _state(straight), _state(resumed)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the epoch end fired the evaluator in both runs
    assert straight["log"][0]["validation/accuracy"] == \
        resumed["log"][0]["validation/accuracy"]


@pytest.mark.parametrize("opt", ["lars", "adam"])
def test_other_optimizers_train(world1, opt):
    res = _run("--iterations", 3, "--optimizer", opt)
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))


@pytest.mark.parametrize("flags,err", [
    ("--zero --double-buffering", SystemExit),
    ("--zero --optimizer lars", SystemExit),
    # --fsdp, --accum-steps, --data and --train-root are ported: JAX's own
    # checks refuse --fsdp beside --zero, a K that does not divide the
    # batch and a missing folder or file
    ("--fsdp --zero", SystemExit), ("--accum-steps 3", SystemExit),
    ("--data x", FileNotFoundError), ("--train-root x.npz",
                                      FileNotFoundError),
    ("--aux-loss", SystemExit)])
def test_refusals(flags, err):
    with pytest.raises(err):
        train_imagenet.main(SMALL + flags.split())


@pytest.fixture(scope="module")
def zero_world(tmp_path_factory):
    base = " ".join(SMALL + ["--iterations", "6"])
    argv = [base, base + " --zero", base + " --optimizer adam",
            base + " --optimizer adam --zero"]
    return torch_dist_worker.launch(
        "imagenet", {f"argv{i}": np.asarray(a) for i, a in enumerate(argv)},
        2, tmp_path_factory.mktemp("imagenet"))


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_zero_on_two_ranks_equals_the_plain_optimizer(zero_world, opt):
    plain, zero = (0, 1) if opt == "momentum" else (2, 3)
    for r, out in enumerate(zero_world):
        keys = sorted(k[len(f"{plain}/model/"):] for k in out
                      if k.startswith(f"{plain}/model/"))
        assert keys
        np.testing.assert_array_equal(out[f"{zero}/losses"],
                                      out[f"{plain}/losses"])
        for k in keys:
            np.testing.assert_array_equal(out[f"{zero}/model/{k}"],
                                          out[f"{plain}/model/{k}"],
                                          f"{k} rank {r}")
    # the parameters are the same on both ranks (the running statistics
    # are rank-local again after the epoch end's average)
    for k in zero_world[0]:
        if k.startswith(f"{zero}/model/") and "running" not in k:
            np.testing.assert_array_equal(zero_world[0][k],
                                          zero_world[1][k], k)
