"""MNIST ``--data``: ``examples.train_mnist.load_data`` against the JAX
example's, on an npz the test writes (``x_train``, ``y_train``, ``x_test``,
``y_test``, as a downloaded MNIST npz holds them: uint8 images, uint8
labels).

The loaded arrays are the JAX example's bit for bit (float32 images, int32
labels), the first epoch's training batches after ``scatter_dataset`` and
``SerialIterator`` are the JAX example's on a world of one, and the
example trains one epoch on the file.
"""

import importlib.util
import os
import types

import jax
import numpy as np
import pytest
import torch.distributed as dist

import chainermn_tpu
from chainermn_tpu.iterators import SerialIterator as JIter
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch import create_communicator, scatter_dataset
from chainermn_tpu_torch.examples import train_mnist
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.runtime.bootstrap import init_distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_mnist", os.path.join(REPO, "examples", "mnist",
                                        "train_mnist.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def npz(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=rng.randint(0, 256, (120, 28, 28), np.uint8),
             y_train=rng.randint(0, 10, 120).astype(np.uint8),
             x_test=rng.randint(0, 256, (30, 28, 28), np.uint8),
             y_test=rng.randint(0, 10, 30).astype(np.uint8))
    return str(path)


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def test_load_data_equals_jax(npz):
    args = types.SimpleNamespace(data=npz)
    got = train_mnist.load_data(args)
    want = _jax_example().load_data(args)
    for t, j in zip(got, want):
        assert len(t) == len(j)
        for a, b in zip(t._arrays, j._arrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_first_epoch_batches_equal_jax(npz, world1):
    args = types.SimpleNamespace(data=npz)
    jcomm = chainermn_tpu.create_communicator(
        "naive", mesh=init_topology(devices=jax.devices()[:1]).mesh)
    jtrain = chainermn_tpu.scatter_dataset(
        _jax_example().load_data(args)[0], jcomm, shuffle=True, seed=0)
    ttrain = scatter_dataset(train_mnist.load_data(args)[0],
                             create_communicator("naive", device="cpu"),
                             shuffle=True, seed=0)
    jit, tit = JIter(jtrain, 25, seed=0), SerialIterator(ttrain, 25, seed=0)
    while True:
        (jx, jy), (tx, ty) = jit.next(), tit.next()
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tit.is_new_epoch == jit.is_new_epoch
        if tit.is_new_epoch:
            break


def test_example_trains_on_the_file(npz, world1, tmp_path):
    res = train_mnist.main(["--data", npz, "--epoch", "1", "--unit", "16",
                            "--batchsize", "20", "--device", "cpu",
                            "--prefetch", "0", "--out", str(tmp_path)])
    (rec,) = res["log"]
    assert rec["iteration"] == 6
    assert all(np.isfinite(rec[k]) for k in ("main/loss", "validation/loss"))
