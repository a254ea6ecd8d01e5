"""``examples/train_cifar.py``: VGG-16 on CIFAR-10 with double buffering.

* The synthetic set is the JAX example's ``make_synthetic_cifar`` from the
  same seed, transposed to NCHW.
* The example runs at a toy size (batch 2-4, float32) on a world of one
  through an epoch end (``AllreducePersistent``), and on a 2-process gloo
  world (``torch_dist_worker.py`` mode ``imagenet`` with ``example``
  ``train_cifar``) with ``--double-buffering``: after one iteration every
  parameter is still the initial one bit for bit (update 0 applies zeros,
  as JAX's double buffering does), and after three both ranks hold the
  same parameters.
* The example's step (``create_communicator("xla")`` ->
  ``create_multi_node_optimizer(SGD momentum 0.9)`` ->
  ``make_train_step``) on the tiny VGG with dropout 0, float32, from flax
  weights: two steps, plain and double-buffered, against the JAX
  package's ``make_train_step(..., with_model_state=True)`` on a
  one-device mesh: losses, parameters and running statistics within 1e-4
  (relative) / 1e-5 (absolute).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.models.vgg import VGG as JVGG
from chainermn_tpu.optimizers import (
    create_multi_node_optimizer as jmno, init_model_state, init_opt_state,
    make_train_step as jstep)
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch import (
    create_communicator, create_multi_node_optimizer, make_train_step,
    weights)
from chainermn_tpu_torch.examples import train_cifar
from chainermn_tpu_torch.models import VGG, VGG16
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_flax_parity import flat, nchw, perturbed_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ("--device cpu --batchsize 4 --train-size 16 --dtype float32 "
       "--log-interval 100 --warmup-steps 0 --seed 2").split()
TINY = dict(cfg=(8, "M", 16, "M"), hidden=16, num_classes=10)
LR = 0.05


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def test_synthetic_set_is_the_jax_examples():
    spec = importlib.util.spec_from_file_location(
        "jax_train_cifar", os.path.join(REPO, "examples", "cifar",
                                        "train_cifar.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = mod.make_synthetic_cifar(7, 4)
    got = train_cifar.make_synthetic_cifar(7, 4)
    wx, wy = want[np.arange(7)]
    gx, gy = got[np.arange(7)]
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(gx, wx.transpose(0, 3, 1, 2))


def test_example_trains_through_an_epoch_end(world1):
    res = train_cifar.main(TOY + ["--epoch", "1", "--double-buffering"])
    assert res["iterations"] == 4 and res["world"] == 1
    assert len(res["losses"]) == 4 and all(np.isfinite(res["losses"]))
    assert len(res["log"]) == 1
    assert isinstance(res["model"], VGG) and len(res["model"].norms) == 13


def test_data_npz_is_read_as_nhwc(world1, tmp_path):
    x = np.random.RandomState(0).randn(8, 32, 32, 3).astype(np.float32)
    y = np.arange(8) % 10
    np.savez(tmp_path / "c.npz", x_train=x, y_train=y)
    ds = train_cifar.load_data(train_cifar.parse_args(
        ["--data", str(tmp_path / "c.npz")]))
    gx, gy = ds[np.arange(8)]
    np.testing.assert_array_equal(gx, x.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(gy, y)
    res = train_cifar.main(TOY + ["--iterations", "2", "--data",
                                  str(tmp_path / "c.npz")])
    assert all(np.isfinite(res["losses"]))


def test_double_buffering_on_two_ranks(tmp_path):
    base = " ".join(TOY[:2] + ["--batchsize", "2", "--train-size", "8",
                               "--dtype", "float32", "--seed", "2",
                               "--warmup-steps", "0", "--double-buffering"])
    outs = torch_dist_worker.launch(
        "imagenet", {"example": np.asarray("train_cifar"),
                     "argv0": np.asarray(base + " --iterations 1"),
                     "argv1": np.asarray(base + " --iterations 3")},
        2, tmp_path)
    init = VGG16(device="cpu", generator=torch.Generator().manual_seed(2))
    names = [n for n, _ in init.named_parameters()]
    for r, out in enumerate(outs):
        for n, p in init.named_parameters():
            np.testing.assert_array_equal(out[f"0/model/{n}"],
                                          p.detach().numpy(), n)
        assert np.all(np.isfinite(out["1/losses"]))
    moved = 0
    for n in names:
        np.testing.assert_array_equal(outs[0][f"1/model/{n}"],
                                      outs[1][f"1/model/{n}"], n)
        moved += not np.array_equal(outs[0][f"1/model/{n}"],
                                    outs[0][f"0/model/{n}"])
    assert moved == len(names)


def _jax_steps(double_buffering, x, y, variables):
    comm = jcreate("xla", mesh=init_topology(devices=jax.devices()[:1]).mesh)
    model = JVGG(dropout_rate=0.0, **TINY)

    def loss_fn(p, state, batch):
        xb, yb = batch
        logits, mut = model.apply({"params": p, "batch_stats": state}, xb,
                                  train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean()
        acc = (logits.argmax(-1) == yb).astype(jnp.float32).mean()
        return loss, (mut["batch_stats"], {"accuracy": acc})

    opt = jmno(optax.sgd(LR, momentum=0.9), comm,
               double_buffering=double_buffering)
    step = jstep(comm, loss_fn, opt, has_aux=True, with_model_state=True,
                 donate=False)
    params = comm.bcast_data(variables["params"])
    opt_state = init_opt_state(comm, opt, params)
    state = init_model_state(comm, variables["batch_stats"])
    losses = []
    for xs, ys in zip(x, y):
        params, state, opt_state, loss, _ = step(
            params, state, opt_state, (jnp.asarray(xs), jnp.asarray(ys)))
        losses.append(float(loss))
    return losses, params, jax.tree.map(lambda a: a[0], state)


@pytest.mark.parametrize("double_buffering", [False, True])
def test_step_matches_jax(world1, double_buffering):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 4, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(2, 4))
    v = perturbed_variables(JVGG(dropout_rate=0.0, **TINY), x[0],
                            train=False)
    jlosses, jparams, jstats = _jax_steps(double_buffering, x, y, v)

    comm = create_communicator("xla", device="cpu")
    model = weights.load_flax_variables(
        VGG(image_size=8, dropout_rate=0.0, device="cpu", **TINY), v)
    model.train()
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9), comm,
        double_buffering=double_buffering)

    def loss_fn(batch):
        logits = model(batch[0])
        return F.cross_entropy(logits, batch[1]), {
            "accuracy": (logits.argmax(-1) == batch[1]).float().mean()}

    step = make_train_step(comm, loss_fn, opt, has_aux=True)
    losses = [float(step((nchw(xs), torch.from_numpy(ys)))[0])
              for xs, ys in zip(x, y)]
    step.finalize()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
    back = weights.state_dict_to_flax(model, norm="BatchNorm")
    for tree, want in (("params", jparams), ("batch_stats", jstats)):
        got, want = flat(back[tree]), flat(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{tree}{k}")
