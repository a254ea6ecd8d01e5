"""``examples/train_parallel_conv.py``: channel-sharded convolutions.

The JAX example's ``ChannelShardedCNN`` runs under ``run_spmd`` on a
2-device CPU mesh (each device initialised from its own seed, its own
optax Adam); the port's runs on a 2-process gloo world
(``torch_dist_worker.py`` mode ``pconv``), each rank starting from its
device's flax weights.  After 4 Adam steps (lr 1e-3: at 1e-2 Adam's
parity with optax is looser, ROADMAP.md Queue C7) on the example's batch,
every rank's losses and parameters agree with its device's within 1e-4
(relative) / 1e-5 (absolute).  The example itself trains at its JAX
defaults on a world of one and of two, its loss falling.
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

import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu.training import put_global_batch
from chainermn_tpu_torch.examples import train_parallel_conv as pc
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, LR, BATCH, SEED = 4, 1e-3, 8, 3


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_parallel_conv",
        os.path.join(REPO, "examples", "parallel_convolution",
                     "train_parallel_conv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(world):
    """The JAX example's init and training loop at ``STEPS``/``LR``:
    the initial variables, the per-device losses of each step and the
    final variables, each stacked [world, ...]."""
    mod = _jax_example()
    comm = jcreate("xla",
                   mesh=init_topology(devices=jax.devices()[:world]).mesh)
    model = mod.ChannelShardedCNN()
    x, y = pc.make_batch(BATCH, SEED)
    xb = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    yb = jnp.asarray(y.numpy().astype(np.int32))
    seeds = np.arange(world, dtype=np.uint32).reshape(world, 1)
    params = comm.run_spmd(
        lambda s: model.init(jax.random.key(s[0]), jnp.zeros((1, 16, 16, 3)),
                             comm), put_global_batch(comm, seeds))
    init = jax.tree.map(np.asarray, params)
    opt = optax.adam(LR)

    def body(p, s):
        def loss_fn(pp):
            return optax.softmax_cross_entropy_with_integer_labels(
                model.apply(pp, xb, comm), yb).mean()
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    opt_state = comm.run_spmd(lambda p: opt.init(p), params)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = comm.run_spmd(body, params, opt_state)
        losses.append(np.asarray(loss).reshape(world))
    return init, np.stack(losses, 1), jax.tree.map(np.asarray, params)


def test_two_ranks_match_jax_run_spmd(tmp_path):
    init, jlosses, jfinal = _jax_run(2)
    inputs = {f"var/{k}": v for k, v in torch_dist_worker.flatten(
        init["params"]).items()}
    inputs.update(steps=np.int64(STEPS), lr=np.float64(LR),
                  batchsize=np.int64(BATCH), seed=np.int64(SEED))
    outs = torch_dist_worker.launch("pconv", inputs, 2, tmp_path)
    want = torch_dist_worker.flatten(jfinal["params"])
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["losses"], jlosses[r], rtol=1e-4,
                                   atol=1e-5, err_msg=f"rank {r}")
        for k, v in want.items():
            np.testing.assert_allclose(out[f"var/{k}"], v[r], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{k} rank {r}")
    # the ranks own different filters and see the same batch
    assert not np.allclose(outs[0]["losses"], outs[1]["losses"])


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def test_example_trains_on_one_rank(world1):
    res = pc.main(["--device", "cpu", "--steps", "20"])
    assert res["world"] == 1 and res["losses"][-1] < res["losses"][0]


def test_example_trains_on_two_ranks(tmp_path):
    """The example at its JAX defaults (60 steps of 32) on two ranks: the
    world's mean loss falls, the same on both."""
    outs = torch_dist_worker.launch(
        "imagenet", {"example": np.asarray("train_parallel_conv"),
                     "argv0": np.asarray("--device cpu")}, 2, tmp_path)
    assert len(outs[0]["0/losses"]) == 60
    np.testing.assert_array_equal(outs[0]["0/losses"], outs[1]["0/losses"])
    assert outs[0]["0/losses"][-1] < outs[0]["0/losses"][0]


def test_batch_is_the_jax_examples():
    rng = np.random.RandomState(0)
    y = (rng.rand(32) * 10).astype(np.int32)
    x = rng.randn(32, 16, 16, 3).astype(np.float32)
    x += y.reshape(-1, 1, 1, 1) * 0.3
    gx, gy = pc.make_batch(32, 0)
    np.testing.assert_array_equal(gx.numpy(), x.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(gy.numpy(), y)
    assert isinstance(gx, torch.Tensor) and gy.dtype == torch.int64
