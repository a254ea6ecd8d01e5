"""The slice as a whole: data-parallel ResNet training, port vs JAX.

Three steps of a toy bottleneck ResNet (stage_sizes=(1, 1), num_filters=8,
32x32; the port's fused BatchNorm+ReLU, flax's BatchNorm) through
``create_communicator("xla")`` + ``create_multi_node_optimizer(SGD,
momentum 0.9)`` + ``make_train_step``,
against the JAX package's ``make_train_step(..., with_model_state=True,
donate=False)`` from the same flax weights and batches.  World 1 runs in
this process; world 2 is a 2-process gloo world against a 2-device JAX
mesh, each rank on its slice of the global batch and keeping its own BN
running statistics.  Losses, parameters and every rank's batch_stats must
agree at 1e-4 relative (float32; the two frameworks sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.models.resnet import ResNet as JResNet
from chainermn_tpu.optimizers import (
    create_multi_node_optimizer as jmno, init_model_state, init_opt_state,
    make_train_step as jstep)
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS, LOCAL_B, LR = 3, 4, 0.1
RTOL, ATOL = 1e-4, 1e-5


def _model():
    # flax's nn.BatchNorm: the JAX FusedBatchNormAct's custom VJP fails
    # inside make_train_step's shard_map on this JAX version (ROADMAP.md
    # Queue C); test_torch_resnet.py holds the port's fused module to
    # both flax norms
    return JResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)


def _inputs(world, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(STEPS, world, LOCAL_B, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(STEPS, world, LOCAL_B)).astype(np.int32)
    v = _model().init(jax.random.key(seed), jnp.asarray(x[0, 0]),
                      train=False)
    flat = torch_dist_worker.flatten(jax.tree.map(np.asarray, v))
    return x, y, v, {**{f"var/{k}": a for k, a in flat.items()},
                     "x": x, "y": y, "lr": np.float32(LR)}


def _jax_train(world, x, y, variables):
    mesh = init_topology(devices=jax.devices()[:world]).mesh
    comm = jcreate("xla", mesh=mesh)
    model = _model()

    def loss_fn(p, state, batch):
        xb, yb = batch
        logits, mut = model.apply({"params": p, "batch_stats": state}, xb,
                                  train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean()
        return loss, mut["batch_stats"]

    opt = jmno(optax.sgd(LR, momentum=0.9), comm)
    step = jstep(comm, loss_fn, opt, with_model_state=True, donate=False)
    params = comm.bcast_data(variables["params"])
    opt_state = init_opt_state(comm, opt, params)
    state = init_model_state(comm, variables["batch_stats"])
    losses = []
    for xs, ys in zip(x, y):
        gx = jnp.asarray(xs.reshape((-1,) + xs.shape[2:]))
        gy = jnp.asarray(ys.reshape(-1))
        params, state, opt_state, loss = step(params, state, opt_state,
                                              (gx, gy))
        losses.append(float(loss))
    return (np.asarray(losses), jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, state))


def _check(out, rank, losses, params, stats):
    np.testing.assert_allclose(out["losses"], losses, rtol=RTOL, atol=ATOL)
    got = {k[4:]: v for k, v in out.items() if k.startswith("var/")}
    want = torch_dist_worker.flatten({"params": params})
    want.update(torch_dist_worker.flatten(
        {"batch_stats": jax.tree.map(lambda a: a[rank], stats)}))
    # the port names its norms after its fused module
    want = {k.replace("/BatchNorm_", "/FusedBatchNormAct_"): v
            for k, v in want.items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{k} on rank {rank}")


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    topo = init_distributed(device="cpu")
    yield topo
    if created:
        dist.destroy_process_group()


def test_three_steps_match_jax_world1(world1):
    x, y, v, inputs = _inputs(1)
    out = torch_dist_worker.run_train(inputs, world1.rank)
    losses, params, stats = _jax_train(1, x, y, v)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    _check(out, 0, losses, params, stats)


def test_three_steps_match_jax_world2(tmp_path):
    x, y, v, inputs = _inputs(2, seed=1)
    outs = torch_dist_worker.launch("train", inputs, 2, tmp_path)
    losses, params, stats = _jax_train(2, x, y, v)
    for r, out in enumerate(outs):
        _check(out, r, losses, params, stats)
    # local BN: the two ranks saw different batches, so their running
    # statistics differ while their parameters agree
    a = outs[0]["var/batch_stats/bn_init/mean"]
    b = outs[1]["var/batch_stats/bn_init/mean"]
    assert not np.allclose(a, b)
