"""Gradient accumulation, port vs JAX: ``make_train_step(accum_steps=K)``.

Two steps of SGD momentum 0.9 through ``create_communicator("xla")`` and
the multi-node optimizer, each step's local batch of 4 split into K = 2
microbatches, against the JAX package's ``make_train_step(...,
accum_steps=2, donate=False)`` on a CPU mesh from the same flax weights and
batches: a BN-free MLP (48-16-16-10) and a BN model (the toy ResNet of
``test_torch_train_step.py``; flax's ``nn.BatchNorm``, ghost-batch
statistics updated after each microbatch in turn).  World 1 runs in this
process; world 2 is a 2-process gloo world against a 2-device JAX mesh,
through the plain, double-buffered and ZeRO-1 optimizers.  Losses,
parameters and every rank's running statistics agree at 1e-4 relative
(float32; the frameworks sum in other orders), and each optimizer issues
exactly one gradient reduction a step.  The BN-free step also equals K = 1
on the whole batch within float32 drift, and a K that does not divide the
batch raises ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.models import MLP as JMLP
from chainermn_tpu.models.resnet import ResNet as JResNet
from chainermn_tpu.optimizers import (
    create_multi_node_optimizer as jmno, init_model_state, init_opt_state,
    make_train_step as jstep)
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch import (
    create_communicator, create_multi_node_optimizer, make_train_step)
from chainermn_tpu_torch.models import MLP
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS, LOCAL_B, K, LR = 2, 4, 2, 0.1
RTOL, ATOL = 1e-4, 1e-5
WORLD2 = ("mlp-plain-2", "mlp-double-2", "mlp-zero-2", "resnet-plain-2")


def _jmodel(name):
    if name == "mlp":
        return JMLP(n_units=16, n_out=10)
    return JResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)


def _inputs(world, names=("mlp", "resnet"), seed=0):
    rng = np.random.RandomState(seed)
    out, data = {"lr": np.float32(LR)}, {}
    for name in names:
        shape = (48,) if name == "mlp" else (32, 32, 3)
        x = rng.randn(STEPS, world, LOCAL_B, *shape).astype(np.float32)
        y = rng.randint(0, 10, size=(STEPS, world, LOCAL_B)).astype(np.int32)
        v = _jmodel(name).init(jax.random.key(seed), jnp.asarray(x[0, 0]),
                               **({} if name == "mlp" else {"train": False}))
        v = jax.tree.map(np.asarray, v)
        data[name] = (x, y, v)
        out.update({f"{name}/var/{k}": a for k, a in
                    torch_dist_worker.flatten(v).items()})
        out[f"{name}/x"], out[f"{name}/y"] = x, y
    return out, data


def _jax_train(world, config, x, y, variables):
    name, flavor, k = config.split("-")
    mesh = init_topology(devices=jax.devices()[:world]).mesh
    comm = jcreate("xla", mesh=mesh)
    model = _jmodel(name)
    bn = "batch_stats" in variables
    ce = optax.softmax_cross_entropy_with_integer_labels

    if bn:
        def loss_fn(p, state, batch):
            logits, mut = model.apply({"params": p, "batch_stats": state},
                                      batch[0], train=True,
                                      mutable=["batch_stats"])
            return ce(logits, batch[1]).mean(), mut["batch_stats"]
    else:
        def loss_fn(p, batch):
            return ce(model.apply({"params": p}, batch[0]), batch[1]).mean()

    opt = jmno(optax.sgd(LR, momentum=0.9), comm,
               double_buffering=flavor == "double", zero=flavor == "zero")
    step = jstep(comm, loss_fn, opt, with_model_state=bn, donate=False,
                 accum_steps=int(k))
    params = comm.bcast_data(variables["params"])
    opt_state = init_opt_state(comm, opt, params)
    state = init_model_state(comm, variables["batch_stats"]) if bn else None
    losses = []
    for xs, ys in zip(x, y):
        batch = (jnp.asarray(xs.reshape((-1,) + xs.shape[2:])),
                 jnp.asarray(ys.reshape(-1)))
        if bn:
            params, state, opt_state, loss = step(params, state, opt_state,
                                                  batch)
        else:
            params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return (np.asarray(losses), jax.tree.map(np.asarray, params),
            None if state is None else jax.tree.map(np.asarray, state))


def _check(out, config, rank, data, world):
    name = config.split("-")[0]
    x, y, v = data[name]
    losses, params, stats = _jax_train(world, config, x, y, v)
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(out[f"{config}/losses"], losses, rtol=RTOL,
                               atol=ATOL)
    assert int(out[f"{config}/reductions"]) == STEPS, config
    pre = f"{config}/var/"
    got = {k[len(pre):]: a for k, a in out.items() if k.startswith(pre)}
    want = torch_dist_worker.flatten({"params": params})
    if stats is not None:
        want.update(torch_dist_worker.flatten(
            {"batch_stats": jax.tree.map(lambda a: a[rank], stats)}))
        # the port names its norms after its fused module
        want = {k.replace("/BatchNorm_", "/FusedBatchNormAct_"): a
                for k, a in want.items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{config} {k} on rank {rank}")


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    topo = init_distributed(device="cpu")
    yield topo
    if created:
        dist.destroy_process_group()


@pytest.mark.parametrize("config", ["mlp-plain-2", "resnet-plain-2"])
def test_accum_matches_jax_world1(world1, config):
    inputs, data = _inputs(1, names=(config.split("-")[0],))
    out = torch_dist_worker.run_accum(dict(inputs, configs=config),
                                      world1.rank)
    _check(out, config, 0, data, 1)


@pytest.fixture(scope="module")
def world2_run(tmp_path_factory):
    inputs, data = _inputs(2, seed=1)
    outs = torch_dist_worker.launch(
        "accum", dict(inputs, configs=",".join(WORLD2)), 2,
        tmp_path_factory.mktemp("accum"))
    return outs, data


@pytest.mark.parametrize("config", WORLD2)
def test_accum_matches_jax_world2(world2_run, config):
    outs, data = world2_run
    for r, out in enumerate(outs):
        _check(out, config, r, data, 2)
    if config.startswith("resnet"):
        # local BN: the ranks saw other batches, so their statistics differ
        key = f"{config}/var/batch_stats/bn_init/mean"
        assert not np.allclose(outs[0][key], outs[1][key])


def _mlp_step(k, batch, seed=0):
    comm = create_communicator("xla", device="cpu")
    model = MLP(16, 10, n_in=48, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9), comm)
    step = make_train_step(
        comm, lambda b: torch.nn.functional.cross_entropy(model(b[0]), b[1]),
        opt, accum_steps=k)
    return float(step(batch)), {n: p.grad.clone()
                                for n, p in model.named_parameters()}


def test_bn_free_accum_equals_full_batch(world1):
    rng = np.random.RandomState(2)
    batch = (torch.from_numpy(rng.randn(8, 48).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 10, size=8)))
    loss1, g1 = _mlp_step(1, batch)
    for k in (2, 4, 8):
        loss_k, gk = _mlp_step(k, batch)
        assert loss_k == pytest.approx(loss1, rel=1e-6, abs=1e-7)
        for n, g in g1.items():
            np.testing.assert_allclose(gk[n].numpy(), g.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"K {k} {n}")


def test_accum_steps_must_divide_the_batch(world1):
    batch = (torch.zeros(6, 48), torch.zeros(6, dtype=torch.long))
    with pytest.raises(ValueError, match=r"accum_steps \(4\) must divide "
                       r"the per-device batch \(6\)"):
        _mlp_step(4, batch)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        _mlp_step(0, batch)
