"""The port's multi-node optimizers against the JAX package's.

* The fork's double buffer (``create_multi_node_optimizer(...,
  double_buffering=True)``): update t applies the world mean of step t-1's
  gradients, update 0 applies zeros.  On a 2-process gloo world, SGD(lr=1)
  on ``0.5 * |w - r|^2`` (rank r's target) takes w from 0 to 0, then to the
  mean of the targets, then to twice that, as the JAX package's
  ``test_one_step_staleness_exact`` does on its mesh; for the xla,
  hierarchical and float16-wire xla communicators, bit for bit.
* An MLP (784-16-16-10) from flax weights through ``weights.py``: 4 steps
  with Adam (lr 1e-3, the MNIST example's) and with SGD momentum (lr 0.1),
  double buffering off and on, on a
  2-process world against JAX ``make_train_step`` on a 2-device mesh with
  the same per-rank batches.  Losses and parameters agree at rtol 1e-5
  (float32; the two frameworks sum in other orders and order Adam's
  arithmetic differently), atol 1e-7 for values near zero.
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
from chainermn_tpu.optimizers import (
    create_multi_node_optimizer as jmno, init_opt_state, make_train_step as
    jstep)
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch import (
    create_communicator, create_multi_node_optimizer, make_train_step)
from chainermn_tpu_torch.runtime.bootstrap import init_distributed

WORLD, UNIT, STEPS, LOCAL_B = 2, 16, 4, 8
LR = {"adam": 1e-3, "momentum": 0.1}
RTOL, ATOL = 1e-5, 1e-7


def _jax_comm():
    return jcreate("xla", mesh=init_topology(
        devices=jax.devices()[:WORLD]).mesh)


@pytest.fixture(scope="module")
def opt_world(tmp_path_factory):
    rng = np.random.RandomState(5)
    x = rng.randn(STEPS, WORLD, LOCAL_B, 784).astype(np.float32)
    y = rng.randint(0, 10, (STEPS, WORLD, LOCAL_B)).astype(np.int32)
    variables = JMLP(UNIT, 10).init(jax.random.key(3), jnp.zeros((1, 784)))
    inputs = {f"var/{k}": v for k, v in torch_dist_worker.flatten(
        jax.tree.map(np.asarray, variables)).items()}
    inputs.update(x=x, y=y, unit=np.int64(UNIT),
                  **{f"lr_{k}": np.float32(v) for k, v in LR.items()})
    outs = torch_dist_worker.launch("opt", inputs, WORLD,
                                    tmp_path_factory.mktemp("opt"))
    return x, y, variables, outs


def _jax_staleness():
    comm = _jax_comm()
    opt = jmno(optax.sgd(1.0), comm, double_buffering=True)
    params = {"w": jnp.zeros((3,))}
    state = init_opt_state(comm, opt, params)

    def quad_loss(p, batch):
        (target,) = batch
        return 0.5 * jnp.sum((p["w"] - target.mean(axis=0)) ** 2)

    step = jstep(comm, quad_loss, opt, donate=False)
    targets = (jnp.arange(WORLD, dtype=jnp.float32)[:, None]
               * jnp.ones((WORLD, 3)),)
    ws = []
    for _ in range(3):
        params, state, _ = step(params, state, targets)
        ws.append(np.asarray(params["w"]))
    return np.stack(ws)


@pytest.mark.parametrize("label", ["xla", "hierarchical", "xla_f16"])
def test_one_step_staleness_exact(opt_world, label):
    outs = opt_world[3]
    want = _jax_staleness()
    mean = np.mean(np.arange(WORLD))  # grad_r = w - r at w = 0: mean -0.5
    np.testing.assert_array_equal(want, np.repeat(
        [[0.0], [mean], [2 * mean]], 3, axis=1))
    for out in outs:
        np.testing.assert_array_equal(out[f"stale/{label}"], want)


def _jax_mlp(opt_name, db, x, y, variables):
    comm = _jax_comm()
    model = JMLP(UNIT, 10)
    inner = (optax.adam(LR["adam"]) if opt_name == "adam"
             else optax.sgd(LR["momentum"], momentum=0.9))
    opt = jmno(inner, comm, double_buffering=db)

    def loss_fn(p, batch):
        xb, yb = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, xb), yb).mean()

    step = jstep(comm, loss_fn, opt, donate=False)
    params = comm.bcast_data(variables)
    state = init_opt_state(comm, opt, params)
    losses = []
    for xs, ys in zip(x, y):
        params, state, loss = step(params, state, (
            jnp.asarray(xs.reshape(-1, 784)), jnp.asarray(ys.reshape(-1))))
        losses.append(float(loss))
    return np.asarray(losses), jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("db", [False, True], ids=["plain", "double"])
@pytest.mark.parametrize("opt_name", ["adam", "momentum"])
def test_mlp_four_steps_match_jax(opt_world, opt_name, db):
    x, y, variables, outs = opt_world
    losses, params = _jax_mlp(opt_name, db, x, y, variables)
    assert np.all(np.isfinite(losses))
    want = torch_dist_worker.flatten(params)
    cfg = f"{opt_name}_db{int(db)}"
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{cfg}/losses"], losses, rtol=RTOL,
                                   atol=ATOL)
        got = {k[len(cfg) + 5:]: v for k, v in out.items()
               if k.startswith(f"{cfg}/var/")}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{cfg} {k} on rank {r}")


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def _adam_run(drain_at=None, steps=4):
    comm = create_communicator("xla", device="cpu")
    w = torch.nn.Parameter(torch.ones(4))
    inner = torch.optim.Adam([w], lr=0.1)
    opt = create_multi_node_optimizer(inner, comm, double_buffering=True)
    step = make_train_step(comm, lambda b: ((w * b) ** 2).sum(), opt)
    ws = []
    for t in range(steps):
        step(torch.arange(4.0) + t)
        ws.append(w.detach().clone())
        if t == drain_at:
            step.finalize()
    return ws, inner


def test_update_zero_applies_zeros_through_the_inner_step(world1):
    ws, inner = _adam_run(steps=1)
    torch.testing.assert_close(ws[0], torch.ones(4), rtol=0, atol=0)
    # the step ran: Adam counted it, as optax's update 0 does
    assert int(inner.state[inner.param_groups[0]["params"][0]]["step"]) == 1


def test_finalize_waits_without_changing_the_trajectory(world1):
    plain, _ = _adam_run()
    drained, _ = _adam_run(drain_at=1)
    for a, b in zip(plain, drained):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(plain[1], plain[2])


def test_double_buffering_and_the_other_flags(world1):
    comm = create_communicator("flat", device="cpu")
    w = torch.nn.Parameter(torch.zeros(2))
    for kw in ({"zero": True}, {"compression": "int8"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            create_multi_node_optimizer(torch.optim.SGD([w], lr=1.0), comm,
                                        **kw)
    opt = create_multi_node_optimizer(torch.optim.SGD([w], lr=1.0), comm,
                                      double_buffering=True)
    with pytest.raises(NotImplementedError, match="closure"):
        opt.step(lambda: 0.0)
