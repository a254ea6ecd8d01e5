"""ZeRO-1 (``create_multi_node_optimizer(..., zero=True)``) against the
unsharded multi-node optimizer and the JAX package's ``_Zero1Optimizer``.

Gloo worlds of 2 and 4 processes (``torch_dist_worker.py`` mode ``zero``,
one world of each size for the file) train an MLP (8-16-16-4, from flax
weights) for 4 steps with Adam and with AdamW (whose weight decay reads the
parameter shards), with and without ``zero``, on the float32 and the
bfloat16 wire.  Held, as the JAX tests hold their ZeRO-1:

* ZeRO-1 losses and parameters equal the unsharded optimizer's within
  rtol 1e-5 / atol 1e-6 (reduce-scatter and all-reduce may sum in other
  orders), and JAX's ZeRO-1 within rtol 1e-5 / atol 1e-5 (float32 wire;
  across frameworks the gradients differ in their last bits, and Adam
  scales each element's step to about lr = 5e-2 whatever its gradient, so
  an element whose gradient is near zero moves by up to lr times its
  gradient's relative difference: ROADMAP.md Queue C item 7);
* the optimizer state on each rank is 1/size of the unsharded state
  (Adam's two moments over ceil(n/size) elements);
* the wire leg: this rank's gradient shard is JAX's ``astype(wire)`` ->
  ``reduce_scatter`` -> ``/ size`` -> ``astype`` bit for bit on two ranks,
  and on four for data whose sums are exact (multiples of 1/8); the
  bfloat16 training curve stays within 5e-3 of the unsharded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu.communicators import _packing as jpack
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.models import MLP as JMLP
from chainermn_tpu.optimizers import (
    create_multi_node_optimizer as jmno, init_opt_state, make_train_step as
    jstep)
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch import (
    create_communicator, create_multi_node_optimizer)
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

UNIT, STEPS, LOCAL_B, N_GRAD = 16, 4, 8, 37
RTOL, ATOL = 1e-5, 1e-6
JAX_ATOL = 1e-5  # across frameworks (module docstring)
OPTS = {"adam": lambda: optax.adam(5e-2),
        "adamw": lambda: optax.adamw(5e-2, weight_decay=1e-2)}


def _variables():
    return JMLP(UNIT, 4).init(jax.random.key(0), jnp.zeros((1, 8)))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    rng = np.random.RandomState(n)
    inputs = {f"var/{k}": v for k, v in torch_dist_worker.flatten(
        jax.tree.map(np.asarray, _variables())).items()}
    inputs.update(
        x=rng.randn(STEPS, n, LOCAL_B, 8).astype(np.float32),
        y=rng.randint(0, 4, (STEPS, n, LOCAL_B)).astype(np.int32),
        g=rng.randn(n, N_GRAD).astype(np.float32),
        exact=(rng.randint(-64, 64, (n, N_GRAD)) / 8).astype(np.float32),
        unit=np.int64(UNIT))
    outs = torch_dist_worker.launch("zero", inputs, n,
                                    tmp_path_factory.mktemp("zero"))
    return n, inputs, outs


def _jcomm(n, **kw):
    return jcreate("xla", mesh=init_topology(
        devices=jax.devices()[:n]).mesh, **kw)


def _jax_train(n, inputs, name, zero):
    comm = _jcomm(n)
    model = JMLP(UNIT, 4)
    opt = jmno(OPTS[name](), comm, zero=zero)

    def loss_fn(p, batch):
        xb, yb = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, xb), yb).mean()

    step = jstep(comm, loss_fn, opt, donate=False)
    params = comm.bcast_data(_variables())
    state = init_opt_state(comm, opt, params)
    losses = []
    for xs, ys in zip(inputs["x"], inputs["y"]):
        params, state, loss = step(params, state, (
            jnp.asarray(xs.reshape(-1, 8)), jnp.asarray(ys.reshape(-1))))
        losses.append(float(loss))
    return np.asarray(losses), torch_dist_worker.flatten(
        jax.tree.map(np.asarray, params))


def _vars(out, cfg):
    pre = f"{cfg}/var/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_zero_matches_the_unsharded_optimizer(world, name, wire):
    n, _, outs = world
    rtol = RTOL if wire == "float32" else 5e-3
    for r, out in enumerate(outs):
        plain, zero = f"{wire}/{name}/zero0", f"{wire}/{name}/zero1"
        np.testing.assert_allclose(out[f"{zero}/losses"],
                                   out[f"{plain}/losses"], rtol=rtol)
        pv, zv = _vars(out, plain), _vars(out, zero)
        assert pv.keys() == zv.keys() and pv
        for k in pv:
            np.testing.assert_allclose(zv[k], pv[k], rtol=rtol,
                                       atol=ATOL if wire == "float32"
                                       else 5e-3, err_msg=f"{k} rank {r}")
        # every rank ends with the same replicated parameters
        for k in zv:
            np.testing.assert_array_equal(zv[k], _vars(outs[0], zero)[k])


@pytest.mark.parametrize("name", sorted(OPTS))
def test_zero_matches_jax_zero(world, name):
    n, inputs, outs = world
    losses, params = _jax_train(n, inputs, name, zero=True)
    jlosses, _ = _jax_train(n, inputs, name, zero=False)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    for r, out in enumerate(outs):
        cfg = f"float32/{name}/zero1"
        np.testing.assert_allclose(out[f"{cfg}/losses"], losses, rtol=RTOL)
        got = _vars(out, cfg)
        assert got.keys() == params.keys()
        for k in params:
            np.testing.assert_allclose(got[k], params[k], rtol=RTOL,
                                       atol=JAX_ATOL,
                                       err_msg=f"{k} rank {r}")


def test_state_is_one_over_size(world):
    n, inputs, outs = world
    count = sum(v.size for k, v in inputs.items() if k.startswith("var/"))
    for out in outs:
        for name in OPTS:
            for wire in ("float32", "bfloat16"):
                plain = int(out[f"{wire}/{name}/zero0/state_numel"])
                zero = int(out[f"{wire}/{name}/zero1/state_numel"])
                assert plain == 2 * count  # exp_avg and exp_avg_sq
                assert zero == 2 * -(-count // n)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", ["g", "exact"])
def test_wire_leg_is_jax_bit_for_bit(world, wire, key):
    """JAX's ZeRO-1 wire leg, line for line: pad, ``astype(wire)``,
    ``reduce_scatter``, ``/ size``, ``astype`` back."""
    n, inputs, outs = world
    comm = _jcomm(n)
    dt = None if wire == "float32" else jnp.bfloat16

    def leg(g):
        g, _ = jpack.pad_to_multiple(g, n)
        w = g if dt is None else g.astype(dt)
        return (comm.reduce_scatter(w) / n).astype(jnp.float32)

    want = np.asarray(comm.run_spmd(leg, jnp.asarray(inputs[key])))
    for r, out in enumerate(outs):
        got = out[f"wire/{wire}/{key}"]
        assert got.dtype == np.float32 and got.shape == want[r].shape
        if n == 2 or key == "exact":
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want[r].view(np.uint32))
        else:  # four randn summands: sums may round in another order
            ulp = 2.0 ** -7 if dt is not None else 2.0 ** -23
            mag = np.abs(inputs[key]).sum(0)
            mag = np.pad(mag, (0, (-N_GRAD) % n)).reshape(n, -1)[r]
            assert np.all(np.abs(got - want[r]) <= 2 * ulp * mag / n)


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def test_zero_refusals(world1):
    comm = create_communicator("xla", device="cpu")
    a, b = torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(
        torch.zeros(3))
    with pytest.raises(ValueError, match="mutually exclusive"):
        create_multi_node_optimizer(torch.optim.SGD([a], lr=1.0), comm,
                                    zero=True, double_buffering=True)
    with pytest.raises(ValueError, match="parameter groups"):
        create_multi_node_optimizer(torch.optim.SGD(
            [{"params": [a]}, {"params": [b], "lr": 0.5}], lr=1.0), comm,
            zero=True)


def test_zero_state_dict_is_the_shards_and_lr_reaches_them(world1):
    comm = create_communicator("xla", device="cpu")
    w = torch.nn.Parameter(torch.arange(5.0))
    opt = create_multi_node_optimizer(
        torch.optim.SGD([w], lr=1.0, momentum=0.9), comm, zero=True)
    for g in opt.param_groups:
        g["lr"] = 0.5
    w.grad = torch.ones(5)
    opt.step()
    torch.testing.assert_close(w.detach(), torch.arange(5.0) - 0.5,
                               rtol=0, atol=0)
    (st,) = opt.state_dict()["state"].values()
    assert st["momentum_buffer"].shape == (5,)
    opt.zero_grad(set_to_none=True)  # the model's gradients
    assert w.grad is None
