"""The long-context example's sequence-parallel step, port vs JAX, on the CPU.

On gloo worlds of 2 and 4 processes (``tests/torch_dist_worker.py`` mode
``seq``), from flax weights (2 layers, d_model 32, 4 heads, T 64, batch 2):
each rank runs ``examples.train_lm.sp_loss`` on its block of the tokens,
``backward()`` and ``sum_gradients``; the loss and every rank's summed
parameter gradients must equal the JAX example's ``sp_body`` objective
(``examples/long_context/train_lm.py:111-131``, written out below, under
``shard_map(..., check_vma=False)`` as the example runs it) and its
gradient, within 1e-5 relative, for ``ring``, ``ring_flash`` and
``ulysses``.  That gradient is the single-device one (checked here too), so
ranks that averaged their shares (1/P of it) or all-reduced twice (P times
it) fail.  ``examples.train_lm.main`` itself runs three Adam steps on each
world with every sequence-parallel impl and matches the ``xla`` run of the
same world (the whole sequence on every rank).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker
from chainermn_tpu.models import TransformerLM as JLM
from chainermn_tpu.utils import shard_map

CFG = dict(vocab=32, d_model=32, n_layers=2, n_heads=4)
B, T = 2, 64
IMPLS = ("ring", "ring_flash", "ulysses")
EXAMPLE = ("--device cpu --seq-len 64 --batchsize 2 --steps 3 --vocab 32 "
           "--d-model 32 --layers 2 --heads 4 --lr 1e-3 --seed 5")


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    toks = np.random.RandomState(40 + n).randint(
        0, CFG["vocab"], (B, T)).astype(np.int32)
    params = JLM(**CFG, max_len=T).init(jax.random.key(n),
                                        jnp.asarray(toks))
    params = jax.tree.map(np.asarray, params)
    inputs = {f"lm/var/{k}": v for k, v in
              torch_dist_worker.flatten(params).items()}
    inputs.update({"lm/toks": toks, "lm/impls": np.asarray(",".join(IMPLS)),
                   "lm/cfg": np.asarray([CFG["vocab"], CFG["d_model"],
                                         CFG["n_layers"], CFG["n_heads"], T]),
                   "example/argv": np.asarray(EXAMPLE),
                   "example/impls": np.asarray(",".join(IMPLS + ("xla",)))})
    outs = torch_dist_worker.launch("seq", inputs, n,
                                    tmp_path_factory.mktemp(f"lm{n}"))
    return n, toks, params, outs


_JAX_SP: dict = {}


def _jax_sp(impl, n, params, toks):
    """The JAX example's sequence-parallel loss and its gradient (computed
    once per world and impl)."""
    if (impl, n) not in _JAX_SP:
        _JAX_SP[impl, n] = _jax_sp_run(impl, n, params, toks)
    return _JAX_SP[impl, n]


def _jax_sp_run(impl, n, params, toks):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    t_local = T // n
    model = JLM(**CFG, max_len=T, attention_impl=impl, axis_name="sp")

    def sp_body(pp, tkk):
        me = jax.lax.axis_index("sp")
        logits = model.apply(pp, tkk, pos_offset=me * t_local)
        nxt = jax.lax.ppermute(
            tkk[:, :1], "sp", perm=[(i, (i - 1) % n) for i in range(n)])
        targets = jnp.concatenate([tkk[:, 1:], nxt], axis=1)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
        mask = jnp.ones_like(ce)
        mask = mask.at[:, -1].set(jnp.where(me == n - 1, 0.0, 1.0))
        total = jax.lax.psum((ce * mask).sum(), "sp")
        count = jax.lax.psum(mask.sum(), "sp")
        return total / count

    def loss_fn(p, tk):
        return shard_map(sp_body, mesh=mesh, in_specs=(P(), P(None, "sp")),
                         out_specs=P(), check_vma=False)(p, tk)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                       jnp.asarray(toks))
    return float(loss), torch_dist_worker.flatten(
        jax.tree.map(np.asarray, grads))


def _single_device(params, toks):
    model = JLM(**CFG, max_len=T, attention_impl="xla")

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(toks))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], jnp.asarray(toks)[:, 1:]).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), torch_dist_worker.flatten(
        jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("impl", IMPLS)
def test_sp_loss_and_summed_gradients_match_jax(world, impl):
    n, toks, params, outs = world
    loss, want = _jax_sp(impl, n, params, toks)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"lm/{impl}/loss"], loss, rtol=1e-5,
                                   err_msg=f"rank {r}")
        got = {k[len(f"lm/{impl}/grad/"):]: v for k, v in out.items()
               if k.startswith(f"lm/{impl}/grad/")}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=1e-5,
                atol=1e-5 * np.abs(want[k]).max(), err_msg=f"{k} rank {r}")


def test_jax_sp_gradient_is_the_single_device_gradient(world):
    """What the port is held to: the JAX sp objective's gradient is the
    single-device gradient, not P times or 1/P of it."""
    n, toks, params, _ = world
    loss, want = _single_device(params, toks)
    got_loss, got = _jax_sp("ring", n, params, toks)
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("impl", IMPLS)
def test_example_main_matches_the_whole_sequence_run(world, impl):
    n, _, _, outs = world
    for r, out in enumerate(outs):
        losses = out[f"example/{impl}/losses"]
        assert losses.shape == (3,) and np.all(np.isfinite(losses))
        np.testing.assert_allclose(losses, out["example/xla/losses"],
                                   rtol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_array_equal(losses, outs[0][f"example/{impl}/losses"])
