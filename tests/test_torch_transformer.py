"""The port's TransformerLM against the JAX package's, on the CPU.

Flax weights (``model.init``) go through ``weights.py`` into the port's
model; the same tokens from numpy seeds give logits and parameter gradients
that agree in float32 (1e-4 relative: both sides sum in other orders, and
the flash path folds the softmax tile by tile on the JAX side), for the
``xla`` and ``flash`` attentions, multi-head and grouped-query, and for
scalar and per-sequence position offsets.  The weights mapping round-trips
exactly; the full-width configuration counts flax's parameters; the
unported extensions raise, and the sequence-parallel impls run on a world
of one as their single-shard twins.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from chainermn_tpu.models import TransformerLM as JLM
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.models import TransformerLM

VOCAB, D_MODEL, LAYERS, HEADS, T, B = 64, 32, 2, 4, 48, 2
RTOL, ATOL = 1e-4, 1e-5


def _flax(impl="xla", kv=None, seed=0, **kw):
    model = JLM(vocab=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
                n_heads=HEADS, n_kv_heads=kv, max_len=2 * T,
                attention_impl=impl, **kw)
    params = model.init(jax.random.key(seed), jnp.zeros((1, T), jnp.int32))
    return model, jax.tree.map(np.asarray, params)


def _port(params, impl="xla", kv=None, dtype=torch.float32):
    model = TransformerLM(VOCAB, D_MODEL, LAYERS, HEADS, max_len=2 * T,
                          attention_impl=impl, n_kv_heads=kv, dtype=dtype,
                          device="cpu")
    return weights.load_flax_variables(model, params)


def _tokens(seed=1):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, T)).astype(
        np.int32)


def test_weights_round_trip_exactly():
    _, params = _flax(kv=2)
    back = weights.state_dict_to_flax(_port(params, kv=2))
    want = torch_dist_worker.flatten(params)
    got = torch_dist_worker.flatten(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_full_width_parameter_count_matches_flax():
    """The LM bench's configuration: vocab 32768, d_model 2048, 8 layers,
    16 heads, max_len 8192 -- 553.9 M parameters on both sides (the port's
    built on the meta device, flax's by eval_shape)."""
    cfg = dict(vocab=32768, d_model=2048, n_layers=8, n_heads=16,
               max_len=8192)
    shapes = jax.eval_shape(JLM(**cfg, attention_impl="flash").init,
                            jax.random.key(0),
                            jnp.zeros((1, 128), jnp.int32))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    model = TransformerLM(**cfg, attention_impl="flash",
                          dtype=torch.bfloat16, device="meta")
    got = sum(p.numel() for p in model.parameters())
    assert got == want
    assert round(got / 1e6, 1) == 553.9
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _grads_as_flax(model):
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad
    return torch_dist_worker.flatten(weights.state_dict_to_flax(g))


@pytest.mark.parametrize("kv", [None, 2, 1], ids=["mha", "gqa2", "mqa"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_and_grads_match_jax(impl, kv):
    jmodel, params = _flax(impl, kv)
    toks = _tokens()
    # the loss weights every logit, so every parameter gets a gradient
    w = np.random.RandomState(2).randn(B, T, VOCAB).astype(np.float32)

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(toks))
        return (logits * w).sum(), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = _port(params, impl, kv)
    logits = model(torch.from_numpy(toks))
    (logits * torch.from_numpy(w)).sum().backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    want = torch_dist_worker.flatten(jax.tree.map(np.asarray, jgrads))
    got = _grads_as_flax(model)
    assert got.keys() == want.keys()
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=RTOL * scale, err_msg=k)


@pytest.mark.parametrize("offset", ["scalar", "vector"])
def test_position_offsets_match_jax(offset):
    jmodel, params = _flax("flash")
    toks = _tokens(3)
    off = 7 if offset == "scalar" else np.array([0, 11], np.int32)
    want = jmodel.apply(params, jnp.asarray(toks), pos_offset=off)
    got = _port(params, "flash")(torch.from_numpy(toks),
                                 pos_offset=torch.as_tensor(off))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_bfloat16_forward_close_to_jax():
    """bf16 compute over float32 parameters: the two frameworks round at
    other places, so within bf16's resolution of the float32 logits."""
    jmodel = JLM(vocab=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
                 n_heads=HEADS, max_len=2 * T, attention_impl="xla",
                 dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(0), jnp.zeros((1, T), jnp.int32)))
    toks = _tokens(4)
    want = np.asarray(jmodel.apply(params, jnp.asarray(toks)))
    for impl in ("xla", "flash"):
        got = _port(params, impl, dtype=torch.bfloat16)(
            torch.from_numpy(toks)).detach().numpy()
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < 3e-2, (impl, err)


def test_layer_norm_is_flax():
    """eps 1e-6, the fast variance clamped at 0, float32 statistics."""
    import flax.linen as fnn
    x = np.random.RandomState(5).randn(3, 7, 32).astype(np.float32) * 3 + 2
    ln = fnn.LayerNorm(dtype=jnp.bfloat16, param_dtype=jnp.float32)
    p = ln.init(jax.random.key(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: a + 0.1 * np.arange(a.size).reshape(a.shape)
                     / a.size, p)
    want = np.asarray(ln.apply(p, jnp.asarray(x).astype(jnp.bfloat16)),
                      np.float32)
    from chainermn_tpu_torch.models.transformer import LayerNorm
    m = LayerNorm(32, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        m.weight.copy_(torch.tensor(np.asarray(p["params"]["scale"])))
        m.bias.copy_(torch.tensor(np.asarray(p["params"]["bias"])))
        got = m(torch.from_numpy(x).bfloat16()).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    assert m.eps == 1e-6


def _msg(call, exc=ValueError):
    with pytest.raises(exc) as e:
        call()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    {"n_heads": 5},
    {"n_kv_heads": 3},
    {"n_kv_heads": 0},
], ids=["heads_divide_d_model", "kv_divides_heads", "kv_positive"])
def test_value_errors_match_jax(kw):
    cfg = dict(vocab=VOCAB, d_model=D_MODEL, n_layers=1, n_heads=HEADS)
    cfg.update(kw)
    toks = jnp.zeros((1, 8), jnp.int32)
    want = _msg(lambda: JLM(**cfg).init(jax.random.key(0), toks))
    got = _msg(lambda: TransformerLM(**cfg, device="cpu"))
    assert got == want


def test_tp_size_divisibility_error_matches_jax():
    cfg = dict(vocab=VOCAB, d_model=D_MODEL, n_layers=1, n_heads=HEADS,
               tp_size=3)
    want = _msg(lambda: JLM(**cfg).init(jax.random.key(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    assert _msg(lambda: TransformerLM(**cfg, device="cpu")) == want


@pytest.mark.parametrize("kw,queue", [
    ({"attention_impl": "ring"}, "A9"),
    ({"attention_impl": "ring_flash"}, "A9"),
    ({"attention_impl": "ulysses"}, "A9"),
    ({"moe_experts": 4}, "A9"),
    ({"tp_size": 2}, "A12"),
])
def test_unported_extensions_raise(kw, queue):
    impl = kw.get("attention_impl")
    if impl is not None:
        # the sequence-parallel impls are ported (A9, part): on a world of
        # one (a ring of one rank) each gives the logits and gradients of
        # its single-shard twin, flash for ring_flash, xla for the others
        _world_of_one_matches(impl, "flash" if impl == "ring_flash"
                              else "xla")
        return
    msg = _msg(lambda: TransformerLM(VOCAB, D_MODEL, 1, HEADS, device="cpu",
                                     **kw), NotImplementedError)
    assert f"Queue {queue}" in msg


def _world_of_one_matches(impl, twin):
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    created = not dist.is_initialized()
    comm = create_communicator("naive", device="cpu")
    try:
        with pytest.raises(ValueError, match="pass comm="):
            TransformerLM(VOCAB, D_MODEL, 1, HEADS, device="cpu",
                          attention_impl=impl)
        _, params = _flax(kv=2)
        toks = torch.from_numpy(_tokens(6))
        w = torch.from_numpy(np.random.RandomState(7).randn(
            B, T, VOCAB).astype(np.float32))
        runs = []
        for model in (_port(params, twin, kv=2),
                      weights.load_flax_variables(TransformerLM(
                          VOCAB, D_MODEL, LAYERS, HEADS, max_len=2 * T,
                          attention_impl=impl, n_kv_heads=2, comm=comm,
                          device="cpu"), params)):
            logits = model(toks)
            (logits * w).sum().backward()
            runs.append((logits.detach().numpy(), _grads_as_flax(model)))
        (want, gwant), (got, ggot) = runs
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        for k in gwant:
            np.testing.assert_allclose(
                ggot[k], gwant[k], rtol=RTOL,
                atol=RTOL * np.abs(gwant[k]).max(), err_msg=k)
    finally:
        if created:
            dist.destroy_process_group()


def test_unknown_impl_and_attend_refused():
    want = "attention_impl must be flash|ring|ring_flash|ulysses|xla"
    assert want in _msg(lambda: TransformerLM(
        VOCAB, D_MODEL, 1, HEADS, attention_impl="fused", device="cpu"))
    model = TransformerLM(VOCAB, D_MODEL, 1, HEADS, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    assert "Queue A12" in _msg(lambda: model(toks, attend=lambda *a: a),
                               NotImplementedError)
