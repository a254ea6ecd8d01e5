"""The port's ViT against the JAX package's flax ViT (``models/vit.py``).

A tiny ViT (image 32, patch 8, width 32, 2 layers, 4 heads, 10 classes)
with flax-initialised weights (the leaves flax starts constant moved by
seeded noise) carried across with ``chainermn_tpu_torch.weights``:

* float32 logits within 1e-5 of flax's in train and eval mode (dropout
  0), with ``cls`` and ``gap`` pooling, and the parameter gradients of a
  cross-entropy within 1e-4 (``test_torch_resnet.py``'s tolerance);
* ``attention_impl="flash"``: the port's flash (its plain version on the
  CPU) against JAX's Pallas kernel in interpret mode, as
  ``tests/test_vit.py`` runs it, within 1e-5;
* bf16 compute with float32 parameters: float32 logits within 2e-2
  relative L2 of flax's bf16 model;
* ViT-S/16 and ViT-B/16 have the flax trees' parameter counts (read with
  ``jax.eval_shape``, no init), and the weights round-trip exactly;
* the bad configurations raise JAX's ``ValueError`` messages; dropout
  differs between train and eval and follows the model's generator.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_flax_parity as tfp
from chainermn_tpu.models.vit import ViT as JViT, ViT_B16 as JB16, \
    ViT_S16 as JS16
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.models import vit as tvit
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(num_classes=10, patch=8, d_model=32, n_layers=2, n_heads=4)


def _pair(**kw):
    kw = {**TINY, **kw}
    return JViT(**kw), tvit.ViT(**kw, image_size=32, device="cpu")


def _input(seed=0, b=2):
    return np.random.RandomState(seed).randn(b, 32, 32, 3).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("pooling", ["cls", "gap"])
def test_logits_and_grads_match_flax(pooling):
    x = _input()
    y = np.random.RandomState(1).randint(0, 10, size=2)
    jm, tm = _pair(pooling=pooling)
    v = tfp.perturbed_variables(jm, x)
    weights.load_flax_variables(tm, v)
    jeval = jax.jit(functools.partial(jm.apply, train=False))(v, x)
    tm.eval()
    _close(tm(tfp.nchw(x)).detach(), jeval, 1e-5, "eval logits")

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.key(0)})
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2), y]), \
            logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    tm.train()
    logits = tm(tfp.nchw(x))
    _close(logits.detach(), jlogits, 1e-5, "train logits")
    F.cross_entropy(logits, torch.from_numpy(y)).backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    gm = _pair(pooling=pooling)[1]
    with torch.no_grad():
        for k, p in gm.named_parameters():
            p.copy_(grads[k])
    got = tfp.flat(weights.state_dict_to_flax(gm)["params"])
    want = tfp.flat(jgrads)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-4, k)


def test_flash_matches_jax_pallas():
    x = _input(seed=2)
    jm, tm = _pair(attention_impl="flash")
    v = tfp.perturbed_variables(_pair()[0], x, seed=3)
    weights.load_flax_variables(tm, v)
    tm.eval()
    # JAX's flash runs its Pallas kernel in interpret mode on the CPU
    want = jm.apply(v, jnp.asarray(x), train=False)
    _close(tm(tfp.nchw(x)).detach(), want, 1e-5, "flash logits")


def test_bf16_compute_float32_params():
    x = _input(seed=4)
    jm = JViT(**TINY, dtype=jnp.bfloat16)
    tm = tvit.ViT(**TINY, dtype=torch.bfloat16, image_size=32, device="cpu")
    v = tfp.perturbed_variables(jm, x, seed=5)
    weights.load_flax_variables(tm, v)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    tm.eval()
    got = tm(tfp.nchw(x)).detach()
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel


@pytest.mark.parametrize("name", ["s16", "b16"])
def test_param_counts_equal_flax(name):
    jcls, tcls = {"s16": (JS16, tvit.ViT_S16),
                  "b16": (JB16, tvit.ViT_B16)}[name]
    shapes = jax.eval_shape(
        functools.partial(jcls().init, train=False), jax.random.key(0),
        jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = tcls(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want
    assert want == {"s16": 22_050_664, "b16": 86_567_656}[name]


def test_weights_round_trip_is_exact():
    x = _input()
    jm, tm = _pair()
    v = tfp.perturbed_variables(jm, x, seed=7)
    weights.load_flax_variables(tm, v)
    back = tfp.flat(weights.state_dict_to_flax(tm))
    want = tfp.flat(v)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw,image", [
    (dict(n_heads=5), 32), (dict(pooling="max"), 32), (dict(), 36)])
def test_bad_configs_raise_jax_errors(kw, image):
    x = np.zeros((1, image, image, 3), np.float32)
    with pytest.raises(ValueError) as jerr:
        JViT(**{**TINY, **kw}).init(jax.random.key(0), jnp.asarray(x))
    with pytest.raises(ValueError) as terr:
        tvit.ViT(**{**TINY, **kw}, image_size=image, device="cpu")
    assert str(terr.value) == str(jerr.value)
    if image != 32:
        # a model built at 32 refuses an input the patch does not divide
        m = tvit.ViT(**TINY, image_size=32, device="cpu")
        with pytest.raises(ValueError) as ferr:
            m(torch.zeros(1, 3, image, image))
        assert str(ferr.value) == str(jerr.value)


def test_attention_impl_refused():
    with pytest.raises(ValueError, match="xla|flash"):
        tvit.ViT(**TINY, attention_impl="ring", image_size=32, device="cpu")


def test_dropout_train_vs_eval():
    m = tvit.ViT(**TINY, dropout=0.1, image_size=32, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    x = tfp.nchw(_input(seed=9))
    m.eval()
    e1, e2 = m(x), m(x)
    assert torch.equal(e1, e2)
    m.train()
    m.dropout_generator.manual_seed(2)
    t1 = m(x)
    m.dropout_generator.manual_seed(2)
    t2 = m(x)
    t3 = m(x)  # the generator moved on: other masks
    assert torch.equal(t1, t2)
    assert not torch.allclose(t1, e1) and not torch.allclose(t1, t3)
