"""The port's AlexNet, NIN, GoogLeNet and GoogLeNetBN against the flax
models of the JAX package.

Each model at a small size (64 or 66 pixels, 10 classes), float32, its
weights carried over from a flax init tree with ``weights.py``:

* train mode, dropout off on both sides (flax's through
  ``nn.intercept_methods``, so GoogLeNet's aux heads take part): the logits
  (and the aux heads' logits), the updated running statistics of
  GoogLeNetBN, the training objective of ``examples/train_imagenet.py``
  (``loss3 + 0.3 loss1 + 0.3 loss2`` with ``--aux-loss``) and its
  parameter gradients; then eval-mode logits with the updated statistics.
  Values agree within 1e-4 (relative and absolute); the gradients of the
  dense layers elementwise within 1e-4, every other gradient tensor by
  relative L2 error within 5e-2 (a max-pool window whose top two values
  lie within the frameworks' float32 drift routes its gradient to another
  position, as ``test_torch_vgg.py`` sets out; a wrong backward pass is
  off by far more);
* equal parameter counts and exact weight round trips;
* flax's asymmetric ``"SAME"`` pads at odd and even sizes (AlexNet's
  11x11/4 stem at 66 pixels pads (4, 5), GoogLeNetBN's 7x7/2 at 66 pads
  (2, 3));
* LRN against the JAX function; NIN's refusal below 48 pixels; the aux
  head in eval mode against ``_AuxHead(train=False)`` (dropout 0.7 is the
  identity there); the dropout layer's semantics.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu.models.alexnet import (
    AlexNet as JAlexNet, local_response_normalization as jlrn)
from chainermn_tpu.models.googlenet import (
    GoogLeNet as JGoogLeNet, GoogLeNetBN as JGoogLeNetBN, _AuxHead)
from chainermn_tpu.models.nin import NIN as JNIN
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.examples.train_imagenet import objective
from chainermn_tpu_torch.models import (
    NIN, AlexNet, GoogLeNet, GoogLeNetBN)
from chainermn_tpu_torch.models import googlenet as tgoog
from chainermn_tpu_torch.models.alexnet import local_response_normalization
from chainermn_tpu_torch.models.layers import Dropout, dropout_seed
from chainermn_tpu_torch.models.resnet import _same_pads
from torch_flax_parity import (
    close, flat, grads_as_flax, n_params, nchw, no_dropout,
    perturbed_variables, port_no_dropout, rel_l2, round_trip_exact)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# arch -> (flax model, port constructor, image size, batch)
ARCHS = {
    "alex": (lambda: JAlexNet(num_classes=10),
             lambda: AlexNet(num_classes=10, image_size=66, device="cpu"),
             66, 2),
    "nin": (lambda: JNIN(num_classes=10),
            lambda: NIN(num_classes=10, device="cpu"), 64, 2),
    "googlenet": (lambda: JGoogLeNet(num_classes=10, aux_heads=True),
                  lambda: GoogLeNet(num_classes=10, aux_heads=True,
                                    image_size=64, device="cpu"), 64, 2),
    "googlenetbn": (lambda: JGoogLeNetBN(num_classes=10, aux_heads=True),
                    lambda: GoogLeNetBN(num_classes=10, aux_heads=True,
                                        image_size=66, device="cpu"),
                    66, 4),
}


@functools.lru_cache(maxsize=None)
def _case(arch):
    jmk, _, size, batch = ARCHS[arch]
    rng = np.random.RandomState(11)
    x = rng.randn(batch, size, size, 3).astype(np.float32)
    y = rng.randint(0, 10, size=batch)
    jmodel = jmk()
    v = perturbed_variables(jmodel, x, train=True)
    return x, y, jmodel, v


def _jax_step(arch):
    """JAX's objective, outputs, updated statistics, gradients and eval
    logits, with every dropout the identity."""
    x, y, jmodel, v = _case(arch)
    has_bn = "batch_stats" in v

    def loss(p):
        variables = {"params": p, **({"batch_stats": v["batch_stats"]}
                                     if has_bn else {})}
        out, mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        logits, aux = out if isinstance(out, tuple) else (out, ())

        def ce(lg):
            return optax.softmax_cross_entropy_with_integer_labels(
                lg, jnp.asarray(y)).mean()

        return ce(logits) + 0.3 * sum(ce(a) for a in aux), (
            logits, aux, mut.get("batch_stats"))

    with no_dropout():
        (jl, (logits, aux, stats)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(v["params"])
    ev = {"params": v["params"], **({"batch_stats": stats} if has_bn else {})}
    jeval = jax.jit(functools.partial(jmodel.apply, train=False))(
        ev, jnp.asarray(x))
    return jl, logits, aux, stats, grads, jeval


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_matches_flax(arch):
    x, y, jmodel, v = _case(arch)
    jl, jlogits, jaux, jstats, jgrads, jeval = _jax_step(arch)
    model = weights.load_flax_variables(port_no_dropout(ARCHS[arch][1]()), v)
    model.train()
    out = model(nchw(x))
    loss, logits = objective(out, torch.from_numpy(y))
    loss.backward()
    close(logits.detach(), jlogits, "train logits")
    aux = out[1] if isinstance(out, tuple) else ()
    assert len(aux) == len(jaux) == (2 if arch.startswith("google") else 0)
    for a, ja in zip(aux, jaux):
        close(a.detach(), ja, "aux logits")
    close(float(loss.detach()), float(jl), "objective")
    back = weights.state_dict_to_flax(model, norm="BatchNorm")
    if jstats is not None:
        got, want = flat(back["batch_stats"]), flat(jstats)
        assert got.keys() == want.keys()
        for k in want:
            close(got[k], want[k], k)
    else:
        assert "batch_stats" not in back
    model.eval()
    close(model(nchw(x)).detach(), jeval, "eval logits")
    got, want = flat(grads_as_flax(model)), flat(jgrads)
    assert got.keys() == want.keys()
    for k in want:
        if "/Dense_" in k:
            close(got[k], want[k], k)
        else:
            assert rel_l2(got[k], want[k]) <= 5e-2, k


@pytest.mark.parametrize("arch", list(ARCHS))
def test_parameter_count_and_round_trip(arch):
    x, y, jmodel, v = _case(arch)
    model = ARCHS[arch][1]()
    assert sum(p.numel() for p in model.parameters()) == n_params(
        v["params"])
    round_trip_exact(model, v)


def test_published_sizes():
    """Parameter counts at 224 pixels and 1000 classes, the JAX models'
    (counted from their init trees)."""
    counts = {AlexNet: 62_378_344, NIN: 7_439_608}
    for cls, n in counts.items():
        assert sum(p.numel() for p in cls(device="cpu").parameters()) == n
    bn = GoogLeNetBN(aux_heads=True, device="cpu")
    assert sum(p.numel() for p in bn.parameters()) == 13_671_992
    # 3 stem boundaries + 7 in each of the 9 blocks
    assert sum(isinstance(m, tgoog.FusedBatchNormAct) and m.fuse_relu
               for m in bn.modules()) == 66
    # BN convolutions are bias-free; the aux heads' 1x1 keeps its bias
    assert not any(c.bias is not None for c in bn.modules()
                   if isinstance(c, tgoog.Conv)
                   and not any(c is h.conv for h in bn.aux.values()))
    assert all(h.conv.bias is not None for h in bn.aux.values())
    plain = GoogLeNet(device="cpu")
    assert all(c.bias is not None for c in plain.modules()
               if isinstance(c, tgoog.Conv))


def test_same_padding_at_odd_and_even_sizes():
    assert _same_pads(224, 11, 4) == (3, 4)     # AlexNet's stem
    assert _same_pads(66, 11, 4) == (4, 5)
    assert _same_pads(227, 11, 4) == (4, 4)
    assert _same_pads(224, 7, 2) == (2, 3)      # GoogLeNet's stem
    assert _same_pads(225, 7, 2) == (3, 3)
    assert _same_pads(112, 3, 2) == (0, 1)      # its 3x3/2 max pools
    assert _same_pads(113, 3, 2) == (1, 1)
    assert _same_pads(28, 3, 1) == (1, 1)       # the inception pool


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_lrn_matches_jax(dtype):
    x = (np.random.RandomState(5).randn(2, 7, 5, 13) * 3).astype(np.float32)
    want = np.asarray(jlrn(jnp.asarray(x, dtype)), np.float32)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = local_response_normalization(nchw(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-6 if dtype == np.float32 else 1e-2
    close(got.float().permute(0, 2, 3, 1), want, "lrn", tol, tol)
    # the window sums the squares (torch's local_response_norm averages)
    assert not np.allclose(
        torch.nn.functional.local_response_norm(
            nchw(x), 5, 1e-4, 0.75, 2.0).permute(0, 2, 3, 1).numpy(), want,
        rtol=1e-7, atol=1e-7)


def test_nin_refuses_small_inputs():
    model = NIN(num_classes=10, device="cpu")
    with pytest.raises(ValueError, match="48x48"):
        model(torch.zeros(1, 3, 47, 64))
    with pytest.raises(ValueError, match="48x48"):
        JNIN(num_classes=10).init(jax.random.key(0),
                                  jnp.zeros((1, 47, 64, 3)))


@pytest.mark.parametrize("size", [4, 14])
def test_aux_head_in_eval_mode_matches_flax(size):
    x = np.random.RandomState(size).randn(2, size, size, 32).astype(
        np.float32)
    head = _AuxHead(num_classes=10)
    v = perturbed_variables(head, x, train=False)
    want = jax.jit(functools.partial(head.apply, train=False))(
        v, jnp.asarray(x))
    port = tgoog.AuxHead(32, 10, size, dtype=torch.float32, device="cpu",
                         generator=None,
                         dropout_generator=torch.Generator())
    assert port.dropout.rate == 0.7
    p = v["params"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    port.load_state_dict({
        "conv.weight": t(np.asarray(p["Conv_0"]["kernel"])
                         .transpose(3, 2, 0, 1)),
        "conv.bias": t(p["Conv_0"]["bias"]),
        "fc.weight": t(np.asarray(p["Dense_0"]["kernel"]).T),
        "fc.bias": t(p["Dense_0"]["bias"]),
        "classifier.weight": t(np.asarray(p["Dense_1"]["kernel"]).T),
        "classifier.bias": t(p["Dense_1"]["bias"])})
    port.eval()
    close(port(nchw(x)).detach(), want, "aux head")


def test_dropout_layer():
    gen = torch.Generator().manual_seed(dropout_seed(0, 3, 1))
    d = Dropout(0.25, gen)
    x = torch.ones(4000)
    y = d(x)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.7 < float(kept.float().mean()) < 0.8
    # the same seed gives the same mask; another step another one
    gen.manual_seed(dropout_seed(0, 3, 1))
    assert torch.equal(d(x), y)
    gen.manual_seed(dropout_seed(0, 4, 1))
    assert not torch.equal(d(x), y)
    d.eval()
    assert d(x) is x
    assert len({dropout_seed(s, i, r) for s in range(3) for i in range(50)
                for r in range(8)}) == 3 * 50 * 8
