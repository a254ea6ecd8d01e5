"""The port's VGG against the flax VGG of the JAX package.

A tiny VGG (``cfg=(8, "M", 16, "M")``, hidden 16, 8x8 inputs: a 2x2x16
map flattened, so the NHWC flatten order shows) and VGG-16 at CIFAR's 32
pixels (batch 2 and 8), float32.  The port runs its fused BatchNorm+ReLU module
(the plain kernel versions on the CPU), flax its ``nn.BatchNorm`` then
ReLU; weights go over with ``weights.py``.  In train mode (dropout off on
both sides) the logits, the updated running statistics and the parameter
gradients of a cross-entropy loss agree within 1e-4 (relative and
absolute); in eval mode, with the updated statistics, the logits too.
The parameter counts are equal and the weights round-trip exactly.

Below VGG-16's last max pool the gradients are held per tensor, by
relative L2 error within 5e-2: the two forward passes drift apart by
~2e-5 over 13 layers (float32 sums in other orders), and a 2x2 window
whose top two values lie closer than that routes its gradient to the
other position in one framework (this batch has one such window of 4096;
moving one window's gradient changes a layer's by ~1/sqrt(4096/2)).  A
wrong backward pass (a missing term, a transposed layout) is off by
orders of magnitude more.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from chainermn_tpu.models.vgg import VGG as JVGG
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.models import VGG, VGG16
from chainermn_tpu_torch.ops.fused_norm import (
    FusedBatchNormAct, ReferenceBatchNormAct)
from torch_flax_parity import (
    close, close_trees, flat, grads_as_flax, n_params, nchw,
    perturbed_variables, port_no_dropout, rel_l2, round_trip_exact)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (model keywords, image size, batch): VGG-16 at batch 8, so that its last
# norms (1x1 maps) see 8 rows, not 2
CASES = {"tiny": (dict(cfg=(8, "M", 16, "M"), hidden=16, num_classes=5), 8,
                  2),
         "vgg16": (dict(num_classes=10), 32, 8)}


@functools.lru_cache(maxsize=None)
def _case(name):
    kw, size, batch = CASES[name]
    x = np.random.RandomState(3).randn(batch, size, size, 3).astype(
        np.float32)
    y = np.random.RandomState(4).randint(0, kw["num_classes"], size=batch)
    jmodel = JVGG(dropout_rate=0.0, **kw)
    v = perturbed_variables(jmodel, x, train=False)
    return kw, size, x, y, jmodel, v


def _port(name, **kw):
    ckw, size, _ = CASES[name]
    return VGG(image_size=size, device="cpu", **{**ckw, **kw})


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_flax(name):
    kw, size, x, y, jmodel, v = _case(name)

    def jloss(p):
        logits, mut = jmodel.apply({"params": p,
                                    "batch_stats": v["batch_stats"]},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, (logits, mut["batch_stats"])

    (jl, (jlogits, jstats)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(v["params"])
    jeval = jax.jit(functools.partial(jmodel.apply, train=False))(
        {"params": v["params"], "batch_stats": jstats}, jnp.asarray(x))

    model = weights.load_flax_variables(port_no_dropout(_port(name)), v)
    model.train()
    logits = model(nchw(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    close(logits.detach(), jlogits, "train logits")
    close(float(loss.detach()), float(jl), "loss")
    close_trees(weights.state_dict_to_flax(model, norm="BatchNorm")
                ["batch_stats"], jstats)
    model.eval()
    close(model(nchw(x)).detach(), jeval, "eval logits")
    got, want = flat(grads_as_flax(model)), flat(jgrads)
    assert got.keys() == want.keys()
    for k in want:
        if name == "tiny" or k.startswith("/Dense_") or \
                k.startswith("/BatchNorm_12/"):
            close(got[k], want[k], k)
        else:
            assert rel_l2(got[k], want[k]) <= 5e-2, k


@pytest.mark.parametrize("name", list(CASES))
def test_parameter_count_and_round_trip(name):
    kw, size, x, y, jmodel, v = _case(name)
    model = _port(name)
    assert sum(p.numel() for p in model.parameters()) == n_params(
        v["params"])
    round_trip_exact(model, v)
    # the norms are the fused module, with the ReLU fused
    assert all(isinstance(n, FusedBatchNormAct) and n.fuse_relu
               for n in model.norms)
    assert len(model.norms) == (13 if name == "vgg16" else 2)


def test_vgg16_size_and_layouts():
    model = VGG16(device="cpu")
    assert 14e6 < sum(p.numel() for p in model.parameters()) < 16e6
    sd = model.state_dict()
    assert tuple(sd["convs.0.weight"].shape) == (64, 3, 3, 3)
    assert tuple(sd["fc.weight"].shape) == (512, 512)
    assert tuple(sd["classifier.weight"].shape) == (10, 512)


def test_reference_norm_seam_gives_the_same_logits():
    """``norm_cls=ReferenceBatchNormAct`` (plain autograd) and the fused
    module agree on the same weights."""
    kw, size, x, y, jmodel, v = _case("tiny")
    a = weights.load_flax_variables(port_no_dropout(_port("tiny")), v)
    b = weights.load_flax_variables(port_no_dropout(
        _port("tiny", norm_cls=ReferenceBatchNormAct)), v)
    assert isinstance(b.norms[0], ReferenceBatchNormAct)
    close(a(nchw(x)).detach(), b(nchw(x)).detach(), "logits")


def test_bfloat16_compute_keeps_float32_parameters():
    kw, size, x, y, jmodel, v = _case("tiny")
    model = weights.load_flax_variables(
        _port("tiny", dtype=torch.bfloat16), v)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    model.train()
    out = model(nchw(x))
    assert out.dtype == torch.float32 and out.shape == (2, 5)
    out.sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    # bf16 compute stays near the float32 model's logits
    ref = weights.load_flax_variables(port_no_dropout(_port("tiny")), v)
    port_no_dropout(model)
    np.testing.assert_allclose(model(nchw(x)).detach().numpy(),
                               ref(nchw(x)).detach().numpy(), rtol=0.1,
                               atol=0.1)


def test_a_flax_leaf_without_a_place_is_refused():
    """``weights.py`` takes every leaf: a tree with one more layer than
    the port's model raises, naming it."""
    kw, size, x, y, jmodel, v = _case("tiny")
    params = dict(v["params"], Dense_2={"kernel": np.zeros((16, 5)),
                                        "bias": np.zeros(5)})
    with pytest.raises(ValueError, match="Dense_2/bias"):
        weights.load_flax_variables(_port("tiny"),
                                    {"params": params,
                                     "batch_stats": v["batch_stats"]})
