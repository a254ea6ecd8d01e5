"""The port's ResNet against the flax ResNet of the JAX package.

A toy bottleneck ResNet (stage_sizes=(1, 1), num_filters=8, 32x32 input)
keeps every trap of the full model: the stride-2 "SAME" pads are
asymmetric (stem (2, 3), the 3x3/s2 conv and the max pool (0, 1)), the
projection shortcut, the zero-init BN and the fused ReLU.  The flax
variables go over with ``chainermn_tpu_torch.weights``; logits (train and
eval mode) and the updated running statistics must agree at float32 1e-4.
The JAX side runs both with its default ``nn.BatchNorm`` and with its
``FusedBatchNormAct`` (Pallas in interpret mode); the port always uses
its fused module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.resnet import (
    BasicBlock as JBasic, BottleneckBlock as JBottleneck, ResNet as JResNet)
from chainermn_tpu.ops.fused_norm import FusedBatchNormAct as JFused
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.models import resnet as tres
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4


def _jax_model(norm_cls, block="bottleneck"):
    return JResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                   block_cls=JBottleneck if block == "bottleneck" else JBasic,
                   norm_cls=norm_cls)


def _port_model(block="bottleneck"):
    return tres.ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                       block_cls=(tres.BottleneckBlock if block == "bottleneck"
                                  else tres.BasicBlock), device="cpu")


def _perturbed_variables(model, x, seed=0):
    """flax init, then every parameter moved by seeded noise so no γ is
    zero and no β is zero (the zero-init BN would hide a wrong branch),
    and running stats made non-trivial."""
    v = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(seed), jnp.asarray(x))
    rng = np.random.RandomState(seed + 1)
    noise = lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape)  # noqa
    params = jax.tree.map(lambda a: jnp.asarray(noise(a), jnp.float32),
                          v["params"])
    stats = jax.tree.map(lambda a: jnp.asarray(
        np.abs(noise(a)) + 0.05, jnp.float32), v["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _apply(model, train):
    """Jitted flax apply (one compile beats op-by-op dispatch here)."""
    if train:
        return jax.jit(functools.partial(model.apply, train=True,
                                         mutable=["batch_stats"]))
    return jax.jit(functools.partial(model.apply, train=False))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _input(seed=3):
    return np.random.RandomState(seed).randn(2, 32, 32, 3).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL, err_msg=what)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
@pytest.mark.parametrize("jax_norm", ["BatchNorm", "FusedBatchNormAct"])
def test_logits_and_running_stats_match_flax(jax_norm, block):
    x = _input()
    jmodel = _jax_model(None if jax_norm == "BatchNorm" else JFused, block)
    v = _perturbed_variables(jmodel, x)
    jlogits, mut = _apply(jmodel, True)(v, jnp.asarray(x))

    model = weights.load_flax_variables(_port_model(block), v)
    model.train()
    logits = model(_nchw(x))
    _close(logits.detach(), jlogits, "train logits")
    got = _flat(weights.state_dict_to_flax(model, norm=jax_norm)
                ["batch_stats"])
    want = _flat(mut["batch_stats"])
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], k)
    # eval mode with the updated running stats
    model.eval()
    v_eval = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    jeval = _apply(jmodel, False)(v_eval, jnp.asarray(x))
    _close(model(_nchw(x)).detach(), jeval, "eval logits")


@pytest.mark.parametrize("jax_norm", ["BatchNorm", "FusedBatchNormAct"])
def test_weights_round_trip_is_exact(jax_norm):
    x = _input()
    jmodel = _jax_model(None if jax_norm == "BatchNorm" else JFused)
    v = _perturbed_variables(jmodel, x, seed=5)
    model = weights.load_flax_variables(_port_model(), v)
    back = _flat(weights.state_dict_to_flax(model, norm=jax_norm))
    want = _flat(v)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    # layouts: conv HWIO -> OIHW, dense [in, out] -> [out, in]
    sd = model.state_dict()
    assert tuple(sd["conv_init.weight"].shape) == (8, 3, 7, 7)
    assert tuple(sd["dense.weight"].shape) == (10, 64)


def test_same_padding_matches_flax():
    """The pads the port derives are flax's: asymmetric at stride 2."""
    assert tres._same_pads(224, 7, 2) == (2, 3)
    assert tres._same_pads(56, 3, 2) == (0, 1)
    assert tres._same_pads(112, 3, 2) == (0, 1)
    assert tres._same_pads(56, 3, 1) == (1, 1)
    assert tres._same_pads(7, 1, 2) == (0, 0)


def test_grads_match_flax():
    """Parameter gradients of a loss on the logits, through the fused
    norm's backward, against jax.grad through flax."""
    x = _input(seed=7)
    y = np.random.RandomState(8).randint(0, 10, size=2)
    jmodel = _jax_model(JFused)
    v = _perturbed_variables(jmodel, x, seed=9)

    def jloss(p):
        logits, _ = jmodel.apply({"params": p,
                                  "batch_stats": v["batch_stats"]},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2), y])

    jgrads = jax.jit(jax.grad(jloss))(v["params"])
    model = weights.load_flax_variables(_port_model(), v)
    loss = torch.nn.functional.cross_entropy(model(_nchw(x)),
                                             torch.from_numpy(y))
    loss.backward()
    # gradients laid out as flax params, via the same name map
    grads = {k: p.grad for k, p in model.named_parameters()}
    gmodel = _port_model()
    with torch.no_grad():
        for k, p in gmodel.named_parameters():
            p.copy_(grads[k])
    got = _flat(weights.state_dict_to_flax(gmodel)["params"])
    want = _flat(jgrads)
    for k in want:
        _close(got[k], want[k], k)


def test_unported_options_raise():
    # the s2d stem and the remat policies are ported; an unknown stem or
    # policy raises JAX's ValueError
    tres.ResNet50(stem="s2d", remat_policy="norm", device="cpu")
    with pytest.raises(ValueError, match="unknown stem 's3d'"):
        tres.ResNet50(stem="s3d", device="cpu")
    with pytest.raises(ValueError, match="unknown remat_policy 'all'"):
        tres.ResNet50(remat_policy="all", device="cpu")
