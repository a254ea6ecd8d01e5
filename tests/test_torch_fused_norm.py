"""The port's fused BatchNorm(+ReLU) against the JAX package's Pallas kernels.

The same numpy inputs, made from a seed, go through
``chainermn_tpu.ops.fused_norm`` (Pallas in interpret mode, as
tests/test_fused_norm.py runs it here) and ``chainermn_tpu_torch.ops.
fused_norm`` (on the CPU, where each kernel wrapper takes its plain
version).  Tolerances are the JAX package's own pins: 1e-5 for the forward
and the per-kernel float32 results, 1e-4 for the gradients (the backward
recomputes x̂, which reassociates a few multiplies).  The traffic model is
plain arithmetic and must agree exactly.

The Triton kernels themselves run only on a CUDA card; they are held to
their plain versions in tests/test_torch_kernels_gpu.py.
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the packages' ops/__init__ export a function of the module's name
jfn = importlib.import_module("chainermn_tpu.ops.fused_norm")
tfn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _np(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _affine(c, seed=1):
    rng = np.random.RandomState(seed)
    return ((rng.rand(c) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.2).astype(np.float32))


def _stats(c, seed=4):
    rng = np.random.RandomState(seed)
    return ((rng.randn(c) * 0.1).astype(np.float32),
            (rng.rand(c) + 0.3).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# the four kernels, one by one, against their Pallas counterparts
# ---------------------------------------------------------------------------

R, C = 48, 13  # C not a power of two; R a multiple of the Pallas tile


def _kernel_inputs():
    x = _np((R, C), 20, 1.5, 0.3)
    g = _np((R, C), 21)
    scale, bias = _affine(C)
    mean, var = _stats(C)
    invstd = (1.0 / np.sqrt(var + 1e-5)).astype(np.float32)
    db, dg = _np((C,), 22, 3.0), _np((C,), 23, 3.0)
    return x, g, scale, bias, mean, invstd, db, dg


def test_stats_kernel_matches_pallas():
    x = _kernel_inputs()[0]
    jm, jv = jfn._stats_call(jnp.asarray(x), 16, True)
    tm, tv = tfn.stats_call(_t(x))
    _close(tm, np.asarray(jm).reshape(-1), FWD_TOL, "mean")
    _close(tv, np.asarray(jv).reshape(-1), FWD_TOL, "var")


@pytest.mark.parametrize("relu", [True, False])
def test_apply_kernel_matches_pallas(relu):
    x, _, scale, bias, mean, invstd, _, _ = _kernel_inputs()
    v = lambda a: jnp.asarray(a).reshape(1, C)  # noqa: E731
    want = jfn._apply_call(jnp.asarray(x), v(mean), v(invstd), v(scale),
                           v(bias), relu, 16, True)
    got = tfn.apply_call(_t(x), _t(mean), _t(invstd), _t(scale), _t(bias),
                         relu)
    _close(got, want, FWD_TOL)


@pytest.mark.parametrize("relu", [True, False])
def test_bwd_reduce_kernel_matches_pallas(relu):
    x, g, scale, bias, mean, invstd, _, _ = _kernel_inputs()
    v = lambda a: jnp.asarray(a).reshape(1, C)  # noqa: E731
    jdb, jdg = jfn._bwd_reduce_call(jnp.asarray(x), jnp.asarray(g), v(mean),
                                    v(invstd), v(scale), v(bias), relu, 16,
                                    True)
    tdb, tdg = tfn.bwd_reduce_call(_t(x), _t(g), _t(mean), _t(invstd),
                                   _t(scale), _t(bias), relu)
    _close(tdb, np.asarray(jdb).reshape(-1), FWD_TOL, "dbeta")
    _close(tdg, np.asarray(jdg).reshape(-1), FWD_TOL, "dgamma")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_bwd_dx_kernel_matches_pallas(relu, train):
    x, g, scale, bias, mean, invstd, db, dg = _kernel_inputs()
    v = lambda a: jnp.asarray(a).reshape(1, C)  # noqa: E731
    want = jfn._bwd_dx_call(jnp.asarray(x), jnp.asarray(g), v(mean),
                            v(invstd), v(scale), v(bias), v(db), v(dg), relu,
                            train, 16, True)
    got = tfn.bwd_dx_call(_t(x), _t(g), _t(mean), _t(invstd), _t(scale),
                          _t(bias), _t(db), _t(dg), relu, train)
    _close(got, want, FWD_TOL)


# ---------------------------------------------------------------------------
# fused_norm end to end: forward and gradients through the custom VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_fused_norm_forward_and_grads_match_jax(train, relu):
    c = 10
    x = _np((6, 4, 4, c), 7, 1.2, 0.2)
    scale, bias = _affine(c)
    mean, var = _stats(c)
    kw = dict(use_running_average=not train, relu=relu)
    stats = {} if train else {"mean": mean, "var": var}

    def jloss(xx, s, b):
        y, _, _ = jfn.fused_norm(xx, s, b, **stats, **kw)
        return (y ** 2).sum()

    jy, jm, jv = jfn.fused_norm(jnp.asarray(x), scale, bias, **stats, **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x),
                                                jnp.asarray(scale),
                                                jnp.asarray(bias))

    tx, ts, tb = (_t(a).requires_grad_() for a in (x, scale, bias))
    tstats = {k: _t(a) for k, a in stats.items()}
    ty, tm, tv = tfn.fused_norm(tx, ts, tb, **tstats, **kw)
    (ty ** 2).sum().backward()

    _close(ty.detach(), jy, FWD_TOL, "y")
    _close(tm, jm, FWD_TOL, "mean")
    _close(tv, jv, FWD_TOL, "var")
    for got, want, name in zip((tx.grad, ts.grad, tb.grad), jgrads,
                               ("x", "scale", "bias")):
        _close(got, want, GRAD_TOL, f"grad wrt {name}")


def test_reference_oracle_matches_fused_norm():
    """The port's plain differentiable oracle computes what the kernels'
    autograd core computes, forward and backward."""
    c = 9
    x = _np((20, c), 8)
    scale, bias = _affine(c)
    outs = []
    for fn in (tfn.fused_norm, tfn.fused_norm_reference):
        tx, ts, tb = (_t(a).requires_grad_() for a in (x, scale, bias))
        y, m, v = fn(tx, ts, tb, relu=True)
        (y ** 2).sum().backward()
        outs.append([y.detach(), m.detach(), v.detach(), tx.grad, ts.grad,
                     tb.grad])
    for got, want in zip(*outs):
        _close(got, want, GRAD_TOL)


def test_running_stats_and_eval_match_flax_module():
    """Module: the momentum update of the running stats (biased variance)
    and the eval-mode output agree with flax's FusedBatchNormAct."""
    c = 8
    x = _np((4, 6, 6, c), 12, 1.0, 0.5)
    scale, bias = _affine(c)
    jmod = jfn.FusedBatchNormAct(use_running_average=False, momentum=0.9,
                                 fuse_relu=True)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    jy, mut = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    jeval = jfn.FusedBatchNormAct(use_running_average=True, fuse_relu=True
                                  ).apply({**variables, **mut},
                                          jnp.asarray(x))

    tmod = tfn.FusedBatchNormAct(c, momentum=0.9, fuse_relu=True,
                                 device="cpu")
    with torch.no_grad():
        tmod.weight.copy_(_t(scale))
        tmod.bias.copy_(_t(bias))
    xt = _t(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    ty = tmod(xt)
    _close(ty.detach().permute(0, 2, 3, 1), jy, FWD_TOL, "train y")
    _close(tmod.running_mean, mut["batch_stats"]["mean"], 1e-6, "mean")
    _close(tmod.running_var, mut["batch_stats"]["var"], 1e-6, "var")
    tmod.eval()
    _close(tmod(xt).detach().permute(0, 2, 3, 1), jeval, FWD_TOL, "eval y")


def test_running_stats_match_flax_batchnorm():
    """Same update as flax's own nn.BatchNorm (momentum 0.9)."""
    c = 5
    x = _np((16, c), 13, 2.0, -0.4)
    v = fnn.BatchNorm(use_running_average=False, momentum=0.9).init(
        jax.random.key(0), jnp.asarray(x))
    _, mut = fnn.BatchNorm(use_running_average=False, momentum=0.9).apply(
        v, jnp.asarray(x), mutable=["batch_stats"])
    tmod = tfn.FusedBatchNormAct(c, momentum=0.9, device="cpu")
    tmod(_t(x))
    _close(tmod.running_mean, mut["batch_stats"]["mean"], 1e-6, "mean")
    _close(tmod.running_var, mut["batch_stats"]["var"], 1e-6, "var")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_traffic_model_equals_jax(dt, relu, train):
    shape = (8, 28, 28, 96)
    got = tfn.fused_norm_traffic_bytes(shape, getattr(torch, dt),
                                       train=train, relu=relu)
    want = jfn.fused_norm_traffic_bytes(shape, getattr(jnp, dt), train=train,
                                        relu=relu)
    assert got == want


@pytest.mark.parametrize("batch,image", [(32, 224), (2, 32)])
def test_resnet_traffic_model_equals_jax(batch, image):
    got = tfn.resnet_bn_traffic_bytes(batch, image=image)
    want = jfn.resnet_bn_traffic_bytes(batch, image=image)
    assert got == want
    assert got["num_boundaries"] == 53


def test_wrapper_validation():
    x = torch.zeros((8, 4))
    v = torch.zeros(4)
    with pytest.raises(ValueError, match="dtype"):
        tfn.stats_call(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        tfn.stats_call(torch.zeros((4, 8)).t())
    with pytest.raises(ValueError, match="float32"):
        tfn.apply_call(x, v.double(), v, v, v, True)
    with pytest.raises(ValueError, match="not supported"):
        tfn.stats_call(torch.zeros((8, 4), device="meta"))
    with pytest.raises(ValueError, match="empty activation batch"):
        tfn.fused_norm(torch.zeros((0, 4)), v, v)
    with pytest.raises(ValueError, match="needs mean= and var="):
        tfn.fused_norm(x, v, v, use_running_average=True)


def test_cpu_tensors_launch_no_kernel():
    tfn.reset_launch_counts()
    x = _t(_np((16, 4), 3)).requires_grad_()
    y, _, _ = tfn.fused_norm(x, torch.ones(4), torch.zeros(4))
    y.sum().backward()
    assert tfn.launch_counts() == {"stats_call": 0, "apply_call": 0,
                                   "bwd_reduce_call": 0, "bwd_dx_call": 0}
