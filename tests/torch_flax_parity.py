"""Shared pieces of the tests that hold a port model to its flax model.

Weights go from a flax init tree (every leaf moved by seeded noise, the
running variances kept positive) into the port with
``chainermn_tpu_torch.weights``; inputs are NHWC numpy arrays made from a
seed, fed to the port as NCHW.  Train-mode parity disables flax's dropout
(:func:`no_dropout`) and the port's (:func:`port_no_dropout`): the masks
cannot be the same.
"""

import contextlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from chainermn_tpu_torch import weights
from chainermn_tpu_torch.models.layers import Dropout

RTOL = ATOL = 1e-4


def perturbed_variables(model, x, seed=0, **init_kw):
    """flax init at ``x``'s shape, then the parameters flax starts
    constant (biases, BatchNorm scales) and the running statistics moved
    by seeded noise, so none of them hides a wrong branch."""
    v = jax.jit(lambda x: model.init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        x, **init_kw))(jnp.asarray(x))
    rng = np.random.RandomState(seed + 2)

    def noise(a):
        # the leaves flax starts constant (biases, scales) get N(0, 0.1^2)
        # added; kernels keep their draw, so activations keep their scale
        a = np.asarray(a, np.float32)
        if a.std() > 0:
            return jnp.asarray(a)
        return jnp.asarray(a + 0.1 * rng.randn(*a.shape), jnp.float32)

    out = {"params": jax.tree.map(noise, v["params"])}
    if "batch_stats" in v:
        # running means near 0, variances near 1 (what a layer of lecun-
        # initialised convolutions feeds its norm)
        out["batch_stats"] = jax.tree.map(
            lambda a: noise(a) if a.mean() < 0.5 else
            jnp.asarray(np.asarray(a) + 0.2 * np.abs(rng.randn(*a.shape)),
                        jnp.float32), v["batch_stats"])
    return out


@contextlib.contextmanager
def no_dropout():
    """Every flax ``nn.Dropout`` is the identity inside the block."""
    def skip(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and \
                context.method_name == "__call__":
            return args[0]
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(skip):
        yield


def port_no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def close(got, want, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def close_trees(got, want, rtol=RTOL, atol=ATOL):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], k, rtol, atol)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def grads_as_flax(model, norm="BatchNorm"):
    """The port model's parameter gradients laid out as flax params."""
    grads = {k: p.grad for k, p in model.named_parameters()}
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(grads[k])
    return weights.state_dict_to_flax(model, norm=norm)["params"]


def round_trip_exact(model, variables, norm="BatchNorm"):
    """flax -> port -> flax gives every leaf back bit for bit."""
    weights.load_flax_variables(model, variables)
    back = flat(weights.state_dict_to_flax(model, norm=norm))
    want = flat(variables)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def n_params(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
