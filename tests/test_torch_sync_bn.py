"""``links.MultiNodeBatchNormalization`` against BatchNorm over the
concatenated batch in one process.

A 2-process gloo world (``torch_dist_worker.py`` mode ``syncbn``), each rank
holding a batch of 4 drawn with its own mean and scale, so local and global
statistics differ.  The single process is flax ``nn.BatchNorm`` (momentum
0.9, epsilon 2e-5: the JAX package's ``MultiNodeBatchNormalization``
without its axis binding) over the 8 rows, differentiated with
``jax.grad``.  Rank r's output and input gradient equal rows 4r..4r+3 of
the single process's, the two ranks' parameter gradients sum to its
parameter gradients, and the running statistics after two steps (flax's
biased variance) and the eval-mode output equal its, within 1e-5
(float32), for ``[N, C]`` and ``[N, C, H, W]`` inputs.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD, B, C = 2, 4, 6
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.RandomState(0)
    scale = np.arange(1, WORLD + 1, dtype=np.float32).reshape(-1, 1, 1)
    x = rng.randn(WORLD, B, C).astype(np.float32) * scale + scale
    x4 = (rng.randn(WORLD, B, C, 3, 2).astype(np.float32)
          * scale[..., None, None] - scale[..., None, None])
    inputs = {"x": x, "x4": x4,
              "w": rng.randn(C).astype(np.float32),
              "b": rng.randn(C).astype(np.float32),
              "gy": rng.randn(*x.shape).astype(np.float32),
              "gy4": rng.randn(*x4.shape).astype(np.float32)}
    outs = torch_dist_worker.launch("syncbn", inputs, WORLD,
                                    tmp_path_factory.mktemp("syncbn"))
    return inputs, outs


def _channels_last(a):
    """[N, C, ...] -> [N, ..., C] (flax normalizes the last axis)."""
    return np.moveaxis(a, 1, -1)


def _single_process(inputs, key):
    """flax over the concatenated batch: output, gradients, the running
    statistics after two steps, and the eval output of the local rows."""
    xs = inputs[key].reshape((-1,) + inputs[key].shape[2:])
    gy = inputs["gy4" if key == "x4" else "gy"].reshape(xs.shape)
    x, g = jnp.asarray(_channels_last(xs)), jnp.asarray(_channels_last(gy))
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=2e-5)
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}
    params = {"scale": jnp.asarray(inputs["w"]),
              "bias": jnp.asarray(inputs["b"])}

    def loss(p, x_):
        y, _ = bn.apply({"params": p, "batch_stats": stats}, x_,
                        mutable=["batch_stats"])
        return jnp.sum(y * g), y

    (_, y), (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(params, x)
    for _ in range(2):
        _, mut = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        stats = mut["batch_stats"]
    y_eval = nn.BatchNorm(use_running_average=True, epsilon=2e-5).apply(
        {"params": params, "batch_stats": stats}, x)
    back = lambda a: np.moveaxis(np.asarray(a), -1, 1).reshape(  # noqa
        inputs[key].shape)
    return {"y": back(y), "dx": back(dx), "dw": np.asarray(dp["scale"]),
            "db": np.asarray(dp["bias"]),
            "running_mean": np.asarray(stats["mean"]),
            "running_var": np.asarray(stats["var"]), "eval": back(y_eval)}


@pytest.mark.parametrize("key", ["x", "x4"])
def test_matches_one_process_over_the_concatenated_batch(world, key):
    inputs, outs = world
    want = _single_process(inputs, key)
    for r, out in enumerate(outs):
        for name in ("y", "dx", "eval"):
            np.testing.assert_allclose(out[f"{key}/{name}"], want[name][r],
                                       err_msg=f"{name} rank {r}", **TOL)
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(out[f"{key}/{name}"], want[name],
                                       err_msg=f"{name} rank {r}", **TOL)
    for name in ("dw", "db"):
        np.testing.assert_allclose(outs[0][f"{key}/{name}"]
                                   + outs[1][f"{key}/{name}"], want[name],
                                   err_msg=name, **TOL)


def test_local_statistics_would_differ(world):
    """The collective changes the numbers: BatchNorm over rank 0's rows
    alone is far from the synchronized output."""
    inputs, outs = world
    x = inputs["x"][0]
    local = (x - x.mean(0)) / np.sqrt(x.var(0) + 2e-5) * inputs["w"] \
        + inputs["b"]
    assert not np.allclose(outs[0]["x/y"], local, atol=1e-3)
