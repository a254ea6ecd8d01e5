"""The port's tensor-parallel layers (``chainermn_tpu_torch/parallel/
tensor.py``) against the JAX package's, on the CPU.

Twins of ``tests/test_tensor_expert_parallel.py``'s tensor-parallel tests,
on gloo worlds of 2 and 4 ranks (``torch_dist_worker.py`` mode ``tpep``)
against JAX's layers inside ``shard_map`` on a mesh of as many CPU devices,
rank r against device r's output, float32 within 1e-5:

* Column -> gelu -> Row from sliced dense weights (and the dense math);
* the gathered column output (JAX's psum of a position-scattered buffer)
  and its weight gradient (each rank its own columns of the cotangent);
* the gradients of ``sum(psum(gelu(x w1) w2)^2)`` against JAX's and the
  dense gradients (the psum's transpose: the cotangent passed through);
* ``TensorParallelMLP``'s output shape and its divisibility ``ValueError``,
  JAX's message.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker
from chainermn_tpu.parallel.tensor import (
    ColumnParallelDense as JCol, RowParallelDense as JRow,
    TensorParallelMLP as JMLP)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, D, H = 4, 16, 64
TOL = 1e-5
WORLDS = (2, 4)


def _weights(seed):
    rng = np.random.RandomState(seed)
    return dict(w1=rng.randn(D, H).astype(np.float32) * 0.2,
                b1=rng.randn(H).astype(np.float32) * 0.1,
                w2=rng.randn(H, D).astype(np.float32) * 0.2,
                b2=rng.randn(D).astype(np.float32) * 0.1,
                x=rng.randn(B, D).astype(np.float32))


def _jax_refs(p, w):
    """JAX's layers on a ``p``-device mesh: the same quantities as the
    worker's ``tp/*`` outputs (gradients sliced per device later)."""
    mesh = Mesh(np.array(jax.devices()[:p]), ("tp",))
    h = H // p
    w1, b1, w2, b2, x = (jnp.asarray(w[k]) for k in ("w1", "b1", "w2", "b2",
                                                     "x"))

    def mlp(w1l, b1l, w2l, b2l, xx):
        y = JCol(h, "tp").apply({"params": {"kernel": w1l, "bias": b1l}}, xx)
        return JRow(D, "tp").apply({"params": {"kernel": w2l, "bias": b2l}},
                                   nn.gelu(y))

    out = {"mlp": jax.jit(jax.shard_map(
        mlp, mesh=mesh, in_specs=(P(None, "tp"), P("tp"), P("tp", None), P(),
                                  P()), out_specs=P()))(w1, b1, w2, b2, x)}

    def gather(w1_, b1_):
        return jax.shard_map(
            lambda wl, bl, xx: JCol(h, "tp", gather_output=True).apply(
                {"params": {"kernel": wl, "bias": bl}}, xx),
            mesh=mesh, in_specs=(P(None, "tp"), P("tp"), P()),
            out_specs=P())(w1_, b1_, x)

    out["gather"] = jax.jit(gather)(w1, b1)
    out["gather_grad_w"] = jax.jit(jax.grad(
        lambda w_: (gather(w_, b1) ** 2).sum()))(w1)

    def tp_loss(w1_, w2_):
        def body(w1l, w2l, xx):
            return jax.lax.psum(jnp.dot(nn.gelu(jnp.dot(xx, w1l)), w2l),
                                "tp")
        o = jax.shard_map(body, mesh=mesh,
                          in_specs=(P(None, "tp"), P("tp", None), P()),
                          out_specs=P())(w1_, w2_, x)
        return (o ** 2).sum()

    out["g_w1"], out["g_w2"] = jax.jit(jax.grad(tp_loss, argnums=(0, 1)))(
        w1, w2)
    out["dense_g"] = jax.grad(
        lambda a, b: ((jnp.dot(nn.gelu(jnp.dot(x, a)), b)) ** 2).sum(),
        argnums=(0, 1))(w1, w2)
    bad = JMLP(hidden=H + 1, axis_name="tp")
    try:
        jax.jit(jax.shard_map(lambda xx: bad.init(jax.random.key(0), xx),
                              mesh=mesh, in_specs=P(), out_specs=P()))(x)
    except ValueError as e:
        out["module_err"] = str(e)
    return jax.tree.map(lambda v: np.asarray(v) if not isinstance(v, str)
                        else v, out)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    res = {}
    for p in WORLDS:
        w = _weights(p)
        outs = torch_dist_worker.launch(
            "tpep", {f"tp/{k}": v for k, v in w.items()}, p,
            tmp_path_factory.mktemp(f"tp{p}"))
        res[p] = (w, _jax_refs(p, w), outs)
    return res


def _slices(p, r):
    h = H // p
    return slice(r * h, (r + 1) * h)


@pytest.mark.parametrize("p", WORLDS)
def test_column_row_mlp_matches_jax_and_dense(worlds, p):
    w, ref, outs = worlds[p]
    dense = np.asarray(jnp.dot(nn.gelu(jnp.dot(w["x"], w["w1"]) + w["b1"]),
                               w["w2"]) + w["b2"])
    for out in outs:
        np.testing.assert_allclose(out["tp/mlp"], ref["mlp"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(out["tp/mlp"], dense, rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("p", WORLDS)
def test_column_gather_output_matches_jax(worlds, p):
    w, ref, outs = worlds[p]
    np.testing.assert_allclose(ref["gather"], w["x"] @ w["w1"] + w["b1"],
                               rtol=2e-5, atol=2e-5)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["tp/gather"], ref["gather"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["tp/gather_grad_w"],
                                   ref["gather_grad_w"][:, _slices(p, r)],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("p", WORLDS)
def test_tp_gradients_match_jax_and_dense(worlds, p):
    _, ref, outs = worlds[p]
    for r, out in enumerate(outs):
        sl = _slices(p, r)
        np.testing.assert_allclose(out["tp/g_w1"], ref["g_w1"][:, sl],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["tp/g_w2"], ref["g_w2"][sl],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["tp/g_w1"], ref["dense_g"][0][:, sl],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["tp/g_w2"], ref["dense_g"][1][sl],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p", WORLDS)
def test_tensor_parallel_mlp_module(worlds, p):
    """The module wrapper: the full output shape on every rank, the same
    on every rank (the row sum), and JAX's divisibility message."""
    w, ref, outs = worlds[p]
    for out in outs:
        assert out["tp/module"].shape == w["x"].shape
        assert np.abs(out["tp/module"]).sum() > 0
        np.testing.assert_array_equal(out["tp/module"],
                                      outs[0]["tp/module"])
        assert str(out["tp/module_err"]) == ref["module_err"]
