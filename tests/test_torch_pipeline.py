"""The port's pipeline parallelism (``chainermn_tpu_torch/parallel/
pipeline.py``) against the JAX package's, on the CPU.

Gloo worlds of 4 and 2 ranks (``torch_dist_worker.py`` mode ``pipe``, one
stage a rank) run GPipe (``make_pipeline_fn``) and 1F1B
(``make_pipeline_train_fn``); the JAX references run in this process on a
CPU mesh of S devices, rank s held against slice ``[s]`` of JAX's stacked
stage parameters.  Cases (those of ``tests/test_pipeline.py``):

* the tanh stage: the forward; GPipe's gradients (the collect hands the
  last stage one copy of the cotangent); M 1; 1F1B's loss and gradients;
  1F1B equal to GPipe's autograd; M = 8S, the ring's slots reused;
  ``collect="last"`` zero off the last stage;
* a stage of two transformer ``Block`` s at d 64, T 32, weights from the
  stacked flax tree through ``weights.flax_stage_to_state_dict`` (JAX's
  blocks with ``attention_impl="xla"``);
* the memory property: at M = 8S the bytes held by autograd's saved
  tensors peak lower under 1F1B than under GPipe.

Tolerances are JAX's own: 1e-5 on outputs and losses, 1e-4 on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist_worker
from chainermn_tpu.models.transformer import Block as JBlock
from chainermn_tpu.parallel.pipeline import (
    make_pipeline_fn as jpipe, make_pipeline_train_fn as jtrain)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

M, MB, DIM = 8, 4, 16
BLK = dict(d=64, heads=4, t=32, m=4)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _tanh(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _mse(y, t):
    return ((y - t) ** 2).mean()


def _jblock_stage(params, x):
    for i in range(2):
        x = JBlock(n_heads=BLK["heads"]).apply(
            {"params": params[f"block_{i}"]}, x)
    return x


def _inputs(s):
    rng = np.random.RandomState(s)
    inp = {"w": (rng.randn(s, DIM, DIM) * 0.4).astype(np.float32),
           "b": (rng.randn(s, DIM) * 0.1).astype(np.float32),
           "x": rng.randn(M * MB, DIM).astype(np.float32),
           "t": rng.randn(M * MB, DIM).astype(np.float32),
           "xbig": rng.randn(8 * s * MB, DIM).astype(np.float32),
           "tbig": rng.randn(8 * s * MB, DIM).astype(np.float32),
           "m": np.int64(M)}
    d, t, bm = BLK["d"], BLK["t"], BLK["m"]
    x0 = jnp.zeros((1, t, d), jnp.float32)
    trees = [JBlock(n_heads=BLK["heads"]).init(jax.random.key(10 * i + j),
                                               x0)["params"]
             for i in range(s) for j in range(2)]
    stacked = {f"block_{j}": jax.tree.map(
        lambda *a: np.stack([np.asarray(v) for v in a]),
        *[trees[2 * i + j] for i in range(s)]) for j in range(2)}
    inp.update(torch_dist_worker.flatten(stacked, "blk"))
    inp.update(bx=(rng.randn(bm, t, d)).astype(np.float32),
               bt=(rng.randn(bm, t, d)).astype(np.float32),
               bm=np.int64(bm), blk_d=np.int64(d),
               blk_heads=np.int64(BLK["heads"]))
    return inp, stacked


@pytest.fixture(scope="module", params=[4, 2], ids=["S4", "S2"])
def world(request, tmp_path_factory):
    s = request.param
    inp, stacked = _inputs(s)
    outs = torch_dist_worker.launch("pipe", inp, s,
                                    tmp_path_factory.mktemp(f"pipe{s}"))
    mesh = Mesh(np.array(jax.devices()[:s]), ("pp",))
    return s, inp, stacked, outs, mesh


def _stacked(inp):
    return jnp.asarray(inp["w"]), jnp.asarray(inp["b"])


def test_forward_matches_jax(world):
    s, inp, _, outs, mesh = world
    want = np.asarray(jpipe(_tanh, mesh, "pp", n_microbatches=M)(
        _stacked(inp), jnp.asarray(inp["x"])))
    for out in outs:
        np.testing.assert_allclose(out["fwd"], want, **OUT_TOL)


def test_gpipe_gradients_match_jax(world):
    """The collect's backward hands the last stage one copy of the
    cotangent: every rank's loss backward gives JAX's gradients (W copies
    would scale the last stage's by S)."""
    s, inp, _, outs, mesh = world
    fn = jpipe(_tanh, mesh, "pp", n_microbatches=M)
    x = jnp.asarray(inp["x"])
    gw, gb = jax.grad(lambda p: (fn(p, x) ** 2).sum())(_stacked(inp))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["gpipe/w"], np.asarray(gw)[r],
                                   **GRAD_TOL)
        np.testing.assert_allclose(out["gpipe/b"], np.asarray(gb)[r],
                                   **GRAD_TOL)


def test_single_microbatch_is_chainlist_depth(world):
    s, inp, _, outs, mesh = world
    x = jnp.asarray(inp["x"][:MB])
    want = np.asarray(jpipe(_tanh, mesh, "pp", n_microbatches=1)(
        _stacked(inp), x))
    for out in outs:
        np.testing.assert_allclose(out["m1"], want, **OUT_TOL)


def test_1f1b_loss_and_grads_match_jax(world):
    s, inp, _, outs, mesh = world
    loss, (gw, gb) = jtrain(_tanh, _mse, mesh, "pp", n_microbatches=M)(
        _stacked(inp), jnp.asarray(inp["x"]), jnp.asarray(inp["t"]))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["1f1b/loss"], float(loss), **OUT_TOL)
        np.testing.assert_allclose(out["1f1b/w"], np.asarray(gw)[r],
                                   **GRAD_TOL)
        np.testing.assert_allclose(out["1f1b/b"], np.asarray(gb)[r],
                                   **GRAD_TOL)


def test_1f1b_matches_gpipe_autograd(world):
    for out in world[3]:
        for k in ("w", "b"):
            np.testing.assert_allclose(out[f"1f1b/{k}"],
                                       out[f"gpipe_mse/{k}"], **GRAD_TOL)


def test_many_microbatches_reuse_the_ring(world):
    """M = 8S: every slot of the 2S ring is reused many times."""
    s, inp, _, outs, mesh = world
    loss, (gw, gb) = jtrain(_tanh, _mse, mesh, "pp", n_microbatches=8 * s)(
        _stacked(inp), jnp.asarray(inp["xbig"]), jnp.asarray(inp["tbig"]))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["big/loss"], float(loss), **OUT_TOL)
        np.testing.assert_allclose(out["big/w"], np.asarray(gw)[r],
                                   **GRAD_TOL)
        np.testing.assert_allclose(out["big/b"], np.asarray(gb)[r],
                                   **GRAD_TOL)


def test_saved_tensor_high_water_mark_below_gpipe(world):
    for out in world[3]:
        assert 0 < int(out["mem/1f1b"]) < int(out["mem/gpipe"]), (
            int(out["mem/1f1b"]), int(out["mem/gpipe"]))


def test_collect_last_only_on_final_stage(world):
    s, inp, _, outs, _ = world
    w, b = inp["w"], inp["b"]
    want = inp["x"]
    for i in range(s):
        want = np.tanh(want @ w[i] + b[i])
    for r, out in enumerate(outs):
        got = out["last"].reshape(-1, DIM)
        if r < s - 1:
            assert not got.any()
        else:
            np.testing.assert_allclose(got, want, **OUT_TOL)


def test_block_stage_forward_matches_jax(world):
    s, inp, stacked, outs, mesh = world
    want = np.asarray(jpipe(_jblock_stage, mesh, "pp",
                            n_microbatches=BLK["m"])(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(inp["bx"])))
    for out in outs:
        np.testing.assert_allclose(out["blk/fwd"], want, **OUT_TOL)


def test_block_stage_1f1b_matches_jax(world):
    s, inp, stacked, outs, mesh = world
    loss, grads = jtrain(_jblock_stage, _mse, mesh, "pp",
                         n_microbatches=BLK["m"])(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(inp["bx"]),
        jnp.asarray(inp["bt"]))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["blk/1f1b/loss"], float(loss),
                                   **OUT_TOL)
        got = {k[len("blk/1f1b/g/"):]: v for k, v in out.items()
               if k.startswith("blk/1f1b/g/")}
        assert len(got) == 2 * 12
        for name, v in got.items():
            i, layer, kind = name.split(".")
            leaf = grads[f"block_{i}"][layer]
            if kind == "weight":
                want = np.asarray(leaf["kernel" if "kernel" in leaf
                                       else "scale"])[r]
                want = want.T if want.ndim == 2 else want
            else:
                want = np.asarray(leaf["bias"])[r]
            np.testing.assert_allclose(v, want, err_msg=name, **GRAD_TOL)


def test_stage_must_keep_the_activation_shape():
    import torch
    from chainermn_tpu_torch.parallel.pipeline import _run_stage
    with pytest.raises(ValueError, match="homogeneous"):
        _run_stage(lambda p, a: a[:, :2], None, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="homogeneous"):
        _run_stage(lambda p, a: a.double(), None, torch.zeros(3, 4))


def test_flax_stage_map_refuses_other_trees():
    from chainermn_tpu_torch.weights import flax_stage_to_state_dict
    with pytest.raises(ValueError, match="block_0"):
        flax_stage_to_state_dict({"dense": {}}, 0)
