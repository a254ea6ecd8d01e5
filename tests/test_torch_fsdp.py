"""The port's FSDP (``chainermn_tpu_torch/parallel/fsdp.py``) against the
JAX package's, on the CPU.

One gloo world of four ranks (``torch_dist_worker.py`` mode ``fsdp``) runs
every multi-rank check; the JAX references run in this process on a
4-device CPU mesh.  Held:

* JAX ``tests/test_fsdp.py``'s MLP problem (flax weights, Adam at 1e-3,
  five steps on the same batch): losses within 1e-5 relative and
  parameters within 2e-5 of JAX's ``make_fsdp_train_step`` (Adam's
  per-element step at lr 1e-3, ROADMAP.md Queue C item 7);
* 4 buckets with prefetch 0 and 1 bit-equal to one bucket;
* the bfloat16 wire against JAX's bfloat16 wire within 5e-3 (ZeRO-1's
  bfloat16 tolerance; the wire rounds every gathered parameter);
* ``global_loss`` against the replicated objective of JAX's
  ``test_global_loss_matches_replicated`` (rtol 1e-6);
* a FusedBatchNormAct model against the plain data-parallel step, the
  running buffers rank-local; ``accum_steps=2`` against the full batch;
* a checkpoint resumed into a fresh state steps bit for bit as the
  uninterrupted state; resumes into another world size, bucket count or
  sharding mode are refused; consolidation (live, and by one process
  reading the four ranks' files through ``load_inference_params``) gives
  the gathered parameters bit for bit.

The refusals of ``fsdp_init`` and ``make_fsdp_train_step`` run in this
process on a world of one.
"""

import copy

import jax
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.parallel.fsdp import (
    fsdp_full_params as jfull, fsdp_init as jinit,
    make_fsdp_train_step as jstep)
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu.training import put_global_batch
from chainermn_tpu_torch import (
    create_communicator, create_multi_node_optimizer)
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.optim import LARS
from chainermn_tpu_torch.parallel import (
    FsdpState, fsdp_init, make_fsdp_meta, make_fsdp_train_step)
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from chainermn_tpu_torch.serving.weights import load_inference_params
from chainermn_tpu_torch.training import FsdpUpdater
from test_fsdp import _mlp_problem
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 4
RTOL, ATOL = 1e-5, 2e-5
BF16_TOL = 5e-3
GX_T = WORLD * 4


def _as_port(flax_params):
    """flax MLP leaves under the port's ``nn.Sequential`` names."""
    p = flax_params["params"]
    return {f"{j}.{kind}": (np.asarray(p[f"Dense_{i}"]["kernel"]).T
                            if kind == "weight"
                            else np.asarray(p[f"Dense_{i}"]["bias"]))
            for i, j in ((0, 0), (1, 2)) for kind in ("weight", "bias")}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's FSDP on the MLP problem (float32 and bfloat16 wires) and the
    replicated global-loss objective."""
    comm = jcreate("xla", mesh=init_topology(
        devices=jax.devices()[:WORLD]).mesh)
    params, loss_fn, data = _mlp_problem(comm)
    batch = put_global_batch(comm, data)
    runs = {}
    for name, wire in (("adam", None), ("bf16", "bfloat16")):
        state, meta = jinit(comm, params, optax.adam(1e-3))
        step = jstep(comm, loss_fn, optax.adam(1e-3), meta, donate=False,
                     wire_dtype=wire)
        losses = []
        for _ in range(5):
            state, loss = step(state, batch)
            losses.append(float(loss))
        runs[name] = (np.asarray(losses), _as_port(jfull(state, meta)))
    gx = np.random.RandomState(0).randn(2, GX_T).astype(np.float32)

    def ref_loss(w):
        return jax.numpy.mean((w[np.arange(GX_T) % 6][None, :] - gx) ** 2)

    w = jax.numpy.arange(6, dtype=jax.numpy.float32)
    glosses = []
    for _ in range(4):
        loss, g = jax.value_and_grad(ref_loss)(w)
        glosses.append(float(loss))
        w = w - 0.1 * g
    runs["global"] = (np.asarray(glosses), {"w": np.asarray(w)})
    return params, data, gx, runs


@pytest.fixture(scope="module")
def world(jax_ref, tmp_path_factory):
    params, (xs, ys), gx, _ = jax_ref
    p = params["params"]
    inputs = {f"mlp/Dense_{i}/{k}": np.asarray(p[f"Dense_{i}"][k])
              for i in (0, 1) for k in ("kernel", "bias")}
    ckpt_dir = tmp_path_factory.mktemp("fsdp_ckpt")
    inputs.update(x=np.asarray(xs), y=np.asarray(ys), gx=gx,
                  ckpt_dir=np.asarray(str(ckpt_dir)))
    outs = torch_dist_worker.launch("fsdp", inputs, WORLD,
                                    tmp_path_factory.mktemp("fsdp"))
    return inputs, outs, str(ckpt_dir)


def _params(out, cfg):
    pre = f"{cfg}/p/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _same_bits(a, b):
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_fsdp_matches_jax_fsdp(world, jax_ref):
    _, outs, _ = world
    jlosses, jparams = jax_ref[3]["adam"]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["k1/losses"], jlosses, rtol=RTOL)
        got = _params(out, "k1")
        assert got.keys() == jparams.keys()
        for k in jparams:
            np.testing.assert_allclose(got[k], jparams[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("cfg", ["k4d0", "k4d1"])
def test_buckets_and_prefetch_are_bit_equal(world, cfg):
    _, outs, _ = world
    for out in outs:
        assert _same_bits(out[f"{cfg}/losses"], out["k1/losses"])
        want = _params(out, "k1")
        for k, v in _params(out, cfg).items():
            assert _same_bits(v, want[k]), k


def test_bf16_wire_matches_jax_bf16_wire(world, jax_ref):
    _, outs, _ = world
    jlosses, jparams = jax_ref[3]["bf16"]
    for out in outs:
        np.testing.assert_allclose(out["bf16/losses"], jlosses,
                                   rtol=BF16_TOL)
        got = _params(out, "bf16")
        for k in jparams:
            np.testing.assert_allclose(got[k], jparams[k], rtol=BF16_TOL,
                                       atol=BF16_TOL)
        # the wire changed something: not the float32 run's bits
        assert not _same_bits(out["bf16/losses"], out["k1/losses"])


def test_global_loss_matches_replicated_objective(world, jax_ref):
    _, outs, _ = world
    jlosses, jparams = jax_ref[3]["global"]
    for out in outs:
        np.testing.assert_allclose(out["global/losses"], jlosses, rtol=1e-6)
        np.testing.assert_allclose(out["global/p/w"], jparams["w"],
                                   rtol=1e-6, atol=1e-7)


def test_step_counters(world):
    """gathers, reduce-scatters, wire casts, most gathers in flight."""
    _, outs, _ = world
    want = {"k1": [1, 1, 0, 1], "k4d0": [4, 4, 0, 1], "k4d1": [4, 4, 0, 2],
            "bf16": [2, 2, 8, 2], "accum2": [4, 4, 0, 2],
            "global": [1, 1, 0, 1]}
    for out in outs:
        for cfg, w in want.items():
            assert out[f"{cfg}/stats"].tolist() == w, cfg


def test_batchnorm_model_matches_plain_step(world):
    """FusedBatchNormAct under FSDP (two buckets, its pre-hook) against
    the plain data-parallel step: the same losses and parameters, and each
    rank's running buffers its own."""
    _, outs, _ = world
    for out in outs:
        np.testing.assert_allclose(out["bn_fsdp/losses"],
                                   out["bn_plain/losses"], rtol=1e-6)
        plain = _params(out, "bn_plain")
        for k, v in _params(out, "bn_fsdp").items():
            np.testing.assert_allclose(v, plain[k], rtol=1e-6, atol=1e-7)
        for k in ("1.running_mean", "1.running_var"):
            np.testing.assert_allclose(out[f"bn_fsdp/buf/{k}"],
                                       out[f"bn_plain/buf/{k}"], rtol=1e-6,
                                       atol=1e-7)
    assert not np.allclose(outs[0]["bn_fsdp/buf/1.running_mean"],
                           outs[1]["bn_fsdp/buf/1.running_mean"])


def test_accumulation_matches_full_batch(world):
    _, outs, _ = world
    for out in outs:
        np.testing.assert_allclose(out["accum2/losses"],
                                   out["accum1/losses"], rtol=1e-6)
        full = _params(out, "accum1")
        for k, v in _params(out, "accum2").items():
            np.testing.assert_allclose(v, full[k], rtol=1e-6, atol=1e-7)


def test_checkpoint_round_trip_is_bit_exact(world):
    _, outs, _ = world
    for out in outs:
        assert int(out["resumed/iteration"]) == 2
        assert _same_bits(out["resumed/losses"], out["straight/losses"])
        want = _params(out, "straight")
        for k, v in _params(out, "resumed").items():
            assert _same_bits(v, want[k]), k


@pytest.mark.parametrize("what,match", [
    ("buckets", "num_buckets=2 but the live FsdpState was built with "
                "num_buckets=1"),
    ("world", "world_size=4 but this world has comm.size=2"),
    ("unsharded", "holds an FSDP-sharded state"),
    ("sharded_target", "holds no FSDP-sharded state"),
])
def test_checkpoint_refusals(world, what, match):
    _, outs, _ = world
    for out in outs:
        assert match in str(out[f"refuse/{what}"])


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield create_communicator("naive", device="cpu")
    if created:
        dist.destroy_process_group()


def test_consolidation_by_one_process(world, world1):
    """Live consolidation gathers the saved parameters bit for bit; one
    process (a world of one) loads what the four ranks saved through
    ``load_inference_params(metas=)`` and gets the same bits."""
    inputs, outs, ckpt_dir = world
    for out in outs:
        want = _params(out, "saved")
        for k, v in _params(out, "live").items():
            assert _same_bits(v, want[k]), k
    model = torch_dist_worker.fsdp_mlp(inputs)
    metas = make_fsdp_meta(model, WORLD, num_buckets=2)
    state, _ = fsdp_init(world1, model, torch.optim.SGD(
        model.parameters(), lr=0.05, momentum=0.9), num_buckets=2)
    ckpt = create_multi_node_checkpointer(world1, ckpt_dir, name="fsdp")
    got = load_inference_params({"fsdp": state, "iteration": np.int64(0)},
                                metas, checkpointer=ckpt)
    assert int(got["iteration"]) == 2
    want = _params(outs[0], "saved")
    assert list(got["fsdp"]) == list(want)
    for k, v in got["fsdp"].items():
        assert _same_bits(v.numpy(), want[k]), k
    with pytest.raises(ValueError, match="does not match the metas"):
        load_inference_params({"fsdp": state}, make_fsdp_meta(
            torch_dist_worker.fsdp_mlp(inputs), WORLD, num_buckets=1),
            checkpointer=ckpt)


def _mlp():
    return torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))


@pytest.mark.parametrize("case,exc,match", [
    ("lars", ValueError, "layer-wise trust-ratio"),
    ("wrapper", TypeError, "not a create_multi_node_optimizer wrapper"),
    ("accum", ValueError, "accum_steps must be >= 1"),
    ("prefetch", ValueError, "prefetch must be >= 0"),
    ("int_wire", ValueError, "wire_dtype must be a floating dtype"),
    ("wire_list", ValueError, "bucket_wire_dtypes has 3 entries"),
    ("compressors", ValueError, "bucket_compressors has 3 entries"),
])
def test_refusals(world1, case, exc, match):
    m = _mlp()
    sgd = torch.optim.SGD(m.parameters(), lr=0.1)
    calls = {
        "lars": lambda: fsdp_init(world1, m, LARS(m.parameters(), lr=0.1)),
        "wrapper": lambda: fsdp_init(world1, m, create_multi_node_optimizer(
            sgd, world1)),
        "accum": lambda: make_fsdp_train_step(
            world1, None, *fsdp_init(world1, m, sgd), accum_steps=0),
        "prefetch": lambda: make_fsdp_train_step(
            world1, None, *fsdp_init(world1, m, sgd), prefetch=-1),
        "int_wire": lambda: make_fsdp_train_step(
            world1, None, *fsdp_init(world1, m, sgd), wire_dtype="int32"),
        "wire_list": lambda: fsdp_init(world1, m, sgd, num_buckets=2,
                                       bucket_wire_dtypes=[None] * 3),
        # quantized buckets are ported (A10): JAX's length-mismatch refusal
        "compressors": lambda: fsdp_init(world1, m, sgd, num_buckets=2,
                                         bucket_compressors=["int8"] * 3),
    }
    with pytest.raises(exc, match=match):
        calls[case]()


def test_lars_allowed_shard_wise_and_parameters_released(world1):
    """``allow_layerwise=True`` is JAX's escape; ``fsdp_init`` frees the
    module's parameter storage, keeping dtype and device."""
    m = _mlp()
    state, meta = fsdp_init(world1, m, LARS(m.parameters(), lr=0.1),
                            allow_layerwise=True, num_buckets=2)
    assert isinstance(state, FsdpState) and meta.num_buckets == 2
    assert all(p.numel() == 0 and p.dtype == torch.float32
               for p in m.parameters())
    assert sum(meta.shard_lens) == 3 * 4 + 4 + 4 * 2 + 2


def test_updater_params_property(world1):
    """``FsdpUpdater.params`` gathers the full parameters; assigning to it
    raises, as in JAX."""
    m = _mlp()
    want = {k: v.detach().clone() for k, v in m.named_parameters()}
    state, meta = fsdp_init(world1, m, torch.optim.SGD(m.parameters(),
                                                       lr=0.1))
    up = FsdpUpdater(None, None, state, meta, world1)
    got = up.params
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k])
    with pytest.raises(AttributeError, match="derived from the sharded"):
        up.params = want


def test_step_functions_leave_no_hooks(world1):
    """The bucketed schedule's forward pre-hooks live for a step only: two
    step functions over one state leave the module without hooks between
    steps, and their steps are those of plain SGD on the same model."""
    torch.manual_seed(0)
    m = _mlp()
    ref = copy.deepcopy(m)
    x, y = torch.randn(8, 3), torch.randn(8, 2)
    state, meta = fsdp_init(world1, m, torch.optim.SGD(m.parameters(),
                                                       lr=0.1), num_buckets=2)

    def loss_fn(batch):
        return ((m(batch[0]) - batch[1]) ** 2).mean()

    steps = [make_fsdp_train_step(world1, loss_fn, state, meta)
             for _ in range(2)]

    def hooks():
        return sum(len(mod._forward_pre_hooks) for mod in m.modules())

    assert hooks() == 0
    sgd = torch.optim.SGD(ref.parameters(), lr=0.1)
    for step in steps:
        got = step((x, y))
        assert hooks() == 0
        assert step.stats["gathers"] == 2
        sgd.zero_grad()
        want = ((ref(x) - y) ** 2).mean()
        want.backward()
        sgd.step()
        assert torch.allclose(got, want.detach(), rtol=1e-6, atol=0)
