"""The port's gradient compression (``chainermn_tpu_torch/compression/`` and
its seams) against the JAX package's, on the CPU.

Gloo worlds of four and two ranks (``torch_dist_worker.py`` mode
``compress``) run the multi-rank checks; the JAX references run in this
process on CPU meshes of the same sizes.  Held:

* bit for bit against JAX in deterministic mode on a world of 4: int8 and
  fp8 ``allreduce_grad(compressor=, state=)`` over 3 EF steps -- each
  rank's wire (codes, then the saturation flags), its residual, exponents
  and step, and the means;
* the fp8 in-wire sum (bytes through an all-to-all, a float16 sum in rank
  order from +0, one rounding, an all-gather) against JAX's ``psum`` of
  e4m3fn codes at W 2, 4 and over the (inter, intra) pair 2 x 2;
* torch's float16 -> e4m3fn cast (``to_e4m3fn``) against ml_dtypes for
  every finite float16 pattern; clip limits and ``wire_bits_per_param``
  exactly JAX's;
* JAX's contracts on the port's worlds: stochastic unbiasedness, EF decay,
  the optimizer seam's int8/fp8 trajectories against uncompressed (and
  ``NoCompression(bf16)`` bit-equal to the dtype knob), FSDP's quantized
  buckets, the two-process MNIST int8 contract;
* one quantized bucket's compressed reduce-scatter bit for bit against
  JAX's ``_make_compressed_gather`` on the same flat buffers;
* the checkpoint sidecar's three refusals and the round trip that
  continues; per-channel int8 weights bit for bit against JAX.

Stochastic rounding draws from another generator than JAX's threefry, so
its bits are held by JAX's property tests only.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker
from chainermn_tpu.communicators import _packing as jpacking
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.compression import (
    CompressionState as JState, Fp8Compressor as JFp8,
    Int8Compressor as JInt8)
from chainermn_tpu.compression import quantize as jq
from chainermn_tpu.parallel import fsdp as jfsdp
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch import (
    create_communicator, create_multi_node_optimizer)
from chainermn_tpu_torch.compression import (
    CompressionState, Fp8Compressor, Int8Compressor, NoCompression,
    available_compressors, compression_layout, resolve_compressor,
    wire_bits_per_param)
from chainermn_tpu_torch.compression import quantize as tq
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.optim import init_optimizer_state
from chainermn_tpu_torch.parallel import fsdp_init, make_fsdp_train_step
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 4
L_RS = 96          # the reduce-scatter check's shard length
N_SUM = 4096       # codes a rank in the summation checks


def _ef_grads(rng, w):
    return {"w": (rng.randn(w, 40, 50) * 0.01).astype(np.float32),
            "b": (rng.randn(w, 77) * 3).astype(np.float32)}


def _codes(rng, w):
    """Each rank's float8_e4m3fn codes as bytes, within the clip
    ``448 / w``, with zeros and negative zeros among them."""
    x = (rng.randn(w, N_SUM) * 10.0 ** rng.uniform(-3, 2, (w, N_SUM)))
    x = np.clip(x, -448 / w, 448 / w).astype(np.float32)
    x[:, :64] = 0.0
    x[:, 64:128] = -0.0
    x[:2, 128:192] = -0.0
    return x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)


def _opt_inputs(rng):
    """The JAX compression tests' MLP problem (4 tanh layers of 16)."""
    inp = {}
    for i in range(4):
        inp[f"opt/layer{i}/w"] = (rng.randn(16, 16) / 4.0).astype(np.float32)
        inp[f"opt/layer{i}/b"] = (rng.randn(16) / 4.0).astype(np.float32)
    inp["opt/x"] = rng.randn(W * 4, 16).astype(np.float32)
    inp["opt/y"] = np.tanh(rng.randn(W * 4, 16)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.RandomState(0)
    inp = {f"ef/{k}": v for k, v in _ef_grads(rng, W).items()}
    inp["sum/codes"] = _codes(rng, W)
    inp.update({"decay/w": rng.randn(W, 3, 4).astype(np.float32),
                "decay/b": rng.randn(W, 7).astype(np.float32)})
    inp.update(_opt_inputs(np.random.RandomState(0)))
    inp["rs/ef"] = (rng.randn(W, W * L_RS) * 1e-3).astype(np.float32)
    inp["rs/scale"] = np.asarray([-7.0, -6.0, -8.0, -7.0], np.float32)
    inp["rs/ct"] = (rng.randn(W, W * L_RS) * 0.02).astype(np.float32)
    inp["parts"] = np.asarray("ef,nc,sum,contracts,opt,fsdp")
    outs = torch_dist_worker.launch("compress", inp, W,
                                    tmp_path_factory.mktemp("compress4"))
    return inp, outs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    rng = np.random.RandomState(1)
    tmp = tmp_path_factory.mktemp("compress2")
    inp = {"sum/codes": _codes(rng, 2), "parts": np.asarray("sum,mnist"),
           "out_dir": np.asarray(str(tmp))}
    return inp, torch_dist_worker.launch("compress", inp, 2, tmp)


@pytest.fixture(scope="module")
def jcomm4():
    return jcreate("flat", mesh=init_topology(
        devices=jax.devices()[:W]).mesh)


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield create_communicator("flat", device="cpu")
    if created:
        dist.destroy_process_group()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(
        {2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


# ---- resolver / registry / spec ---------------------------------------------

def test_registry_names():
    assert {"none", "int8", "fp8"} <= set(available_compressors())


def test_resolve_forms():
    assert resolve_compressor(None) is None
    c = Int8Compressor(chunk_size=256, stochastic=False)
    assert resolve_compressor(c) is c
    assert isinstance(resolve_compressor("int8"), Int8Compressor)
    assert isinstance(resolve_compressor("fp8"), Fp8Compressor)
    nc = resolve_compressor("bfloat16")
    assert isinstance(nc, NoCompression) and nc.wire == torch.bfloat16
    assert resolve_compressor(torch.float16).wire == torch.float16
    assert isinstance(resolve_compressor({"name": "int8", "chunk_size": 8}),
                      Int8Compressor)


@pytest.mark.parametrize("make", [
    lambda m: m.NoCompression(), lambda m: m.NoCompression("bfloat16"),
    lambda m: m.Int8Compressor(chunk_size=256, stochastic=False, seed=3),
    lambda m: m.Fp8Compressor()])
def test_spec_round_trip_and_jax_spec(make):
    """Specs round-trip and equal the JAX package's spec strings, so
    checkpoint sidecars name compressors alike."""
    import chainermn_tpu.compression as jm
    import chainermn_tpu_torch.compression as tm
    c = make(tm)
    again = resolve_compressor(c.spec)
    assert again == c and again.spec == c.spec
    assert c.spec == make(jm).spec


@pytest.mark.parametrize("value,exc", [
    ("zstd", ValueError), (3.0, TypeError), ({"name": "lz4"}, ValueError)])
def test_unknown_compressors_raise(value, exc):
    with pytest.raises(exc):
        resolve_compressor(value)


def test_nocompression_rejects_int_wire():
    with pytest.raises(ValueError, match="quantizer"):
        NoCompression(wire_dtype="int8")


def test_facade_exports():
    import chainermn_tpu_torch as cmn
    for name in ("Compressor", "NoCompression", "Int8Compressor",
                 "Fp8Compressor", "CompressionState", "resolve_compressor",
                 "available_compressors", "pipeline_apply",
                 "pipeline_1f1b", "make_pipeline_fn",
                 "make_pipeline_train_fn"):
        assert hasattr(cmn, name), name


# ---- the wire's arithmetic ---------------------------------------------------

def test_float16_to_e4m3fn_table():
    """``to_e4m3fn`` gives ml_dtypes' bits for every finite float16
    pattern (torch's own cast saturates to 448 where ml_dtypes gives NaN,
    past magnitude 464)."""
    f16 = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(
        np.float16)
    f16 = f16[np.isfinite(f16)]
    want = f16.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = tq.to_e4m3fn(torch.from_numpy(f16.copy())).view(
        torch.uint8).numpy()
    assert np.array_equal(got, want)


def test_float32_to_e4m3fn_within_the_clip():
    rng = np.random.RandomState(3)
    x = (rng.randn(200000) * 10.0 ** rng.uniform(-4, 3, 200000))
    x = np.clip(x, -448, 448).astype(np.float32)
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = tq.to_e4m3fn(torch.from_numpy(x)).view(torch.uint8).numpy()
    assert np.array_equal(got, want)


def _jax_psum(codes, shape, axes):
    mesh = Mesh(np.array(jax.devices()[:codes.shape[0]]).reshape(shape),
                axes)
    spec = P(axes)
    f = jax.jit(jax.shard_map(lambda v: jax.lax.psum(v[0], axes)[None],
                              mesh=mesh, in_specs=spec, out_specs=spec))
    return np.asarray(f(jnp.asarray(codes.view(ml_dtypes.float8_e4m3fn))))


@pytest.mark.parametrize("case", ["w2", "w4", "w2x2"])
def test_fp8_sum_rule_matches_jax_psum(case, world2, world4):
    inp, outs = world2 if case == "w2" else world4
    codes = inp["sum/codes"]
    w = codes.shape[0]
    shape, axes = {"w2": ((2,), ("x",)), "w4": ((4,), ("x",)),
                   "w2x2": ((2, 2), ("inter", "intra"))}[case]
    want = _jax_psum(codes, shape, axes).view(np.uint8)
    key = "sum/hier" if case == "w2x2" else "sum/flat"
    for r in range(w):
        assert np.array_equal(outs[r][key], want[r]), (case, r)
    # the one-process rule is the same function of the codes
    got = tq.sum_wire(torch.from_numpy(codes).view(torch.float8_e4m3fn),
                      torch.float8_e4m3fn).view(torch.uint8).numpy()
    assert np.array_equal(got, want[0])


@pytest.mark.parametrize("w", [1, 2, 4, 8, 42, 63, 64, 100, 224, 225])
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_clip_limits_match_jax(name, w):
    tc = resolve_compressor(name)
    jc = {"int8": JInt8, "fp8": JFp8}[name]()
    try:
        want = (jc.clip_limit(w), jc.effective_clip(w))
    except ValueError as e:
        with pytest.raises(ValueError, match="fp8" if name == "int8"
                           else "max_code"):
            tc.clip_limit(w)
        assert "too few code levels" in str(e)
        return
    assert (tc.clip_limit(w), tc.effective_clip(w)) == want


@pytest.mark.parametrize("length", [1, 1000, 1024, 1025, 25557032])
@pytest.mark.parametrize("name", ["int8", "fp8", "none"])
def test_wire_bits_per_param_exact(name, length):
    tc = resolve_compressor(name)
    jc = {"int8": JInt8(), "fp8": JFp8(), "none": None}[name]
    assert wire_bits_per_param(tc, length, 4) == jq.wire_bits_per_param(
        jc, length, 4)
    if name == "int8" and length == 25557032:
        assert abs(wire_bits_per_param(tc, length) - 8.008) < 1e-3


def test_generator_seed_is_replayable():
    a = Int8Compressor(seed=3).uniform((64,), 5, 1, "cpu")
    assert torch.equal(a, Int8Compressor(seed=3).uniform((64,), 5, 1, "cpu"))
    assert not torch.equal(a, Int8Compressor(seed=3).uniform((64,), 5, 2,
                                                             "cpu"))
    assert not torch.equal(a, Int8Compressor(seed=3).uniform((64,), 6, 1,
                                                             "cpu"))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


# ---- allreduce_grad: bit for bit against JAX --------------------------------

@pytest.fixture(scope="module")
def jax_ef(world4, jcomm4):
    """JAX's 3 EF steps of each quantizer on the same gradients: each
    rank's wire, state and means."""
    inp, _ = world4
    grads = {k[3:]: jnp.asarray(inp[k]) for k in inp if k.startswith("ef/")}
    out = {}
    for jc in (JInt8(chunk_size=256, stochastic=False),
               JFp8(chunk_size=256, stochastic=False)):
        st = jcomm4.init_compression_state(
            {k: v[0] for k, v in grads.items()}, jc)
        st = jax.tree.map(lambda a: jnp.broadcast_to(a, (W,) + a.shape), st)

        def fn(g, s, jc=jc):
            buf = jpacking.pack(g, comm_dtype=jnp.float32)[0][0]
            codes, _ = jc.compress(buf, s, rank=jcomm4.axis_index(),
                                   world_size=W)
            mean, s2 = jcomm4.allreduce_grad(g, compressor=jc, state=s)
            return codes, mean, s2

        for step in range(3):
            codes, mean, st = jcomm4.run_spmd(fn, grads, st)
            out[(jc.name, step)] = (np.asarray(codes), mean, st)
    return out


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_allreduce_grad_bit_exact_against_jax(world4, jax_ef, name, step):
    _, outs = world4
    codes, mean, st = jax_ef[(name, step)]
    pre = f"ef/{name}/{step}"
    for r, out in enumerate(outs):
        assert np.array_equal(out[f"{pre}/wire"].view(np.uint8),
                              _bits(codes[r])), f"wire rank {r}"
        for k in ("ef", "scale", "step"):
            assert _same_bits(out[f"{pre}/{k}"], getattr(st, k)[r]), (k, r)
        for k in mean:
            assert _same_bits(out[f"{pre}/mean/{k}"], mean[k][r]), (k, r)


def test_nocompression_is_the_dtype_knob(world4, jcomm4):
    """``NoCompression("bfloat16")`` on a plain flavor gives the knob's
    bits; ``NoCompression()`` is the plain path.  Against JAX's knob the
    bfloat16 sums' order differs (gloo against XLA's CPU reduction), so
    within the wire's rounding."""
    inp, outs = world4
    grads = {k[3:]: jnp.asarray(inp[k]) for k in inp if k.startswith("ef/")}
    jk = jcreate("xla", mesh=jcomm4.mesh, allreduce_grad_dtype="bfloat16")
    want = jk.run_spmd(lambda g: jk.allreduce_grad(g), grads)
    for r, out in enumerate(outs):
        for k in ("w", "b"):
            assert _same_bits(out[f"nc/comp/{k}"], out[f"nc/knob/{k}"])
            assert _same_bits(out[f"nc/bare/{k}"], out[f"nc/plain/{k}"])
            ref = np.asarray(want[k][r])
            np.testing.assert_allclose(out[f"nc/comp/{k}"], ref,
                                       rtol=2 ** -6,
                                       atol=2 ** -6 * np.abs(ref).max())


def test_fp8_route_on_the_hierarchical_flavor(world4, jax_ef):
    """The fp8 mean through the (inter, intra) = 2 x 2 flavor is the
    flat one's, as JAX's psum over both axes is."""
    _, outs = world4
    _, mean, _ = jax_ef[("fp8", 0)]
    for r, out in enumerate(outs):
        assert _same_bits(out["sum/hier_mean"], mean["w"][r])


def test_quantizer_without_state_and_mis_sized_state_raise(world1):
    g = {"w": torch.zeros(40, 40)}
    with pytest.raises(ValueError, match="init_compression_state"):
        world1.allreduce_grad(g, compressor="int8")
    wrong = world1.init_compression_state({"tiny": torch.zeros(3)},
                                          Int8Compressor())
    with pytest.raises(ValueError, match="init_compression_state"):
        world1.allreduce_grad(g, compressor="int8", state=wrong)
    assert world1.init_compression_state(g, "bfloat16") is None


def test_communicator_compression_kwarg(world1):
    c = create_communicator("xla", device="cpu", compression="bfloat16")
    assert c.allreduce_grad_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="allreduce_grad_dtype"):
        create_communicator("xla", device="cpu",
                            allreduce_grad_dtype="float16",
                            compression="bfloat16")
    with pytest.raises(ValueError, match="allreduce_grad_dtype"):
        create_communicator("flat", device="cpu", compression="bfloat16")
    q = create_communicator("hierarchical", device="cpu",
                            compression="int8")
    assert isinstance(q.compression, Int8Compressor)
    g = {"w": torch.randn(5)}
    st = q.init_compression_state(g)
    mean, st2 = q.allreduce_grad(g, state=st)
    assert float(st2.step[0]) == 1.0 and float(st.step[0]) == 0.0


# ---- JAX's contracts on the port's worlds ------------------------------------

def test_int8_time_averaged_error_decays(world4):
    """Deterministic EF on a constant stream: the time-averaged mean
    converges at 1/t, the residual stays bounded."""
    for out in world4[1]:
        errs = out["decay/errs"]
        assert all(a > b for a, b in zip(errs, errs[1:])), errs
        assert errs[0] / errs[-1] >= 8.0, errs
        assert np.isfinite(out["decay/ef_norm"]) and \
            out["decay/ef_norm"] < 10.0


def test_stochastic_rounding_unbiased(world4):
    for out in world4[1]:
        assert out["unbiased/err"] < 0.05


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_optimizer_seam_trains_close_to_uncompressed(world4, name):
    for out in world4[1]:
        base, q = out["opt/base/losses"], out[f"opt/{name}/losses"]
        assert q[-1] < q[0]
        assert abs(q[-1] - base[-1]) < 0.1 * abs(base[0]), (base, q)
        assert float(out[f"opt/{name}/comp_step"][0]) == 12.0
    # globally synchronous: every rank saw the same losses
    assert all(np.array_equal(o[f"opt/{name}/losses"],
                              world4[1][0][f"opt/{name}/losses"])
               for o in world4[1])


def test_optimizer_nocompression_matches_dtype_knob_trajectory(world4):
    for out in world4[1]:
        assert np.array_equal(out["opt/knob/losses"],
                              out["opt/nocomp/losses"])
        for k in [k for k in out if k.startswith("opt/knob/p/")]:
            assert _same_bits(out[k], out[k.replace("knob", "nocomp")]), k
        assert out["opt/knob/warned"] and not out["opt/nocomp/warned"]


@pytest.mark.parametrize("kw,exc,match", [
    (dict(compression="int8", zero=True), NotImplementedError,
     "bucket_compressors"),
    (dict(compression="fp8", double_buffering=True), NotImplementedError,
     "error feedback"),
    (dict(compression=NoCompression("bfloat16"), double_buffering=True),
     NotImplementedError, "allreduce_grad_dtype"),
    (dict(compression="zstd"), ValueError, "unknown compressor"),
])
def test_optimizer_refusals(world1, kw, exc, match):
    w = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(exc, match=match):
        create_multi_node_optimizer(torch.optim.Adam([w], lr=1e-3), world1,
                                    **kw)


def test_raw_dtype_knob_deprecation_names_replacement(world1):
    c = create_communicator("xla", device="cpu",
                            allreduce_grad_dtype="bfloat16")
    w = torch.nn.Parameter(torch.zeros(2))
    with pytest.warns(DeprecationWarning, match="NoCompression"):
        create_multi_node_optimizer(torch.optim.Adam([w], lr=1e-3), c)


# ---- FSDP's quantized buckets ----------------------------------------------

def test_fsdp_int8_buckets_train_and_report_layout(world4):
    for out in world4[1]:
        losses = out["fsdp/int8/losses"]
        assert losses[-1] < losses[0], losses
        assert out["fsdp/int8/quantized"].all()
        assert any("int8" in s for s in json.loads(
            str(out["fsdp/int8/specs"])))
        assert (out["fsdp/int8/ef_steps"] == 12.0).all()


def test_fsdp_mixed_buckets_quantize_only_where_asked(world4):
    for out in world4[1]:
        assert out["fsdp/mixed/quantized"].tolist() == [True, False]
        losses = out["fsdp/mixed/losses"]
        assert losses[-1] < losses[0]
        # the int8 bucket's reduce-scatter moves a quarter of the bytes
        assert out["fsdp/mixed/scatter_bytes"] < \
            out["fsdp/int8/scatter_bytes"] * 4


def _tanh_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(16, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 16))


@pytest.mark.parametrize("case,exc,match", [
    ("accum", NotImplementedError, "accum"),
    ("length", ValueError, "bucket_compressors has 1 entries"),
    ("wire", ValueError, "conflicts"),
    ("mixed_dtype", NotImplementedError, "single float packed buffer"),
])
def test_fsdp_refusals(world1, case, exc, match):
    m = _tanh_model()
    opt = torch.optim.Adam(m.parameters(), lr=0.01)
    calls = {
        "accum": lambda: make_fsdp_train_step(
            world1, None, *fsdp_init(world1, m, opt, num_buckets=2,
                                     bucket_compressors="int8"),
            accum_steps=2),
        "length": lambda: fsdp_init(world1, m, opt, num_buckets=3,
                                    bucket_compressors=["int8"]),
        "wire": lambda: fsdp_init(
            world1, m, opt, num_buckets=1, bucket_wire_dtypes=["float16"],
            bucket_compressors=NoCompression("bfloat16")),
        "mixed_dtype": lambda: fsdp_init(world1, _mixed(), opt,
                                         bucket_compressors="int8"),
    }
    with pytest.raises(exc, match=match):
        calls[case]()


def _mixed():
    m = _tanh_model()
    m[2].to(torch.bfloat16)
    return m


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_bucket_reduce_scatter_bit_exact_against_jax(world4, name):
    """One bucket's compressed reduce-scatter (JAX
    ``_make_compressed_gather``'s backward) on the same flat buffers, each
    rank with its own exponent and residual: the shard gradients and the
    advanced states."""
    inp, outs = world4
    jc = {"int8": JInt8, "fp8": JFp8}[name](stochastic=False)
    layout = jfsdp.BucketLayout(
        start=0, stop=1, pack_meta=None, orig_lens=(W * L_RS,),
        shard_lens=(L_RS,), pads=(0,), nbytes=0, compressor=jc.spec)
    mesh = Mesh(np.array(jax.devices()[:W]), ("x",))
    cg = jfsdp._make_compressed_gather(jc, layout, None, "x", W, None, 0)

    def body(shard, ef, scale, ct):
        cs = JState(ef=ef[0], scale=scale, step=jnp.zeros((1,), jnp.float32),
                    spec=jc.spec)
        _, vjp = jax.vjp(cg, shard[0], cs)
        gshard, ns = vjp(ct[0])
        return gshard[None], ns.ef[None], ns.scale, ns.step

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("x"),) * 4,
                              out_specs=P("x")))
    got = f(jnp.zeros((W, L_RS), jnp.float32), jnp.asarray(inp["rs/ef"]),
            jnp.asarray(inp["rs/scale"]), jnp.asarray(inp["rs/ct"]))
    gshard, ef, scale, step = (np.asarray(a) for a in got)
    for r, out in enumerate(outs):
        pre = f"rs/{name}"
        assert _same_bits(out[f"{pre}/gshard"], gshard[r]), r
        assert _same_bits(out[f"{pre}/ef"], ef[r]), r
        assert _same_bits(out[f"{pre}/scale"], scale[r:r + 1]), r
        assert _same_bits(out[f"{pre}/step"], step[r:r + 1]), r


# ---- the two-process MNIST contract -----------------------------------------

def test_two_process_mnist_int8_matches_uncompressed(world2):
    _, (r0, r1) = world2
    for name in ("base", "int8"):
        np.testing.assert_allclose(r0[f"mnist/{name}/losses"],
                                   r1[f"mnist/{name}/losses"], rtol=1e-6)
    base, q = r0["mnist/base/losses"], r0["mnist/int8/losses"]
    assert base[-1] < base[0] and q[-1] < q[0]
    assert abs(q[-1] - base[-1]) < 0.1 * abs(base[0]), (base, q)
    ef = r0["mnist/int8/ef"]
    assert np.isfinite(ef).all() and max(ef[15:]) <= max(ef[:15]), ef


def test_mnist_example_with_int8(world2):
    """``train_mnist --compression int8`` on the 2-rank world: the epoch
    loss falls and ends within 0.1 x the uncompressed run's first."""
    _, (r0, r1) = world2
    base, q = r0["example/base/loss"], r0["example/int8/loss"]
    assert np.array_equal(q, r1["example/int8/loss"])
    assert q[-1] < q[0]
    assert abs(q[-1] - base[-1]) < 0.1 * abs(base[0]), (base, q)


# ---- checkpoint guards ------------------------------------------------------

def _fsdp_states(comm, **kw):
    m = _tanh_model()
    state, meta = fsdp_init(comm, m, torch.optim.Adam(m.parameters(),
                                                      lr=0.01),
                            num_buckets=2, **kw)
    step = make_fsdp_train_step(
        comm, lambda b: torch.mean((m(b[0]) - b[1]) ** 2), state, meta)
    g = torch.Generator().manual_seed(5)
    batch = (torch.randn(8, 16, generator=g), torch.randn(8, 16, generator=g))
    return state, step, batch


def test_compressed_state_roundtrips_and_continues(world1, tmp_path):
    state, step, batch = _fsdp_states(world1, bucket_compressors="int8")
    step(batch)
    ckpt = create_multi_node_checkpointer(world1, str(tmp_path), "cmp")
    ckpt.save({"fsdp": state}, 1)
    fresh, step2, _ = _fsdp_states(world1, bucket_compressors="int8")
    init_optimizer_state(fresh.inner)  # the resume target's Adam state
    restored, gen = ckpt.resume({"fsdp": fresh})
    assert gen == 1 and restored["fsdp"] is fresh
    for a, b in zip(fresh.comp, state.comp):
        for k in ("ef", "scale", "step"):
            assert torch.equal(getattr(a, k), getattr(b, k))
    l2, l3 = float(step2(batch)), float(step(batch))
    assert l2 == l3
    for a, b in zip(fresh.flat_shards(), state.flat_shards()):
        assert torch.equal(a, b)
    for a, b in zip(fresh.comp, state.comp):
        assert torch.equal(a.ef, b.ef) and torch.equal(a.scale, b.scale)


def test_compressed_optimizer_state_roundtrips(world1, tmp_path):
    """A compressed optimizer's ``comp_state`` in the checkpoint tree is
    saved and restored in place, under the sidecar's guard."""
    w = torch.nn.Parameter(torch.randn(3000))
    opt = create_multi_node_optimizer(torch.optim.SGD([w], lr=0.1), world1,
                                      compression="fp8")
    for _ in range(3):
        w.grad = torch.randn(3000)
        opt.step()
    ckpt = create_multi_node_checkpointer(world1, str(tmp_path), "opt")
    ckpt.save({"comp": opt.comp_state}, 3)
    w2 = torch.nn.Parameter(torch.zeros(3000))
    opt2 = create_multi_node_optimizer(torch.optim.SGD([w2], lr=0.1),
                                       world1, compression="fp8")
    _, gen = ckpt.resume({"comp": opt2.comp_state})
    assert gen == 3
    for k in ("ef", "scale", "step"):
        assert torch.equal(getattr(opt2.comp_state, k),
                           getattr(opt.comp_state, k))
    assert compression_layout({"c": opt2.comp_state})["specs"] == [
        Fp8Compressor().spec]
    opt3 = create_multi_node_optimizer(torch.optim.SGD([w2], lr=0.1),
                                       world1, compression="int8")
    with pytest.raises(ValueError, match="does not match the live"):
        ckpt.resume({"comp": opt3.comp_state})


@pytest.mark.parametrize("saved,live,match", [
    ("int8", None, "no compression configured"),
    (None, "int8", "no compression state"),
    ("int8", "fp8", "does not match the live"),
])
def test_checkpoint_compression_refusals(world1, tmp_path, saved, live,
                                         match):
    state_s, _, _ = _fsdp_states(world1, bucket_compressors=saved)
    state_l, _, _ = _fsdp_states(world1, bucket_compressors=live)
    ckpt = create_multi_node_checkpointer(world1, str(tmp_path), "cmp")
    ckpt.save({"fsdp": state_s}, 1)
    with pytest.raises(ValueError, match=match):
        ckpt.resume({"fsdp": state_l})


# ---- per-channel int8 weights (serving) --------------------------------------

@pytest.mark.parametrize("axis", [-1, 0, 1])
@pytest.mark.parametrize("shape", [(16, 8), (7, 33), (4, 4, 12)])
def test_per_channel_int8_exact_against_jax(shape, axis):
    rng = np.random.default_rng(sum(shape) + axis)
    w = (rng.normal(size=shape) * 10.0 ** rng.uniform(-2, 2, size=shape[-1])
         ).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel along the last axis
    jcodes, jscale = jq.quantize_per_channel_int8(jnp.asarray(w), axis)
    codes, scale = tq.quantize_per_channel_int8(torch.from_numpy(w), axis)
    assert _same_bits(codes.numpy(), jcodes) and _same_bits(scale.numpy(),
                                                            jscale)
    assert _same_bits(tq.dequantize_int8(codes, scale).numpy(),
                      jq.dequantize_int8(jcodes, jscale))
    tcodes, tscale = tq.quantize_per_tensor_int8(torch.from_numpy(w))
    jtc, jts = jq.quantize_per_tensor_int8(jnp.asarray(w))
    assert _same_bits(tcodes.numpy(), jtc) and _same_bits(tscale.numpy(),
                                                          jts)


@pytest.mark.parametrize("seed", range(3))
def test_per_channel_roundtrip_bound_and_beats_per_tensor(seed):
    rng = np.random.default_rng(100 + seed)
    scales = 10.0 ** rng.uniform(-3, 1, size=32)
    w = torch.from_numpy((rng.normal(size=(64, 32)) * scales).astype(
        np.float32))
    cc, cs = tq.quantize_per_channel_int8(w)
    tc, ts = tq.quantize_per_tensor_int8(w)
    err_c = (tq.dequantize_int8(cc, cs) - w).abs()
    err_t = (tq.dequantize_int8(tc, ts) - w).abs()
    assert bool((err_c <= cs / 2 + 1e-6 * cs).all())
    assert float(err_c.mean()) < float(err_t.mean())


def test_lm_int8_weights_exact_against_jax():
    """``load_inference_params(int8_weights=True, channel_axes=...)`` on a
    TransformerLM's ``state_dict`` gives the bits of JAX's on the flax
    tree (per-channel along each flax leaf's last axis)."""
    from chainermn_tpu.models.transformer import TransformerLM as JLM
    from chainermn_tpu.serving.weights import (
        load_inference_params as jload)
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving.weights import load_inference_params
    from chainermn_tpu_torch.weights import channel_axes, flax_to_state_dict
    kw = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, max_len=16)
    variables = JLM(**kw).init(jax.random.key(0),
                               jnp.zeros((1, 8), jnp.int32))
    params = {"params": variables["params"]}
    model = TransformerLM(**kw, device="cpu")
    sd = flax_to_state_dict(params, model)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jload(
        params, int8_weights=True)), model)
    got = load_inference_params(sd, int8_weights=True,
                                channel_axes=channel_axes(model))
    assert list(got) == list(want)
    for k in want:
        assert _same_bits(got[k].numpy(), want[k].numpy()), k
