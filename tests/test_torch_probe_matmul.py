"""The probe kernels' plain versions against the JAX package's Pallas kernels.

``wgrad_plain`` and ``rowblock_plain`` (what the port's wrappers run on CPU
tensors, and what the CUDA kernels are held to on the card) must compute
what ``make_wgrad_pallas`` / ``make_rowblock_pallas`` of
``benchmarks/bench_pallas_conv_probe.py`` compute.  The Pallas kernels run
in interpret mode on the CPU: ``pallas_call`` is patched to pass
``interpret=True``, which reaches them because the factories import ``pl``
inside the function.  Inputs: bf16 from ``np.random.RandomState``.

Tolerances: wgrad within a relative L2 error of 2e-5 (bf16 products are
exact in float32; only the order of the float32 sums differs); rowblock
99% equal bit for bit and every element within one bf16 ulp plus the
float32 rounding bound of its k-term sum (``probe_matmul.agreement``).
"""

import functools
import importlib
import importlib.util
import os

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pm = importlib.import_module("chainermn_tpu_torch.ops.probe_matmul")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_probe(monkeypatch):
    """``benchmarks/bench_pallas_conv_probe.py`` with its Pallas kernels in
    interpret mode."""
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(orig, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "bench_pallas_conv_probe",
        os.path.join(REPO, "benchmarks", "bench_pallas_conv_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(sa, sb, seed):
    """bf16 operands as JAX and torch arrays with the same bits."""
    rng = np.random.RandomState(seed)
    ja = jnp.asarray(rng.randn(*sa).astype(np.float32), jnp.bfloat16)
    jb = jnp.asarray(rng.randn(*sb).astype(np.float32), jnp.bfloat16)

    def tt(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return ja, jb, tt(ja), tt(jb)


SWEEP = [(m, bm) for m in (2048, 4096) for bm in (512, 1024, 2048)]


@pytest.mark.parametrize("m,bm", SWEEP)
def test_wgrad_plain_matches_pallas(jax_probe, m, bm):
    ja, jb, ta, tb = _operands((256, m), (m, 64), seed=m + bm)
    want = torch.from_numpy(np.array(jax.jit(
        jax_probe.make_wgrad_pallas(m, bm))(ja, jb)))
    got = pm.wgrad_plain(ta, tb, bm)
    assert got.dtype == torch.float32 and got.shape == (256, 64)
    res = pm.agreement("wgrad", ta, tb, got, want)
    assert res["rel_l2"] <= 2e-5


@pytest.mark.parametrize("k,n", pm.ROWBLOCK_SHAPES)
@pytest.mark.parametrize("m,bm", SWEEP)
def test_rowblock_plain_matches_pallas(jax_probe, m, bm, k, n):
    ja, jb, ta, tb = _operands((m, k), (k, n), seed=m + bm + k)
    out = jax.jit(jax_probe.make_rowblock_pallas(m, bm, k, n))(ja, jb)
    want = torch.from_numpy(np.array(out.astype(jnp.float32))).to(
        torch.bfloat16)
    got = pm.rowblock_plain(ta, tb, bm)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    res = pm.agreement("rowblock", ta, tb, got, want)
    assert res["equal_share"] >= 0.99


def test_wrappers_take_the_plain_version_on_the_cpu():
    _, _, ta, tb = _operands((256, 1024), (1024, 64), seed=1)
    pm.reset_launch_counts()
    assert torch.equal(pm.wgrad(ta, tb, 256), pm.wgrad_plain(ta, tb, 256))
    for k, n in pm.ROWBLOCK_SHAPES:
        _, _, ra, rb = _operands((1024, k), (k, n), seed=k)
        assert torch.equal(pm.rowblock(ra, rb, 512),
                           pm.rowblock_plain(ra, rb, 512))
    # the counts are of kernel launches: none on the CPU
    assert pm.launch_counts() == {"wgrad": 0, "rowblock": 0}


def test_one_chunk_and_a_view_with_an_offset():
    """bm = M sums one chunk; a contiguous view that starts inside a larger
    buffer (a non-zero storage offset) reads the right rows."""
    _, _, ta, tb = _operands((256, 512), (512, 64), seed=2)
    torch.testing.assert_close(pm.wgrad(ta, tb, 512), ta.float() @ tb.float(),
                               rtol=1e-5, atol=1e-4)
    _, _, a, b = _operands((256, 64), (64, 256), seed=3)
    view = torch.cat([torch.zeros(64, 64, dtype=torch.bfloat16), a])[64:]
    assert view.storage_offset() == 64 * 64 and view.is_contiguous()
    assert torch.equal(pm.rowblock(view, b, 128), pm.rowblock(a, b, 128))


@pytest.mark.parametrize("call,match", [
    (lambda a, b: pm.wgrad(a.float(), b, 256), "bfloat16"),
    (lambda a, b: pm.wgrad(a.t(), b, 256), "contiguous"),
    (lambda a, b: pm.wgrad(a[0], b, 256), "2-D"),
    (lambda a, b: pm.wgrad(a, b, 384), "does not divide"),
    (lambda a, b: pm.wgrad(a, b, 0), "does not divide"),
    (lambda a, b: pm.wgrad(a, b, 32), "multiple of 64"),
    (lambda a, b: pm.wgrad(a[:128].contiguous(), b, 256), "expected"),
    (lambda a, b: pm.wgrad_plain(a, b, 384), "does not divide"),
    (lambda a, b: pm.rowblock(b, b[:64].contiguous(), 256), "expected"),
    (lambda a, b: pm.rowblock(b, b[:64, :32].contiguous(), 256), "expected"),
    (lambda a, b: pm.rowblock_plain(a.t().contiguous(), b[:256], 100),
     "does not divide"),
])
def test_preconditions_raise(call, match):
    _, _, ta, tb = _operands((256, 1024), (1024, 64), seed=4)
    with pytest.raises(ValueError, match=match):
        call(ta, tb)


def test_work_counts_and_bounds_at_the_probe_shape():
    """The FLOP/byte counts and the least time on an H100 SXM at M =
    256 * 56 * 56: 26.31 GFLOP and 513.87 / 513.84 MB, bytes-bound at
    about 0.1534 ms for all three cases."""
    from chainermn_tpu_torch.utils.gpu_info import CARDS
    sxm = CARDS["h100 80gb hbm3"]
    m = 256 * 56 * 56
    cases = {"wgrad": (256, m, 64, 4), "dgrad": (m, 64, 256, 2),
             "fwd1x1": (m, 256, 64, 2)}
    for name, (mm, k, n, out) in cases.items():
        flops = pm.probe_flops(mm, k, n)
        nbytes = pm.probe_bytes(mm, k, n, out)
        assert round(flops / 1e9, 2) == 26.31, name
        assert round(nbytes / 1e6, 2) == (513.87 if name == "wgrad"
                                          else 513.84), name
        ms, by = pm.bound_ms(flops, nbytes, sxm)
        assert by == "bytes" and round(ms, 4) == 0.1534, name
    # one float32 [256, 64] partial a span of the kernel's split, any bm
    assert pm.wgrad_workspace_bytes(m, 1024) == 132 * 65536
    assert pm.wgrad_workspace_bytes(m, 8192) == 132 * 65536


def test_agreement_refuses_what_is_off():
    _, _, ta, tb = _operands((256, 512), (512, 64), seed=5)
    want = pm.wgrad_plain(ta, tb, 512)
    with pytest.raises(AssertionError, match="relative L2"):
        pm.agreement("wgrad", ta, tb, want * (1 + 1e-4), want)
    ra, rb = ta.t().contiguous(), tb[:256].contiguous()  # [512,256] @ [256,64]
    good = pm.rowblock_plain(ra, rb, 512)
    assert pm.agreement("rowblock", ra, rb, good, good)["equal_share"] == 1.0
    bad = good.clone()
    bad[0, 0] = bad[0, 0].float() * 1.1 + 1.0   # far off in one element
    with pytest.raises(AssertionError, match="beyond one bf16 ulp"):
        pm.agreement("rowblock", ra, rb, bad, good)
    # one ulp up everywhere: each within bounds, but not 99% equal
    up = (good.view(torch.int16) + torch.where(
        good.float() >= 0, 1, -1).to(torch.int16)).view(torch.bfloat16)
    with pytest.raises(AssertionError, match="equal bit for bit"):
        pm.agreement("rowblock", ra, rb, up, good)
