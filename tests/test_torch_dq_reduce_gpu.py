"""The wgmma dQ kernel and the CUDA BatchNorm backward reduction, on the card.

Both are CUDA kernels with no CPU mode, so every test here is marked ``gpu``
and skips without a CUDA card.  The file imports torch and the port only,
so that the machine with the card (which has no JAX) runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_dq_reduce_gpu.py

* ``flash_bwd_dq`` at head dims 64 and 128 in bf16 and fp16 (the
  ``dq_wgmma_kernel`` path): causal with a ragged T and a GQA group,
  non-causal with Tq != Tk, segment ids with a padding row, dropout, and
  [B] offsets with an lse cotangent, against ``flash_backward_plain``
  within a relative L2 error of 1e-2 (the kernel rounds dS to the input
  type before dS K, as the TPU kernel does); two launches give the same
  bits; no key gives dQ 0.
* ``bwd_reduce_call`` (``cmn_bn_bwd_reduce``): float32, bf16 and fp16, with
  and without the ReLU, a ragged R, C not a multiple of 8 and a base off
  the 16-byte grid (the scalar path), C of several channel tiles; within
  rtol 1e-4 and atol 1e-4 sqrt(R) of ``bwd_reduce_plain`` (sums of R terms
  of O(1) taken in another order); one launch a call; two calls and a
  CUDA-graph replay give the same bits, as do calls on two streams at once.
"""

import importlib

import pytest
import torch

tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
tfn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


# name: (B, Tq, Tk, H, Hk, causal, extras)
DQ_CASES = {
    "causal_ragged_gqa": (2, 300, 300, 8, 2, True, {}),
    "cross_noncausal": (2, 100, 260, 4, 4, False, {}),
    "segments": (2, 200, 200, 4, 4, True, {"seg": True}),
    "dropout": (2, 192, 192, 4, 2, True, {"rate": 0.1}),
    "offsets_glse": (2, 96, 160, 4, 4, True, {"offs": True, "glse": True}),
}


def _dq_inputs(dev, dtype, d, b, tq, tk, h, hk, causal, extra, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    q = (mk(b, tq, h, d) * 0.5).to(dtype)
    k = (mk(b, tk, hk, d) * 0.5).to(dtype)
    v = mk(b, tk, hk, d).to(dtype)
    g = mk(b, tq, h, d).to(dtype)
    kw = dict(seed=99, rate=extra.get("rate", 0.0))
    if extra.get("seg"):
        ids = lambda t: torch.randint(0, 3, (b, t), generator=gen,  # noqa
                                      device=dev, dtype=torch.int32)
        kw["qseg"], kw["kseg"] = ids(tq), ids(tk)
        kw["qseg"][0, :5] = 9  # a padding id that matches no key
    if extra.get("offs"):
        kw["offs"] = torch.tensor([[3, 0], [70, 11]], device=dev,
                                  dtype=torch.int32)
    gl = mk(b, h, tq) if extra.get("glse") else None
    out, lse = tfa.flash_forward_plain(q, k, v, causal, **kw)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, g, lse, delta, gl, causal), kw


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DQ_CASES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_dq_wgmma_matches_plain(cuda, dtype, d, name):
    b, tq, tk, h, hk, causal, extra = DQ_CASES[name]
    args, kw = _dq_inputs(cuda, dtype, d, b, tq, tk, h, hk, causal, extra)
    before = tfa.flash_bwd_dq.launches
    got = tfa.flash_bwd_dq(*args, **kw)
    assert tfa.flash_bwd_dq.launches == before + 1
    want = tfa.flash_backward_plain(*args, block_k=1024, **kw)[0]
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, want) <= 1e-2, (name, _rel(got, want))
    if extra.get("seg"):  # a padding row has no key: its dQ is 0
        assert bool((got[0, :5] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_dq_wgmma_repeats_bit_for_bit(cuda, d):
    args, kw = _dq_inputs(cuda, torch.bfloat16, d, 2, 700, 700, 8, 2, True,
                          {"rate": 0.1, "glse": True}, seed=d)
    a = tfa.flash_bwd_dq(*args, **kw)
    b = tfa.flash_bwd_dq(*args, **kw)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_dq_without_keys_is_zero(cuda):
    """Tk 0: every row is empty and dQ is 0 (no TMA map of an empty K)."""
    q = torch.randn(2, 50, 4, 64, device=cuda).to(torch.bfloat16)
    kv = torch.empty(2, 0, 4, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.full((2, 4, 50), 1e30, device=cuda)
    dq = tfa.flash_bwd_dq(q, kv, kv, q, lse, torch.zeros_like(lse))
    assert bool((dq == 0).all())


def _bn_inputs(shape, dtype, dev, seed=0):
    r, c = shape
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dev, dtype)
    g = torch.randn(shape, generator=gen).to(dev, dtype)
    vec = lambda: (torch.rand(c, generator=gen) + 0.5).to(dev)  # noqa
    mean, var = tfn.stats_plain(x)
    return x, g, mean, torch.rsqrt(var + 1e-5), vec(), vec() - 1.0


def _check_reduce(x, g, mean, invstd, scale, bias, relu):
    before = tfn.bwd_reduce_call.launches
    got = tfn.bwd_reduce_call(x, g, mean, invstd, scale, bias, relu)
    assert tfn.bwd_reduce_call.launches == before + 1
    want = tfn.bwd_reduce_plain(x, g, mean, invstd, scale, bias, relu)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * x.shape[0] ** 0.5)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
@pytest.mark.parametrize("shape", [(401408, 64), (1001, 64), (333, 13),
                                   (517, 100), (96, 2048), (300, 4104)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "fp16"])
def test_bwd_reduce_matches_plain(cuda, dtype, shape, relu):
    _check_reduce(*_bn_inputs(shape, dtype, cuda), relu)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_bwd_reduce_off_the_16_byte_grid(cuda, dtype):
    """x and g that start one element into a buffer (contiguous, C a
    multiple of 8, not 16-byte aligned) take the scalar path."""
    r, c = 1000, 64
    x, g, mean, invstd, scale, bias = _bn_inputs((r, c), dtype, cuda)
    bx = torch.empty(r * c + 1, dtype=dtype, device=cuda)
    bg = torch.empty_like(bx)
    xs, gs = bx[1:].view(r, c), bg[1:].view(r, c)
    xs.copy_(x)
    gs.copy_(g)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    got = _check_reduce(xs, gs, mean, invstd, scale, bias, True)
    for a, b in zip(got, tfn.bwd_reduce_call(x, g, mean, invstd, scale,
                                             bias, True)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(100352, 256), (12547, 13), (96, 2048)])
def test_bwd_reduce_repeats_and_replays(cuda, shape):
    """Two calls, calls on two streams at once, and CUDA-graph replays
    give the same bits: each launch zeroes its own tile counters, so
    neither a stale count nor another stream's launch can pick the
    block that adds the partials."""
    args = _bn_inputs(shape, torch.bfloat16, cuda, seed=4)
    a = tfn.bwd_reduce_call(*args, True)
    b = tfn.bwd_reduce_call(*args, True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(tfn.bwd_reduce_call(*args, True))
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    for out in outs:
        assert all(torch.equal(u, v) for u, v in zip(a, out))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = tfn.bwd_reduce_call(*args, True)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(a, c))


@pytest.mark.gpu
def test_bwd_reduce_refuses_mixed_dtypes(cuda):
    x, g, mean, invstd, scale, bias = _bn_inputs((64, 8), torch.bfloat16,
                                                 cuda)
    with pytest.raises(ValueError, match="one dtype"):
        tfn.bwd_reduce_call(x, g.float(), mean, invstd, scale, bias, True)
