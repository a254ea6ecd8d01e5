"""The CUDA BatchNorm statistics kernel (``cmn_bn_stats``), on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``gpu`` and
skips without a CUDA card.  The file imports torch and the port only, so
that the machine with the card (which has no JAX) runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_stats_gpu.py

``stats_call`` against ``stats_plain`` within rtol 1e-4 and atol 1e-4
(float32 sums of the same values in another order): every distinct
``[R, C]`` of ResNet-50's 53 BatchNorm boundaries at batch 32 in bf16 and
float32 and at batch 256 in bf16, fp16 at two shapes, C not a multiple of
8 (13, 100, 2050) and of several channel tiles (4104), R 1 and 7, and a
view one element into its buffer (the scalar path).  Data of mean 100 and
standard deviation 1 against a float64 reference: the mean within 1e-5
relative, the variance within 1e-5 of mean(x^2) (the fast variance
subtracts two sums of ~1e4, so its absolute error is a few float32
roundings of them).  One launch a call; two calls, a CUDA-graph replay and
calls on two streams at once give the same bits.
"""

import importlib

import pytest
import torch

tfn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _shapes(batch):
    return sorted({(n * h * w, c) for _, (n, h, w, c), _
                   in tfn.resnet_bn_boundaries(batch)}, reverse=True)


def _x(shape, dtype, dev, seed=0, scale=1.5, shift=0.3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, device=dev, generator=gen) * scale
            + shift).to(dtype)


def _check(x):
    before = tfn.stats_call.launches
    got = tfn.stats_call(x)
    assert tfn.stats_call.launches == before + 1
    for a, b in zip(got, tfn.stats_plain(x)):
        assert a.dtype == torch.float32 and a.shape == (x.shape[1],)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    return got


B32 = [(s, dt) for s in _shapes(32) for dt in ("bfloat16", "float32")]
B256 = [(s, "bfloat16") for s in _shapes(256)]
FP16 = [((100352, 256), "float16"), ((1568, 2048), "float16")]
EDGES = [((r, c), dt) for r, c in ((1, 64), (7, 64), (1, 13), (7, 13),
                                   (12547, 100), (1001, 2050), (300, 4104),
                                   (7, 4104), (1, 1))
         for dt in ("bfloat16", "float32")]
CASES = B32 + B256 + FP16 + EDGES


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", CASES, ids=[
    f"{r}x{c}-{dt}" for (r, c), dt in CASES])
def test_stats_matches_plain(cuda, shape, dtype):
    _check(_x(shape, getattr(torch, dtype), cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000, 64), (96, 2048), (300, 4104)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stats_off_the_16_byte_grid(cuda, shape, dtype):
    """A contiguous view one element into its buffer (C a multiple of 8,
    not 16-byte aligned) takes the scalar path and agrees with the
    aligned tensor's statistics."""
    r, c = shape
    x = _x(shape, getattr(torch, dtype), cuda, seed=1)
    buf = torch.empty(r * c + 1, dtype=x.dtype, device=cuda)
    xs = buf[1:].view(r, c)
    xs.copy_(x)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    got = _check(xs)
    for a, b in zip(got, tfn.stats_call(x)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(100352, 256), (1568, 2048),
                                   (12547, 100)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stats_at_a_large_mean(cuda, shape, dtype):
    x = _x(shape, getattr(torch, dtype), cuda, seed=2, scale=1.0,
           shift=100.0)
    mean, var = tfn.stats_call(x)
    x64 = x.double()
    m64, v64 = x64.mean(0), x64.var(0, correction=0)
    assert float(((mean.double() - m64).abs() / m64.abs()).max()) <= 1e-5
    sq = (x64 * x64).mean(0)
    assert float(((var.double() - v64).abs() / sq).max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(401408, 64), (1568, 2048), (12547, 13),
                                   (300, 4104)])
def test_stats_repeats_and_replays(cuda, shape):
    """Two calls, calls on two streams at once, and CUDA-graph replays
    give the same bits: the sum order depends only on (R, C, the block
    count), and the grid barrier's state is the cooperative launch's own."""
    x = _x(shape, torch.bfloat16, cuda, seed=3)
    a = tfn.stats_call(x)
    b = tfn.stats_call(x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(tfn.stats_call(x))
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    for out in outs:
        assert all(torch.equal(u, v) for u, v in zip(a, out))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = tfn.stats_call(x)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(a, c))


@pytest.mark.gpu
def test_stats_beside_a_long_kernel(cuda):
    """A launch while another stream's kernel holds SMs (a 2 ms spin, as a
    collective would) still runs and gives the same bits."""
    x = _x((100352, 256), torch.bfloat16, cuda, seed=5)
    a = tfn.stats_call(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(2_000_000)
    b = tfn.stats_call(x)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
