"""The Triton kernels of the port against their plain versions, on the card.

Triton kernels have no CPU mode, so every test here is marked ``gpu`` and
skips without a CUDA card.  The file imports torch and the port only, so
that the machine with the card (which has no JAX) runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

Tolerances: float32 results within 1e-5 (elementwise passes; the kernel
may contract a multiply-add the plain version rounds twice) or 1e-4
relative (sums, taken in another order); bfloat16 outputs within 1e-2,
one to two bfloat16 units in the last place at the values' magnitude.
"""

import importlib

import pytest
import torch

tfn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (Triton kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    r, c = shape
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) + 0.3).to(device, dtype)
    g = torch.randn(shape, generator=gen).to(device, dtype)
    vec = lambda: (torch.rand(c, generator=gen) + 0.5).to(device)  # noqa
    return x, g, vec(), vec() - 1.0, vec()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1000, 64), (333, 13), (96, 2048),
                                   (6272, 1024)])
def test_kernels_match_plain(cuda, shape, dtype):
    x, g, scale, bias, invstd = _inputs(shape, dtype, cuda)
    mean, var = tfn.stats_plain(x)
    for got, want in zip(tfn.stats_call(x), (mean, var)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    out_tol = 1e-5 if dtype == torch.float32 else 1e-2
    for relu in (True, False):
        torch.testing.assert_close(
            tfn.apply_call(x, mean, invstd, scale, bias, relu).float(),
            tfn.apply_plain(x, mean, invstd, scale, bias, relu).float(),
            rtol=out_tol, atol=out_tol)
        db, dg = tfn.bwd_reduce_plain(x, g, mean, invstd, scale, bias, relu)
        for got, want in zip(tfn.bwd_reduce_call(x, g, mean, invstd, scale,
                                                 bias, relu), (db, dg)):
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * shape[0] ** 0.5)
        for train in (True, False):
            torch.testing.assert_close(
                tfn.bwd_dx_call(x, g, mean, invstd, scale, bias, db, dg,
                                relu, train).float(),
                tfn.bwd_dx_plain(x, g, mean, invstd, scale, bias, db, dg,
                                 relu, train).float(),
                rtol=out_tol, atol=out_tol)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_reductions_are_deterministic(cuda):
    x, g, scale, bias, invstd = _inputs((100352, 256), torch.bfloat16, cuda)
    a = tfn.stats_call(x)
    b = tfn.stats_call(x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    mean = a[0]
    a = tfn.bwd_reduce_call(x, g, mean, invstd, scale, bias, True)
    b = tfn.bwd_reduce_call(x, g, mean, invstd, scale, bias, True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("train", [True, False])
def test_fused_norm_grads_match_reference(cuda, train):
    """Autograd through the kernels vs autograd through the plain oracle,
    in float32 on a channels-last NCHW activation."""
    c = 64
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randn(8, c, 14, 14, generator=gen).to(cuda)
    x0 = x0.contiguous(memory_format=torch.channels_last)
    outs = []
    for cls in (tfn.FusedBatchNormAct, tfn.ReferenceBatchNormAct):
        m = cls(c, fuse_relu=True, device=cuda)
        m.train(train)
        with torch.no_grad():
            m.weight.copy_(torch.linspace(0.5, 1.5, c, device=cuda))
            m.bias.copy_(torch.linspace(-0.2, 0.2, c, device=cuda))
        x = x0.clone().requires_grad_()
        y = m(x)
        (y.float() ** 2).sum().backward()
        outs.append([y.detach(), x.grad, m.weight.grad, m.bias.grad,
                     m.running_mean.clone(), m.running_var.clone()])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
