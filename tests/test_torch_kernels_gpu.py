"""The kernels of the port against their plain versions, on the card.

Triton and CUDA kernels have no CPU mode, so every test here is marked
``gpu`` and skips without a CUDA card.  The file imports torch and the port only, so
that the machine with the card (which has no JAX) runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

Tolerances: float32 results within 1e-5 (elementwise passes; the kernel
may contract a multiply-add the plain version rounds twice) or 1e-4
relative (sums, taken in another order); bfloat16 outputs within 1e-2,
one to two bfloat16 units in the last place at the values' magnitude.
"""

import importlib
import os
import sys

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


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _assert_same_bits(got, want, what):
    """Bit-exact, except that NaN payloads may differ: NaN positions must
    agree."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want)), what
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan]), what


CAST_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.gpu
@pytest.mark.parametrize("src", CAST_DTYPES)
def test_cast_scale_kernel_is_bit_exact(cuda, src):
    """The CUDA cast_scale kernel against cast_scale_plain, for every
    destination and None, scales 1, 1/2, 1/3, 1/8, lengths from 1 to the
    packed gradient counts of the MLP and of ResNet-50, a view that starts
    one element in (not 16-byte aligned), +-7e4 (float16 overflow), NaN
    and subnormals."""
    from chainermn_tpu_torch.models import MLP, ResNet50
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    counts = [sum(p.numel() for p in m.parameters())
              for m in (MLP(device=cuda), ResNet50(device=cuda))]
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = cs.cast_scale.launches
    calls = 0
    for n in [1, 7, 127, 128, 33000] + counts:
        x = torch.randn(n + 1, device=cuda, generator=gen) * 3e4
        x[::97] = float("nan")
        x[1::89], x[2::83] = 7e4, -7e4
        x[3::79], x[4::71] = 1e-41, 3e-8
        x = x.to(src)
        for view in (x[:n], x[1:]):
            for dst in CAST_DTYPES + [None]:
                for scale in (1.0, 0.5, 1.0 / 3.0, 0.125):
                    _assert_same_bits(
                        cs.cast_scale(view, dst, scale),
                        cs.cast_scale_plain(view, dst, scale),
                        f"{src}->{dst} n={n} scale={scale} "
                        f"offset={view.storage_offset()}")
                    calls += 1
    torch.cuda.synchronize()
    assert cs.cast_scale.launches - before == calls


@pytest.mark.gpu
def test_cast_scale_refuses_other_inputs(cuda):
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    x = torch.ones(8, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cs.cast_scale(x.t(), torch.float16, 1.0)
    with pytest.raises(ValueError, match="not one of"):
        cs.cast_scale(x.double(), None, 1.0)
    assert cs.cast_scale(x[:0], torch.float16, 1.0).numel() == 0


@pytest.mark.gpu
def test_xla_float16_wire_launches_two_casts(cuda):
    """A world of one on the card: the xla communicator's float16 wire runs
    the kernel twice for one float32 group and gives the float32 mean."""
    import torch.distributed as dist
    from chainermn_tpu_torch import create_communicator
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    created = not dist.is_initialized()
    comm = create_communicator("xla", allreduce_grad_dtype="float16")
    try:
        g = {"w": torch.randn(1000, device=cuda), "b": torch.randn(
            7, device=cuda)}
        before = cs.cast_scale.launches
        out = comm.allreduce_grad(g)
        assert cs.cast_scale.launches - before == 2
        for k in g:
            assert out[k].dtype == torch.float32
            torch.testing.assert_close(out[k], g[k].half().float(), rtol=0,
                                       atol=0)
    finally:
        if created:
            dist.destroy_process_group()


@pytest.mark.gpu
def test_every_flavor_runs_on_the_card(cuda):
    """A world of one on the card: every communicator keeps its gradients'
    values, dtypes and device (non_cuda_aware through pinned host memory
    and a gloo group), and the double buffer's update 0 applies zeros."""
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     make_train_step)
    created = not dist.is_initialized()
    try:
        g = {"w": torch.randn(5, 3, device=cuda),
             "h": torch.randn(7, device=cuda).half()}
        for name in ("naive", "flat", "hierarchical", "two_dimensional",
                     "single_node", "non_cuda_aware", "xla"):
            out = create_communicator(name).allreduce_grad(g)
            for k in g:
                assert out[k].device == g[k].device, name
                torch.testing.assert_close(out[k], g[k], rtol=0, atol=0)
        w = torch.nn.Parameter(torch.ones(3, device=cuda))
        opt = create_multi_node_optimizer(
            torch.optim.SGD([w], lr=1.0),
            create_communicator("xla", allreduce_grad_dtype="float16"),
            double_buffering=True)
        step = make_train_step(opt.communicator,
                               lambda b: ((w - b) ** 2).sum(), opt)
        step(torch.zeros(3, device=cuda))
        assert torch.equal(w.detach(), torch.ones(3, device=cuda))
        step(torch.zeros(3, device=cuda))
        step.finalize()
        # update 1 applied step 0's gradient, 2 * (w - 0) = 2
        assert torch.equal(w.detach(), -torch.ones(3, device=cuda))
    finally:
        if created:
            dist.destroy_process_group()


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


# --- flash attention: the three CUDA kernels against their plain versions --

tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
# chip_smoke.py (at the repository's root) runs the same cases on the card;
# its case runner and dropout-mask read-out serve both
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
smoke = importlib.import_module("chip_smoke")


def _rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


BF, F16, F32 = torch.bfloat16, torch.float16, torch.float32
FLASH_CASES = {
    # name: (dtype, B, Tq, Tk, H, Hk, D, causal, extras)
    "lm_heads": (BF, 1, 1024, 1024, 16, 16, 128, True, {}),
    "gqa4": (BF, 2, 256, 256, 8, 4, 64, True, {}),
    "mqa_full": (BF, 2, 192, 192, 8, 1, 64, False, {}),
    "cross": (BF, 2, 100, 160, 4, 4, 64, False, {}),
    "t100": (F16, 2, 100, 100, 4, 2, 128, True, {}),
    "seg": (BF, 2, 128, 128, 4, 4, 64, True, {"seg": True}),
    "dropout": (BF, 2, 128, 128, 4, 2, 64, True, {"rate": 0.1}),
    "offs_scalar": (BF, 2, 96, 128, 4, 4, 32, True,
                    {"offs": "scalar", "glse": True}),
    "offs_vector": (F32, 2, 96, 128, 4, 4, 32, True,
                    {"offs": "vector", "glse": True}),
    "f32_d16": (F32, 2, 200, 200, 8, 8, 16, True, {}),
    "f32_d128_all": (F32, 1, 160, 160, 4, 2, 128, True,
                     {"seg": True, "rate": 0.2, "glse": True}),
    "f16_d16": (F16, 2, 130, 130, 8, 2, 16, False, {"rate": 0.1}),
    # the wgmma kernels' edges (bf16/fp16 at D 64/128)
    "t1000_causal_d128": (BF, 1, 1000, 1000, 4, 4, 128, True, {}),
    "decode_tq1_tk4096": (BF, 2, 1, 4096, 8, 2, 128, True,
                          {"offs": "decode"}),
    "gqa8_d128": (BF, 2, 256, 256, 16, 2, 128, True, {}),
    "qkv_views_d128": (BF, 2, 384, 384, 4, 4, 128, True, {"qkv": True}),
    "f16_d64": (F16, 2, 300, 300, 4, 2, 64, True, {"glse": True}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, name):
    """Relative L2 errors within 1e-5 (float32: products agree to rounding)
    or 1e-2 (bf16/fp16: the kernels round P and dS to the input type before
    their products, as the TPU kernels do); empty rows give 0 and 1e30."""
    dtype, b, tq, tk, h, hk, d, causal, extra = FLASH_CASES[name]
    before = tfa.launch_counts()
    errs = smoke.flash_case(tfa, torch, cuda, dtype, b, tq, tk, h, hk, d,
                            causal, **extra)
    assert all(n - before[w] == 1 for w, n in tfa.launch_counts().items())
    tol = smoke.FLASH_TOL[str(dtype).split(".")[1]]
    assert all(rel <= tol for _, rel in errs.values()), (errs, tol)


@pytest.mark.gpu
def test_flash_kernels_repeat_bit_for_bit(cuda):
    """Two launches of each kernel on the same inputs give the same bits
    (no atomics: one block writes each output tile), for the wgmma kernels
    (bf16 D 128, fp16 D 64) and the mma.sync ones (D 32)."""
    assert smoke.flash_repeat(tfa, torch, cuda) == {
        "flash_fwd": True, "flash_bwd_dkv": True, "flash_bwd_dq": True}


@pytest.mark.gpu
def test_flash_dropout_mask_is_exact(cuda):
    got, want = smoke.flash_keep_grid(tfa, torch, cuda)
    assert torch.equal(got, want)
    assert 0.85 < float(want.float().mean()) < 0.95


@pytest.mark.gpu
def test_flash_attention_autograd_on_the_card(cuda):
    """The public function on CUDA tensors: forward and the two backward
    kernels, once each, and the plain autograd on the same inputs."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 64, 4, 32, generator=gen, device=cuda)
               .requires_grad_() for _ in range(3))
    before = tfa.launch_counts()
    out, lse = tfa.flash_attention(q, k, v, True, return_lse=True)
    (out.square().sum() + lse.sum()).backward()
    assert {w: n - before[w] for w, n in tfa.launch_counts().items()} == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    got = [out, lse, q.grad, k.grad, v.grad]
    ref = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    out_p, lse_p = tfa.flash_attention(*ref, True, return_lse=True)
    (out_p.square().sum() + lse_p.sum()).backward()
    want = [out_p, lse_p] + [t.grad for t in ref]
    for a, b in zip(got, want):
        assert _rel(a.detach().cpu(), b.detach()) <= 1e-5
    with pytest.raises(ValueError, match="blockwise"):
        tfa.flash_attention(q, k, v, bwd_impl="blockwise")
