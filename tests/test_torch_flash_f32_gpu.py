"""The float32 flash kernels against their plain versions, on the card.

``fwd_f32_kernel`` and ``dkv_f32_kernel`` (register-blocked CUDA-core
kernels in ``chainermn_tpu_torch/csrc/flash_attention.cu``) at every head
dim the dispatch takes, causal and not, with segments, dropout 0.2,
vector offsets with an lse cotangent, GQA groups of 1, 4 and 8, ragged T,
Tq != Tk, a Tq 1 decode row over 4096 keys and the q/k/v views of one qkv
projection: relative L2 errors within 1e-5 (float32 products on the CUDA
cores agree with the plain float32 version to rounding; never TF32).  Each
case also runs ``dq_f32_kernel`` through the same case runner as
``chip_smoke.py``'s phase 10.  Then each kernel launched twice on the same
inputs gives the same bits (no atomics).  CUDA kernels have no CPU mode:
every test is marked ``gpu`` and skips without a card.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_flash_f32_gpu.py
"""

import importlib
import os
import sys

import pytest
import torch

tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
smoke = importlib.import_module("chip_smoke")

TOL = 1e-5
CASES = {
    # name: (B, Tq, Tk, H, Hk, D, causal, extras)
    **{f"d{d}_{'causal' if c else 'full'}": (2, 256, 256, 4, 4, d, c, {})
       for d in (16, 32, 64, 128) for c in (True, False)},
    "segments_d64": (2, 256, 256, 4, 4, 64, True, {"seg": True}),
    "segments_d128_full": (2, 200, 200, 4, 2, 128, False, {"seg": True}),
    "dropout_d128": (2, 256, 256, 4, 2, 128, True, {"rate": 0.2}),
    "dropout_d32": (2, 300, 300, 4, 4, 32, False, {"rate": 0.2}),
    "offsets_glse_d128": (2, 96, 128, 4, 4, 128, True,
                          {"offs": "vector", "glse": True}),
    "offsets_glse_d16": (2, 96, 128, 4, 4, 16, True,
                         {"offs": "vector", "glse": True}),
    "gqa1_d128": (1, 256, 256, 8, 8, 128, True, {}),
    "gqa4_d128": (1, 256, 256, 8, 2, 128, True, {}),
    "gqa8_d128": (2, 512, 512, 16, 2, 128, True, {}),
    "gqa8_d32": (1, 300, 300, 8, 1, 32, True, {}),
    "t200_d128": (1, 200, 200, 4, 4, 128, True, {}),
    "t1000_d128": (1, 1000, 1000, 8, 8, 128, True, {}),
    "t1000_d64_full": (1, 1000, 1000, 4, 2, 64, False, {}),
    "cross_tq96_tk128": (2, 96, 128, 4, 4, 128, False, {}),
    "cross_tq96_tk128_causal": (2, 96, 128, 4, 2, 32, True, {}),
    "decode_tq1_tk4096": (2, 1, 4096, 16, 4, 128, True, {"offs": "decode"}),
    "qkv_views_d128": (2, 640, 640, 8, 8, 128, True, {"qkv": True}),
    "qkv_views_d64": (1, 333, 333, 4, 4, 64, False, {"qkv": True}),
    "everything_d128": (1, 160, 160, 4, 2, 128, True,
                        {"seg": True, "rate": 0.2, "glse": True,
                         "offs": "vector"}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_kernels_match_plain(cuda, name):
    b, tq, tk, h, hk, d, causal, extra = CASES[name]
    before = tfa.launch_counts()
    errs = smoke.flash_case(tfa, torch, cuda, torch.float32, b, tq, tk, h,
                            hk, d, causal, seed=len(name), **extra)
    assert all(n - before[w] == 1 for w, n in tfa.launch_counts().items())
    assert all(rel <= TOL for _, rel in errs.values()), errs


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 128])
def test_f32_kernels_repeat_bit_for_bit(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda)  # noqa: E731
    q, g = mk(2, 700, 8, d), mk(2, 700, 8, d)
    k, v = mk(2, 700, 2, d), mk(2, 700, 2, d)
    seg = torch.randint(0, 2, (2, 700), generator=gen, device=cuda,
                        dtype=torch.int32)
    kw = dict(qseg=seg, kseg=seg, rate=0.2, seed=5)
    runs = []
    for _ in range(2):
        out, lse = tfa.flash_fwd(q, k, v, True, **kw)
        delta = (g * out).sum(-1).transpose(1, 2).contiguous()
        runs.append((out, lse) + tfa.flash_bwd_dkv(q, k, v, g, lse, delta,
                                                    lse * 0.1, True, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
