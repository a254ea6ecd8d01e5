"""The ImageNet example's new paths on the card: the ViT's attention
kernels and float32 step, and the remat policies' BatchNorm buffers.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
``chip_smoke.py`` only, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_vit_gpu.py

* rows 6-8 at ViT-B/16's attention shape (B 256, T 197, H 12, D 64,
  non-causal, q/k/v views of one qkv projection) against their plain
  versions, bf16 and float32, phase 10's limits (``chip_smoke.flash_case``);
* the float32 ViT-B/16 step at 2 layers, flash against the plain attention
  (``chip_smoke.p25_vit_f32``: ``utils.compare``'s gates);
* one float32 ResNet-50 step under the "block" and "norm" remat policies
  against "none" (``chip_smoke.p25_remat_f32``): loss, gradients and the
  running buffers (moved once), exact BatchNorm launches, the convolutions
  each policy recomputes, "block"'s lower peak memory.
"""

import importlib
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu
tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
tfn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernels_at_the_vit_shape(cuda, dtype):
    b, t, h, d = chip_smoke.P25_VIT_SHAPE
    res = chip_smoke.flash_case(tfa, torch, cuda, getattr(torch, dtype), b,
                                t, t, h, h, d, False, qkv=True)
    tol = chip_smoke.FLASH_TOL[dtype]
    for w, (_, rel) in res.items():
        assert rel <= tol, (w, rel)


def test_vit_f32_step_flash_equals_xla(cuda):
    out = chip_smoke.p25_vit_f32(torch, cuda)
    assert out["grad_rel"] <= 1e-3 and out["loss_rel"] <= 1e-4


def test_remat_policies_move_buffers_once(cuda):
    out = chip_smoke.p25_remat_f32(tfn, torch, cuda)
    for policy in ("block", "norm"):
        assert out[policy]["buffer_rel"] <= 1e-6, out
