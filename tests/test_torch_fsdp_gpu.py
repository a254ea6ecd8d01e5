"""FSDP on the card against the same step on the CPU.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
``chip_smoke.py`` only, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_fsdp_gpu.py

A Linear-FusedBatchNormAct(ReLU)-Linear model, two buckets, SGD momentum,
3 float32 steps with TF32 off (``chip_smoke.p26_card_vs_cpu``): the card
runs the BatchNorm kernels (and ``cast_scale`` on the bfloat16 wire), the
CPU their plain versions.  Losses within 1e-5 relative and parameters
within 2e-5 on the float32 wire, within 5e-3 on the bfloat16 wire; each
BatchNorm kernel launched once a step a boundary (3 launches a step) and
4 casts a bucket a step on the wire.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_fsdp_step_on_the_card_equals_the_cpu(cuda, wire):
    res = chip_smoke.p26_card_vs_cpu(torch, cuda, wire)
    tol = (1e-5, 2e-5) if wire is None else (chip_smoke.P26_BF16_RTOL,) * 2
    assert res["loss_rel"] <= tol[0], res
    assert res["param_abs"] <= tol[1], res
    steps = chip_smoke.P26_STEPS
    assert {w: n for w, n in res["counts"].items() if w != "cast_scale"} \
        == {w: steps for w in res["counts"] if w != "cast_scale"}
    assert res["counts"]["cast_scale"] == (0 if wire is None
                                           else 4 * 2 * steps)
    assert not any(res["cpu_counts"].values())
