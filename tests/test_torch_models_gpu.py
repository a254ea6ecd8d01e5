"""The reference's other models on the card: their BatchNorm boundaries,
launch counts and float32 step.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
``chip_smoke.py`` only, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_models_gpu.py

* the four BatchNorm kernels against their plain versions (phase 2's
  limits, through ``chip_smoke.phase_kernels``) at the distinct [R, C] of
  VGG-16 at batch 64 and of GoogLeNetBN at 224 pixels and batch 32 (16 to
  384 channels, many not powers of two, rows down to 1568);
* one training step launches each BatchNorm kernel exactly 13 times for
  VGG-16 and 66 times for GoogLeNetBN with its aux heads;
* the float32 VGG-16 step with the kernels against the plain runs on the
  card and on the CPU that take its branches (``chip_smoke.p23_f32_step``:
  ``utils.compare``'s gates);
* dropout masks drawn on the card repeat for a seed.
"""

import importlib
import os
import sys

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from chainermn_tpu_torch.models import VGG16, GoogLeNetBN  # noqa: E402
from chainermn_tpu_torch.models.googlenet import BLOCKS  # noqa: E402
from chainermn_tpu_torch.models.layers import Dropout  # noqa: E402

tfn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def googlenetbn_shapes(batch, image=224):
    """The distinct [R, C] of GoogLeNetBN's 66 BatchNorm boundaries."""
    s = image // 2
    shapes = {(batch * s * s, 64)}
    s //= 2
    shapes |= {(batch * s * s, 64), (batch * s * s, 192)}
    for name, (c1, c3r, c3, c5r, c5, cp) in BLOCKS.items():
        side = {"3": image // 8, "4": image // 16, "5": image // 32}[name[0]]
        shapes |= {(batch * side * side, c) for c in (c1, c3r, c3, c5r, c5,
                                                      cp)}
    return sorted(shapes, reverse=True)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["vgg16", "googlenetbn"])
def test_bn_kernels_at_the_models_boundaries(cuda, model):
    shapes = (sorted(set(chip_smoke.vgg_bn_shapes(64)), reverse=True)
              if model == "vgg16" else googlenetbn_shapes(32))
    errs = {}
    chip_smoke.phase_kernels(tfn, torch, cuda, shapes,
                             (torch.bfloat16, torch.float32), errs)
    assert set(errs) == {"stats_call", "apply_call", "bwd_reduce_call",
                         "bwd_dx_call"}


@pytest.mark.gpu
@pytest.mark.parametrize("model,boundaries", [("vgg16", 13),
                                              ("googlenetbn", 66)])
def test_one_step_launches_every_boundary_once(cuda, model, boundaries):
    if model == "vgg16":
        net, x = VGG16(dtype=torch.bfloat16), torch.randn(8, 3, 32, 32)
    else:
        net = GoogLeNetBN(num_classes=10, dtype=torch.bfloat16,
                          aux_heads=True, image_size=96)
        x = torch.randn(8, 3, 96, 96)
    net.train()
    tfn.reset_launch_counts()
    out = net(x.to(cuda))
    logits, aux = out if isinstance(out, tuple) else (out, ())
    y = torch.zeros(8, dtype=torch.long, device=cuda)
    loss = F.cross_entropy(logits, y) + sum(0.3 * F.cross_entropy(a, y)
                                            for a in aux)
    loss.backward()
    torch.cuda.synchronize()
    assert tfn.launch_counts() == dict.fromkeys(
        ("stats_call", "apply_call", "bwd_reduce_call", "bwd_dx_call"),
        boundaries)
    assert torch.isfinite(loss)


@pytest.mark.gpu
def test_vgg16_float32_step_matches_the_plain_runs(cuda):
    out = chip_smoke.p23_f32_step(tfn, torch, cuda)
    assert set(out) == {"plain", "cpu"}


@pytest.mark.gpu
def test_dropout_masks_on_the_card_repeat_for_a_seed(cuda):
    gen = torch.Generator(device=cuda)
    d = Dropout(0.5, gen)
    x = torch.ones(10000, device=cuda)
    gen.manual_seed(7)
    a = d(x)
    gen.manual_seed(7)
    assert torch.equal(d(x), a)
    assert 0.45 < float((a != 0).float().mean()) < 0.55
