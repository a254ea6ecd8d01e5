"""The long-context probe and the LM bench on the card.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
nothing else, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_long_context_gpu.py

* ``bench_flash_64k``'s window check at T 16384 and 65536 (B 1, H 4, D
  128, bf16, causal): the kernels' last 256 rows of out, lse and dq and
  their dk/dv rows of the last 256 keys against the plain version on
  those queries alone, within the bf16 tolerance;
* ``bench_lm``'s line at the LM's width cut to 2 layers: JAX's keys and
  the MFU, the exact FLOP count of that configuration, finite losses, 2
  launches of each flash kernel and 2 casts a step call.
"""

import importlib
import math
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("t", [16384, 65536])
def test_window_check_on_the_card(dev, t):
    from chainermn_tpu_torch.benchmarks import bench_flash_64k as probe
    q, k, v, g = probe.operands(dev, (1, t, 4, 128), 4, seed=t)
    res = probe.window_check(q, k, v, g)
    assert set(res["rel_l2"]) == {"out", "lse", "dq", "dk", "dv"}
    assert all(e <= probe.WINDOW_TOL for e in res["rel_l2"].values()), res
    assert res["launches"] == {"flash_fwd": 1, "flash_bwd_dkv": 1,
                               "flash_bwd_dq": 1}


def test_bench_lm_line_at_two_layers(dev):
    from chainermn_tpu_torch import init_distributed
    from chainermn_tpu_torch.benchmarks import bench_lm
    init_distributed()
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    fa.reset_launch_counts()
    cs.reset_launch_counts()
    line = bench_lm.main(["--layers", "2", "--attempts", "1"])
    torch.cuda.synchronize()
    for key in ("metric", "value", "unit", "seq_len", "d_model", "layers",
                "n_params_m", "train_gflop_per_token", "mfu", "peak_tflops",
                "step_ms", "device_ms_per_step", "device_busy_share"):
        assert key in line, key
    assert line["schema"] == "bench_lm/v1"
    assert line["train_gflop_per_token"] == round(
        bench_lm.lm_train_gflop_per_token(8192, 2048, 2, 32768, 16), 4)
    assert all(map(math.isfinite, (line["first_loss"], line["final_loss"],
                                   line["mfu"])))
    n = line["step_calls"]
    assert fa.launch_counts() == {"flash_fwd": 2 * n, "flash_bwd_dkv": 2 * n,
                                  "flash_bwd_dq": 2 * n}
    assert cs.cast_scale.launches == 2 * n
