"""The CPU smokes of the ImageNet slice's benchmarks (split from
``test_torch_imagenet_data.py``, whose example runs they sat beside):
``run_configs --tune-remat``, ``bench_vit`` (``xla`` and ``flash``) and its
FLOP count, and ``bench_resnet_probe`` (every variant, and ``--stages``);
``bench --stem s2d``'s is in ``test_torch_bench.py``.
"""

import json

import pytest
import torch.distributed as dist

from chainermn_tpu_torch.benchmarks import (
    bench_resnet_probe, bench_vit, run_configs)
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def test_tune_remat_smoke(world1, capsys):
    doc = run_configs.main(["--device", "cpu", "--tune-remat"])
    assert doc["schema"] == "remat_tune/v1" and doc["smoke"] is True
    rows = doc["configs"]["resnet50_xla"]["rows"]
    assert list(rows) == ["none", "block", "norm"]
    # the policies change the memory, not the arithmetic
    assert len({r["final_loss"] for r in rows.values()}) == 1
    assert doc["configs"]["resnet50_xla"]["selected"] in rows
    assert "resnet50_hier" not in doc["configs"]  # a world of one
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(doc))


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_bench_vit_smoke(world1, attention):
    out = bench_vit.main(["--device", "cpu", "--attention", attention])
    assert out["metric"] == "tiny_vit_cpu_smoke_train_throughput"
    assert out["smoke"] is True and out["value"] > 0
    assert out["final_loss"] < out["first_loss"]
    assert out["step_calls"] == 7  # 2 warm-up + 5 timed
    assert out["train_gflop_per_image"] == pytest.approx(
        bench_vit.vit_train_gflop_per_image(32, 8, 32, 2, 10))


def test_vit_gflop_count():
    # ViT-B/16 at 224: 197 tokens, the published ~17.6 G multiply-adds
    # forward (2 FLOPs each), x3 for training
    g = bench_vit.vit_train_gflop_per_image(224, 16, 768, 12, 1000)
    assert 3 * 2 * 17.0 < g < 3 * 2 * 18.0


def test_resnet_probe_smoke(world1, tmp_path):
    out = tmp_path / "probe.json"
    doc = bench_resnet_probe.main(
        ["--device", "cpu", "--steps", "1", "--out", str(out),
         "--variants", ",".join(bench_resnet_probe.VARIANTS)])
    assert json.loads(out.read_text())["schema"] == "resnet_probe/v1"
    assert doc["smoke"] is True
    assert list(doc["variants"]) == list(bench_resnet_probe.VARIANTS)
    assert all(v["ms_per_step"] > 0 for v in doc["variants"].values())
    assert doc["traffic"]["num_boundaries"] == 53
    stages = bench_resnet_probe.main(["--device", "cpu", "--stages",
                                      "--batch", "1"])["stages"]
    assert [*stages] == [s[0] for s in bench_resnet_probe.STAGES]
    with pytest.raises(SystemExit, match="unknown variant"):
        bench_resnet_probe.main(["--device", "cpu", "--variants", "fulll"])
