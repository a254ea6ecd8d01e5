"""The port's two measurement entry points on the CPU.

``bench_conv_probe.main`` at a small M gives the JAX probe's document shape
(renamed keys, the card's bound); ``bench.main`` prints the JAX bench's CPU
smoke line (``bench.py``: the keys at :152-160 and ``smoke`` at :193) plus
``norm``.  Without ``--device`` both raise on a box with no card: the port
never falls back to the CPU on its own.  On the CPU the probe's wrappers
take their plain versions and record the host's wall time (``host_ms``),
never a device time.
"""

import json

import pytest
import torch

from chainermn_tpu_torch.benchmarks import bench, bench_conv_probe
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = ("wgrad", "dgrad", "fwd1x1")


def test_probe_on_the_cpu(tmp_path):
    out = tmp_path / "probe.json"
    doc = bench_conv_probe.main(["--device", "cpu", "--M", "4096",
                                 "--blocks", "1024,2048,1000",
                                 "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    assert doc["schema"] == "conv_probe_torch/v1"
    assert doc["schema_version"] == 1 and doc["backend"] == "cpu"
    assert doc["M"] == 4096 and doc["n_devices"] == 1
    assert doc["peak_assumed"] is True and doc["device_kind"] is None
    assert set(doc["cases"]) == set(CASES) | {"conv3x3_fwd",
                                              "conv3x3_fwd_bwd"}
    for name in CASES:
        row = doc["cases"][name]
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
        assert "host_ms" in row["library"]
        assert "device_ms" not in row["library"]
        # 1000 does not divide 4096: skipped, as in the JAX probe
        assert set(row["kernel_sweep"]) == {"1024", "2048"}
        assert row["kernel_best"]["bm"] in (1024, 2048)
        for res in row["kernel_sweep"].values():
            assert res["max_abs_err"] == 0.0   # plain against plain here
        assert ("workspace_mb" in row["kernel_sweep"]["1024"]) == (
            name == "wgrad")
    assert doc["cases"]["conv3x3_fwd_bwd"]["flops_g"] == pytest.approx(
        3 * doc["cases"]["conv3x3_fwd"]["flops_g"])
    assert doc["cases"]["conv3x3_fwd"]["batch"] == 1
    for banned in ("pallas_sweep", "xla", "hbm_gbps_assumed",
                   "lane_ceiling_tflops"):
        assert banned not in json.dumps(doc)


def test_probe_kernel_failure_raises():
    """A block size that divides M but that the kernel does not take raises
    (the JAX probe recorded it and went on)."""
    with pytest.raises(ValueError, match="multiple of 64"):
        bench_conv_probe.main(["--device", "cpu", "--M", "1024",
                               "--blocks", "512,32"])


def test_bench_on_the_cpu(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    out = bench.main(["--device", "cpu", "--metrics", str(metrics)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "stem",
                        "scan_steps", "smoke", "norm"}
    assert out["metric"] == "tiny_resnet_cpu_smoke_train_throughput"
    assert out["smoke"] is True and out["norm"] == "fused"
    assert out["stem"] == "conv7" and out["scan_steps"] == 1
    assert out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 125.0)
    rec = json.loads(metrics.read_text())
    assert rec["kind"] == "bench" and rec["value"] == out["value"]


@pytest.mark.parametrize("flags", [["--stem", "s2d"], ["--scan", "4"]])
def test_bench_unported_knobs_raise(flags):
    # --stem s2d runs (the space-to-depth stem); several steps a dispatch
    # stay refused, naming their eager counterpart, the captured step
    argv = ["--device", "cpu", "--attempts", "1"] + flags
    if flags[0] == "--stem":
        out = bench.main(argv)
        assert out["stem"] == "s2d" and out["scan_steps"] == 1
        assert out["smoke"] is True and out["value"] > 0
        return
    with pytest.raises(NotImplementedError, match="captured train step"):
        bench.main(argv)


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA card")
    for call in (lambda: bench_conv_probe.main(["--M", "1024"]),
                 lambda: bench.main(["--attempts", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
