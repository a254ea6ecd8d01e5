"""Observability's second slice on the card.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
nothing else, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_watchdog_gpu.py

On an NCCL world of one card:

* the watchdog's monitor thread runs while the main thread waits in
  ``torch.cuda.synchronize`` on a held stream (``torch.cuda._sleep``,
  a stimulus of a device-side hang): its ``step_stall`` dump is written
  before the synchronize returns, with the main thread's stack in it;
* the MNIST example on the float16 wire with ``--observability`` and
  ``CHAINERMN_TPU_WATCHDOG=1`` gives the parameters of the run without the
  watchdog, bit for bit, 2 x iterations cast launches, no dump and no
  watchdog thread after it;
* ``bench_allreduce --traced`` on the bf16 wire writes
  ``tracing_overhead/v1`` with 2 cast launches a call;
* after a small serving trace through the flash kernel, one
  ``TelemetryAggregator.collect`` gives the registry's percentiles.
"""

import importlib
import json
import os
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chainermn_tpu_torch import init_distributed
    init_distributed()
    yield torch.device("cuda")
    from chainermn_tpu_torch import observability as obs
    obs.disable()
    obs.reset_flight_recorder()
    obs.get_registry().reset()


def _same(a, b):
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(view), b.view(view))


def test_monitor_runs_while_the_host_waits_in_synchronize(cuda, tmp_path):
    from chainermn_tpu_torch import observability as obs
    rec = obs.FlightRecorder(capacity=64)
    for i in range(6):
        rec.record_step(0.001, iteration=i)
    wd = obs.Watchdog(rec, obs.WatchdogConfig(
        deadline_s=60.0, step_stall_factor=2.0, poll_interval_s=0.05,
        max_dumps=1, out_dir=str(tmp_path))).start()
    try:
        torch.cuda._sleep(1 << 31)  # ~1.1-1.3 s of the stream
        torch.cuda.synchronize()
        returned = time.time()
    finally:
        wd.stop()
    assert len(wd.dump_paths) == 1
    doc = json.load(open(wd.dump_paths[0]))
    assert doc["reason"].startswith("step_stall")
    assert doc["ts"] < returned
    main = [t for t in doc["threads"] if t["thread"] == "MainThread"]
    assert main and any("synchronize" in ln for ln in main[0]["stack"])
    assert obs.watchdog_thread_count() == 0


def _mnist(tmp_path, label, watchdog):
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.examples import train_mnist
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    out = str(tmp_path / label)
    old = os.environ.get("CHAINERMN_TPU_WATCHDOG")
    os.environ["CHAINERMN_TPU_WATCHDOG"] = "1" if watchdog else "0"
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    try:
        res = train_mnist.main([
            "--epoch", "1", "--unit", "1000", "--batchsize", "100",
            "--communicator", "xla", "--allreduce-grad-dtype", "float16",
            "--double-buffering", "--observability", "--out", out])
        torch.cuda.synchronize()
    finally:
        if old is None:
            os.environ.pop("CHAINERMN_TPU_WATCHDOG", None)
        else:
            os.environ["CHAINERMN_TPU_WATCHDOG"] = old
        obs.disable()
        obs.reset_flight_recorder()
        obs.get_registry().reset()
    return {"casts": cs.launch_counts()["cast_scale"],
            "iters": res["log"][-1]["iteration"],
            "params": res["model"].state_dict(),
            "dumps": [f for f in os.listdir(out)
                      if f.startswith("flight_") and f.endswith(".json")],
            "threads": obs.watchdog_thread_count()}


def test_mnist_under_the_watchdog_is_bit_equal(cuda, tmp_path):
    off = _mnist(tmp_path, "off", False)
    on = _mnist(tmp_path, "on", True)
    for r in (off, on):
        assert r["casts"] == 2 * r["iters"]
        assert r["dumps"] == [] and r["threads"] == 0
    assert all(_same(on["params"][k], off["params"][k])
               for k in off["params"])


def test_traced_on_the_bf16_wire(cuda, tmp_path):
    from chainermn_tpu_torch.benchmarks import bench_allreduce
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    cs.reset_launch_counts()
    doc = bench_allreduce.main([
        "--communicators", "xla", "--allreduce-grad-dtype", "bfloat16",
        "--mb", "16", "--iters", "5", "--warmup", "1", "--repeats", "2",
        "--traced", str(tmp_path / "t.json")])
    torch.cuda.synchronize()
    calls = 2 * 2 * (1 + 1 + 3 * 5)
    assert cs.launch_counts()["cast_scale"] == 2 * calls
    assert doc["schema"] == "tracing_overhead/v1"
    assert doc["backend"] == "cuda" and doc["timer"] == "event"
    assert doc["events_per_traced_run"] > 0
    assert len(doc["per_repeat_pct"]) == 2


def test_fleet_percentiles_after_serving(cuda):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    args = bs.parser().parse_args(["--dtype", "bfloat16", "--requests",
                                   "8"])
    obs.enable()
    model = bs.build_model(args)
    trace = bs.build_trace(args)
    eng = bs._engine(model, args, policy="continuous")
    fa.reset_launch_counts()
    for _, prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new)
    assert len(eng.run_until_idle()) == len(trace)
    assert fa.launch_counts()["flash_fwd"] > 0
    doc = obs.TelemetryAggregator(create_communicator("xla")).collect(0)
    reg = obs.get_registry()
    assert set(doc["slo"]) == {"serving_ttft_seconds",
                               "serving_token_seconds",
                               "serving_step_seconds"}
    for name, slo in doc["slo"].items():
        h = reg.get(name)
        counts = [0] * (len(h.bounds) + 1)
        for labels in h.labels_seen():
            for i, c in enumerate(h.state(**labels)["counts"]):
                counts[i] += c
        for q, v in slo["quantiles"].items():
            assert v == h._quantile_from_counts(counts, int(q[1:]) / 100)
