"""The port's measurement utilities: retry, the card table, the profiler
trace reader, the result envelope and the JSONL sink.

``stamp_envelope`` is held to the JAX package's on the same documents; the
retry classification, the card table and the trace reader are the port's
own (the JAX versions' markers, TPU peaks and trace layout do not apply),
so they are tested for what they must do on a GPU.
"""

import gzip
import importlib
import json
import os

import pytest
import torch

from chainermn_tpu.observability import ledger as jledger
from chainermn_tpu_torch.observability import (
    append_jsonl, schema_version, stamp_envelope)
from chainermn_tpu_torch.utils import gpu_info, retry
from chainermn_tpu_torch.utils.trace import device_op_times, top_ops

trace = importlib.import_module("chainermn_tpu_torch.utils.trace")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- retry

@pytest.mark.parametrize("exc,transient", [
    (RuntimeError("[Rank 0] Watchdog caught collective operation timeout: "
                  "WorkNCCL(OpType=ALLREDUCE) ran for 600000 ms"), True),
    (RuntimeError("Connection reset by peer"), True),
    (ConnectionRefusedError("connection refused"), True),
    (TimeoutError("timed out waiting for the store"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (RuntimeError("wgrad: kernel launch failed with CUDA error 700"), False),
    (RuntimeError("building probe_matmul.cu failed (/usr/local/cuda/bin/nvcc"
                  " ...): error: identifier undefined"), False),
    (RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)"),
     False),
    (AssertionError("rowblock: 3 elements beyond one bf16 ulp"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     False),
    (ValueError("wgrad: bm 384 does not divide M 1024"), False),
    (RuntimeError("XlaRuntimeError: INTERNAL: something"), False),
])
def test_transient_classification(exc, transient):
    assert retry.is_transient(exc) is transient


def test_retry_counts_attempts(monkeypatch):
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("NCCL timeout in the store")
        return "ok"

    assert retry.retry_transient(flaky, attempts=3) == "ok"
    assert len(calls) == 3

    calls.clear()
    with pytest.raises(RuntimeError, match="timeout"):
        retry.retry_transient(flaky, attempts=2)
    assert len(calls) == 2


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: misaligned address"),
    RuntimeError("building flash_attention.cu failed (nvcc ...)"),
    AssertionError("wgrad: relative L2 error 3e-4 over 2e-05"),
])
def test_deterministic_failures_are_not_retried(monkeypatch, exc):
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    calls = []

    def doomed():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)):
        retry.retry_transient(doomed, attempts=5)
    assert len(calls) == 1


def test_retry_stops_an_open_profiler(monkeypatch):
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    from torch.profiler import ProfilerActivity, profile
    state = {"n": 0}

    def leaves_profiler_open():
        state["n"] += 1
        if state["n"] == 1:
            profile(activities=[ProfilerActivity.CPU]).__enter__()
            raise RuntimeError("socket closed: connection reset")
        assert not torch.autograd._profiler_enabled()
        return state["n"]

    assert retry.retry_transient(leaves_profiler_open, attempts=2) == 2


# ------------------------------------------------------------- gpu_info

@pytest.mark.parametrize("name,key,peak,bw,f32", [
    ("NVIDIA H100 80GB HBM3", "h100 80gb hbm3", 989.4, 3.35e12, 66.9),
    ("NVIDIA H100 PCIe", "h100 pcie", 756.5, 2.0e12, 51.0),
    ("NVIDIA H100 NVL", "h100 nvl", 835.5, 3.9e12, 60.0),
])
def test_card_table(name, key, peak, bw, f32):
    card, matched = gpu_info.card_info(name)
    assert matched == key
    assert (card.peak_tflops, card.hbm_bytes_per_s, card.f32_tflops) == (
        peak, bw, f32)
    assert gpu_info.peak_tflops_info(name) == (peak, key)
    assert gpu_info.PEAK_TFLOPS[key] == peak


def test_unknown_card_is_assumed():
    """An unknown card gets the SXM5 rates, marked as assumed (None)."""
    peak, matched = gpu_info.peak_tflops_info("NVIDIA A100-SXM4-80GB")
    assert matched is None and peak == 989.4
    card, matched = gpu_info.card_info("Some Future GPU")
    assert matched is None and card == gpu_info.CARDS["h100 80gb hbm3"]
    assert not any("tpu" in k for k in gpu_info.CARDS)


# ---------------------------------------------------------------- trace

def _write_trace(path, events, gz=False):
    """A Chrome trace shaped as torch.profiler exports it."""
    doc = {"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 0,
         "dur": dur_us} for cat, name, dur_us in events]}
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump(doc, f)
    return path


def test_device_op_times_reads_device_events_only(tmp_path):
    path = _write_trace(tmp_path / "trace.json", [
        ("kernel", "wgrad_chunk_kernel", 1000),
        ("kernel", "wgrad_chunk_kernel", 1500),
        ("kernel", "chunk_sum_kernel", 200),
        ("gpu_memset", "Memset (Device)", 10),
        ("cuda_runtime", "cudaLaunchKernel", 9000),   # host side
        ("cpu_op", "aten::mm", 5000),                 # host side
    ])
    times = device_op_times(str(path))
    assert times == {"wgrad_chunk_kernel": (2.5, 2),
                     "chunk_sum_kernel": (0.2, 1),
                     "Memset (Device)": (0.01, 1)}
    assert top_ops(str(path), n=1) == [("wgrad_chunk_kernel", 2.5, 2)]
    # a directory reads its newest trace, gzipped too
    gz = _write_trace(tmp_path / "later.json.gz",
                      [("kernel", "fusion.1", 300),
                       ("kernel", "fusion.2", 100),
                       ("gpu_memcpy", "Memcpy HtoD", 50)], gz=True)
    os.utime(gz, (2e9, 2e9))
    cats = top_ops(str(tmp_path), n=5, by_category=True)
    assert cats[0][0] == "fusion" and cats[0][2] == 2
    assert abs(cats[0][1] - 0.4) < 1e-12


def test_a_capture_without_device_events_raises(tmp_path):
    path = _write_trace(tmp_path / "host_only.json", [
        ("cpu_op", "aten::mm", 5000), ("cuda_runtime", "cudaMalloc", 10)])
    with pytest.raises(ValueError, match="no CUDA kernel events"):
        device_op_times(str(path))
    with pytest.raises(FileNotFoundError, match="no trace"):
        device_op_times(str(tmp_path / "missing"))


MARK = ("at::cuda::spin_kernel(long)", "kernel", 0.001)


def _calls(n, kernels=(("k", "kernel", 0.2),)):
    return [ev for _ in range(n) for ev in kernels]


@pytest.mark.parametrize("events,ok", [
    ([MARK] + _calls(5) + [MARK], True),
    ([MARK] + _calls(5, (("k", "kernel", 0.2), ("j", "kernel", 0.1),
                         ("Memset", "gpu_memset", 0.0))) + [MARK], True),
    ([MARK] + _calls(4) + [MARK], False),   # one launch lost
    (_calls(5) + [MARK], False),            # the first marker lost
    ([MARK] + _calls(5), False),            # the last marker lost
    (_calls(5), False),
    ([], False),
])
def test_a_capture_is_complete_only_with_every_kernel(events, ok):
    """A capture of 5 calls between two markers counts only if both
    markers and a multiple of 5 of every other kernel are in it."""
    assert trace.complete(events, 5) is ok


def test_device_time_refuses_a_box_without_a_card():
    """No card, no device time: it raises instead of reading 0 or timing
    the host."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace.device_time(lambda t: t * 2, (torch.ones(8),), steps=2,
                          warmup=1)


# --------------------------------------------------------------- ledger

def test_stamp_envelope_matches_jax():
    docs = [
        {"suite": "conv_probe_torch", "cases": {}},
        {"schema": "already/v3", "backend": "cuda", "n_devices": 4},
        {"device_kind": "kept", "git_sha": "abc"},
    ]
    for doc in docs:
        for schema in ("conv_probe_torch/v1", None):
            kw = dict(device_kind="NVIDIA H100 80GB HBM3", n_devices=1,
                      backend="cuda", root=REPO)
            ours = stamp_envelope(dict(doc), schema, **kw)
            ref = jledger.stamp_envelope(dict(doc), schema, **kw)
            assert ours == ref, (doc, schema)
    assert schema_version("conv_probe_torch/v1") == 1
    assert schema_version("x/v12") == 12 and schema_version("x") is None


def test_stamp_envelope_never_clobbers():
    doc = {"schema": "a/v2", "schema_version": 9, "device_kind": "mine",
           "n_devices": 3, "backend": "cpu", "git_sha": "deadbeef"}
    assert stamp_envelope(dict(doc), "b/v1", device_kind="other",
                          n_devices=8, backend="cuda") == doc


def test_append_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    append_jsonl(path, {"kind": "bench", "value": 1.5})
    append_jsonl(path, {"kind": "bench", "value": torch.tensor(2.5).item()})
    lines = open(path).read().splitlines()
    assert [json.loads(x)["value"] for x in lines] == [1.5, 2.5]
    assert lines[0] == '{"kind":"bench","value":1.5}'


@pytest.mark.parametrize("name,cat", [
    ("triton_stats_kernel_0d1d", "fused_norm (Triton)"),
    ("void bn_bwd_reduce_kernel<__nv_bfloat16, true>",
     "fused_norm reduce (CUDA)"),
    ("void cast_scale_kernel<float, __half>", "cast_scale (CUDA)"),
    ("ncclDevKernel_AllReduce_Sum_bf16", "nccl"),
    ("Memcpy DtoD (Device -> Device)", "memcpy / memset"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "conv / gemm"),
    ("void at::native::vectorized_elementwise_kernel<4>",
     trace.OTHER_CATEGORY),
])
def test_kernel_category_groups_kernel_names(name, cat):
    """The profile breakdowns' grouping of kernel names (first matching
    fragment wins; the rest is "other")."""
    assert trace.kernel_category(name) == cat


def test_kernel_category_takes_another_table():
    table = (("flash (CUDA)", ("fwd_wgmma_kernel",)), ("gemm", ("gemm",)))
    assert trace.kernel_category("fwd_wgmma_kernel<128>", table) == \
        "flash (CUDA)"
    assert trace.kernel_category("Memset", table) == trace.OTHER_CATEGORY


def test_capture_reliability_check_needs_a_card():
    """The capture check measures the profiler on the card; without one it
    raises instead of measuring anything else."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA card")
    from chainermn_tpu_torch.benchmarks import bench_device_time
    with pytest.raises(RuntimeError, match="no CUDA device|CUDA"):
        bench_device_time.main(["--rounds", "1", "--age", "0"])
