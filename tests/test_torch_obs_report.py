"""``python -m chainermn_tpu_torch.tools.obs_report`` against JAX's
``tools/obs_report.py``.

Both render the same inputs: a metrics JSONL of every record kind the
sections read, the golden flight dumps of ``tests/data`` (a desync hang
and the attribution pair), a lint/protocol findings document, the
committed run ledger and run diff.  The port is given the inputs with
JAX's link classes renamed to the card's (``ici``/``dcn`` ->
``nvlink``/``ib``, as its own writers record them), and its text must be
JAX's with the same renaming.  A renamed link changes a table's column
widths, so the texts are compared with runs of whitespace, and the
dashes of a table's rule row, collapsed.
"""

import importlib.util
import json
import os
import re
import time

import pytest
from torch_obs_links import seeded_events, to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from chainermn_tpu_torch.tools import obs_report as port_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_obs_report", os.path.join(REPO, "tools", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _jax_tool()


def _norm(text: str, rename: bool = False) -> str:
    if rename:
        text = re.sub(r"\bici\b", "nvlink", text)
        text = re.sub(r"\bdcn\b", "ib", text)
    text = re.sub(r"-{2,}", "--", text)  # a table's rule row
    return re.sub(r"\s+", " ", text).strip()


def _records():
    """JSONL records of every kind a metrics section reads (JAX's link
    names)."""
    from chainermn_tpu.observability import contention as jcont
    events = {r: seeded_events(5, rank=r) for r in range(2)}
    cont = jcont.contention_report(events)
    cont["kind"] = "contention_report"
    hist = {"count": 3, "sum": 0.03, "min": 0.005, "max": 0.015,
            "quantiles": {"0.5": 0.01, "0.9": 0.014, "0.99": 0.015}}
    return [
        {"kind": "metric", "name": "comm_collective_calls", "type": "counter",
         "labels": {"op": "allreduce_grad", "comm": "XlaCommunicator"},
         "value": 3, "ts": 1.0},
        {"kind": "metric", "name": "comm_collective_bytes", "type": "counter",
         "labels": {"op": "allreduce_grad", "comm": "XlaCommunicator",
                    "dtype": "bfloat16"}, "value": 1048576, "ts": 1.0},
        dict(hist, kind="metric", name="comm_collective_seconds",
             type="histogram", labels={"op": "allreduce_grad",
                                       "comm": "XlaCommunicator"}, ts=1.0),
        {"kind": "metric", "name": "comm_object_calls", "type": "counter",
         "labels": {"op": "bcast_obj", "comm": "XlaCommunicator"},
         "value": 2, "ts": 1.0},
        {"kind": "step_report", "iteration": 10, "epoch": 1, "steps": 10,
         "examples_per_sec": 1234.5, "data_load_s_mean": 0.001,
         "host_put_s_mean": 0.002, "dispatch_s_mean": 0.003,
         "device_block_s_mean": 0.004, "step_s_mean": 0.01},
        {"kind": "straggler_report", "n_ranks": 2, "median_step_s": 0.01,
         "threshold": 1.5,
         "ranks": [{"rank": 0, "count": 10, "mean_s": 0.01, "p50_s": 0.01,
                    "p95_s": 0.012, "max_s": 0.013},
                   {"rank": 1, "count": 10, "mean_s": 0.03, "p50_s": 0.03,
                    "p95_s": 0.031, "max_s": 0.032}],
         "stragglers": [{"rank": 1, "mean_s": 0.03, "ratio_vs_median": 3.0}]},
        {"kind": "bench_allreduce", "communicator": "xla", "devices": 4,
         "payload_mib": 64.0, "time_ms": 10.0, "busbw_gbps": 11.2},
        {"kind": "metric", "name": "compression_bits_per_param",
         "type": "gauge", "labels": {"seam": "plan:inter:dcn", "bucket": "1",
                                     "compressor": "int8"}, "value": 8.25},
        {"kind": "metric", "name": "compression_wire_bytes_saved",
         "type": "counter", "labels": {"seam": "plan:inter:dcn",
                                       "bucket": "1", "compressor": "int8"},
         "value": 3 << 20},
        {"kind": "metric", "name": "compression_saturated_chunks",
         "type": "gauge", "labels": {"seam": "plan:inter:dcn", "bucket": "1",
                                     "compressor": "int8"}, "value": 2},
        {"kind": "metric", "name": "compression_residual_norm",
         "type": "gauge", "labels": {"seam": "optimizer", "bucket": "0",
                                     "compressor": "fp8"}, "value": 0.125},
        {"kind": "bench_serving", "policy": "continuous", "requests": 8,
         "generated_tokens": 512, "tokens_per_sec": 640.5,
         "ttft_s": {"p50": 0.02, "p99": 0.05},
         "per_token_s": {"p50": 0.001, "p99": 0.004}},
        {"kind": "bench_serving_prefix", "speedup": 1.7,
         "cached": {"stats": {"hits": 6, "admits": 8, "hit_tokens": 300,
                              "prompt_tokens": 400, "cached_pages": 12,
                              "evictions": 1}}},
        {"kind": "bench_serving_spec", "k": 4, "acceptance_rate": 0.6,
         "accept_tokens_per_step": 2.4, "speedup": 1.8,
         "spec": {"verify_rows": 40}},
        {"kind": "bench_serving_fleet", "replicas": 2, "sessions": 4,
         "requests": 16, "tokens_per_sec": 900.0,
         "ttft_s": {"p50": 0.03, "p99": 0.07}, "session_affinity_ok": True,
         "prefix_hits": 5},
        {"kind": "metric", "name": "serving_queue_depth", "type": "gauge",
         "labels": {}, "value": 3},
        {"kind": "metric", "name": "serving_prefix_prompt_tokens",
         "type": "counter", "labels": {}, "value": 400},
        {"kind": "metric", "name": "serving_prefix_hit_tokens",
         "type": "counter", "labels": {}, "value": 120},
        {"kind": "metric", "name": "serving_spec_rows", "type": "counter",
         "labels": {}, "value": 10},
        {"kind": "metric", "name": "serving_spec_proposed_tokens",
         "type": "counter", "labels": {}, "value": 40},
        {"kind": "metric", "name": "serving_spec_accepted_tokens",
         "type": "counter", "labels": {}, "value": 22},
        {"kind": "metric", "name": "serving_spec_out_tokens",
         "type": "counter", "labels": {}, "value": 32},
        {"kind": "step_attribution", "iteration": 10, "rank": 0,
         "step_s": 0.02, "sum_frac": 1.0,
         "buckets": {"compute": 0.010, "ici_comm": 0.002, "dcn_comm": 0.004,
                     "host_input": 0.003, "checkpoint": 0.0,
                     "stall": 0.001}},
        {"kind": "metric", "name": "attribution_regressions_total",
         "type": "counter", "labels": {"bucket": "dcn_comm"}, "value": 2},
        {"kind": "plan_table_state", "iteration": 12,
         "table_hash": "abcd1234", "last_swap_step": 8,
         "observed_gbps": {"ici": 80.5, "dcn": 3.25},
         "cells": [{"topology": "inter:2,intra:2", "dtype": "float32",
                    "bucket": "1MiB", "plan": "hier_dcn_bf16",
                    "striped": True}]},
        {"kind": "plan_table_swap", "iteration": 8, "table_hash": "abcd1234",
         "best_speedup": 1.31,
         "evidence": [{"bucket": "dcn_comm", "ratio": 2.5, "iteration": 7}]},
        {"kind": "fleet_telemetry", "step": 5, "n_ranks": 2,
         "dropped_events": 0,
         "occupancy": {"dcn": {"allreduce_grad": {
             "busy_s": 0.012, "by_rank": {"0": 0.006, "1": 0.006},
             "truncated": True}}},
         "truncated": [["dcn", "allreduce_grad"]],
         "overlap": [{"link": "dcn", "owners": ["allreduce_grad", "moe"],
                      "contended_s": 0.002}],
         "step_time": {"0": 0.01, "1": 0.02}, "stragglers": [1],
         "slo": {"serving_ttft_seconds": {
             "count": 8, "quantiles": {"p50": 0.02, "p95": 0.04,
                                       "p99": 0.05}}}},
        cont,
    ]


@pytest.fixture(scope="module")
def jsonl_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_report")
    recs = _records()
    paths = []
    for name, rows in (("jax.jsonl", recs), ("port.jsonl", to_port(recs))):
        p = str(d / name)
        with open(p, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        paths.append(p)
    return paths


def _render(tool, argv, capsys):
    rc = tool.main(argv)
    cap = capsys.readouterr()
    return rc, cap.out


def _unpath(text, argv):
    """The input paths of ``argv`` (shown in a report's header or its
    dump table) as placeholders: the two tools read files of their own."""
    for i, a in enumerate(argv):
        if os.sep in a:
            text = text.replace(a, f"<input {i}>")
    return text


def _assert_same(argv_jax, argv_port, capsys, rename=True):
    rc_j, out_j = _render(JAX_TOOL, argv_jax, capsys)
    rc_p, out_p = _render(port_tool, argv_port, capsys)
    assert rc_p == rc_j
    assert _norm(_unpath(out_p, argv_port)) == \
        _norm(_unpath(out_j, argv_jax), rename=rename)
    return out_p


@pytest.mark.parametrize("flags", [
    [], ["--section", "collectives"], ["--section", "steps"],
    ["--section", "straggler"], ["--section", "bench"], ["--compression"],
    ["--serving"], ["--attribution"], ["--contention"]])
def test_metrics_sections_equal_jax(flags, jsonl_pair, capsys):
    jx, pt = jsonl_pair
    out = _assert_same(flags + [jx], flags + [pt], capsys)
    assert out.strip()


def test_metrics_mode_refusals_equal_jax(tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    _assert_same([str(empty)], [str(empty)], capsys)
    with pytest.raises(SystemExit):
        port_tool.main(["--trace", str(tmp_path / "t.json"), str(empty)])
    capsys.readouterr()


@pytest.fixture(scope="module")
def flight_dirs(tmp_path_factory):
    """The golden dumps as JAX wrote them and renamed for the port."""
    out = {}
    for name in ("flight", "attr_flight"):
        d = tmp_path_factory.mktemp(name)
        for r in (0, 1):
            doc = json.load(open(os.path.join(DATA, f"{name}_{r}.json")))
            with open(d / f"flight_{r}.json", "w") as f:
                json.dump(to_port(doc), f)
        out[name] = (os.path.join(DATA, f"{name}_0.json"),
                     os.path.join(DATA, f"{name}_1.json")), \
            (str(d / "flight_0.json"), str(d / "flight_1.json"))
    return out


def _jax_flight_report(jx, pt, max_events=60):
    """JAX's ``--flight`` report, its merged timeline rendered from the
    dumps with the card's link names: that table prints each event's
    fields cut to 60 characters, so a longer link name shifts the cut."""
    J = JAX_TOOL
    jd, pd = J.load_flight_dumps(list(jx)), J.load_flight_dumps(list(pt))
    parts = [J.flight_summary_section(jd), J.flight_desync_section(jd),
             J.flight_timeline_section(pd, max_events=max_events),
             J.flight_fsdp_lane_section(jd), J.flight_contention_section(jd),
             J.flight_attribution_section(jd)]
    return "\n\n".join(p for p in parts if p)


def _assert_flight_same(jx, pt, flags, capsys):
    rc, out_p = _render(port_tool, ["--flight", *pt] + flags, capsys)
    assert rc == 0
    want = _jax_flight_report(jx, pt, int(flags[-1]) if flags else 60)
    assert _norm(_unpath(out_p, pt)) == _norm(_unpath(want, jx),
                                              rename=True)
    return out_p


@pytest.mark.parametrize("golden", ["flight", "attr_flight"])
@pytest.mark.parametrize("flags", [[], ["--events", "5"]])
def test_flight_report_equals_jax(golden, flags, flight_dirs, capsys):
    jx, pt = flight_dirs[golden]
    _assert_flight_same(jx, pt, flags, capsys)


@pytest.mark.parametrize("golden", ["flight", "attr_flight"])
@pytest.mark.parametrize("flag", ["--attribution", "--contention"])
def test_flight_lanes_equal_jax(golden, flag, flight_dirs, capsys):
    jx, pt = flight_dirs[golden]
    _assert_same(["--flight", *jx, flag], ["--flight", *pt, flag], capsys)


def test_flight_trace_equals_jax(flight_dirs, tmp_path, capsys):
    jx, pt = flight_dirs["attr_flight"]
    tj, tp = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    _render(JAX_TOOL, ["--flight", *jx, "--trace", tj], capsys)
    _render(port_tool, ["--flight", *pt, "--trace", tp], capsys)
    doc_p = json.load(open(tp))
    assert doc_p == to_port(json.load(open(tj)))
    xs = [e for e in doc_p["traceEvents"] if e.get("ph") == "X"]
    assert xs and {e["pid"] for e in xs} == {0, 1}


def test_flight_ring_overflow_equals_jax(tmp_path, capsys):
    src = json.load(open(os.path.join(DATA, "attr_flight_0.json")))
    src["dropped_events"] = 7
    pj, pp = tmp_path / "j", tmp_path / "p"
    pj.mkdir()
    pp.mkdir()
    json.dump(src, open(pj / "flight_0.json", "w"))
    json.dump(to_port(src), open(pp / "flight_0.json", "w"))
    out = _assert_flight_same([str(pj / "flight_0.json")],
                              [str(pp / "flight_0.json")], ["--events", "5"],
                              capsys)
    assert "RING OVERFLOW: rank 0 lost 7 event(s)" in out


def test_flight_without_dumps_fails_as_jax(tmp_path, capsys):
    _assert_same(["--flight", str(tmp_path)], ["--flight", str(tmp_path)],
                 capsys)


def test_lint_and_protocol_documents_equal_jax(flight_dirs, capsys):
    lint = os.path.join(REPO, "PROTOCOL_LINT_r20.json")
    out = _assert_same(["--lint", lint], ["--lint", lint], capsys)
    assert "control-plane protocol model" in out
    jx, pt = flight_dirs["flight"]
    rc, out_p = _render(port_tool, ["--flight", *pt, "--lint", lint], capsys)
    assert rc == 0
    want = _jax_flight_report(jx, pt) + "\n\n" + JAX_TOOL.lint_section(
        JAX_TOOL.load_lint_doc(lint))
    assert _norm(_unpath(out_p, pt)) == _norm(_unpath(want, jx),
                                              rename=True)


def test_ledger_and_diff_documents_equal_jax(tmp_path, capsys):
    led = os.path.join(REPO, "LEDGER_r17.json")
    diff = os.path.join(REPO, "REGRESSION_DIFF_r17.json")
    port_diff = tmp_path / "diff.json"
    port_diff.write_text(json.dumps(to_port(json.load(open(diff)))))
    out = _assert_same(["--ledger", led, "--diff", diff],
                       ["--ledger", led, "--diff", str(port_diff)], capsys)
    assert "REGRESSED: dcn_comm" in out


def test_live_loop_renders_as_jax(jsonl_pair, capsys, monkeypatch):
    """One refresh of ``--live``, then the interrupt that ends it."""
    def stop(_s):
        raise KeyboardInterrupt
    monkeypatch.setattr(time, "sleep", stop)
    jx, pt = jsonl_pair
    out = _assert_same(["--live", jx], ["--live", pt], capsys)
    assert "obs_report --live" in out
