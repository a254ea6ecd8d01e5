"""The port's run ledger and its CLI against the JAX package's.

* ``classify_artifact`` and ``build_manifest`` over every committed
  ``*_r*.json`` / ``BENCH_*.json`` artifact equal JAX's (the checkout's
  ``git_sha`` pinned to one value on both sides; an artifact's device
  kind is its own).
* ``KNOWN_SCHEMAS`` holds JAX's and every schema the port's writers stamp.
* ``RunLedger`` round-trips through its JSONL file and its snapshot
  document; ``ingest_artifacts``, ``trend`` and ``cells`` equal JAX's.
* An H100-stamped record lands in a cell of its own: a baseline for it is
  never a TPU or CPU record, and a TPU baseline is never an H100 record.
* ``python -m chainermn_tpu_torch.tools.ledger`` ``ingest``, ``trend`` and
  ``diff`` give JAX's documents (the diff's link names read as the card's).
"""

import importlib.util
import json
import os
import re

import pytest
from torch_obs_links import to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from chainermn_tpu.observability import ledger as jl
from chainermn_tpu_torch.observability import ledger as pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = [os.path.basename(p) for p in jl.iter_artifacts(REPO)]
H100 = "NVIDIA H100 80GB HBM3"
SHA = "0123456789abcdef0123456789abcdef01234567"
ENVELOPE = ("git_sha", "device_kind", "schema_version")


def _tool(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def pinned_sha(monkeypatch):
    """Both packages stamp the same checkout sha."""
    monkeypatch.setattr(jl, "git_sha", lambda root=None: SHA)
    monkeypatch.setattr(pl, "git_sha", lambda root=None: SHA)


def _strip(doc):
    return {k: v for k, v in doc.items() if k not in ENVELOPE}


def test_committed_artifacts_are_there():
    assert len(ARTIFACTS) >= 40


def test_known_schemas_hold_jax_and_every_port_writer():
    assert set(jl.KNOWN_SCHEMAS) <= set(pl.KNOWN_SCHEMAS)
    written = set()
    pkg = os.path.join(REPO, "chainermn_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                written |= set(re.findall(r'"([a-z_]+/v\d+)"', text))
    written -= {"flight_dump/v1"}  # a dump's own tag, not an artifact
    assert written, "no schema string found in the port"
    assert written <= set(pl.KNOWN_SCHEMAS), written - pl.KNOWN_SCHEMAS


@pytest.mark.parametrize("name", ARTIFACTS)
def test_classify_and_manifest_equal_jax(name, pinned_sha):
    path = os.path.join(REPO, name)
    doc = json.load(open(path))
    assert pl.classify_artifact(doc, path) == jl.classify_artifact(doc, path)
    assert pl.classify_artifact(doc, path) is not None
    assert pl.build_manifest(doc, path, root=REPO) == \
        jl.build_manifest(doc, path, root=REPO)


@pytest.mark.parametrize("doc", [
    [], 3, {"schema": "nonsense/v9"}, {"kind": "not_a_schema"},
    {"suite": "tpu_smoke"}, {"bench": "benchmarks/bench_vit.py"},
    {"n": 1, "cmd": "x", "rc": 0, "tail": ""},
    {"n_devices": 4, "rc": 0, "ok": True, "tail": ""},
    [{"config": "a", "metric": "b", "value": 1}],
    {"schema": "bench_transport/v1", "git_sha": "x"},
])
def test_classify_shapes_equal_jax_where_jax_knows_them(doc):
    got = pl.classify_artifact(doc)
    if isinstance(doc, dict) and doc.get("schema") == "bench_transport/v1":
        # the port's own writer: registered here, unknown to JAX
        assert got == {"schema": "bench_transport/v1", "schema_version": 1,
                       "legacy": False}
        assert jl.classify_artifact(doc) is None
    else:
        assert got == jl.classify_artifact(doc)


def test_ingest_trend_and_cells_equal_jax(pinned_sha):
    led_p, led_j = pl.RunLedger(), jl.RunLedger()
    man_p, prob_p = pl.ingest_artifacts(REPO, led_p)
    man_j, prob_j = jl.ingest_artifacts(REPO, led_j)
    assert man_p == man_j and prob_p == prob_j == []
    assert led_p.cells() == led_j.cells()
    for metric in ("headline", "tracing_overhead_pct", "retune_speedup",
                   "serving_tokens_per_sec", "async_ckpt_stall_ms"):
        assert led_p.trend(metric) == led_j.trend(metric)
        for (dk, schema) in led_j.cells():
            for direction in ("higher", "lower"):
                assert led_p.baseline(schema, dk, metric, direction) == \
                    led_j.baseline(schema, dk, metric, direction)
    assert _strip(led_p.to_doc()) == _strip(led_j.to_doc())


def test_ledger_round_trips_jsonl_and_snapshot(tmp_path, pinned_sha):
    path = str(tmp_path / "runs.jsonl")
    led = pl.RunLedger(path)
    pl.ingest_artifacts(REPO, led)
    again = pl.RunLedger.load(path)
    assert again.records() == led.records()
    snap = tmp_path / "LEDGER.json"
    snap.write_text(json.dumps(led.to_doc()))
    assert pl.RunLedger.load(str(snap)).records() == led.records()
    assert pl.RunLedger.from_doc(led.to_doc()).cells() == led.cells()
    with pytest.raises(ValueError, match="run_manifest/v1"):
        led.append({"schema": "other/v1"})
    with pytest.raises(ValueError, match="run_ledger/v1"):
        pl.RunLedger.from_doc({"schema": "x"})


def _record(device_kind, value, name, schema="elastic_smoke/v1",
            backend="cuda"):
    doc = {"schema": schema, "device_kind": device_kind, "backend": backend,
           "git_sha": SHA, "n_devices": 1,
           "async_ckpt": {"stall_ms": value}, "chaos": {"lost_steps": 0}}
    return pl.build_manifest(doc, f"{name}_r{int(value)}.json")


def test_h100_records_keep_a_cell_of_their_own():
    led = pl.RunLedger()
    led.append(_record("TPU v5 lite", 1.0, "TPU"))
    led.append(_record(None, 2.0, "HOST", backend="cpu"))
    led.append(_record(H100, 40.0, "CARD"))
    led.append(_record(H100, 30.0, "CARD2"))
    assert led.cells() == {("TPU v5 lite", "elastic_smoke/v1"): 1,
                           ("cpu", "elastic_smoke/v1"): 1,
                           (H100, "elastic_smoke/v1"): 2}
    best = led.baseline("elastic_smoke/v1", H100, "async_ckpt_stall_ms",
                        "lower")
    assert best["device_kind"] == H100 and best["metrics"][
        "async_ckpt_stall_ms"] == 30.0
    # the card's baseline excluding its own run is still a card's
    other = led.baseline("elastic_smoke/v1", H100, "async_ckpt_stall_ms",
                         "lower", exclude_artifact="CARD2_r30.json")
    assert other["device_kind"] == H100
    for dk in ("TPU v5 lite", "cpu"):
        rec = led.baseline("elastic_smoke/v1", dk, "async_ckpt_stall_ms",
                           "lower")
        assert rec["device_kind"] == dk
    assert led.baseline("elastic_smoke/v1", "TPU v4",
                        "async_ckpt_stall_ms", "lower") is None
    assert [r["device_kind"] for r in led.trend(
        "async_ckpt_stall_ms", device_kind=H100)] == [H100, H100]


def test_detect_device_kind_is_none_without_a_card():
    import torch
    if torch.cuda.is_available():
        assert pl.detect_device_kind() == torch.cuda.get_device_name(0)
    else:
        assert pl.detect_device_kind() is None


# ---- the CLI -----------------------------------------------------------------

JTOOL = os.path.join(REPO, "tools", "ledger.py")


def _both(argv, capsys):
    """Run JAX's CLI and the port's on ``argv``; their (rc, last stdout
    line parsed) pairs."""
    from chainermn_tpu_torch.tools import ledger as port_cli
    jax_cli = _tool(JTOOL, "jax_ledger_cli")
    out = []
    for cli, args in ((jax_cli, argv[0]), (port_cli, argv[1])):
        rc = cli.main(args)
        lines = capsys.readouterr().out.strip().splitlines()
        out.append((rc, json.loads(lines[-1])))
    return out


def test_cli_ingest_equals_jax(tmp_path, capsys, pinned_sha):
    a, b = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    (rc_j, res_j), (rc_p, res_p) = _both(
        (["ingest", "--root", REPO, "--out", a],
         ["ingest", "--root", REPO, "--out", b]), capsys)
    assert rc_j == rc_p == 0
    assert {k: v for k, v in res_p.items() if k != "out"} == \
        {k: v for k, v in res_j.items() if k != "out"}
    assert _strip(json.load(open(b))) == _strip(json.load(open(a)))


def test_cli_trend_equals_jax(capsys, pinned_sha):
    argv = ["trend", "headline", "--root", REPO]
    (rc_j, res_j), (rc_p, res_p) = _both((argv, argv), capsys)
    assert rc_j == rc_p == 0 and res_p == res_j and res_p["points"] > 0


@pytest.mark.parametrize("pair", [
    ("healthy_dcn_spans.json", "degraded_dcn_spans.json"),
    ("healthy_dcn_spans.json", "healthy_dcn_spans.json"),
])
def test_cli_span_diff_equals_jax(pair, tmp_path, capsys):
    a, b = (os.path.join(REPO, "tests", "data", p) for p in pair)
    oj, op = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    (rc_j, res_j), (rc_p, res_p) = _both(
        (["diff", a, b, "--out", oj], ["diff", a, b, "--out", op]), capsys)
    assert rc_j == rc_p == 0
    assert res_p["regressed"] == res_j["regressed"]
    assert res_p["bucket"] == res_j["bucket"]
    assert _strip(json.load(open(op))) == to_port(
        _strip(json.load(open(oj))))


def test_cli_artifact_diff_equals_jax(tmp_path, capsys, pinned_sha):
    a = os.path.join(REPO, "TRACING_OVERHEAD_r16.json")
    b = os.path.join(REPO, "TRACING_OVERHEAD_r17.json")
    oj, op = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    (rc_j, _), (rc_p, _) = _both(
        (["diff", a, b, "--out", oj], ["diff", a, b, "--out", op]), capsys)
    assert rc_j == rc_p == 0
    assert _strip(json.load(open(op))) == _strip(json.load(open(oj)))
