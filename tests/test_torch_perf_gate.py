"""``python -m chainermn_tpu_torch.tools.perf_gate`` against JAX's
``tools/perf_gate.py``.

Every mode runs on the committed artifacts in both tools, with JAX's
budgets file given as the input (``--budgets``/``--floors``): the exit
code, the summary line and the ``--out`` document (and the ``--table``
plan table) must be JAX's; a document's envelope (``git_sha``,
``device_kind``) is the only field that may differ.  The port's own
:file:`perf_budgets.json` holds no TPU or CPU-host figure.
"""

import importlib.util
import json
import os
import sys

import pytest
from torch_obs_links import to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from chainermn_tpu_torch.tools import perf_gate as port_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BUDGETS = os.path.join(REPO, "tools", "perf_budgets.json")
PORT_BUDGETS = os.path.join(REPO, "chainermn_tpu_torch", "tools",
                            "perf_budgets.json")
ENVELOPE = ("git_sha", "device_kind", "schema_version")


def _jax_gate():
    spec = importlib.util.spec_from_file_location(
        "jax_perf_gate", os.path.join(REPO, "tools", "perf_gate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_GATE = _jax_gate()


def _a(name):
    return os.path.join(REPO, name)


MODES = {
    "budgets": ["--budgets", JAX_BUDGETS, "--root", REPO],
    "budgets_strict": ["--budgets", JAX_BUDGETS, "--root", REPO,
                       "--strict", "--max-regression-pct", "50"],
    "planner": ["--planner", _a("ALLREDUCE_SWEEP_r06.json")],
    "planner_striped": ["--planner", _a("ALLREDUCE_SWEEP_STRIPED_r11.json"),
                        "--require-striped", "1"],
    "planner_compressed": ["--planner",
                           _a("ALLREDUCE_SWEEP_COMPRESSED_r08.json")],
    "planner_striped_too_many": ["--planner",
                                 _a("ALLREDUCE_SWEEP_STRIPED_r11.json"),
                                 "--require-striped", "99"],
    "online_tune": ["--online-tune", _a("ONLINE_TUNE_r12.json")],
    "online_tune_high": ["--online-tune", _a("ONLINE_TUNE_r12.json"),
                         "--retune-threshold", "99"],
    "joint": ["--joint", _a("JOINT_SWEEP_r18.json")],
    "serving_v2": ["--serving", _a("SERVING_r13.json"),
                   "--floors", JAX_BUDGETS],
    "serving_v1": ["--serving", _a("SERVING_r07.json"),
                   "--floors", JAX_BUDGETS],
    "moe": ["--moe", _a("ALLTOALL_SWEEP_r15.json"),
            "--moe-bench", _a("MOE_BENCH_r15.json")],
    "moe_strict": ["--moe", _a("ALLTOALL_SWEEP_r15.json"),
                   "--require-alltoall-wins", "99",
                   "--require-dcn-shrink", "9"],
    "elastic": ["--elastic", _a("ELASTIC_r19.json"), "--floors",
                JAX_BUDGETS],
    "ledger": ["--ledger", _a("LEDGER_r17.json"), "--floors", JAX_BUDGETS,
               "--root", REPO],
    "wrong_schema": ["--elastic", _a("ONLINE_TUNE_r12.json")],
}


def _strip(doc):
    if isinstance(doc, dict):
        return {k: v for k, v in doc.items() if k not in ENVELOPE}
    return doc


def _run_jax(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["perf_gate.py"] + argv)
    return JAX_GATE.main()


def _gate_pair(mode, tmp_path, monkeypatch, capsys):
    outs = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        argv = MODES[mode] + ["--out", str(d / "out.json")]
        if mode.startswith(("planner", "moe")):
            argv += ["--table", str(d / "table.json")]
        rc = (_run_jax(argv, monkeypatch) if side == "jax"
              else port_gate.main(argv))
        lines = capsys.readouterr().out.strip().splitlines()
        files = {}
        for f in ("out.json", "table.json"):
            if (d / f).exists():
                files[f] = _strip(json.load(open(d / f)))
        outs.append((rc, json.loads(lines[-1]) if lines else None, files))
    return outs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_equals_jax(mode, tmp_path, monkeypatch, capsys):
    (rc_j, line_j, files_j), (rc_p, line_p, files_p) = _gate_pair(
        mode, tmp_path, monkeypatch, capsys)
    assert rc_p == rc_j
    assert line_p == line_j
    assert set(files_p) == set(files_j)
    for name in files_j:
        # plan specs carry link classes: the port's are the card's
        assert files_p[name] == to_port(files_j[name]), name


def test_expected_verdicts():
    """The committed artifacts pass the gates they were made for, and the
    impossible requirements fail (so the parity above covers both)."""
    want = {"planner": 0, "planner_striped": 0, "planner_striped_too_many": 1,
            "online_tune": 0, "online_tune_high": 1, "joint": 0,
            "moe": 0, "moe_strict": 1, "elastic": 0, "wrong_schema": 2,
            "serving_v2": 0}
    for mode, rc in want.items():
        assert port_gate.main(MODES[mode]) == rc, mode


def test_port_budgets_hold_no_tpu_or_host_figure():
    doc = json.load(open(PORT_BUDGETS))
    jax_doc = json.load(open(JAX_BUDGETS))
    assert doc["schema"] == "perf_budgets/v1"
    rules = {"serving_prefix_cache_speedup",
             "serving_spec_accept_tokens_per_step",
             "elastic_resume_lost_steps"}
    jax_values = {m["name"]: m["budget"] for m in jax_doc["metrics"]}
    for m in doc["metrics"]:
        if m["name"] in rules:
            assert m["budget"] == jax_values[m["name"]], m["name"]
            continue
        # any other floor is the card's own reading, named with its card
        assert m["unit"] in ("ms", "images/sec/chip", "tokens/sec/chip",
                             "tokens/sec", "GB/s", "s"), m
        assert "NVIDIA" in m["comment"] and " W" in m["comment"], m
        assert m["budget"] != jax_values.get(m["name"]), m


def test_elastic_gate_without_a_stall_ceiling(tmp_path):
    """The port's budgets have no millisecond ceiling the card has not
    measured: the stall is held by the async-below-sync rule alone."""
    doc = json.load(open(_a("ELASTIC_r19.json")))
    ok = str(tmp_path / "ok.json")
    json.dump(doc, open(ok, "w"))
    out = str(tmp_path / "gate.json")
    assert port_gate.main(["--elastic", ok, "--floors", PORT_BUDGETS,
                           "--out", out]) == 0
    names = [c["name"] for c in json.load(open(out))["checks"]]
    assert names == ["elastic_resume_lost_steps"]
    doc["async_ckpt"]["stall_ms"] = doc["async_ckpt"]["sync_stall_ms"]
    bad = str(tmp_path / "bad.json")
    json.dump(doc, open(bad, "w"))
    assert port_gate.main(["--elastic", bad, "--floors", PORT_BUDGETS]) == 1
    doc["async_ckpt"]["stall_ms"] = 0.5
    doc["chaos"]["lost_steps"] = 2
    json.dump(doc, open(bad, "w"))
    assert port_gate.main(["--elastic", bad, "--floors", PORT_BUDGETS]) == 1


def test_exactly_one_mode():
    with pytest.raises(SystemExit):
        port_gate.main([])
    with pytest.raises(SystemExit):
        port_gate.main(["--elastic", "a", "--ledger", "b"])
