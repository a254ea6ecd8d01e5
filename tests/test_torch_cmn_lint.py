"""The port's static-analysis tools on the CPU.

* ``python -m chainermn_tpu_torch.tools.cmn_lint``: ``--list`` (JAX's
  rules), an entry point's JSON (exit 0 on a clean sweep), a planted
  fault through ``--rules`` exiting 1, ``--events``/``--artifacts``, and
  the findings document read back by ``obs_report --lint`` (JAX's lane);
* ``tools/check_db_overlap.py``'s verdicts from kernel timelines (the
  card's profile is judged by the same function), and its refusal to run
  without a card;
* ``tools/contention_smoke.py --device cpu``: a 2-rank gloo world, the
  five checks (check 4 is the port's ``lint_step``).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*argv, module="cmn_lint", timeout=300):
    return subprocess.run(
        [sys.executable, "-m", f"chainermn_tpu_torch.tools.{module}",
         *argv], capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_list_names_jax_s_entries_and_rules():
    from chainermn_tpu.analysis.entrypoints import ENTRY_POINTS as J
    from chainermn_tpu.analysis.rules import all_rules
    r = _cli("--list")
    assert r.returncode == 0, r.stderr[-800:]
    for name in J:
        assert f"  {name}:" in r.stdout
    for rule in all_rules():
        assert f"{rule.id} [{rule.severity}]: {rule.summary}" in r.stdout


def test_entry_point_json_and_obs_report_lane(tmp_path):
    out = tmp_path / "lint.json"
    r = _cli("examples/mnist", "--flavors", "xla,hierarchical", "--json",
             "--out", str(out))
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    doc = json.loads(r.stdout)
    assert doc["suite"] == "cmn_lint" and doc["ok"] is True
    assert doc["schema"] == "cmn_lint/v1" and doc["world"] == 8
    assert [rep["target"] for rep in doc["reports"]] == [
        "examples/mnist[xla]", "examples/mnist[hierarchical]"]
    for rep in doc["reports"]:
        for rule in ("schedule-desync", "census-drift",
                     "unpinned-transpose", "captured-constant",
                     "donation-alias", "async-pair"):
            assert rule not in rep["skipped"], rep["skipped"]
    assert json.loads(out.read_text())["ok"] is True
    r2 = _cli("--lint", str(out), module="obs_report")
    assert r2.returncode == 0, r2.stderr[-1500:]
    assert "cmn-lint static analysis" in r2.stdout and "CLEAN" in r2.stdout


def test_exit_code_on_findings(tmp_path):
    """A committed-artifact root holding a document of no registered
    schema is an error finding: exit 1, and obs_report lists it."""
    (tmp_path / "BENCH_r99.json").write_text(json.dumps({"x": 1}))
    out = tmp_path / "o" / "CMN_LINT_bad.json"
    r = _cli("--artifacts", str(tmp_path), "--out", str(out))
    assert r.returncode == 1, r.stdout
    assert "artifact-drift" in r.stdout and "ERROR" in r.stdout
    r2 = _cli("--lint", str(out.parent), module="obs_report")
    assert r2.returncode == 0 and "artifact-drift" in r2.stdout
    r3 = _cli("examples/mnist", "--flavors", "nope")
    assert r3.returncode != 0


def test_events_lane_on_a_flight_dump(tmp_path):
    ev = [{"kind": "fsdp_gather_begin", "ts": 1.0, "seq": 0, "bucket": 0,
           "link": "nvlink", "nbytes": 1 << 20},
          {"kind": "plan_stage_begin", "ts": 1.01, "seq": 1,
           "plan": "alltoall_hier", "op": "all_to_all", "stage": 0,
           "scope": "intra", "link": "nvlink", "nbytes": 1 << 16},
          {"kind": "fsdp_gather_end", "ts": 1.03, "seq": 2, "bucket": 0,
           "link": "nvlink", "nbytes": 1 << 20},
          {"kind": "plan_stage_end", "ts": 1.04, "seq": 3,
           "plan": "alltoall_hier", "op": "all_to_all", "stage": 0,
           "scope": "intra", "link": "nvlink", "nbytes": 1 << 16}]
    (tmp_path / "flight_0.json").write_text(json.dumps(
        {"rank": 0, "events": ev}))
    r = _cli("--events", str(tmp_path), "--json")
    assert r.returncode == 0, r.stderr[-800:]  # warnings only
    doc = json.loads(r.stdout)
    assert [f["rule"] for f in doc["findings"]] == ["overlapping-collectives"]
    assert doc["findings"][0]["details"]["link"] == "nvlink"


# ---------------------------------------------------------------------------
# check_db_overlap
# ---------------------------------------------------------------------------

def _k(name, ts, end, tid=7):
    return {"name": name, "ts": ts, "end": end, "tid": tid}


def _timeline(steps, pending_len, side_stream=True):
    """Kernels of ``steps`` double-buffered steps: markers around each
    forward on stream 7, the pending all-reduce (started at the update)
    and the loss all-reduce."""
    ks, t = [], 0.0
    for _ in range(steps):
        ks += [_k("spin_kernel", t, t + 1), _k("gemm", t + 1, t + 50),
               _k("spin_kernel", t + 50, t + 51)]
        upd = t + 120
        ks.append(_k("ncclDevKernel_AllReduce_Sum_f32", upd,
                     upd + pending_len, 9 if side_stream else 7))
        ks.append(_k("ncclDevKernel_AllReduce_Sum_f32", upd + 2, upd + 3,
                     7))
        t += 140
    return sorted(ks, key=lambda k: k["ts"])


def test_check_db_overlap_verdicts():
    from chainermn_tpu_torch.tools.check_db_overlap import judge
    split = judge(_timeline(4, pending_len=80), 4, 4)
    assert split["ok"] and split["verdict"].startswith("split")
    assert split["all_reduce_per_step"] == 2.0
    assert all(o > 0 for o in split["pending_overlap_us"])
    serial = judge(_timeline(4, pending_len=5), 4, 4)
    assert not serial["ok"] and serial["verdict"].startswith("serialized")
    merged = [k for k in _timeline(4, 80) if not (
        "nccl" in k["name"] and k["tid"] == 7)]
    m = judge(merged, 4, 4)
    assert not m["ok"] and m["verdict"].startswith("merged")
    one = judge(_timeline(4, 80), 4, 1)
    assert one["ok"] and one["verdict"].startswith("not judgeable")


def test_check_db_overlap_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks a box without a CUDA card")
    r = _cli("--steps", "2", module="check_db_overlap")
    assert r.returncode != 0 and "device='cpu'" in r.stderr


# ---------------------------------------------------------------------------
# contention_smoke
# ---------------------------------------------------------------------------

def test_contention_smoke_on_a_gloo_world(tmp_path):
    out = tmp_path / "CONTENTION.json"
    r = _cli("--device", "cpu", "--out", str(out), "--dump-dir",
             str(tmp_path / "dumps"), module="contention_smoke",
             timeout=240)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    doc = json.loads(out.read_text())
    assert doc["ok"] is True and doc["n_ranks"] == 2
    assert doc["schema"] == "contention_smoke/v1"
    names = [c["name"] for c in doc["checks"]]
    assert "overlapping_collectives_lint_fires" in names
    lint = next(c for c in doc["checks"]
                if c["name"] == "overlapping_collectives_lint_fires")
    assert any("fsdp" in f["details"]["identities"]
               for f in lint["findings"])
