"""The elastic supervisor, its restart manifests and the smoke tools.

* ``scan_latest_generation`` gives JAX's answers on the same checkpoint
  directories; ``load_flight_dumps`` / ``build_restart_manifest`` give
  JAX's documents on the same dumps (the port's with the card's link
  names, timestamps and envelope aside).
* ``Supervisor``: the child environment (the ``torchrun`` names, the
  ``CHAINERMN_TPU_*`` contract, the control plane on the port after the
  store's, the CPU when asked, per-attempt world and device schedules);
  output past a pipe's 64 KB does not block a child; an incident kills the
  survivors, embeds the survivor's dump and relaunches; the restart budget
  and a missing ``RESULT`` line are errors.
* The chaos run: JAX's MLP worker on a 2-rank gloo world, rank 1 SIGKILLed
  at step 7 of 12, relaunched at the same size: a ``restart_manifest/v1``
  with the survivor's flight dump, at most one lost step, and the losses
  of the uninterrupted run bit for bit.
* ``attribution_smoke`` on a 2-rank gloo world passes JAX's three checks;
  ``elastic_run`` runs a worker file.
"""

import json
import os
import sys

import numpy as np
import pytest
from torch_obs_links import seeded_events, to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from chainermn_tpu_torch.elastic import manifest as pm
from chainermn_tpu_torch.elastic.supervisor import (
    Supervisor, SupervisorConfig, scan_latest_generation)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- generations -------------------------------------------------------------

SCENARIOS = {
    "n_ranks_pins": [(4, 0), (4, 1), (5, 0), (5, 1), (6, 0)],
    "torn_rank_file": [(4, 0), (4, 1), (5, 0), (5, "torn")],
    "larger_world_superset": [(7, 0), (7, 1), (7, 2), (7, 3)],
    "gap": [(3, 0), (3, 2), (2, 0), (2, 1)],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("n_ranks", [None, 1, 2, 4])
def test_scan_latest_generation_equals_jax(name, n_ranks, tmp_path):
    from chainermn_tpu.elastic.supervisor import \
        scan_latest_generation as jax_scan
    for gen, rank in SCENARIOS[name]:
        fn = tmp_path / f"snap.{gen}.rank{1 if rank == 'torn' else rank}.npz"
        if rank == "torn":
            fn.write_bytes(b"torn")
        else:
            np.savez(str(fn), a=np.zeros(1))
    got = scan_latest_generation(str(tmp_path), "snap", n_ranks=n_ranks)
    assert got == jax_scan(str(tmp_path), "snap", n_ranks=n_ranks)
    assert scan_latest_generation(str(tmp_path / "missing"), "snap") is None


# ---- manifests ---------------------------------------------------------------

def _dumps(d, port):
    for r in (0, 1):
        evs = seeded_events(11, rank=r)
        doc = {"kind": "flight_dump", "schema": "flight_dump/v1", "rank": r,
               "ts": 1.0, "reason": "watchdog", "dropped_events": 3 * r,
               "ring_capacity": 64, "collective_state": {}, "events": evs,
               "threads": [],
               "clock": {"rank": r, "offsets": {
                   "1": {"offset_s": 0.002, "rtt_s": 0.001}} if r == 0
                   else {}}}
        with open(os.path.join(d, f"flight_{r}.json"), "w") as f:
            json.dump(to_port(doc) if port else doc, f)
    (d / "flight_2.json").write_text("{torn")


def _strip(doc):
    return {k: v for k, v in doc.items()
            if k not in ("ts", "git_sha", "device_kind", "schema_version")}


def test_restart_manifest_equals_jax(tmp_path):
    from chainermn_tpu.elastic import manifest as jm
    dj, dp = tmp_path / "j", tmp_path / "p"
    dj.mkdir()
    dp.mkdir()
    _dumps(dj, port=False)
    _dumps(dp, port=True)
    assert pm.load_flight_dumps(str(dp)) == to_port(
        jm.load_flight_dumps(str(dj)))
    kw = dict(incident=2, reason="rank 1 exited rc=-9 (killed)",
              exit_codes={0: -9, 1: -9}, resume_generation=6, attempt=1,
              world_before=2, world_after=1,
              watchdog_config={"CHAINERMN_TPU_WATCHDOG_HEARTBEAT": "0.2"},
              resize={"from_world": 2, "to_world": 1},
              extra={"stderr_tails": {"1": "killed"}})
    doc_p = pm.build_restart_manifest(dump_dir=str(dp), **kw)
    doc_j = jm.build_restart_manifest(dump_dir=str(dj), **kw)
    assert _strip(doc_p) == to_port(_strip(doc_j))
    assert doc_p["schema"] == "restart_manifest/v1"
    assert doc_p["evidence"]["truncated"] is True
    assert sorted(doc_p["flight_dumps"]) == ["0", "1"]
    assert doc_p["attribution"]["steps"]
    path = pm.write_restart_manifest(doc_p, str(tmp_path / "out"))
    assert path.endswith("restart_manifest_2.json")
    assert json.load(open(path))["incident"] == 2
    empty = pm.build_restart_manifest(dump_dir=str(tmp_path / "none"), **kw)
    assert empty["attribution"] is None and empty["flight_dumps"] == {}


# ---- the supervisor ----------------------------------------------------------

_ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT", "CHAINERMN_TPU_PROCESS_ID",
             "CHAINERMN_TPU_NUM_PROCESSES", "CHAINERMN_TPU_COORDINATOR",
             "CHAINERMN_TPU_DEVICE", "CHAINERMN_TPU_ELASTIC_ATTEMPT",
             "CHAINERMN_TPU_FLIGHT_DIR", "EXTRA")

_FLAKY = r"""
import json, os, sys, time
attempt = int(os.environ["CHAINERMN_TPU_ELASTIC_ATTEMPT"])
rank = int(os.environ["RANK"])
if attempt == 0 and rank == 1:
    sys.stderr.write("rank 1 going down\n")
    sys.exit(3)
if attempt == 0:
    # the survivor's watchdog dump, then a hang in a "collective"
    d = os.environ["CHAINERMN_TPU_FLIGHT_DIR"]
    with open(os.path.join(d, "flight_" + str(rank) + ".json"), "w") as f:
        json.dump({"kind": "flight_dump", "rank": rank, "reason": "hb",
                   "dropped_events": 0, "ring_capacity": 8,
                   "collective_state": {}, "events": [], "threads": []}, f)
    time.sleep(120)
sys.stdout.write("x" * 200000 + "\n")   # past a pipe's 64 KB
sys.stderr.write("y" * 200000 + "\n")
print("RESULT " + json.dumps({k: os.environ.get(k) for k in KEYS}))
""".replace("KEYS", repr(_ENV_KEYS))


def _config(tmp_path, **kw):
    d = {k: str(tmp_path / k) for k in ("dumps", "out")}
    for v in d.values():
        os.makedirs(v, exist_ok=True)
    return SupervisorConfig(dump_dir=d["dumps"], out_dir=d["out"],
                            attempt_timeout_s=60, env={"EXTRA": "1"}, **kw)


def test_supervisor_relaunches_after_an_incident(tmp_path):
    cfg = _config(tmp_path, n_procs=2, device="cpu", max_restarts=1,
                  resize_schedule=[2, 1], device_schedule=["cpu", None])
    sup = Supervisor(_FLAKY, cfg)
    out = sup.run()
    res = out["results"]
    assert list(res) == [0]               # attempt 1 runs a world of one
    env = res[0]
    assert env["WORLD_SIZE"] == "1" and env["RANK"] == "0"
    assert env["LOCAL_RANK"] == "0" and env["LOCAL_WORLD_SIZE"] == "1"
    assert env["CHAINERMN_TPU_NUM_PROCESSES"] == "1"
    assert env["CHAINERMN_TPU_COORDINATOR"] == \
        f"127.0.0.1:{int(env['MASTER_PORT']) + 1}"
    assert env["CHAINERMN_TPU_DEVICE"] is None   # the card, by default
    assert env["CHAINERMN_TPU_ELASTIC_ATTEMPT"] == "1"
    assert env["CHAINERMN_TPU_FLIGHT_DIR"] == cfg.dump_dir
    assert env["EXTRA"] == "1"
    assert [a["world"] for a in out["attempts"]] == [2, 1]
    assert [a["device"] for a in out["attempts"]] == ["cpu", None]
    (man,) = out["manifests"]
    doc = json.load(open(man))
    assert doc["reason"] == "rank 1 exited rc=3"
    assert doc["exit_codes"] == {"0": -9, "1": 3}   # the survivor killed
    assert list(doc["flight_dumps"]) == ["0"]
    assert "rank 1 going down" in doc["stderr_tails"]["1"]
    assert doc["world"] == {"before": 2, "after": 1}
    assert not [f for f in os.listdir(cfg.dump_dir) if f.endswith(".json")]
    logs = os.listdir(os.path.join(cfg.out_dir, "logs"))
    assert "attempt0.rank1.err" in logs and "attempt1.rank0.out" in logs


def test_supervisor_cpu_env_and_budget(tmp_path):
    cfg = _config(tmp_path, n_procs=2, device="cpu", max_restarts=0)
    with pytest.raises(RuntimeError, match="gave up after 1 incidents"):
        Supervisor(_FLAKY, cfg).run()
    assert len(os.listdir(cfg.out_dir)) == 2   # the manifest and the logs
    ok = _config(tmp_path / "ok", n_procs=2, device="cpu")
    out = Supervisor(_FLAKY.replace("attempt == 0", "attempt < 0"),
                     ok).run()
    assert sorted(out["results"]) == [0, 1]
    assert {r["CHAINERMN_TPU_DEVICE"] for r in out["results"].values()} == \
        {"cpu"}
    assert out["manifests"] == [] and len(out["attempts"]) == 1


def test_supervisor_refuses_a_world_without_results(tmp_path):
    cfg = _config(tmp_path, n_procs=2, device="cpu")
    src = "import os\nif os.environ['RANK'] == '0':\n    print('RESULT {}')\n"
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1\] exited 0 "
                                           r"without a RESULT line"):
        Supervisor(src, cfg).run()


def test_supervisor_times_out_a_wedged_world(tmp_path):
    cfg = _config(tmp_path, n_procs=1, device="cpu", max_restarts=0)
    cfg.attempt_timeout_s = 1.0
    sup = Supervisor("import time\ntime.sleep(60)\n", cfg)
    with pytest.raises(RuntimeError, match="gave up"):
        sup.run()
    assert "attempt timeout" in sup.incidents[0]["reason"]
    assert sup.attempts[0]["failure"]["exit_codes"] == {0: -9}


def test_elastic_run_cli(tmp_path, capsys):
    from chainermn_tpu_torch.tools import elastic_run
    worker = tmp_path / "w.py"
    worker.write_text(_FLAKY)
    rc = elastic_run.main([str(worker), "--device", "cpu", "--n-procs", "2",
                           "--dump-dir", str(tmp_path), "--out-dir",
                           str(tmp_path), "--max-restarts", "1",
                           "--attempt-timeout-s", "60",
                           "--env", "EXTRA=2"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and len(out["manifests"]) == 1
    assert out["results"]["0"]["EXTRA"] == "2"


# ---- the chaos run and the smokes --------------------------------------------

def test_chaos_run_loses_at_most_one_step_bit_for_bit(tmp_path):
    from chainermn_tpu_torch.tools import elastic_smoke as es
    chaos = es.run_chaos(12, 7, str(tmp_path), timeout=120, device="cpu")
    assert chaos["ok"], chaos["checks"]
    assert chaos["restarts"] == 1 and chaos["lost_steps"] <= 1
    assert chaos["max_loss_delta"] == 0.0        # the same bits
    assert chaos["steps_compared"] >= 12 - 7 - 1   # resumed at 6 or 7
    doc = json.load(open(chaos["manifest"]))
    assert doc["schema"] == "restart_manifest/v1"
    assert "0" in doc["flight_dumps"]            # the survivor's dump
    assert doc["flight_dumps"]["0"]["events"]


def test_attribution_smoke_on_a_gloo_world(tmp_path, capsys):
    from chainermn_tpu_torch.tools import attribution_smoke as at
    out = str(tmp_path / "ATTRIBUTION.json")
    rc = at.main(["--device", "cpu", "--steps", "4", "--out", out,
                  "--dump-dir", str(tmp_path / "dumps")])
    capsys.readouterr()
    doc = json.load(open(out))
    assert rc == 0 and doc["ok"], doc["checks"]
    assert [c["name"] for c in doc["checks"]] == [
        "buckets_sum_to_step_time", "critical_path_names_rank_and_span",
        "trace_json_round_trips"]
    assert doc["schema"] == "attribution_smoke/v1"
    assert doc["device_kind"] == "cpu" and doc["n_ranks"] == 2


def test_elastic_smoke_async_leg_on_the_cpu():
    from chainermn_tpu_torch.tools import elastic_smoke as es
    ab = es.run_async_ab(n_saves=3, device="cpu")
    assert ab["ok"] and ab["last_generation_resumable"] == 2
    assert ab["stall_ms"] < ab["sync_stall_ms"]
    assert ab["state_bytes"] == 8 * 512 * 512 * 4


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
