"""The online tuner's live inputs in the port against the JAX package's,
on the CPU.

JAX's ingest, replay and ``MetricsReport`` tests
(``tests/test_online_tune.py``) on the port, each against JAX's tuner on
the same events:

* ``LinkObservations.ingest_events`` / ``ingest_spans`` and
  ``OnlineTuner.ingest`` recover the link rates from ``plan_stage``
  spans (JAX's ``"ici"``/``"dcn"`` read as ``"nvlink"``/``"ib"``); the
  re-tune decision equals JAX's after the renaming
  (:func:`torch_obs_links.to_port`), floats bit for bit;
* the tuner's flight events (``plan_table_retune``, ``plan_table_swap``,
  ``workload_swap``, ``fsdp_prefetch_recommendation``) and metrics
  (``plan_table_swaps_total``, ``online_retunes_total``,
  ``retune_speedup``); ``observe_attribution`` feeds the prefetch advice,
  ``observe_timelines`` and ``reconstruct_workload(timelines=)`` gate the
  joint path;
* ``bench_allreduce --replay-spans`` over the committed degraded dump
  gives JAX's decision (``swap``, ``best_speedup``, ``cells``,
  ``table_hash``);
* ``MetricsReport(online_tune=True)`` writes JAX's records; two gloo
  ranks swap on the same step with only rank 0 armed.
"""

import argparse
import importlib
import importlib.util
import json
import os

import pytest

import chainermn_tpu.planner as J
from chainermn_tpu.observability import FlightRecorder as JRec
from chainermn_tpu.observability.contention import (
    feed_link_observations as jfeed)
import chainermn_tpu_torch.planner as T
from chainermn_tpu_torch import observability as pobs
from chainermn_tpu_torch.observability import FlightRecorder as PRec
from chainermn_tpu_torch.observability.contention import (
    feed_link_observations as pfeed)
from chainermn_tpu_torch.planner.online import plan_table_hash
import torch_dist_worker
from torch_obs_links import port_events, seeded_events, to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN_DUMP = os.path.join(REPO, "tests", "data", "degraded_dcn_spans.json")
TOPO = "inter:2,intra:4"
DCN_REGRESSION = [{"bucket": "dcn_comm", "value_s": 0.0168,
                   "baseline_s": 0.0042, "ratio": 4.0, "iteration": 100}]


@pytest.fixture(autouse=True)
def _fresh_state():
    for M in (J, T):
        M.clear_active_plan_table()
        M.clear_plan_slots()
    yield
    for M in (J, T):
        M.clear_active_plan_table()
        M.clear_plan_slots()
    pobs.disable()
    pobs.reset_flight_recorder()
    pobs.get_registry().reset()


def _stage_pair(t0, plan, stage, link, nbytes, gbps):
    dur = nbytes / (gbps * 1e9)
    base = dict(plan=plan, stage=stage, op="all_reduce",
                scope="intra" if link == "ici" else "inter", link=link,
                nbytes=nbytes)
    return [dict(kind="plan_stage_begin", ts=t0, **base),
            dict(kind="plan_stage_end", ts=t0 + dur, **base)], t0 + dur


def degraded_dcn_events(steps=8, dcn_gbps=0.5, ici_gbps=16.0):
    """JAX's scenario: 8 MiB over a ~0.5 GB/s inter-node hop, 1 MiB
    NVLink spans at 16 GB/s."""
    events, t = [], 0.0
    for _ in range(steps):
        pair, t = _stage_pair(t, "flat", 0, "dcn", 8 << 20, dcn_gbps)
        events += pair
        pair, t = _stage_pair(t, "hierarchical", 0, "ici", 1 << 20,
                              ici_gbps)
        events += pair
        t += 0.01
    return events


def _tuners(**kw):
    kw.setdefault("min_samples", 1)
    jkw, pkw = dict(kw), dict(kw)
    if "fallback_gbps" in kw:
        pkw["fallback_gbps"] = to_port(kw["fallback_gbps"])
    jr, pr = JRec(capacity=256), PRec(capacity=256)
    jt = J.OnlineTuner(topology=J.PlanTopology.from_key(TOPO), flight=jr,
                       **jkw)
    pt = T.OnlineTuner(topology=T.PlanTopology.from_key(TOPO), flight=pr,
                       **pkw)
    return jt, pt, jr, pr


@pytest.mark.parametrize("tags", ["jax", "port"])
def test_ingest_events_recovers_the_rates_as_jax(tags):
    evs = degraded_dcn_events()
    jo, po = J.LinkObservations(), T.LinkObservations()
    assert jo.ingest_events(evs) == 16
    assert po.ingest_events(evs if tags == "jax" else port_events(evs)) \
        == 16
    assert po.observed_gbps() == to_port(jo.observed_gbps())
    assert po.observed_gbps()["ib"] == pytest.approx(0.5, rel=1e-6)
    assert po.summary() == to_port(jo.summary())
    # only plan_stage spans count
    other = [dict(kind="collective_begin", op="x", op_seq=0, ts=0.0),
             dict(kind="collective_end", op="x", op_seq=0, ts=1.0)]
    assert T.LinkObservations().ingest_events(other) == 0


def test_ingest_spans_equals_jax():
    from chainermn_tpu.observability.spans import pair_events as jpair
    from chainermn_tpu_torch.observability.spans import pair_events as ppair
    evs = seeded_events(5)
    jo, po = J.LinkObservations(), T.LinkObservations()
    assert po.ingest_spans(ppair(evs)) == jo.ingest_spans(jpair(evs)) > 0
    assert po.observed_gbps() == to_port(jo.observed_gbps())


@pytest.mark.parametrize("case", ["degraded", "fallback", "seeded"])
def test_ingested_retune_decision_equals_jax(case):
    kw = {}
    evs = degraded_dcn_events()
    if case == "fallback":
        evs, _ = _stage_pair(0.0, "hierarchical", 0, "ici", 1 << 20, 16.0)
        kw["fallback_gbps"] = {"dcn": 2.0}
    if case == "seeded":
        evs = seeded_events(11)
    jt, pt, jr, pr = _tuners(**kw)
    assert pt.ingest(port_events(evs)) == jt.ingest(evs)
    assert not pt.armed
    assert jt.on_regression(DCN_REGRESSION)
    assert pt.on_regression(DCN_REGRESSION) and pt.armed
    want, got = jt.retune(), pt.retune()
    assert want is not None
    assert got == to_port(want)
    if case == "degraded":
        assert got["swap"] is True and got["best_speedup"] >= 1.05
        assert {c["old_plan"] for c in got["cells"]} == {"flat"}
        assert got["evidence"] == DCN_REGRESSION
        assert plan_table_hash(T.PlanTable.from_dict(got["table"])) == \
            got["table_hash"]
    assert [e["kind"] for e in pr.events_since(-1)] == \
        [e["kind"] for e in jr.events_since(-1)] == ["plan_table_retune"]
    assert pt.state() == to_port(jt.state())


def test_only_comm_buckets_arm():
    _, pt, _, _ = _tuners()
    assert not pt.on_regression([{"bucket": "compute", "ratio": 9.0}])
    assert not pt.armed
    assert pt.on_regression([{"bucket": "ici_comm", "ratio": 2.0}])
    assert pt.armed
    _, pt, _, _ = _tuners()
    assert pt.on_regression([{"bucket": "nvlink_comm", "ratio": 2.0}])


def test_no_observations_returns_none():
    _, pt, _, _ = _tuners()
    assert pt.retune() is None


def test_swap_events_and_metrics():
    pobs.enable()
    reg = pobs.get_registry()
    fr = PRec(capacity=256)
    tuner = T.OnlineTuner(topology=T.PlanTopology.from_key(TOPO),
                          flight=fr, registry=reg, min_samples=1)
    tuner.ingest(degraded_dcn_events())
    tuner.on_regression(DCN_REGRESSION)
    d = tuner.maybe_swap(step=9)
    assert d is not None and d["step"] == 9
    kinds = [e["kind"] for e in fr.events_since(-1)]
    assert kinds == ["plan_table_retune", "plan_table_swap"]
    swap = fr.events_since(-1)[-1]
    assert swap["table_hash"] == d["table_hash"] and swap["step"] == 9
    assert reg.get("plan_table_swaps_total").value() == 1
    assert reg.get("online_retunes_total").value() == 1
    assert reg.get("retune_speedup").value() == d["best_speedup"]
    assert T.active_plan_table_meta() == {"table_hash": d["table_hash"],
                                          "swap_step": 9}
    # defaults: the process-wide recorder and (switch on) registry
    rec = pobs.install_flight_recorder()
    t2 = T.OnlineTuner(topology=T.PlanTopology.from_key(TOPO))
    assert t2._flight is rec and t2._reg is reg


def test_prefetch_recommendation_from_attribution_equals_jax():
    jt, pt, jr, pr = _tuners()
    for tun in (jt, pt):
        for i in range(9):
            tun.observe_attribution(
                {"step_s": 1.0, "buckets": {"stall": 0.1 + 0.03 * i}})
    assert pt.recommend_prefetch(current=1, num_buckets=4) == \
        jt.recommend_prefetch(current=1, num_buckets=4) == 2
    want = [e for e in jr.events_since(-1)
            if e["kind"] == "fsdp_prefetch_recommendation"]
    got = [e for e in pr.events_since(-1)
           if e["kind"] == "fsdp_prefetch_recommendation"]
    strip = ("ts", "mono", "seq")
    assert [{k: v for k, v in e.items() if k not in strip} for e in got] \
        == [{k: v for k, v in e.items() if k not in strip} for e in want]


def _two_slots(M):
    M.register_plan_slot("allreduce", nbytes=4 << 20, op="all-reduce",
                         owners=("plan:", "fsdp", "collective"))
    M.register_plan_slot("moe", nbytes=8 << 20, op="all-to-all",
                         owners=("moe",))


@pytest.mark.parametrize("timelines", [
    None, {"ici": {"fsdp": [(0.0, 1.0)]}},
    {"ici": {"moe": [(0.0, 1.0)], "plan:intra": [(0.5, 2.0)]}},
    {"dcn": {"serving": [(0.0, 1.0)]}}])
def test_reconstruct_workload_timelines_equal_jax(timelines):
    for M in (J, T):
        _two_slots(M)
    jw = J.reconstruct_workload(J.PlanTopology.from_key(TOPO),
                                timelines=timelines)
    pw = T.reconstruct_workload(T.PlanTopology.from_key(TOPO),
                                timelines=to_port(timelines))
    assert (pw is None) == (jw is None)
    if pw is not None:
        assert [s.name for s in pw.slots] == [s.name for s in jw.slots]


def test_timeline_evidence_gates_the_joint_path():
    for M in (J, T):
        _two_slots(M)
    _, pt, _, _ = _tuners(joint=True,
                          fallback_gbps={"ici": 0.2, "dcn": 0.02})
    pt.observe_timelines({"nvlink": {"fsdp": [(0.0, 1.0)]}})
    assert pt.retune() is None  # one slot in flight, no payloads seen


def test_joint_decision_and_atomic_apply_events_equal_jax():
    for M in (J, T):
        _two_slots(M)
    jt, pt, jr, pr = _tuners(joint=True,
                             fallback_gbps={"ici": 0.2, "dcn": 0.02})
    occ = {"ici": {"moe": [(0.0, 1.0)], "fsdp": [(0.5, 1.5)]}}
    jt.observe_timelines(occ)
    pt.observe_timelines(to_port(occ))
    want, got = jt.retune(), pt.retune()
    assert got == to_port(want) and got["mode"] == "joint"
    jt.apply_decision(want, step=7)
    pt.apply_decision(got, step=7)
    strip = ("ts", "mono", "seq")
    ev = [[{k: v for k, v in e.items() if k not in strip}
           for e in r.events_since(-1)] for r in (jr, pr)]
    assert ev[1] == to_port(ev[0])
    assert [e["kind"] for e in ev[1]] == [
        "plan_table_retune", "workload_swap", "plan_table_swap"]


def test_derated_observations_beat_the_fallback_as_jax():
    jt, pt, _, _ = _tuners(fallback_gbps={"ici": 16.0, "dcn": 2.0})
    evs, _ = _stage_pair(0.0, "hierarchical", 0, "ici", 1 << 20, 16.0)
    jt.ingest(evs)
    pt.ingest(evs)
    derated = {"dcn": {"bytes": 8 << 20, "busy_s": (8 << 20) / 0.05e9,
                       "derate": 0.025}}
    jfeed(jt.observations, derated)
    pfeed(pt.observations, to_port(derated))
    want, got = jt.retune(), pt.retune()
    assert got == to_port(want)
    assert got["observed_gbps"]["ib"] == pytest.approx(0.05, rel=1e-6)


def _jax_replay(out):
    spec = importlib.util.spec_from_file_location(
        "jax_bench_allreduce", os.path.join(REPO, "benchmarks",
                                            "bench_allreduce.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._replay(argparse.Namespace(
        replay_spans=SPAN_DUMP, replay_topology=TOPO, stripe_ratios=None,
        link_gbps=None, replay_table=None, dtype="float32",
        replay_out=out))


def test_replay_reproduces_jax_s_decision(tmp_path):
    from chainermn_tpu_torch.benchmarks import bench_allreduce
    want = _jax_replay(str(tmp_path / "j.json"))
    out = tmp_path / "ONLINE_TUNE.json"
    got = bench_allreduce.main(["--replay-spans", SPAN_DUMP,
                                "--replay-topology", TOPO,
                                "--replay-out", str(out)])
    assert json.loads(out.read_text())["retune"] == got["retune"]
    assert got["schema"] == "online_tune/v1"
    assert got["n_spans"] == 24 and got["regression_events"] == 4
    for k in ("swap", "best_speedup", "cells", "table_hash", "threshold",
              "rows_merged"):
        assert got["retune"][k] == to_port(want["retune"][k]), k
    assert got["observed_gbps"] == to_port(want["observed_gbps"])
    assert got["retune"]["swap"] is True
    assert got["retune"]["best_speedup"] >= 1.05


def test_replay_with_link_rates_and_a_baseline_table(tmp_path):
    from chainermn_tpu_torch.benchmarks import bench_allreduce
    table = T.PlanTable()
    table.put(T.PlanTopology.from_key(TOPO), "float32", "<=256MiB",
              T.flavor_plan("hierarchical"))
    table.save(str(tmp_path / "table.json"))
    got = bench_allreduce.main([
        "--replay-spans", SPAN_DUMP, "--replay-table",
        str(tmp_path / "table.json"), "--link-gbps", "nvlink=300,ib=25",
        "--stripe-ratios", "0.5,0.75", "--replay-out",
        str(tmp_path / "o.json")])
    assert got["retune"] is not None
    assert {c["old_plan"] for c in got["retune"]["cells"]} == {
        "hierarchical"}
    with pytest.raises(ValueError, match="link"):
        bench_allreduce.main(["--replay-spans", SPAN_DUMP,
                              "--link-gbps", "ici=1"])


class _Upd:
    def __init__(self, comm):
        self.comm, self.iteration, self.telemetry = comm, 0, None
        self.epoch, self.is_new_epoch = 0, False


class _Trainer:
    def __init__(self, out, comm):
        self.out, self.elapsed_time = out, 0.0
        self.updater = _Upd(comm)


class _FixedClock:
    """The recorder's clock, made the same for JAX's and the port's:
    each read is 1 us after the previous one, and ``_drive`` moves it
    10 ms ahead at every iteration.  With the host's clock a loaded
    machine could put a stage span's midpoint outside the 6.5 ms step
    it was recorded in on one side only, and the two step trees (so
    the prefetch advice and the records) then differed."""

    def __init__(self, t0=1000.0):
        self.now = t0

    def _read(self):
        self.now += 1e-6
        return self.now

    time = monotonic = _read

    def advance(self, seconds):
        self.now += seconds


def _drive(M, report, out, comm, steps=4):
    """``steps`` iterations of a fake trainer; the degraded link's stage
    spans inside each step, an emit every 2.  The flight recorder reads
    a :class:`_FixedClock`."""
    from unittest import mock
    recorder = importlib.import_module(M.__name__ + ".flight_recorder")
    clock = _FixedClock()
    with mock.patch.object(recorder, "time", clock):
        return _drive_steps(M, report, out, comm, steps, clock)


def _drive_steps(M, report, out, comm, steps, clock):
    from chainermn_tpu.observability import read_jsonl
    # a recorder another test of this process left installed would be
    # returned as it is, with that test's events: start from none
    M.reset_flight_recorder()
    M.get_registry().reset()
    M.enable()
    fr = M.install_flight_recorder()
    tr = _Trainer(str(out), comm)
    report.initialize(tr)
    for i in range(steps):
        clock.advance(0.01)
        tr.updater.iteration = i + 1
        fr.record_phase("dispatch", i + 1)
        for e in degraded_dcn_events(steps=1):
            fr.record(e["kind"], **{k: v for k, v in e.items()
                                    if k not in ("kind", "ts")})
        tr.updater.telemetry.record_step(0.001, 0.0005, 0.002, 0.003, 8)
        fr.record_step(0.0065, iteration=i + 1)
        report(tr)
    report.finalize(tr)
    return read_jsonl(os.path.join(str(out), "metrics.jsonl"))


@pytest.mark.parametrize("online", [True, False])
def test_metrics_report_online_tune_records_are_jax_s(tmp_path, online):
    from chainermn_tpu import observability as jobs
    from chainermn_tpu.training.extensions import MetricsReport as JReport
    from chainermn_tpu_torch.training.extensions import MetricsReport

    class JComm:
        rank, size, host_size = 0, 1, 1

        def plan_topology(self):
            return J.PlanTopology.from_key(TOPO)

    class PComm:
        rank, size = 0, 1

        def plan_topology(self):
            return T.PlanTopology.from_key(TOPO)

    kw = dict(trigger=(2, "iteration"), online_tune=online,
              fsdp_prefetch=(1, 4) if online else None)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    try:
        jrecs = _drive(jobs, JReport(**kw), tmp_path / "j", JComm())
    finally:
        jobs.disable()
        jobs.reset_flight_recorder()
        jobs.get_registry().reset()
    prep = MetricsReport(**kw)
    precs = _drive(pobs, prep, tmp_path / "p", PComm())
    assert [r["kind"] for r in precs] == [r["kind"] for r in jrecs]
    js = [r for r in jrecs if r["kind"] == "plan_table_state"]
    ps = [r for r in precs if r["kind"] == "plan_table_state"]
    assert [s["iteration"] for s in ps] == ([2, 4] if online else [])
    # both recorders read the same fixed clock: the links, the sample
    # counts and the observed rates agree
    strip = ("ts", "observed_gbps")
    assert [{k: v for k, v in s.items() if k not in strip} for s in ps] \
        == to_port([{k: v for k, v in s.items() if k not in strip}
                    for s in js])
    assert [sorted(s["observed_gbps"]) for s in ps] == to_port(
        [sorted(s["observed_gbps"]) for s in js])
    assert [s["observed_gbps"] for s in ps] == to_port(
        [s["observed_gbps"] for s in js])
    assert (prep._tuner is not None) == online


def test_two_gloo_ranks_swap_on_the_same_step(tmp_path):
    """Only rank 0 observes the slow link and arms; the decision rides
    the object plane's broadcast, so both ranks swap at step 11 with the
    same table, pin and re-selected plan."""
    outs = torch_dist_worker.launch("obs", {"parts": "swap"}, 2, tmp_path)
    res = [json.loads(str(o["swap/doc"])) for o in outs]
    for r in res:
        assert r["swapped"] is True and r["n_swap_events"] == 1
        assert r["step"] == 11 and r["pin"]["swap_step"] == 11
        assert r["best_speedup"] >= 1.05
    assert res[0]["table_hash"] == res[1]["table_hash"]
    assert res[0]["pin"] == res[1]["pin"]
    assert res[0]["plan_8mib"] == res[1]["plan_8mib"] != "flat"
