"""The port's observability stack against the JAX package's.

* The same metric operations give the same ``MetricsRegistry.snapshot()``
  (counters, gauges, histogram quantiles, streaming-histogram buckets and
  quantiles) and byte-equal Prometheus text.
* Span pairing, step trees, attribution, the critical path, the cross-rank
  merge, the straggler report, duration summaries and the desync analysis
  give equal results on the same seeded event streams.
* The flight dump carries JAX's schema; the switch and the recorder gate
  as JAX's do.
* ``instrument_communicator`` over a gloo world of 1 and of 2 gives JAX's
  metric names, labels, call counts and bytes for one op sequence (JAX's
  side on its CPU mesh of the same size).  Seconds are not compared.
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
import torch_dist_worker
from chainermn_tpu.observability import attribution as jattr
from chainermn_tpu.observability import flight_recorder as jfr
from chainermn_tpu.observability import registry as jreg
from chainermn_tpu.observability import sinks as jsinks
from chainermn_tpu.observability import spans as jspans
from chainermn_tpu.observability import straggler as jstrag
from chainermn_tpu_torch import observability as pobs
from chainermn_tpu_torch.observability import attribution as pattr
from chainermn_tpu_torch.observability import flight_recorder as pfr
from chainermn_tpu_torch.observability import registry as preg
from chainermn_tpu_torch.observability import sinks as psinks
from chainermn_tpu_torch.observability import spans as pspans
from chainermn_tpu_torch.observability import straggler as pstrag


@pytest.fixture(autouse=True)
def _observability_off():
    """Each test leaves the process-wide switch, recorder and registry as
    it found them (off, none, empty)."""
    yield
    pobs.disable()
    pobs.reset_flight_recorder()
    pobs.get_registry().reset()


def _drive(reg, seed: int):
    rng = np.random.RandomState(seed)
    c = reg.counter("calls", "c")
    g = reg.gauge("depth", "g")
    h = reg.histogram("lat", "h", window_size=16)
    sh = reg.streaming_histogram("slo", "s", lo=1e-4, hi=10.0,
                                 buckets_per_decade=5)
    for i in range(50):
        lab = {"op": ["a", "b", "c"][i % 3], "wire": ["f32", "bf16"][i % 2]}
        c.inc(float(rng.randint(1, 9)), **lab)
        g.set(float(rng.randn()), q=str(i % 4))
        g.inc(0.5, q="x")
        h.observe(float(rng.exponential()), **lab)
        sh.observe(float(rng.exponential(0.05)), route=str(i % 2))
    sh.merge(sh.state(route="0"), route="merged")
    with reg.timer("timed", phase="t"):
        pass
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_prometheus_are_jax_s(seed):
    j = _drive(jreg.MetricsRegistry(), seed)
    p = _drive(preg.MetricsRegistry(), seed)
    strip = lambda snap: [r for r in snap if r["name"] != "timed"]  # noqa
    assert strip(p.snapshot()) == strip(j.snapshot())
    assert psinks.prometheus_text(strip(p.snapshot())) == \
        jsinks.prometheus_text(strip(j.snapshot()))
    assert psinks.prometheus_text(p.snapshot(), namespace="x:y") == \
        jsinks.prometheus_text(p.snapshot(), namespace="x:y")
    assert [r["count"] for r in p.snapshot() if r["name"] == "timed"] == [1]
    for q in (0.0, 0.3, 0.5, 0.99, 1.0):
        assert p.get("lat").quantile(q, op="a", wire="f32") == \
            j.get("lat").quantile(q, op="a", wire="f32")
        assert p.get("slo").quantile(q, route="1") == \
            j.get("slo").quantile(q, route="1")
    with pytest.raises(TypeError):
        p.gauge("calls")
    with pytest.raises(ValueError):
        p.streaming_histogram("s2", lo=1.0, hi=0.5)


def test_sinks_round_trip(tmp_path):
    path = str(tmp_path / "m.jsonl")
    reg = _drive(preg.MetricsRegistry(), 3)
    n = psinks.write_snapshot_jsonl(path, reg.snapshot(), ts=1.5, rank=2)
    psinks.append_jsonl(path, {"kind": "x", "v": np.float32(2.0)})
    with open(path, "a") as f:
        f.write('{"torn": ')  # a crashed writer's partial line
    recs = psinks.read_jsonl(path)
    assert recs == jsinks.read_jsonl(path)
    assert len(recs) == n + 1 and recs[-1] == {"kind": "x", "v": 2.0}
    assert all(r["ts"] == 1.5 and r["rank"] == 2 for r in recs[:n])
    psinks.atomic_write_json(str(tmp_path / "a.json"), {"k": [1, 2]})
    assert json.load(open(tmp_path / "a.json")) == {"k": [1, 2]}
    psinks.write_prometheus(str(tmp_path / "p.prom"), reg.snapshot())
    assert open(tmp_path / "p.prom").read() == \
        jsinks.prometheus_text(reg.snapshot())


def _events(seed: int, rank: int = 0, steps: int = 4, shift: float = 0.0):
    """A seeded flight-event stream of ``steps`` train steps: phase
    markers, collective and object spans, plan-stage and FSDP edges,
    a compute span and a checkpoint, end-stamped ``step`` events."""
    rng = np.random.RandomState(seed * 31 + rank)
    t = 100.0 + shift
    evs = []
    seq = [0]

    def ev(kind, ts, **kw):
        evs.append({"kind": kind, "ts": ts, "mono": ts - 50.0,
                    "seq": seq[0], **kw})
        seq[0] += 1

    for it in range(steps):
        t0 = t
        for ph in ("data_load", "host_put", "dispatch", "device_block"):
            ev("phase", t, phase=ph, iteration=it)
            if ph == "dispatch":
                a = t + rng.uniform(0.001, 0.002)
                ev("collective_begin", a, op="allreduce_grad",
                   op_seq=it + 1, comm="X", nbytes=64)
                for st, (scope, link) in enumerate(
                        (("intra", "ici"), ("inter", "dcn"))):
                    b = a + 0.0005 + st * 0.002
                    ev("plan_stage_begin", b, plan="hier", stage=st,
                       op="all-reduce", scope=scope, link=link,
                       nbytes=1024)
                    ev("plan_stage_end", b + rng.uniform(0.0005, 0.0015),
                       plan="hier", stage=st, op="all-reduce", scope=scope,
                       link=link, nbytes=1024)
                ev("compute_begin", a + 0.0045, op="compress:allreduce",
                   op_seq=it + 1, bucket=0)
                ev("compute_end", a + 0.005, op="compress:allreduce",
                   op_seq=it + 1, dur_s=0.0005)
                ev("collective_end", a + 0.006 + rng.uniform(0, 0.001),
                   op="allreduce_grad", op_seq=it + 1, dur_s=0.005)
                ev("fsdp_gather_begin", a + 0.0061, bucket=0, nbytes=8,
                   link="ici")
                ev("fsdp_gather_end", a + 0.0064, bucket=0, nbytes=8,
                   link="ici")
                t = a + 0.008
            else:
                t += rng.uniform(0.0005, 0.003)
        if it == 2:
            ev("object_begin", t, op="allgather_obj", op_seq=1, comm="X")
            ev("object_end", t + 0.001, op="allgather_obj", op_seq=1)
            ev("checkpoint_begin", t + 0.0012, op="save", op_seq=1)
            ev("checkpoint_end", t + 0.002, op="save", op_seq=1)
            t += 0.0025
        t += rng.uniform(0.001, 0.004)
        ev("step", t, iteration=it + 1, dur_s=t - t0)
    # an unmatched begin (still open) is dropped by the pairing
    ev("collective_begin", t + 0.001, op="bcast", op_seq=9, comm="X")
    return evs


def _dicts(spans):
    return [s.to_dict() for s in spans]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spans_and_attribution_are_jax_s(seed):
    evs = _events(seed)
    assert _dicts(pspans.pair_events(evs, rank=1)) == \
        _dicts(jspans.pair_events(evs, rank=1))
    assert pspans.stage_link_timings(evs) == jspans.stage_link_timings(evs)
    steps_p, steps_j = pspans.step_windows(evs), jspans.step_windows(evs)
    assert _dicts(steps_p) == _dicts(steps_j)
    assert _dicts(pspans.phase_spans(evs, steps_p)) == \
        _dicts(jspans.phase_spans(evs, steps_j))
    tp = pspans.build_step_trees(evs, rank=0, offset=0.25)
    tj = jspans.build_step_trees(evs, rank=0, offset=0.25)
    assert _dicts(tp) == _dicts(tj) and len(tp) == 4
    for a, b in zip(tp, tj):
        assert pattr.attribute_step(a) == jattr.attribute_step(b)
        assert pattr.critical_path({0: a}) == jattr.critical_path({0: b})
    assert pattr.span_summary(evs, k=3) == jattr.span_summary(evs, k=3)
    by_rank = {r: _events(seed, rank=r, shift=0.003 * r) for r in range(3)}
    offsets = {0: 0.0, 1: -0.002, 2: 0.0015}
    merged_p = pattr.merge_ranks(by_rank, offsets)
    merged_j = jattr.merge_ranks(by_rank, offsets)
    assert {r: _dicts(t) for r, t in merged_p.items()} == \
        {r: _dicts(t) for r, t in merged_j.items()}
    assert pattr.critical_path({r: t[1] for r, t in merged_p.items()}) == \
        jattr.critical_path({r: t[1] for r, t in merged_j.items()})
    assert pattr.attribution_report(by_rank, offsets) == \
        jattr.attribution_report(by_rank, offsets)
    assert pattr.to_trace_events(merged_p) == \
        jattr.to_trace_events(merged_j)
    samples = [(1.0, 1.7, 1.2), (2.0, 2.6, 2.05), (3.0, 3.9, 3.5)]
    assert pattr.offset_from_samples(samples) == \
        jattr.offset_from_samples(samples)


def test_port_link_classes_bucket_as_jax_s():
    """The port's ``nvlink``/``ib`` links land in JAX's comm buckets."""
    for link, bucket in (("nvlink", "ici_comm"), ("ib", "dcn_comm"),
                         ("ici", "ici_comm"), ("dcn", "dcn_comm")):
        sp = pspans.Span("s", "plan_stage", 0, 0.0, 1.0, {"link": link})
        assert pattr.classify_span(sp) == bucket


@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_report_and_durations_are_jax_s(seed):
    rng = np.random.RandomState(seed)
    summaries = []
    for r in range(5):
        d = rng.exponential(0.01, size=20) * (3.0 if r == 3 else 1.0)
        sp, sj = pstrag.summarize_durations(d), jstrag.summarize_durations(d)
        assert sp == sj
        summaries.append(dict(sp, rank=r))
    summaries.append(dict(pstrag.summarize_durations([]), rank=5))
    summaries[1]["compute_open"] = [{"op": "compress", "rank": 1,
                                     "age_s": 2.0}]
    assert pstrag.straggler_report(summaries, threshold=1.4) == \
        jstrag.straggler_report(summaries, threshold=1.4)
    with pytest.raises(ValueError):
        pstrag.straggler_report(summaries, threshold=1.0)


def _state(last, open_=()):
    return {"last_completed": dict(last), "open": list(open_)}


def test_identify_desync_is_jax_s():
    states = {
        0: _state({"allreduce_grad": 7},
                  [{"kind": "collective", "op": "allreduce_grad",
                    "op_seq": 8, "age_s": 3.0}]),
        1: _state({"allreduce_grad": 7},
                  [{"kind": "collective", "op": "allreduce_grad",
                    "op_seq": 8, "age_s": 2.5},
                   {"kind": "compute", "op": "compress:fsdp",
                    "age_s": 9.0}]),
        2: _state({"allreduce_grad": 6, "bcast_obj": 2},
                  [{"kind": "object", "op": "bcast_obj", "op_seq": 3,
                    "age_s": 1.0}]),
        3: _state({"allreduce_grad": 7, "bcast_obj": 2}),
    }
    assert pfr.identify_desync(states) == jfr.identify_desync(states)
    out = pfr.identify_desync(states)
    assert out["desynced_ranks"] == [0, 1, 2, 3]
    assert out["stalled_collectives"][0]["waiting_ranks"] == [0, 1]
    assert out["compute_stragglers"][0]["rank"] == 1


def test_flight_recorder_dump_schema_is_jax_s(tmp_path):
    recs = {}
    for name, mod in (("jax", jfr), ("port", pfr)):
        rec = mod.FlightRecorder(capacity=8)
        tok = rec.collective_begin("allreduce_grad", comm="X", nbytes=4)
        rec.collective_end(tok)
        rec.span_begin("collective", "bcast")
        rec.record_phase("dispatch", 0)
        rec.record_step(0.01, iteration=1)
        for i in range(8):
            rec.record("transport_send", dest=1, tag=i, nbytes=3)
        assert rec.dropped_events == 5
        assert rec.events_since(10)[0]["seq"] == 11
        path = rec.dump(str(tmp_path / name), rank=1, reason="test",
                        peers={0: rec.collective_state()})
        recs[name] = json.load(open(path))
        assert os.path.basename(path) == "flight_1.json"
    j, p = recs["jax"], recs["port"]
    assert p.keys() == j.keys()
    assert p["schema"] == j["schema"] == pfr.DUMP_SCHEMA
    for k in ("kind", "rank", "reason", "dropped_events", "ring_capacity",
              "evidence_truncated", "analysis"):
        assert p[k] == j[k], k
    assert p["collective_state"].keys() == j["collective_state"].keys()
    assert p["collective_state"]["last_completed"] == \
        j["collective_state"]["last_completed"] == {"allreduce_grad": 1}
    strip = lambda evs: [{k: v for k, v in e.items()  # noqa: E731
                          if k not in ("ts", "mono", "dur_s")} for e in evs]
    assert strip(p["events"]) == strip(j["events"])
    assert p["threads"] and {"thread", "ident", "daemon", "stack"} <= \
        set(p["threads"][0])


def test_switch_and_recorder_gating(monkeypatch):
    assert not pobs.enabled() and pobs.get_flight_recorder() is None
    assert pobs.get_plan_obs() is None
    from chainermn_tpu_torch.compression.observe import get_compression_obs
    assert get_compression_obs() is None
    pobs.enable()
    rec = pobs.get_flight_recorder()
    assert rec is not None and pobs.get_flight_recorder() is rec
    assert pobs.get_plan_obs().rep_rank == 0
    pobs.disable()
    assert pobs.get_flight_recorder() is rec  # installed stays installed
    pobs.reset_flight_recorder()
    assert pobs.get_flight_recorder() is None
    mine = pobs.FlightRecorder(capacity=4)
    assert pobs.install_flight_recorder(mine) is mine
    # the environment switch is read at import, as JAX's
    import importlib
    import subprocess
    import sys
    code = ("import chainermn_tpu_torch.observability as o; "
            "print(o.enabled())")
    for val, want in (("1", "True"), ("0", "False"), ("off", "False")):
        outp = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            env=dict(os.environ, CHAINERMN_TPU_OBSERVABILITY=val,
                     PYTHONPATH=torch_dist_worker.REPO), timeout=120)
        assert outp.stdout.strip() == want, outp.stderr[-2000:]
    assert importlib.import_module(
        "chainermn_tpu_torch.observability.registry") is preg


def _jax_rows(n: int):
    """JAX's ``comm_*`` rows for :func:`torch_dist_worker.
    instrument_sequence` on a CPU mesh of ``n`` devices."""
    import jax
    import jax.numpy as jnp

    from chainermn_tpu import create_communicator as jcreate
    from chainermn_tpu import observability as jobs
    from chainermn_tpu.parallel.topology import init_topology

    jobs.get_registry().reset()
    try:
        comm = jcreate("xla", allreduce_grad_dtype="float16",
                       mesh=init_topology(devices=jax.devices()[:n]).mesh)
        inst = jobs.instrument_communicator(comm, force=True)
        g = {"a": np.zeros((n, 3, 4), np.float32),
             "b": np.ones((n, 5), np.float32)}
        inst.run_spmd(lambda t: inst.allreduce_grad(t), g)
        inst.bcast_data({"w": jnp.ones((3, 4))})
        # JAX's object plane is one host: the same op sequence
        inst.allgather_obj(0)
        inst.bcast_obj("x")
        inst.allreduce_obj({"v": 0})
        inst.gather_obj(0)
        inst.scatter_obj([0])
        inst.barrier()
        return torch_dist_worker.comm_metric_rows(
            jobs.get_registry().snapshot())
    finally:
        jobs.get_registry().reset()


def _listify(rows):
    return json.loads(json.dumps(rows))


def test_instrumented_communicator_is_jax_s_world_of_one():
    from chainermn_tpu_torch import create_communicator
    pobs.enable()
    comm = create_communicator("xla", allreduce_grad_dtype="float16",
                               device="cpu")
    inst = pobs.instrument_communicator(comm)
    assert isinstance(inst, pobs.InstrumentedCommunicator)
    assert pobs.instrument_communicator(inst) is inst
    torch_dist_worker.instrument_sequence(inst, 0, 1)
    rows = torch_dist_worker.comm_metric_rows(
        pobs.get_registry().snapshot())
    assert _listify(rows) == _listify(_jax_rows(1))
    # flight spans ride along: one collective span per collective call
    kinds = [e["kind"] for e in pobs.get_flight_recorder().snapshot()]
    assert kinds.count("collective_begin") == kinds.count(
        "collective_end") == 2
    # the double-buffered seam counts as one allreduce_grad
    finish = inst._allreduce_grad_start({"a": torch.ones(2)})
    assert torch.equal(finish()["a"], torch.ones(2))
    assert pobs.get_registry().get("comm_collective_calls").value(
        op="allreduce_grad", comm="XlaCommunicator") == 2
    sub = inst.split(0, 0)
    assert isinstance(sub, pobs.InstrumentedCommunicator)
    pobs.disable()
    assert pobs.instrument_communicator(comm) is comm


def test_instrumented_communicator_is_jax_s_world_of_two(tmp_path):
    outs = torch_dist_worker.launch(
        "obs", {"parts": np.asarray("inst")}, 2, tmp_path, timeout=240)
    want = _listify(_jax_rows(2))
    for out in outs:
        assert json.loads(str(out["inst/rows"])) == want
