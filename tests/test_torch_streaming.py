"""The port's streaming fleet telemetry against the JAX package's, on the
CPU.

* The same flight window (event streams made from numpy seeds, through a
  stub recorder) and the same serving histograms give the same
  ``fleet_telemetry/v1`` document as JAX's ``TelemetryAggregator``, after
  the link renaming (:func:`torch_obs_links.to_port`), floats bit for bit
  (the same Python arithmetic in the same order); the rank-0 fold of
  several ranks' summaries too, with its straggler flags.
* JAX's aggregator tests on the port's own recorder: the window cursor
  ships each event once, capped interval lists are flagged, the dropped
  events are a delta; the fleet percentiles equal the registry
  histogram's and are published as ``fleet_<metric>`` gauges.
* The gather rides the socket control plane's telemetry tag when the
  communicator has one (Python and native transports, a world of threads
  here), else the communicator's ``gather_obj`` (a 3-process gloo world,
  one rank slowed and flagged).
* With observability off, ``MetricsReport(stream_telemetry=True)`` builds
  no aggregator.
"""

import time

import pytest

from chainermn_tpu import observability as jobs
from chainermn_tpu.observability.streaming import (
    TelemetryAggregator as JAgg)
from chainermn_tpu_torch import observability as pobs
from chainermn_tpu_torch.observability.streaming import (
    SCHEMA, TelemetryAggregator as PAgg)
import torch_dist_worker
from torch_obs_links import (on_ranks, port_events, seeded_events,
                             socket_world, to_port)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _observability_off():
    for obs in (pobs, jobs):
        obs.reset_flight_recorder()
        obs.get_registry().reset()
    yield
    for obs in (pobs, jobs):
        obs.disable()
        obs.reset_flight_recorder()
        obs.get_registry().reset()


class _StubRecorder:
    """A recorder whose window is a fixed event list (so both packages
    read the same timestamps)."""

    def __init__(self, events, dropped=0):
        self.events, self.dropped_events = events, dropped

    def events_since(self, seq):
        return [e for e in self.events if e["seq"] > seq]


def _observe(reg, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    h = reg.streaming_histogram("serving_ttft_seconds")
    for v in rng.lognormal(-4.0, 0.7, size=50):
        h.observe(float(v), model="m0")
    t = reg.streaming_histogram("serving_token_seconds")
    for v in rng.lognormal(-6.0, 0.3, size=40):
        t.observe(float(v), model="m0", replica="0")
        t.observe(float(v) * 1.5, model="m0", replica="1")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collect_equals_jax(seed):
    evs = seeded_events(seed)
    docs = {}
    for name, obs, Agg, events in (("j", jobs, JAgg, evs),
                                   ("p", pobs, PAgg, port_events(evs))):
        _observe(obs.get_registry(), seed)
        agg = Agg(None, max_intervals=2 + seed)
        agg._fr = _StubRecorder(events, dropped=3)
        docs[name] = [agg.collect(5), agg.collect(6)]
        docs[name + "_gauge"] = obs.get_registry().get(
            "fleet_serving_ttft_seconds").value(quantile="p95")
    assert docs["p"] == to_port(docs["j"])
    assert docs["p_gauge"] == docs["j_gauge"]
    first, second = docs["p"]
    assert first["schema"] == SCHEMA and first["n_ranks"] == 1
    assert set(first["occupancy"]) == {"nvlink", "ib"}
    assert first["dropped_events"] == 3 and second["dropped_events"] == 0
    assert second["occupancy"] == {} and second["step_time"] == {}


def _summary(rank, durs, seed):
    agg = PAgg(None)
    agg.rank = rank
    agg._fr = _StubRecorder(seeded_events(seed, rank=rank))
    s = agg.local_summary(3)
    s["step_durs"] = durs
    return s


def test_fold_of_ranks_equals_jax_and_flags_the_straggler():
    _observe(pobs.get_registry(), 4)
    _observe(jobs.get_registry(), 4)
    summaries = [_summary(r, [0.1, 0.1 + 0.01 * r] if r != 2 else
                          [0.3, 0.31], r) for r in range(4)]
    got = PAgg(None)._fold(3, summaries)
    jsum = [dict(s, occupancy={
        {"nvlink": "ici", "ib": "dcn"}[k]: v
        for k, v in s["occupancy"].items()}) for s in summaries]
    want = JAgg(None)._fold(3, jsum)
    assert got == to_port(want)
    assert got["stragglers"] == [2] and got["n_ranks"] == 4
    slo = got["slo"]["serving_ttft_seconds"]
    assert slo["count"] == 4 * 50


def _record_window(fr):
    """A real-clock window: an FSDP gather straddled by a MoE hop (a
    guaranteed overlap), plus one step."""
    fs = dict(bucket=0, link="nvlink", nbytes=1 << 20)
    moe = dict(plan="alltoall_hier", op="all_to_all", stage=0,
               scope="intra", link="nvlink", nbytes=1 << 16)
    fr.record("fsdp_gather_begin", **fs)
    time.sleep(0.002)
    fr.record("plan_stage_begin", **moe)
    time.sleep(0.002)
    fr.record("fsdp_gather_end", **fs)
    time.sleep(0.002)
    fr.record("plan_stage_end", **moe)
    fr.record_step(0.05, 1)


def test_single_process_fold_on_the_recorder():
    pobs.enable()
    fr = pobs.install_flight_recorder()
    _record_window(fr)
    reg = pobs.get_registry()
    h = reg.streaming_histogram("serving_ttft_seconds")
    for v in (0.010, 0.020, 0.040):
        h.observe(v, model="m0")
    fleet = PAgg(None).collect(5)
    assert fleet["kind"] == "fleet_telemetry" and fleet["step"] == 5
    assert set(fleet["occupancy"]["nvlink"]) == {"fsdp", "moe"}
    rows = {tuple(r["owners"]): r["contended_s"] for r in fleet["overlap"]
            if r["link"] == "nvlink"}
    assert rows.get(("fsdp", "moe"), 0.0) > 0.0
    assert fleet["step_time"]["0"] == 0.05 and fleet["stragglers"] == []
    slo = fleet["slo"]["serving_ttft_seconds"]
    assert slo["count"] == 3 and set(slo["quantiles"]) == {
        "p50", "p95", "p99"}
    for q, v in slo["quantiles"].items():
        assert v == h.quantile(int(q[1:]) / 100, model="m0")
        assert reg.get("fleet_serving_ttft_seconds").value(quantile=q) == v


def test_window_cursor_ships_each_event_once():
    pobs.enable()
    fr = pobs.install_flight_recorder()
    _record_window(fr)
    agg = PAgg(None)
    assert agg.collect(1)["occupancy"]
    second = agg.collect(2)
    assert second["occupancy"] == {} and second["step_time"] == {}
    _record_window(fr)
    assert "nvlink" in agg.collect(3)["occupancy"]


def test_truncated_interval_lists_are_flagged():
    pobs.enable()
    fr = pobs.install_flight_recorder()
    fs = dict(bucket=0, link="nvlink", nbytes=1 << 10)
    for _ in range(4):
        fr.record("fsdp_gather_begin", **fs)
        time.sleep(0.001)
        fr.record("fsdp_gather_end", **fs)
        time.sleep(0.001)
    doc = PAgg(None, max_intervals=2).collect(1)
    row = doc["occupancy"]["nvlink"]["fsdp"]
    assert row["truncated"] is True and row["dropped_s"] > 0.0
    assert doc["truncated"] == [["nvlink", "fsdp"]]
    assert row["by_rank"]["0"] > row["busy_s"]
    # an uncapped window carries no truncation
    _record_window(fr)
    doc = PAgg(None).collect(2)
    assert doc["truncated"] == [] and all(
        "truncated" not in row for owners in doc["occupancy"].values()
        for row in owners.values())


def test_dropped_events_delta():
    agg = PAgg(None)
    fr = pobs.FlightRecorder(capacity=4)
    agg._fr = fr
    for i in range(10):
        fr.record("ev", i=i)
    assert agg.collect(1)["dropped_events"] == 6
    assert agg.collect(2)["dropped_events"] == 0


class _PlaneComm:
    """What the aggregator reads of a communicator on a socket plane."""

    def __init__(self, plane):
        self._cp, self.rank, self.size = plane, plane.rank, plane.size

    def gather_obj(self, obj, root=0):  # the gloo path: must not be taken
        raise AssertionError("gathered off the control plane")


@pytest.mark.parametrize("backend", ["python", "native"])
def test_collect_rides_the_control_plane_telemetry_tag(backend):
    planes = socket_world(3, backend)
    try:
        aggs = []
        for p in planes:
            agg = PAgg(_PlaneComm(p))
            agg._fr = _StubRecorder(seeded_events(p.rank, rank=p.rank))
            aggs.append(agg)
        docs = on_ranks(lambda r: aggs[r].collect(7), 3)
    finally:
        for p in planes:
            p.shutdown()
    assert docs[1] is None and docs[2] is None
    assert docs[0]["n_ranks"] == 3 and docs[0]["step"] == 7
    assert sorted(docs[0]["step_time"]) == ["0", "1", "2"]


def test_gloo_world_gathers_and_flags_the_slowed_rank(tmp_path):
    """Three ranks, the last one's steps three times the others' (the
    fleet median is the middle rank's mean)."""
    outs = torch_dist_worker.launch("obs", {"parts": "stream"}, 3,
                                    tmp_path)
    import json
    doc = json.loads(str(outs[0]["stream/doc"]))
    assert [str(o["stream/doc"]) for o in outs[1:]] == ["null", "null"]
    assert doc["n_ranks"] == 3 and doc["stragglers"] == [2]
    assert set(doc["occupancy"]) == {"nvlink"}


def test_disabled_builds_no_aggregator(tmp_path):
    from chainermn_tpu_torch.training.extensions import MetricsReport

    class Upd:
        comm, iteration, telemetry = None, 0, None

    class Tr:
        out, updater = str(tmp_path), Upd()

    ext = MetricsReport(stream_telemetry=True)
    ext.initialize(Tr())
    assert ext._stream is None and Tr.updater.telemetry is None
