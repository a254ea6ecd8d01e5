"""The port's run diffing against the JAX package's, on the CPU.

``chainermn_tpu_torch.observability.diffing`` and
``chainermn_tpu.observability.diffing`` profile and diff the same flight
windows: the committed healthy and degraded inter-node span dumps, the
committed ``flight_{0,1}.json`` dumps, and event streams made from numpy
seeds.  The documents must be equal after the link renaming
(:func:`torch_obs_links.to_port`; the occupancy rows' link and the
plan-stage keys' last field), floats bit for bit (the same Python
arithmetic in the same order), leaving out the envelope's provenance
fields, which name each package's device.  The diff of the degraded dump
against the healthy one names ``dcn_comm`` with JAX's ``delta_s``,
``ratio`` and confidence.
"""

import os

import pytest

from chainermn_tpu.observability import diffing as J
from chainermn_tpu.observability.registry import (
    StreamingHistogram as JHist)
from chainermn_tpu_torch.observability import diffing as P
from chainermn_tpu_torch.observability.registry import (
    StreamingHistogram as PHist)
from torch_obs_links import port_events, seeded_events, to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
HEALTHY = os.path.join(DATA, "healthy_dcn_spans.json")
DEGRADED = os.path.join(DATA, "degraded_dcn_spans.json")
ENVELOPE = ("device_kind", "n_devices", "backend", "git_sha")


def _body(doc):
    return {k: v for k, v in doc.items() if k not in ENVELOPE}


def test_degraded_against_healthy_names_dcn_comm_as_jax():
    want = J.diff_runs(HEALTHY, DEGRADED)
    got = P.diff_runs(HEALTHY, DEGRADED)
    assert _body(got) == to_port(_body(want))
    reg = got["regression"]
    assert reg["bucket"] == "dcn_comm"
    for k in ("delta_s", "ratio", "confidence", "base_s", "cand_s"):
        assert reg[k] == want["regression"][k], k
    assert reg["ratio"] == pytest.approx(4.0, rel=0.05)
    assert reg["confidence"] > 0.9
    assert reg["evidence"]["link"] == "ib"
    assert reg["evidence"]["stage"]["stage"].endswith(":inter:ib")
    assert got["schema"] == "run_diff/v1" and got["regressed"]
    assert got["git_sha"] == want["git_sha"]


@pytest.mark.parametrize("path", [HEALTHY, DEGRADED])
def test_run_against_itself_names_nothing(path):
    got = P.diff_runs(path, path)
    assert got["regression"] is None and not got["regressed"]
    assert _body(got) == to_port(_body(J.diff_runs(path, path)))


@pytest.mark.parametrize("path", [HEALTHY, DEGRADED,
                                  os.path.join(DATA, "flight_0.json"),
                                  os.path.join(DATA, "attr_flight_1.json")])
def test_load_run_profile_equals_jax(path):
    assert P.load_run(path) == to_port(J.load_run(path))


def test_committed_flight_dumps_diff_equals_jax():
    a, b = (os.path.join(DATA, f"flight_{r}.json") for r in (0, 1))
    assert _body(P.diff_runs(a, b)) == to_port(_body(J.diff_runs(a, b)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_profiles_and_diff_equal_jax(seed):
    """Multi-rank windows with steps (the exact bucket decomposition):
    the profile, the diff against a slower twin (its inter-node hops
    stretched), and the port's own link names."""
    base = {r: seeded_events(seed, rank=r) for r in (0, 1)}
    slow = {r: seeded_events(seed, rank=r) for r in (0, 1)}
    for evs in slow.values():
        shift = 0.0
        for e in evs:
            e["ts"] += shift
            if e["kind"] == "plan_stage_end" and e.get("link") == "dcn":
                shift += 0.004
                e["ts"] += 0.004
            if e["kind"] == "step":
                e["dur_s"] += shift
    jp, pp = J.run_profile(base, label="a"), P.run_profile(base, label="a")
    assert pp == to_port(jp)
    assert pp["bucket_source"] == "steps"
    assert P.run_profile({r: port_events(e) for r, e in base.items()},
                         label="a") == pp
    want = J.diff_profiles(jp, J.run_profile(slow, label="b"))
    got = P.diff_profiles(pp, P.run_profile(slow, label="b"))
    assert _body(got) == to_port(_body(want))


def _grid(H, values, bpd=None):
    kw = {} if bpd is None else {"buckets_per_decade": bpd}
    h = H("step_s", lo=1e-4, hi=10.0, **kw)
    for v in values:
        h.observe(v)
    return {"step_s": {"lo": h.lo, "hi": h.hi,
                       "buckets_per_decade": h.buckets_per_decade,
                       "series": [{"labels": {}, "state": h.state()}]}}


@pytest.mark.parametrize("bpd", [None, 5])
def test_histogram_diff_equals_jax(bpd):
    """Exact quantile deltas on the shared grid, and a refusal (not a
    wrong delta) on a grid mismatch."""
    qs = (0.5, 0.95, 0.99)
    for H in (JHist, PHist):
        a = _grid(H, [0.010] * 100 + [0.5])
        b = _grid(H, [0.020] * 100, bpd)
        if H is JHist:
            want = J.diff_histograms(a, b, quantiles=qs)
        else:
            got = P.diff_histograms(a, b, quantiles=qs)
    assert got == want
    if bpd is None:
        assert got["step_s"]["p50"]["delta"] > 0
    else:
        assert got["step_s"]["grid_mismatch"]


def test_diff_manifests_equals_jax():
    a = {"artifact": "A_r01.json", "round": 1, "device_kind": "cpu",
         "metrics": {"tput": 100.0, "lat": 2.0, "only_a": 1.0}}
    b = {"artifact": "A_r02.json", "round": 2, "device_kind": "cpu",
         "metrics": {"tput": 50.0, "lat": 0.0, "only_b": 3.0}}
    want, got = J.diff_manifests(a, b), P.diff_manifests(a, b)
    assert _body(got) == _body(want)
    row = {m["metric"]: m for m in got["metrics"]}["tput"]
    assert row["ratio"] == 0.5
