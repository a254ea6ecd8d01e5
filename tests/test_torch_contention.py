"""The port's contention observatory against the JAX package's, on the CPU.

``chainermn_tpu_torch.observability.contention`` and
``chainermn_tpu.observability.contention`` get the same spans and events
(JAX's test cases, the committed ``attr_flight_{0,1}.json`` dumps and
event streams made from numpy seeds); the port's results must equal
JAX's after the link renaming (``ici`` -> ``nvlink``, ``dcn`` -> ``ib``,
:func:`torch_obs_links.to_port`), floats bit for bit: both sides run the
same Python arithmetic in the same order.  Events tagged with the port's
link names give the same documents as events tagged with JAX's.
"""

import json
import os

import pytest

from chainermn_tpu.observability import contention as J
from chainermn_tpu.observability.spans import Span as JSpan
from chainermn_tpu_torch.observability import contention as P
from chainermn_tpu_torch.observability.spans import Span as PSpan
from torch_obs_links import port_events, seeded_events, to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _spans(specs):
    """The same spans for both packages: ``(kind, t0, t1, rank, meta)``."""
    out = {}
    for M, S in (("j", JSpan), ("p", PSpan)):
        out[M] = [S(name=k, kind=k, rank=r, t0=a, t1=b, meta=dict(m))
                  for k, a, b, r, m in specs]
    return out["j"], out["p"]


def _events(base=100.0):
    """JAX's one-step stream: a 20 ms FSDP gather overlapped 10 ms by a
    MoE hop, an inter-node hop and an object broadcast in a 100 ms
    step."""
    evs, seq = [], [0]

    def ev(kind, ts, **f):
        evs.append({"kind": kind, "ts": ts, "seq": seq[0], **f})
        seq[0] += 1

    fs = dict(bucket=0, link="ici", nbytes=3_000_000)
    ev("fsdp_gather_begin", base + 0.010, **fs)
    ev("fsdp_gather_end", base + 0.030, **fs)
    moe = dict(plan="alltoall_hier", op="all_to_all", nbytes=1_000_000)
    ev("plan_stage_begin", base + 0.020, stage=0, scope="intra",
       link="ici", **moe)
    ev("plan_stage_end", base + 0.040, stage=0, scope="intra",
       link="ici", **moe)
    ev("plan_stage_begin", base + 0.050, stage=1, scope="inter",
       link="dcn", **moe)
    ev("plan_stage_end", base + 0.060, stage=1, scope="inter",
       link="dcn", **moe)
    ev("object_begin", base + 0.065, op="plan_table", op_seq=1)
    ev("object_end", base + 0.070, op="plan_table", op_seq=1)
    ev("step", base + 0.100, dur_s=0.100, iteration=1)
    return evs


def _trees(link="ici"):
    """JAX's hand-built step tree (``link`` names the intra class)."""
    inter = {"ici": "dcn", "nvlink": "ib"}[link]
    out = []
    for S in (JSpan, PSpan):
        def sp(kind, t0, t1, **meta):
            return S(name=kind, kind=kind, rank=0, t0=t0, t1=t1, meta=meta)
        step = sp("step", 100.0, 100.1, iteration=1)
        step.children = [
            sp("fsdp", 100.010, 100.030, link=link, nbytes=3_000_000),
            sp("plan_stage", 100.020, 100.040, plan="alltoall_hier",
               scope="intra", link=link, nbytes=1_000_000),
            sp("plan_stage", 100.050, 100.060, plan="alltoall_hier",
               scope="inter", link=inter, nbytes=1_000_000),
            sp("object", 100.065, 100.070, op="plan_table"),
        ]
        out.append({0: [step]})
    return out


CLASSIFY = [
    ("plan_stage", dict(plan="alltoall_hier_bf16", scope="intra",
                        link="ici")),
    ("plan_stage", dict(plan="serving_multicast", scope="inter",
                        link="dcn")),
    ("plan_stage", dict(plan="hier", scope="inter", link="dcn")),
    ("plan_stage", dict(plan="hier@wl:abc123", scope="all")),
    ("plan_stage", dict(scope="intra")),
    ("fsdp", dict(link="ici")),
    ("fsdp", dict(link="nvlink")),
    ("object", dict(op="bcast")),
    ("collective", dict(op="allreduce_grad")),
    ("serving", dict(op="serving_step", link="dcn")),
    ("phase", dict(phase="data_load")),
    ("checkpoint", dict(op="save")),
    ("compute", dict(op="compress")),
]


@pytest.mark.parametrize("kind,meta", CLASSIFY)
def test_classifiers_equal_jax(kind, meta):
    (js,), (ps,) = _spans([(kind, 0.0, 1.0, 0, meta)])
    for f in ("span_link", "span_owner", "plan_identity"):
        assert getattr(P, f)(ps) == to_port(getattr(J, f)(js)), f


LEAF_CASES = {
    "collective_parent_dropped": [
        ("collective", 0.0, 10.0, 0, dict(op="allreduce_grad")),
        ("plan_stage", 2.0, 4.0, 0, dict(plan="hier", scope="intra",
                                          link="ici")),
        ("plan_stage", 12.0, 13.0, 0, dict(plan="hier", scope="intra",
                                            link="ici"))],
    "partial_overlap_keeps_both": [
        ("fsdp", 0.0, 2.0, 0, dict(link="ici")),
        ("plan_stage", 1.0, 3.0, 0, dict(plan="alltoall", scope="intra",
                                          link="ici"))],
    "cross_rank_containment": [
        ("fsdp", 0.0, 1.0, 0, dict(link="ici", nbytes=1 << 20)),
        ("plan_stage", 0.2, 0.8, 1, dict(plan="alltoall_hier",
                                          scope="intra", link="ici",
                                          nbytes=1 << 16))],
    "same_rank_nesting_kept": [
        ("fsdp", 0.0, 1.0, 0, dict(link="ici")),
        ("plan_stage", 0.2, 0.8, 0, dict(plan="alltoall_hier",
                                          scope="intra", link="ici"))],
    "wrapper_guard_same_rank_only": [
        ("collective", 0.0, 10.0, 0, dict(op="allreduce_grad")),
        ("plan_stage", 2.0, 4.0, 1, dict(plan="hier", scope="intra",
                                          link="ici"))],
    "nested_wrappers_dropped": [
        ("collective", 0.0, 5.0, 0, dict(op="multi_node_mean_grad")),
        ("collective", 1.0, 2.0, 0, dict(op="allreduce_grad")),
        ("object", 6.0, 9.0, 0, dict(op="serving_plan_bcast")),
        ("object", 6.5, 7.5, 0, dict(op="bcast_obj"))],
}


@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_leaf_guard_and_occupancy_equal_jax(case):
    js, ps = _spans(LEAF_CASES[case])
    keep_j = [js.index(s) for s in J.leaf_comm_spans(js)]
    keep_p = [ps.index(s) for s in P.leaf_comm_spans(ps)]
    assert keep_p == keep_j
    by_rank = {}
    for i, s in enumerate(js):
        by_rank.setdefault(s.rank, ([], []))
        by_rank[s.rank][0].append(s)
        by_rank[s.rank][1].append(ps[i])
    jt = {r: v[0] for r, v in by_rank.items()}
    pt = {r: v[1] for r, v in by_rank.items()}
    jtl, ptl = J.occupancy_timelines(jt), P.occupancy_timelines(pt)
    assert ptl == to_port(jtl)
    assert P.overlap_matrix(ptl) == to_port(J.overlap_matrix(jtl))
    assert P.link_rates(pt) == to_port(J.link_rates(jt))


def test_tree_occupancy_rates_and_consistency_equal_jax():
    jt, pt = _trees()
    tl = P.occupancy_timelines(pt)
    assert tl == to_port(J.occupancy_timelines(jt))
    assert tl["nvlink"]["fsdp"] == [(100.010, 100.030)]
    assert P.overlap_matrix(tl) == to_port(J.overlap_matrix(
        J.occupancy_timelines(jt)))
    assert P.link_rates(pt) == to_port(J.link_rates(jt))
    rows = P.attribution_consistency(pt)
    assert rows == to_port(J.attribution_consistency(jt))
    assert {r["link"] for r in rows} == {"nvlink", "ib"}
    assert all(r["ok"] and r["iteration"] == 1 for r in rows)
    # a tree tagged with the port's names reads the same
    _, pt2 = _trees("nvlink")
    assert P.link_rates(pt2) == P.link_rates(pt)
    assert P.attribution_consistency(pt2) == rows


def test_static_rates_annotation_equal_jax():
    jt, pt = _trees()
    want = to_port(J.link_rates(jt, modeled_gbps={"ici": 1.0}))
    got = P.link_rates(pt, modeled_gbps={"nvlink": 1.0})
    assert got == want
    assert got["nvlink"]["static_gbps"] == 1.0
    assert "static_gbps" not in got["ib"]


def test_feed_link_observations_equal_jax():
    class Stub:
        def __init__(self):
            self.calls = []

        def add(self, link, nbytes, busy_s):
            self.calls.append((link, nbytes, busy_s))

    rates = {"ici": {"bytes": 100, "busy_s": 0.5},
             "dcn": {"bytes": 0, "busy_s": 1.0},
             "x": {"bytes": 5, "busy_s": 0.0}}
    js, ps = Stub(), Stub()
    J.feed_link_observations(js, rates)
    P.feed_link_observations(ps, to_port(rates))
    assert ps.calls == to_port(js.calls) == [("nvlink", 100, 0.5)]


@pytest.mark.parametrize("tags", ["jax", "port"])
def test_occupancy_from_events_equal_jax(tags):
    evs = _events()
    got = P.occupancy_from_events(
        port_events(evs) if tags == "port" else evs)
    assert got == to_port(J.occupancy_from_events(evs))
    assert set(got) == {"nvlink", "ib"}
    assert "control" in got["ib"]


def test_two_rank_report_with_clock_offsets_equals_jax():
    evs = {0: _events(100.0), 1: _events(99.65)}
    want = J.contention_report(evs, offsets={1: 0.35})
    got = P.contention_report(evs, offsets={1: 0.35})
    assert got == to_port(want)
    assert got["schema"] == "contention/v1" and got["consistency_ok"]
    assert got["links"] == ["ib", "nvlink"]
    assert len(got["consistency"]) == 4


def test_committed_attr_dumps_report_equals_jax():
    """The committed two-rank attribution dumps with their clock
    handshake offsets (rank 1's offset to rank 0)."""
    evs, offsets = {}, {}
    for r in (0, 1):
        with open(os.path.join(DATA, f"attr_flight_{r}.json")) as f:
            doc = json.load(f)
        evs[r] = doc["events"]
        off = (doc.get("clock") or {}).get("offset_s")
        if off is not None:
            offsets[r] = off
    for kw in ({}, {"offsets": offsets},
               {"offsets": offsets, "max_intervals": 1}):
        want = J.contention_report(evs, **kw)
        got = P.contention_report(evs, **kw)
        assert got == to_port(want)
        assert got["consistency_ok"]
    assert got["n_ranks"] == 2 and got["n_steps"] == 4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_streams_report_equals_jax(seed):
    """Two ranks' seeded streams (wrapped plan stages, FSDP x MoE
    contention, object ops, checkpoints): the report equals JAX's, and
    the port's own link names give the same document."""
    evs = {r: seeded_events(seed, rank=r) for r in (0, 1)}
    offsets = {1: 0.001 * (seed + 1)}
    want = J.contention_report(evs, offsets=offsets,
                               modeled_gbps={"ici": 50.0, "dcn": 5.0})
    got = P.contention_report(evs, offsets=offsets,
                              modeled_gbps={"nvlink": 50.0, "ib": 5.0})
    assert got == to_port(want)
    assert got["consistency_ok"]
    pevs = {r: port_events(e) for r, e in evs.items()}
    assert P.contention_report(pevs, offsets=offsets,
                               modeled_gbps={"nvlink": 50.0,
                                             "ib": 5.0}) == got
    # the guard dropped every collective wrapper: no "collective" owner
    assert "collective" not in got["timelines"].get("nvlink", {})
    for r in (0, 1):
        assert P.occupancy_from_events(evs[r], rank=r) == to_port(
            J.occupancy_from_events(evs[r], rank=r))
