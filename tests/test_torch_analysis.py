"""cmn-lint in the port against the JAX package's, on the CPU.

``chainermn_tpu_torch.analysis`` mirrors ``tests/test_analysis.py``'s
cases where they have a torch meaning:

* the HLO parser, ``CollectiveSchedule.diff``, ``overlapping-collectives``
  on JAX's event lists and ``artifact-drift`` on the repo root give JAX's
  results on the same inputs (links renamed ``ici`` -> ``nvlink``);
* each rule fires on its planted fault, with JAX's rule ID and details;
* the recorded census of every communicator flavor equals JAX's
  ``expected_kinds`` without the stages over one rank (the port's
  executor issues none there);
* the clean sweep: zero error findings on every entry point, run dry on
  the fake process group.

Where JAX's own case fails on jax 0.9 (``captured-constant``,
``lint_step``'s raise and skips, the clean sweeps, the fused-norm
fixtures) the port is held to ``docs/static_analysis.md``'s contract.
"""

import json
import os
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu.analysis import hlo as jhlo
from chainermn_tpu.analysis import rules as jrules
from chainermn_tpu.analysis.lint import LintContext as JContext
from chainermn_tpu.analysis.schedule import (
    CollectiveSchedule as JSchedule, schedule_from_hlo as j_from_hlo)
from chainermn_tpu_torch import functions as PF
from chainermn_tpu_torch.analysis import (
    CollectiveSchedule, LintError, census_schedule, dry_world,
    expected_issued_kinds, expected_kinds, extract_schedule, get_rule,
    lint_step, parse_hlo_collectives, record, schedule_from_hlo)
from chainermn_tpu_torch.communicators import create_communicator
from torch_obs_links import to_port
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAVORS = ("naive", "flat", "hierarchical", "two_dimensional",
           "single_node", "non_cuda_aware", "xla")
INTRA = {"hierarchical": 4, "two_dimensional": 4}


def _comm(flavor, **kw):
    if flavor in INTRA:
        kw.setdefault("intra_size", INTRA[flavor])
    return create_communicator(flavor, device="cpu", **kw)


@pytest.fixture(scope="module", autouse=True)
def no_default_group():
    """A dry run needs a process without a default process group, and a
    communicator made without one starts a gloo world of one that
    outlives its test: an earlier test module of this process may have
    left one.  It holds nothing in flight; the next communicator made
    starts another."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield


@pytest.fixture
def world8():
    """Rank 0 of a dry world of 8 (JAX's 8-device CPU mesh)."""
    with dry_world(0, 8):
        yield


def _only(report, rule_id):
    assert [f.rule for f in report.findings] == [rule_id], (
        report.findings, report.skipped)
    return report.findings[0]


# ---------------------------------------------------------------------------
# HLO parser: the same text, JAX's records
# ---------------------------------------------------------------------------

HLO = {
    "sync": """
HloModule m
ENTRY e {
  p0 = f32[256]{0} parameter(0)
  ar = f32[256]{0} all-reduce(f32[256]{0} p0), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=add
  rs = f32[32]{0} reduce-scatter(f32[256]{0} ar), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}, to_apply=add
  ROOT t = tuple(rs)
}
""",
    "multiline": """
HloModule m
ENTRY e {
  p0 = f32[256]{0} parameter(0)
  ar = f32[256]{0} all-reduce(f32[256]{0} p0),
      replica_groups={{0,1,2,3},{4,5,6,7}},
      to_apply=add
  ROOT t = tuple(ar)
}
""",
    "async": """
HloModule m
ENTRY e {
  p0 = f32[1024]{0} parameter(0)
  ars = (f32[1024]{0}, f32[1024]{0}) all-reduce-start(f32[1024]{0} p0), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=add
  other = f32[1024]{0} add(f32[1024]{0} p0, f32[1024]{0} p0)
  ard = f32[1024]{0} all-reduce-done((f32[1024]{0}, f32[1024]{0}) ars)
  ROOT t = tuple(ard)
}
""",
    "unmatched_start": """
HloModule m
ENTRY e {
  p0 = f32[8]{0} parameter(0)
  orphan = (f32[8]{0}, f32[8]{0}) all-reduce-start(f32[8]{0} p0), replica_groups={{0,1}}, to_apply=add
  ROOT t = tuple(p0)
}
""",
    "unmatched_done": """
HloModule m
ENTRY e {
  p0 = f32[8]{0} parameter(0)
  ghost = f32[8]{0} all-reduce-done((f32[8]{0}, f32[8]{0}) p0)
  ROOT t = tuple(ghost)
}
""",
}


def _census_files():
    return sorted(f for f in os.listdir(REPO) if f.startswith("CENSUS_r"))


@pytest.mark.parametrize("name", sorted(HLO))
def test_hlo_parser_equals_jax(name):
    got = parse_hlo_collectives(HLO[name])
    want = jhlo.parse_hlo_collectives(HLO[name])
    assert [vars(o) for o in got.ops] == [vars(o) for o in want.ops]
    assert got.problems == want.problems
    assert got.kinds() == want.kinds()


def test_hlo_parser_cases_hold_jax_s_expectations():
    p = parse_hlo_collectives(HLO["sync"])
    assert p.kinds() == ("all-reduce", "reduce-scatter")
    assert p.ops[0].nbytes == 256 * 4 and p.ops[0].dtype == "f32"
    assert parse_hlo_collectives(HLO["multiline"]).ops[0].groups \
        == "{{0,1,2,3},{4,5,6,7}}"
    op = parse_hlo_collectives(HLO["async"]).ops[0]
    assert op.is_async and op.nbytes == 1024 * 4
    assert [pr["kind"] for pr in parse_hlo_collectives(
        HLO["unmatched_start"]).problems] == ["unmatched-async-start"]
    assert [pr["kind"] for pr in parse_hlo_collectives(
        HLO["unmatched_done"]).problems] == ["unmatched-async-done"]


@pytest.mark.parametrize("flavor", FLAVORS)
def test_recorded_census_equals_the_committed_tpu_census(flavor, world8):
    """The committed census artifacts (JAX's compiled ``allreduce_grad``
    per flavor on an 8-device mesh, intra 4) read as input data: the
    port's recorded census of the same flavor and layout has the same
    collective kinds."""
    from chainermn_tpu_torch.analysis import allreduce_schedule
    files = _census_files()
    assert files
    doc = json.load(open(os.path.join(REPO, files[-1])))
    row = doc["flavors"][flavor]
    if "skipped" in row:  # single_node refuses inter_size 2 there too
        with pytest.raises(ValueError, match="inter_size"):
            _comm(flavor, intra_size=4)
        return
    comm = _comm(flavor, intra_size=doc["intra_size"])
    got = census_schedule(allreduce_schedule(comm)).kinds()
    assert list(got) == [c["op"] for c in row["collectives"]]


def test_schedule_from_hlo_equals_jax():
    for name in HLO:
        got, want = schedule_from_hlo(HLO[name]), j_from_hlo(HLO[name])
        assert got.canonical() == want.canonical()
        assert got.problems == want.problems and got.origin == "hlo"


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_extract_schedule_records_nested_collectives(world8):
    """Collectives inside nested calls -- the make_train_step nesting --
    are all recorded, in issue order, with group name and payload."""
    comm = _comm("xla")

    def inner(x):
        dist.all_reduce(x, group=comm._group)
        return x

    def body(x):
        y = inner(x)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=comm._group)
        return y

    sched = extract_schedule(body, torch.ones(4), comms=[comm])
    assert sched.kinds() == ("all-reduce", "all-reduce")
    assert all(op.axes == ("world",) for op in sched.ops)
    assert sched.ops[0].nbytes == 4 * 4 and sched.ops[0].dtype == "f32"


def test_dry_runs_record_each_rank_s_branch():
    """A collective in only ONE rank's branch -- the desync hazard -- shows
    in that rank's dry run and not in the other's (JAX records both cond
    branches in one trace; a dry run at each rank is the port's view)."""
    def body():
        comm = _comm("xla")
        x = torch.ones(4)
        if comm.rank == 0:
            dist.all_reduce(x, group=comm._group)
        return x
    s0 = extract_schedule(body, rank=0, world=8)
    s1 = extract_schedule(body, rank=1, world=8)
    assert s0.kinds() == ("all-reduce",) and s1.kinds() == ()
    assert not dist.is_initialized()  # the fake group is gone


def test_dry_world_refuses_a_live_group():
    with dry_world(0, 2):
        with pytest.raises(RuntimeError, match="fresh process"):
            with dry_world(1, 2):
                pass


def test_recorder_leaves_the_step_bit_equal(world8):
    """A recorded step's results and parameters equal the bare step's."""
    def run(recorded):
        torch.manual_seed(0)
        comm = _comm("hierarchical")
        model = torch.nn.Linear(8, 4)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        from chainermn_tpu_torch import (create_multi_node_optimizer,
                                         make_train_step)
        mopt = create_multi_node_optimizer(opt, comm)
        step = make_train_step(comm, lambda b: model(b).square().mean(),
                               mopt)
        x = torch.randn(6, 8)
        outs = []
        for _ in range(3):
            outs.append(record(step, x).result if recorded else step(x))
        return outs, [p.detach().clone() for p in model.parameters()]
    bare, recorded = run(False), run(True)
    for a, b in zip(bare[0] + bare[1], recorded[0] + recorded[1]):
        assert torch.equal(a, b)


def test_schedule_diff_reports_first_divergence_as_jax():
    def mk(kind):
        return SimpleNamespace(key=(kind, ("d",), "float32", 4),
                               describe=lambda: kind)
    for S in (CollectiveSchedule, JSchedule):
        a, b = S(label="a"), S(label="b")
        a.ops = [mk("psum"), mk("pmax")]
        b.ops = [mk("psum"), mk("psum"), mk("pmax")]
        assert a.diff(b)["index"] == 1 and a.diff(a) is None
    pa, pb = CollectiveSchedule(label="a"), CollectiveSchedule(label="b")
    ja, jb = JSchedule(label="a"), JSchedule(label="b")
    for s, ops in ((pa, ["x", "y"]), (pb, ["x", "z", "y"]),
                   (ja, ["x", "y"]), (jb, ["x", "z", "y"])):
        s.ops = [mk(k) for k in ops]
    assert pa.diff(pb) == ja.diff(jb)


# ---------------------------------------------------------------------------
# census: the recorded allreduce_grad against JAX's expected kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", FLAVORS)
def test_recorded_census_equals_jax_s_expected_kinds(flavor, world8):
    """Every flavor's recorded ``allreduce_grad`` in census kinds equals
    JAX's ``expected_kinds`` with the stages over one rank left out
    (``issued_census_kinds``; none here: intra 4 x inter 2 or flat 8)."""
    from chainermn_tpu_torch.analysis import allreduce_schedule
    comm = _comm(flavor)
    got = census_schedule(allreduce_schedule(comm)).kinds()
    jax_kinds = jrules.expected_kinds(flavor, comm.inter_size)
    assert expected_kinds(flavor, comm.inter_size) == jax_kinds
    assert got == expected_issued_kinds(flavor, comm.plan_topology())
    from chainermn_tpu.planner.compiler import plan_census_kinds
    from chainermn_tpu.planner.ir import PlanTopology
    from chainermn_tpu.planner.plans import flavor_plan
    topo = PlanTopology(axes=(("inter", comm.inter_size),
                              ("intra", comm.intra_size)))
    full = plan_census_kinds(flavor_plan(flavor), topo)
    sizes = {"inter": comm.inter_size, "intra": comm.intra_size,
             "all": comm.size}
    stages = [st for st in flavor_plan(flavor).stages
              if topo.scope_axes(st.scope)]
    assert got == tuple(k for k, st in zip(full, stages)
                        if sizes[st.scope] > 1)


@pytest.mark.parametrize("flavor,kinds", [
    ("xla", ("all-reduce",)), ("naive", ("all-reduce",)),
    ("hierarchical", ()), ("two_dimensional", ()), ("single_node", ())])
def test_census_of_a_world_of_one(flavor, kinds):
    """In a world of one the flavors' world all-reduce still runs (JAX's
    count: XLA keeps the singleton group), their levels of one rank do
    not (the omission of size-1 stages), and the plan executor issues
    nothing; census-drift holds each to that."""
    from chainermn_tpu_torch.analysis import allreduce_schedule
    from chainermn_tpu_torch.planner.plans import flavor_plan
    with dry_world(0, 1):
        comm = _comm(flavor, intra_size=1)
        got = census_schedule(allreduce_schedule(comm)).kinds()
        assert got == kinds == expected_issued_kinds(flavor,
                                                     comm.plan_topology())
        assert not lint_step(None, comm=comm, census=True,
                             rules=["census-drift"],
                             raise_on_error=False).findings
        plan_run = allreduce_schedule(comm, plan=flavor_plan(flavor))
        assert census_schedule(plan_run).kinds() == ()
    assert len(jrules.expected_kinds(flavor, 1)) >= len(kinds)


# ---------------------------------------------------------------------------
# rules: one planted fault each (stable rule IDs)
# ---------------------------------------------------------------------------

def _rank_variants(order_of_rank, world=4):
    """One dry schedule per rank of a step whose collective order
    branches on the rank."""
    def build(rank):
        def body():
            comm = _comm("xla")
            x = torch.ones(4)
            for op in order_of_rank(comm.rank):
                dist.all_reduce(x, op=op, group=comm._group)
            return x
        return extract_schedule(body, rank=rank, world=world,
                                label=f"rank{rank}")
    return {f"rank{r}": build(r) for r in range(world)}


def test_rule_schedule_desync_catches_rank_divergent_order():
    S, M = dist.ReduceOp.SUM, dist.ReduceOp.MAX
    rep = lint_step(None, variants=_rank_variants(
        lambda r: (S, M) if r == 0 else (M, S, S)),
        rules=["schedule-desync"], raise_on_error=False)
    f = _only(rep, "schedule-desync")
    assert f.severity == "error"
    assert f.details["index"] == 0  # sum against max, as JAX's psum/pmax
    assert "identify_desync" in f.message
    rep2 = lint_step(None, variants=_rank_variants(lambda r: (S, M)),
                     rules=["schedule-desync"], raise_on_error=False)
    assert not rep2.findings


def test_rule_census_drift(world8):
    comm = _comm("xla")
    rep = lint_step(None, comm=comm, flavor="hierarchical", inter_size=2,
                    census=True, rules=["census-drift"],
                    raise_on_error=False)
    f = _only(rep, "census-drift")
    assert f.details["expected"] == ["all-reduce", "all-reduce"]
    assert f.details["observed"] == ["all-reduce"]
    rep2 = lint_step(None, comm=comm, flavor="xla", census=True,
                     rules=["census-drift"], raise_on_error=False)
    assert not rep2.findings


def test_rule_census_drift_per_hop_compressed_dtype(world8):
    """The real compressed plan on an auto communicator passes, per-hop
    wires included; JAX's broken HLO fixture (the int8 hop moving f32)
    fires with JAX's details on both packages.  JAX tolerates the
    fixture's f32 bf16 hops as CPU XLA widening; the port compares every
    hop exactly, so it reports those two hops as well."""
    from chainermn_tpu_torch.planner import PlanTable, PlanTopology
    from chainermn_tpu_torch.planner.autotune import size_bucket
    from chainermn_tpu_torch.planner.plans import compressed_two_dimensional
    plan = compressed_two_dimensional({"name": "int8", "stochastic": False})
    topo = PlanTopology(axes=(("inter", 2), ("intra", 4)))
    table = PlanTable()
    table.put(topo, "float32", size_bucket(1024 * 4), plan)
    comm = create_communicator("auto", device="cpu", intra_size=4,
                               plan_table=table)
    rep = lint_step(None, comm=comm, plan=plan, census=True,
                    rules=["census-drift"], raise_on_error=False)
    assert not rep.findings, rep.findings
    assert "census-drift" not in rep.skipped, rep.skipped

    broken = """
HloModule m
ENTRY e {
  p0 = f32[1024]{0} parameter(0)
  rs = f32[256]{0} reduce-scatter(f32[1024]{0} p0), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}, to_apply=add
  ar1 = f32[256]{0} all-reduce(f32[256]{0} rs), replica_groups={{0,4},{1,5},{2,6},{3,7}}, to_apply=add
  ar2 = f32[1024]{0} all-reduce(f32[1024]{0} ar1), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=add
  ROOT t = tuple(ar2)
}
"""
    ctx = SimpleNamespace(census_schedule=schedule_from_hlo(broken),
                          plan=plan, comm=comm, inter_size=2, flavor=None,
                          name="synthetic")
    found = get_rule("census-drift").run(ctx)
    assert [f.details["stage"] for f in found] == [0, 1, 2]
    assert [f.details["expected_dtype"] for f in found] == \
        ["bf16", "s8", "bf16"]
    assert {f.details["observed_dtype"] for f in found} == {"f32"}
    from chainermn_tpu.planner.plans import (
        compressed_two_dimensional as jcompressed)
    jctx = SimpleNamespace(census_schedule=j_from_hlo(broken),
                           plan=jcompressed({"name": "int8",
                                             "stochastic": False}),
                           comm=None, inter_size=2, flavor=None,
                           name="synthetic")
    (want,) = jrules.get_rule("census-drift").run(jctx)
    assert found[1].details == want.details


@pytest.mark.parametrize("wire,hlo_dtype", [("float16", "f16"),
                                             ("bfloat16", "bf16")])
def test_rule_census_drift_f32_hop_under_a_narrow_plan(wire, hlo_dtype,
                                                       world8):
    """The recorder reads each collective's exact dtype, so an explicit
    plan whose f16 or bf16 hop moves f32 (compression silently off) is a
    per-hop finding; the plan's own program is clean."""
    from chainermn_tpu_torch.planner.plans import flavor_plan
    comm = _comm("xla", allreduce_grad_dtype=wire)
    plan = flavor_plan("xla", wire_dtype=wire)
    rep = lint_step(None, comm=comm, plan=plan, census=True,
                    rules=["census-drift"], raise_on_error=False)
    assert not rep.findings, rep.findings
    assert "census-drift" not in rep.skipped, rep.skipped

    def wide():
        return record(lambda: dist.all_reduce(torch.zeros(64),
                                              group=comm._group),
                      comms=[comm]).schedule
    rep = lint_step(None, comm=comm, plan=plan, census=wide,
                    rules=["census-drift"], raise_on_error=False)
    f = _only(rep, "census-drift")
    assert f.details["expected_dtype"] == hlo_dtype
    assert f.details["observed_dtype"] == "f32"


def test_rule_census_drift_f32_lane_under_a_striped_bf16_plan(world8):
    """The striped lane match is exact too: the plan's own recorded
    program interleaves its groups' bf16 lanes, and the same schedule
    with every hop moving f32 does not."""
    import dataclasses
    from chainermn_tpu_torch.analysis import allreduce_schedule
    from chainermn_tpu_torch.planner import striped_plan
    comm = _comm("two_dimensional")
    plan = striped_plan(0.5)
    sched = allreduce_schedule(comm, plan=plan)
    assert {op.dtype for op in sched} == {"bf16"}
    rep = lint_step(None, comm=comm, plan=plan, census=sched,
                    rules=["census-drift"], raise_on_error=False)
    assert not rep.findings, rep.findings
    wide = CollectiveSchedule(
        ops=[dataclasses.replace(op, dtype="f32") for op in sched],
        label="wide")
    rep = lint_step(None, comm=comm, plan=plan, census=wide,
                    rules=["census-drift"], raise_on_error=False)
    f = _only(rep, "census-drift")
    assert "do not interleave" in f.message
    assert {lane[1] for lane in f.details["observed_lanes"]} == {"f32"}


def test_rule_census_drift_accepts_schedule_text_and_callable(world8):
    from chainermn_tpu_torch.analysis import allreduce_schedule
    comm = _comm("xla")
    sched = allreduce_schedule(comm)
    rep = lint_step(None, comm=comm, flavor="xla", census=sched,
                    rules=["census-drift"], raise_on_error=False)
    assert not rep.findings, rep.findings
    rep = lint_step(None, comm=comm, flavor="hierarchical", inter_size=2,
                    census=sched, rules=["census-drift"],
                    raise_on_error=False)
    assert _only(rep, "census-drift").details["observed"] == ["all-reduce"]
    rep = lint_step(None, comm=comm, flavor="hierarchical", inter_size=2,
                    census=lambda: sched, rules=["census-drift"],
                    raise_on_error=False)
    _only(rep, "census-drift")
    # HLO text is JAX's count: a compiled xla allreduce is one all-reduce
    rep = lint_step(None, comm=comm, flavor="xla", census=HLO["multiline"],
                    rules=["census-drift"], raise_on_error=False)
    assert not rep.findings, rep.findings

    def boom():
        raise RuntimeError("probe died")
    rep = lint_step(None, comm=comm, flavor="xla", census=boom,
                    rules=["census-drift"], raise_on_error=False)
    assert not rep.findings
    assert "probe died" in str(rep.skipped["census-drift"])


def test_rule_census_drift_fires_through_spec_decode_path():
    """The tp=2 draft+verify forward's own recorded schedule, held against
    the xla flavor's one all-reduce, fires with many all-reduces seen."""
    from chainermn_tpu_torch.analysis.entrypoints import _serving_target
    with dry_world(0, 2):
        t = _serving_target(2, spec_k=2)
        sched = record(t["fn"], *t["args"], comms=[t["comm"]]).schedule
        rep = lint_step(None, comm=t["comm"], flavor="xla", census=sched,
                        rules=["census-drift"], raise_on_error=False)
    f = _only(rep, "census-drift")
    assert f.details["expected"] == ["all-reduce"]
    assert len(f.details["observed"]) > 1
    assert set(f.details["observed"]) == {"all-reduce"}


def test_rule_census_drift_serving_weights_multicast(world8):
    from chainermn_tpu_torch.analysis.entrypoints import lint_serving_weights
    from chainermn_tpu_torch.serving.weights import weights_multicast_plan
    comm = _comm("flat")
    plan = weights_multicast_plan(root=0, topology=comm.plan_topology(),
                                  name="serving_weights")

    def broken():
        # a drifted "broadcast": the root sends to every replica -- a fan
        # of point-to-point sends instead of the plan's one multicast
        def fan():
            for r in range(1, comm.size):
                dist.send(torch.zeros(64), r, group=comm._group)
        return record(fan, comms=[comm]).schedule
    rep = lint_step(None, comm=comm, plan=plan, census=broken,
                    rules=["census-drift"], raise_on_error=False)
    f = _only(rep, "census-drift")
    assert "plan 'serving_weights'" in f.message
    assert "collective-permute" in f.details["observed"]
    dist.destroy_process_group()
    try:
        (rep,) = lint_serving_weights()
    finally:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", rank=0, world_size=8,
                                store=FakeStore())
    assert not rep.findings, rep.findings
    assert "census-drift" not in rep.skipped, rep.skipped


def test_rule_wire_dtype_mismatch_per_hop_compressed_plan(world8):
    from chainermn_tpu_torch.analysis import allreduce_schedule
    from chainermn_tpu_torch.planner.plans import (
        compressed_two_dimensional, flavor_plan)
    comm = _comm("two_dimensional")
    plan = compressed_two_dimensional({"name": "int8", "stochastic": False})
    ctx = SimpleNamespace(schedule=allreduce_schedule(comm, plan=plan),
                          plan=plan, fsdp_meta=None, name="t")
    assert not get_rule("wire-dtype-mismatch").run(ctx)
    ctx2 = SimpleNamespace(
        schedule=allreduce_schedule(
            comm, plan=flavor_plan("two_dimensional")),
        plan=plan, fsdp_meta=None, name="t")
    found = get_rule("wire-dtype-mismatch").run(ctx2)
    assert {f.details["expected_dtype"] for f in found} == {"s8", "bf16"}
    s8 = [f for f in found if f.details["expected_dtype"] == "s8"]
    assert len(s8) == 1 and "compressor 'int8'" in s8[0].details["declared"]


def test_rule_wire_dtype_mismatch_float32_under_an_fp16_plan(world8):
    """A step that all-reduces float32 where its plan declares a float16
    wire is the finding; the plan's own program is clean."""
    from chainermn_tpu_torch.planner.plans import flavor_plan
    comm = _comm("xla", allreduce_grad_dtype="float16")
    plan = flavor_plan("xla", wire_dtype="float16")

    def good(g):
        return comm.allreduce_grad([g])

    def bad(g):
        return dist.all_reduce(g.clone(), group=comm._group)
    g = torch.ones(64)
    assert not lint_step(good, g, plan=plan, rules=["wire-dtype-mismatch"],
                         raise_on_error=False).findings
    rep = lint_step(bad, g, plan=plan, rules=["wire-dtype-mismatch"],
                    raise_on_error=False)
    f = _only(rep, "wire-dtype-mismatch")
    assert f.details["expected_dtype"] == "f16"
    assert f.details["observed_dtypes"] == ["f32"]


def test_rule_wire_dtype_mismatch_fsdp_buckets(world8):
    """An FSDP bucket whose layout claims a wire the step never moves is
    an error; the true layout is clean (int8 codes, float32 bucket)."""
    from chainermn_tpu_torch.parallel.fsdp import (fsdp_init,
                                                   make_fsdp_train_step)
    comm = _comm("xla")
    model = torch.nn.Sequential(torch.nn.Linear(64, 64),
                                torch.nn.Linear(64, 8))
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    state, meta = fsdp_init(comm, model, opt, num_buckets=2,
                            bucket_compressors=["int8", None])
    step = make_fsdp_train_step(
        comm, lambda b: model(b).square().mean(), state, meta)
    batch = torch.ones(2, 64)
    rep = lint_step(step, batch, fsdp_meta=meta,
                    rules=["wire-dtype-mismatch"], raise_on_error=False)
    assert not rep.findings, rep.findings
    lying = list(meta.buckets)
    lying[1] = lying[1]._replace(wire_dtype="float8_e4m3fn")
    rep2 = lint_step(step, batch, fsdp_meta=meta._replace(
        buckets=tuple(lying)), rules=["wire-dtype-mismatch"],
        raise_on_error=False)
    f = _only(rep2, "wire-dtype-mismatch")
    assert f.details["bucket"] == 1
    assert f.details["expected_dtype"] == "f8e4m3fn"


def test_rule_unpinned_transpose(world8):
    """torch's autograd all-reduce (whose backward all-reduces the
    cotangent) fires; the port's ``functions.allreduce`` (backward the
    identity, C1) stays clean."""
    comm = _comm("xla")
    params = {"w": torch.ones(4, 4)}
    batch = torch.ones(2, 4)

    def raw_loss(p, x):
        import torch.distributed.nn.functional as dnn
        return dnn.all_reduce((x @ p["w"]).mean(), group=comm._group) \
            / comm.size

    def pinned_loss(p, x):
        return PF.allreduce(comm, (x @ p["w"]).mean(), "mean")

    rep = lint_step(None, comm=comm, loss=raw_loss,
                    loss_args=(params, batch),
                    rules=["unpinned-transpose"], raise_on_error=False)
    f = _only(rep, "unpinned-transpose")
    assert f.details["extra_backward_psums"] >= 1
    assert "functions.allreduce" in f.message
    rep2 = lint_step(None, comm=comm, loss=pinned_loss,
                     loss_args=(params, batch),
                     rules=["unpinned-transpose"], raise_on_error=False)
    assert not rep2.findings


def test_rule_captured_constant():
    big = torch.ones(64, 64)  # 16 KiB > the 4 KiB threshold

    def step(x):
        return (x * big).sum()

    rep = lint_step(step, torch.ones(64, 64), rules=["captured-constant"],
                    raise_on_error=False)
    f = _only(rep, "captured-constant")
    assert f.details["constants"][0]["nbytes"] == 64 * 64 * 4
    assert f.details["max_bytes"] == 4096

    def clean(x, c):
        return (x * c).sum()
    assert not lint_step(clean, torch.ones(64, 64), big,
                         rules=["captured-constant"],
                         raise_on_error=False).findings
    # what the step makes itself, a module it is given and small tables
    # are not captured
    model = torch.nn.Linear(64, 64)
    small = torch.ones(8)

    def made(m, x):
        y = torch.ones(64, 64) * x
        return (m(y) * small.sum()).sum()
    assert not lint_step(made, model, torch.ones(64, 64),
                         rules=["captured-constant"],
                         raise_on_error=False).findings


def test_rule_donation_alias():
    a = torch.ones(8)

    def step(u, v):
        u.add_(v)
        return u

    rep = lint_step(step, a, a, donate_argnums=(0,),
                    rules=["donation-alias"], raise_on_error=False)
    f = _only(rep, "donation-alias")
    assert f.details["donated"] == [0]
    # a view of the donated argument aliases it too
    rep = lint_step(step, a, a[2:4], donate_argnums=(0,),
                    rules=["donation-alias"], raise_on_error=False)
    _only(rep, "donation-alias")
    rep2 = lint_step(step, a, torch.ones(8), donate_argnums=(0,),
                     rules=["donation-alias"], raise_on_error=False)
    assert not rep2.findings


def test_rule_donation_alias_shared_ef_state_across_fsdp_buckets():
    ef = torch.zeros(16)
    state = SimpleNamespace(comp=[{"ef": ef}, {"ef": ef}])
    rep = lint_step(None, fsdp_state=state, rules=["donation-alias"],
                    raise_on_error=False)
    assert _only(rep, "donation-alias").details["buckets"] == [0, 1]
    state2 = SimpleNamespace(comp=[{"ef": torch.zeros(16)},
                                   {"ef": torch.zeros(16)}])
    assert not lint_step(None, fsdp_state=state2, rules=["donation-alias"],
                         raise_on_error=False).findings


def test_rule_async_pair(world8):
    """A handle never waited is an error; one the step's ``finalize``
    waits (the double-buffered optimizer's shape) is not.  JAX's HLO
    fixtures give JAX's findings."""
    comm = _comm("xla")
    pending = []

    def leaky(x):
        pending.append(dist.all_reduce(x, group=comm._group,
                                       async_op=True))
        return x

    def drained(x):
        pending.append(dist.all_reduce(x, group=comm._group,
                                       async_op=True))
        return x
    drained.finalize = lambda: pending.pop().wait()

    rep = lint_step(leaky, torch.ones(4), rules=["async-pair"],
                    raise_on_error=False)
    f = _only(rep, "async-pair")
    assert f.details["kind"] == "unmatched-async-start"
    assert not lint_step(drained, torch.ones(4), rules=["async-pair"],
                         raise_on_error=False).findings

    for name, n in (("unmatched_start", 1), ("sync", 0)):
        pctx = SimpleNamespace(schedule=schedule_from_hlo(HLO[name]),
                               name="synthetic")
        jctx = SimpleNamespace(hlo_schedule=j_from_hlo(HLO[name]),
                               name="synthetic")
        got = get_rule("async-pair").run(pctx)
        want = jrules.get_rule("async-pair").run(jctx)
        assert len(got) == len(want) == n
        assert [f.details for f in got] == [f.details for f in want]


def test_double_buffered_step_holds_its_handle_one_step(world8):
    """The double-buffered optimizer's pending mean spans one step
    boundary: clean once ``finalize()`` ran, a finding without it."""
    from chainermn_tpu_torch import (create_multi_node_optimizer,
                                     make_train_step)
    comm = _comm("xla")
    model = torch.nn.Linear(8, 2)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm,
        double_buffering=True)
    step = make_train_step(comm, lambda b: model(b).square().mean(), opt)
    rep = lint_step(step, torch.ones(4, 8), rules=["async-pair"], steps=2,
                    raise_on_error=False)
    assert not rep.findings, rep.findings
    # the loss mean first, the gradient mean left in flight last: a
    # blocking all-reduce issued after it would wait for it
    assert [(op.kind, op.async_op) for op in rep.schedule] == \
        [("all-reduce", False), ("all-reduce", True)] * 2

    def no_drain(b):
        return step(b)
    rep = lint_step(no_drain, torch.ones(4, 8), rules=["async-pair"],
                    raise_on_error=False)
    assert _only(rep, "async-pair").details["op"] == "all-reduce"
    step.finalize()


# ---------------------------------------------------------------------------
# overlapping-collectives: JAX's event lists, JAX's findings
# ---------------------------------------------------------------------------

def _flight(kind_begin, kind_end, t0, t1, **f):
    return [{"kind": kind_begin, "ts": t0, "seq": 0, **f},
            {"kind": kind_end, "ts": t1, "seq": 1, **f}]


def _seq(events):
    for i, e in enumerate(events):
        e["seq"] = i
    return events


OVERLAP_CASES = {
    "contended": _seq(
        _flight("fsdp_gather_begin", "fsdp_gather_end", 10.010, 10.030,
                bucket=0, link="ici", nbytes=1 << 20)
        + _flight("plan_stage_begin", "plan_stage_end", 10.020, 10.040,
                  plan="alltoall_hier", op="all_to_all", stage=0,
                  scope="intra", link="ici", nbytes=1 << 16)),
    "full_nesting": _seq(
        _flight("fsdp_gather_begin", "fsdp_gather_end", 20.000, 20.100,
                bucket=0, link="ici", nbytes=1 << 20)
        + _flight("plan_stage_begin", "plan_stage_end", 20.020, 20.080,
                  plan="alltoall_hier", op="all_to_all", stage=0,
                  scope="intra", link="ici", nbytes=1 << 16)),
    "decomposition": _seq(
        _flight("collective_begin", "collective_end", 30.000, 30.100,
                op="allreduce_grad", op_seq=1, nbytes=1 << 20)
        + _flight("plan_stage_begin", "plan_stage_end", 30.020, 30.080,
                  plan="hier", op="all-reduce", stage=0,
                  scope="intra", link="ici", nbytes=1 << 20)),
    "cotuned_stripes": _seq(
        _flight("plan_stage_begin", "plan_stage_end", 5.000, 5.020,
                group=0, plan="striped_bf16", op="all-reduce", stage=0,
                scope="intra", link="ici", nbytes=1 << 18)
        + _flight("plan_stage_begin", "plan_stage_end", 5.005, 5.025,
                  group=1, plan="striped_bf16", op="all-reduce", stage=0,
                  scope="intra", link="ici", nbytes=1 << 18)),
    "cotuned_workload": _seq(
        _flight("plan_stage_begin", "plan_stage_end", 40.000, 40.030,
                plan="striped_r90@wl:ab12cd34ef56", op="all-reduce",
                stage=0, scope="intra", link="ici", nbytes=1 << 20)
        + _flight("plan_stage_begin", "plan_stage_end", 40.010, 40.040,
                  plan="alltoall_hier@wl:ab12cd34ef56", op="all_to_all",
                  stage=0, scope="intra", link="ici", nbytes=1 << 18)),
    "across_workloads": _seq(
        _flight("plan_stage_begin", "plan_stage_end", 41.000, 41.030,
                plan="striped_r90@wl:ab12cd34ef56", op="all-reduce",
                stage=0, scope="intra", link="ici", nbytes=1 << 20)
        + _flight("plan_stage_begin", "plan_stage_end", 41.010, 41.040,
                  plan="alltoall_hier@wl:999999999999", op="all_to_all",
                  stage=0, scope="intra", link="ici", nbytes=1 << 18)),
    "one_untagged": _seq(
        _flight("plan_stage_begin", "plan_stage_end", 42.000, 42.030,
                plan="striped_r90@wl:ab12cd34ef56", op="all-reduce",
                stage=0, scope="intra", link="ici", nbytes=1 << 20)
        + _flight("plan_stage_begin", "plan_stage_end", 42.010, 42.040,
                  plan="alltoall_hier", op="all_to_all", stage=0,
                  scope="intra", link="ici", nbytes=1 << 18)),
}


@pytest.mark.parametrize("case", sorted(OVERLAP_CASES))
def test_rule_overlapping_collectives_equals_jax(case):
    events = OVERLAP_CASES[case]
    rep = lint_step(None, flight_events={0: events},
                    rules=["overlapping-collectives"], raise_on_error=False,
                    name="synthetic")
    jctx = JContext(None, (), {}, name="synthetic",
                    flight_events={0: events})
    want = jrules.get_rule("overlapping-collectives").run(jctx)
    assert rep.ok  # warnings only
    assert [f.rule for f in rep.findings] == [f.rule for f in want]
    assert [f.severity for f in rep.findings] == ["warning"] * len(want)
    assert [f.details for f in rep.findings] == \
        [to_port(f.details) for f in want]
    fires = case in ("contended", "full_nesting", "across_workloads",
                     "one_untagged")
    assert bool(rep.findings) == fires


def test_rule_overlapping_collectives_skips_without_events():
    rep = lint_step(lambda x: x * 2, torch.ones(4), raise_on_error=False)
    assert "flight_events" in rep.skipped["overlapping-collectives"]


def test_rule_artifact_drift_on_the_repo_equals_jax():
    rep = lint_step(None, artifact_root=REPO, rules=["artifact-drift"],
                    raise_on_error=False)
    jctx = JContext(None, (), {}, name="artifacts", artifact_root=REPO)
    want = jrules.get_rule("artifact-drift").run(jctx)
    assert [(f.severity, f.details) for f in rep.findings] == \
        [(f.severity, f.details) for f in want]
    assert rep.ok


# ---------------------------------------------------------------------------
# lint_step API
# ---------------------------------------------------------------------------

def test_lint_step_raises_on_error_findings():
    big = torch.ones(64, 64)
    with pytest.raises(LintError) as ei:
        lint_step(lambda x: (x * big).sum(), torch.ones(64, 64))
    assert "captured-constant" in str(ei.value)
    assert ei.value.report.errors


def test_lint_step_skips_rules_without_inputs():
    rep = lint_step(lambda x: x * 2, torch.ones(4), raise_on_error=False)
    assert rep.ok
    for rule_id in ("schedule-desync", "census-drift", "unpinned-transpose",
                    "wire-dtype-mismatch"):
        assert rule_id in rep.skipped, rep.skipped
    for rule_id in ("captured-constant", "donation-alias", "async-pair"):
        assert rule_id not in rep.skipped
    rep = lint_step(None, rules=["captured-constant"], raise_on_error=False)
    assert "no step function given" in rep.skipped["captured-constant"]


def test_unknown_rule_id_is_an_error():
    with pytest.raises(ValueError, match="unknown lint rule"):
        lint_step(lambda x: x, torch.ones(()), rules=["no-such-rule"])


def test_rule_catalog_equals_jax_s():
    from chainermn_tpu_torch.analysis import all_rules
    got = [(r.id, r.severity, r.summary) for r in all_rules()]
    want = [(r.id, r.severity, r.summary) for r in jrules.all_rules()]
    assert got == want and len(got) == 14


def test_report_json_shape():
    rep = lint_step(lambda x: x * 2, torch.ones(4), raise_on_error=False,
                    name="t")
    doc = rep.to_json()
    assert doc["suite"] == "cmn_lint" and doc["target"] == "t"
    assert doc["ok"] is True and doc["findings"] == []
    json.dumps(doc)
    assert torch.equal(rep.outputs[0], torch.full((4,), 2.0))


# ---------------------------------------------------------------------------
# clean sweeps: the entry points hold zero error findings, dry
# ---------------------------------------------------------------------------

DATA_RULES = ("schedule-desync", "census-drift", "unpinned-transpose",
              "captured-constant", "donation-alias", "async-pair")


def test_clean_sweep_mnist_all_flavors():
    from chainermn_tpu_torch.analysis.entrypoints import (MNIST_FLAVORS,
                                                         lint_mnist)
    reports = lint_mnist()
    assert len(reports) == len(MNIST_FLAVORS) == 7
    for rep in reports:
        assert rep.ok, rep.render_text()
        for rule_id in DATA_RULES:
            assert rule_id not in rep.skipped, (rep.target, rep.skipped)


@pytest.mark.parametrize("entry,ran", [
    ("examples/long_context", ("schedule-desync", "captured-constant",
                               "donation-alias", "async-pair")),
    ("examples/resnet_fused", DATA_RULES),
    ("moe/train", ("schedule-desync", "census-drift", "wire-dtype-mismatch",
                   "captured-constant", "donation-alias", "async-pair")),
    ("serving/decode", ("schedule-desync", "captured-constant",
                        "async-pair")),
    ("serving/weights", ("schedule-desync", "census-drift",
                         "wire-dtype-mismatch", "async-pair")),
])
def test_clean_sweep_entry_point(entry, ran):
    from chainermn_tpu_torch.analysis.entrypoints import lint_entry_point
    for rep in lint_entry_point(entry):
        assert rep.ok, rep.render_text()
        for rule_id in ran:
            assert rule_id not in rep.skipped, (rep.target, rep.skipped)


def test_rules_still_fire_through_fused_norm():
    """Routing the body through the fused norm must not blind the
    analyzer: a rank-divergent order around it is still a desync, and an
    autograd all-reduce of a fused-norm loss still shows the gradient
    inflation."""
    from chainermn_tpu_torch.ops.fused_norm import FusedBatchNormAct
    S, M = dist.ReduceOp.SUM, dist.ReduceOp.MAX

    def build(rank):
        def body():
            comm = _comm("xla")
            norm = FusedBatchNormAct(8)
            y = norm(torch.ones(2, 8, 4, 4))
            for op in ((S, M) if comm.rank == 0 else (M, S)):
                dist.all_reduce(y, op=op, group=comm._group)
            return y
        return extract_schedule(body, rank=rank, world=2)
    rep = lint_step(None, variants={f"rank{r}": build(r) for r in (0, 1)},
                    rules=["schedule-desync"], raise_on_error=False)
    f = _only(rep, "schedule-desync")
    assert f.details["index"] == 0  # the norm contributes no collective

    with dry_world(0, 2):
        comm = _comm("xla")
        norm = FusedBatchNormAct(8)

        def raw_fused_loss(p, xb):
            import torch.distributed.nn.functional as dnn
            y = norm(xb * p["w"])
            return dnn.all_reduce(y.mean(), group=comm._group)
        rep2 = lint_step(None, comm=comm, loss=raw_fused_loss,
                         loss_args=({"w": torch.ones(1, 8, 1, 1)},
                                    torch.ones(2, 8, 4, 4)),
                         rules=["unpinned-transpose"], raise_on_error=False)
    assert _only(rep2, "unpinned-transpose").details[
        "extra_backward_psums"] >= 1
