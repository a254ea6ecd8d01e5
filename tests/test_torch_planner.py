"""The port's collective planner (``chainermn_tpu_torch/planner/``) against
the JAX package's, on the CPU.

* The device-free parts, exactly equal to JAX's for the topologies
  ``intra:4``, ``inter:2,intra:2`` and ``inter:2,intra:4`` and sizes from 1 B
  to 512 MiB: every candidate, all-to-all, broadcast, striped and compressed
  plan's dict; census kinds, wire dtypes, stage and group lengths, wire and
  link bytes (link classes renamed ``ici`` -> ``nvlink``, ``dcn`` -> ``ib``:
  the card's NVLink and inter-node network), the modeled time (relative
  1e-12), JAX's invalid plans, the size buckets, the table lookup's
  fallback, ``autotune_from_rows`` on the same rows, the workload
  simulator, ``jointly_tune`` and its table, ``plan_table_hash``, the
  online tuner's decision from the same observations, and
  ``bench_joint``'s document.
* The executor on gloo worlds of 2 and 4 ranks (``intra_size`` 2; worker
  mode ``plan``) against JAX's ``execute_plan`` / ``execute_alltoall`` in
  ``run_spmd`` on CPU meshes of the same shape: every flavor and candidate
  plan with float32, bfloat16 and float16 wires, multicast and p2p stages,
  per-hop int8/fp8 plans over 3 EF steps, the flat and hierarchical
  exchanges (and their gradients), the census of what was issued, the
  refusals.

Tolerance: at world 2 every sum has two terms, which any order rounds
alike, so every plan is held bit for bit.  At world 4 a stage over the
whole world sums four terms, and gloo's ring and XLA's CPU reduction add
them in other orders: there the random tree is held to ``2 (W - 1) u
mean_r |x_r|`` (two orders of a W-term sum each within ``(W - 1) u sum
|x|`` of the exact sum, ``u`` the coarsest wire's unit roundoff; the mean
divides by W), while a tree of eighths whose sums every wire represents
exactly is held bit for bit, as is every plan whose stages sum at most two
terms.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chainermn_tpu.planner as J
import chainermn_tpu_torch.planner as T
import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.parallel.topology import init_topology
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOS = ("intra:4", "inter:2,intra:2", "inter:2,intra:4")
SIZES = (1, 3, 1000, 4 << 10, 65537, 1 << 20, 100 << 20, 512 << 20)
DTYPES = ("float32", "bfloat16")

# JAX's link classes and attribution buckets -> the card's
_LINKS = {"ici": "nvlink", "dcn": "ib", "ici_comm": "nvlink_comm",
          "dcn_comm": "ib_comm"}


def to_port(obj):
    """A JAX document with its link names renamed (exact keys and values;
    ``"ici/owner"`` occupancy keys too).  Field names stay JAX's."""
    if isinstance(obj, dict):
        return {to_port(k): to_port(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(v) for v in obj)
    if isinstance(obj, str):
        if obj in _LINKS:
            return _LINKS[obj]
        head, sep, tail = obj.partition("/")
        if sep and head in _LINKS:
            return f"{_LINKS[head]}/{tail}"
    return obj


def jax_gbps(gbps):
    back = {v: k for k, v in _LINKS.items()}
    return {back[k]: v for k, v in gbps.items()}


def zoo(M, key):
    """Every plan the generators give for topology ``key`` (module M is
    the JAX or the port planner)."""
    t = M.PlanTopology.from_key(key)
    out = list(M.candidate_plans(t, wire_dtypes=("bfloat16", "float16"),
                                 stripe_ratios=M.STRIPE_RATIOS))
    out += M.alltoall_plans(t, stripe_ratios=(0.5, 0.8))
    out += M.broadcast_plans(t, wire_dtypes=("bfloat16", "float16"))
    out += [M.striped_plan(0.7, dcn_comp={"name": c, "stochastic": False})
            for c in ("int8", "fp8")]
    out += [M.multicast_plan(hierarchical=True, root=3, topology=t,
                             name="mc_root3")] if t.size > 3 else []
    return t, out


# ---- the device-free parts ---------------------------------------------------

@pytest.mark.parametrize("key", TOPOS)
def test_plan_dicts_equal_jax(key, tmp_path):
    jt, jz = zoo(J, key)
    tt, tz = zoo(T, key)
    assert [p.to_dict() for p in tz] == [p.to_dict() for p in jz]
    assert tt.key() == jt.key() == key and tt.to_dict() == jt.to_dict()
    for jp, tp in zip(jz, tz):
        # a plan JAX writes loads here and writes back the same dict
        path = tmp_path / f"{jp.name}.json"
        jp.save(str(path))
        assert T.load_plan(str(path)).to_dict() == jp.to_dict()
        assert T.Plan.from_json(jp.to_json()) == tp
    for f in J.FLAVOR_NAMES:
        assert T.flavor_plan(f).to_dict() == J.flavor_plan(f).to_dict()
    assert T.flavor_plan("xla", "bfloat16").to_dict() == \
        J.flavor_plan("xla", "bfloat16").to_dict()


@pytest.mark.parametrize("key", TOPOS)
def test_cost_model_equal_jax(key):
    jt, jz = zoo(J, key)
    tt, tz = zoo(T, key)
    gb = {"nvlink": 300.0, "ib": 12.5}
    for jp, tp in zip(jz, tz):
        assert T.plan_census_kinds(tp, tt) == J.plan_census_kinds(jp, jt)
        for g in range(len(jp.stage_groups())):
            assert T.plan_census_kinds(tp, tt, group=g) == \
                J.plan_census_kinds(jp, jt, group=g)
        assert T.plan_compressed_hops(tp, tt).keys() == \
            J.plan_compressed_hops(jp, jt).keys()
        for dt in DTYPES:
            assert T.plan_wire_dtypes(tp, tt, dt) == \
                J.plan_wire_dtypes(jp, jt, dt), jp.name
        for n in SIZES:
            assert T.plan_stage_lengths(tp, tt, n) == \
                J.plan_stage_lengths(jp, jt, n)
            assert T.plan_group_lengths(tp, n) == J.plan_group_lengths(jp, n)
            for dt in DTYPES:
                assert T.plan_wire_bytes(tp, tt, n, dt) == \
                    J.plan_wire_bytes(jp, jt, n, dt), (jp.name, n)
                assert T.plan_link_bytes(tp, tt, n, dt) == {
                    (s, _LINKS[l]): v for (s, l), v in
                    J.plan_link_bytes(jp, jt, n, dt).items()}
                assert T.plan_dcn_bytes(tp, tt, n, dt) == \
                    J.plan_dcn_bytes(jp, jt, n, dt)
                a = T.plan_modeled_time_s(tp, tt, n, gb, dt)
                b = J.plan_modeled_time_s(jp, jt, n, jax_gbps(gb), dt)
                assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
    assert T.LINK_CLASS == to_port(J.LINK_CLASS)
    with pytest.raises(ValueError, match="accepted"):
        T.validate_link_gbps({"ici": 1.0})


_INVALID = [
    lambda M: M.Stage(op="all-to-some"),
    lambda M: M.Stage(op="all-reduce", scope="diagonal"),
    lambda M: M.Stage(op="all-reduce", lowering="native"),
    lambda M: M.Stage(op="all-gather", lowering="warp"),
    lambda M: M.Stage(op="all-reduce", wire_dtype="float99"),
    lambda M: M.Plan(name="empty", stages=()),
    lambda M: M.Plan(name="ag", stages=(M.Stage(op="all-gather"),)),
    lambda M: M.Plan(name="cross", stages=(
        M.Stage(op="reduce-scatter", scope="intra"),
        M.Stage(op="all-gather", scope="inter"))),
    lambda M: M.Plan(name="sharded", stages=(
        M.Stage(op="reduce-scatter", scope="intra"),)),
    lambda M: M.Plan(name="leafrs", packing="leaf", stages=(
        M.Stage(op="reduce-scatter", scope="intra"),
        M.Stage(op="all-gather", scope="intra"))),
    lambda M: M.Plan(name="leafwire", packing="leaf", wire_dtype="bfloat16",
                     stages=(M.Stage(op="all-reduce"),)),
    lambda M: M.Plan(name="pack", packing="columnar",
                     stages=(M.Stage(op="all-reduce"),)),
    lambda M: M.Stage(op="reduce-scatter", compression={"name": "int8"}),
    lambda M: M.Stage(op="all-reduce", wire_dtype="bfloat16",
                      compression={"name": "int8"}),
    lambda M: M.Stage(op="all-reduce", compression={"chunk_size": 64}),
    lambda M: M.Stage(op="all-reduce", compression={"name": "zstd"}),
    lambda M: M.Plan(name="leafcomp", packing="leaf", stages=(
        M.Stage(op="all-reduce", compression={"name": "int8"}),)),
    lambda M: M.Plan(name="mix", stages=(
        M.Stage(op="all-to-all"), M.Stage(op="all-reduce"))),
    lambda M: M.Plan(name="a2aleaf", packing="leaf",
                     stages=(M.Stage(op="all-to-all"),)),
    lambda M: M.Plan(name="ratio", groups=(
        M.StageGroup(stages=(M.Stage(op="all-reduce"),), ratio=0.5),)),
    lambda M: M.StageGroup(stages=(M.Stage(op="all-reduce"),), ratio=0.0),
    lambda M: M.PlanTopology(axes=(("x", 0),)),
    lambda M: M.multicast_plan(hierarchical=True, root=2),
]


@pytest.mark.parametrize("case", range(len(_INVALID)))
def test_invalid_plans_raise_like_jax(case):
    with pytest.raises(J.PlanError) as want:
        _INVALID[case](J)
    with pytest.raises(T.PlanError) as got:
        _INVALID[case](T)
    assert str(got.value) == str(want.value)


def test_size_buckets_and_lookup_fallback(tmp_path):
    for n in SIZES + (4 << 10, (4 << 10) + 1, 256 << 20, (256 << 20) + 1):
        assert T.size_bucket(n) == J.size_bucket(n)
    assert T.BUCKET_EDGES == J.BUCKET_EDGES
    for M in (J, T):
        topo = M.PlanTopology.from_key("inter:2,intra:4")
        tab = M.PlanTable()
        tab.put(topo, "float32", "<=64KiB", M.flavor_plan("flat"))
        tab.put(topo, "float32", "<=16MiB", M.flavor_plan("two_dimensional"))
        tab.put(topo, "bfloat16", ">256MiB", M.flavor_plan("hierarchical"))
        picks = [getattr(tab.lookup(topo, dt, n), "name", None)
                 for dt in ("float32", "bfloat16", "float16")
                 for n in SIZES]
        if M is J:
            want, jtab = picks, tab
        else:
            assert picks == want
            assert tab.to_dict() == jtab.to_dict()
    # a table JAX wrote loads here and writes back the same dict
    path = tmp_path / "table.json"
    jtab.save(str(path))
    assert T.PlanTable.load(str(path)).to_dict() == jtab.to_dict()
    with pytest.raises(ValueError, match="schema"):
        T.PlanTable.from_dict({"schema": "bogus/v9"})


def _jax_synthetic_rows():
    """JAX's autotuner test rows: a small bucket the fixed flavor wins and
    a big one the bf16 wire wins (two samples)."""
    tkey = "inter:2,intra:4"
    wire = J.Plan(name="flat_bfloat16", packing="flat",
                  wire_dtype="bfloat16", stages=(J.Stage(op="all-reduce"),))
    return [
        {"topology": tkey, "dtype": "float32", "bytes": 2048,
         "plan": "flat", "us": 10.0},
        {"topology": tkey, "dtype": "float32", "bytes": 2048,
         "plan": "flat_bfloat16", "us": 12.0, "plan_spec": wire.to_dict()},
        {"topology": tkey, "dtype": "float32", "bytes": 1 << 20,
         "plan": "flat", "us": 100.0},
        {"topology": tkey, "dtype": "float32", "bytes": 1 << 20,
         "plan": "flat_bfloat16", "us": 60.0, "plan_spec": wire.to_dict()},
        {"topology": tkey, "dtype": "float32", "bytes": 900 << 10,
         "plan": "flat_bfloat16", "us": 70.0, "plan_spec": wire.to_dict()},
    ]


@pytest.mark.parametrize("source", [
    "synthetic", "ALLREDUCE_SWEEP_r06.json",
    "ALLREDUCE_SWEEP_COMPRESSED_r08.json", "ALLREDUCE_SWEEP_STRIPED_r11.json",
    "ALLTOALL_SWEEP_r15.json", "synthesized"])
def test_autotune_from_rows_equals_jax(source):
    """The same rows give the same table and comparison.  The committed
    sweeps are TPU runs, read here only as input data."""
    if source == "synthetic":
        rows = _jax_synthetic_rows()
    elif source == "synthesized":
        gb = {"nvlink": 0.2, "ib": 0.02}
        rows = []
        for key in TOPOS:
            for n in (4 << 10, 1 << 20, 64 << 20):
                got = T.synthesize_sweep_rows(
                    T.PlanTopology.from_key(key), "float32", n, gb)
                want = J.synthesize_sweep_rows(
                    J.PlanTopology.from_key(key), "float32", n,
                    jax_gbps(gb))
                assert got == want
                rows += got
    else:
        with open(os.path.join(REPO, source)) as f:
            rows = json.load(f)["rows"]
    T.validate_sweep_rows(rows)
    jt, jc = J.autotune_from_rows(rows)
    tt, tc = T.autotune_from_rows(rows)
    assert tt.to_dict() == jt.to_dict()
    assert tc == jc
    assert T.plan_table_hash(tt) == J.plan_table_hash(jt)
    assert T.FIXED_PLAN_NAMES == J.FIXED_PLAN_NAMES
    with pytest.raises(ValueError, match="missing"):
        T.validate_sweep_rows([{"topology": "intra:4"}])


@pytest.mark.parametrize("table", [
    "PLAN_TABLE_r06.json", "PLAN_TABLE_COMPRESSED_r08.json",
    "PLAN_TABLE_STRIPED_r11.json", "PLAN_TABLE_ALLTOALL_r15.json"])
def test_committed_tables_load_and_hash_alike(table):
    path = os.path.join(REPO, table)
    jt, tt = J.PlanTable.load(path), T.PlanTable.load(path)
    assert tt.to_dict() == jt.to_dict()
    assert T.plan_table_hash(tt) == J.plan_table_hash(jt)
    assert T.plan_table_hash(tt.to_dict()) == T.plan_table_hash(tt)


def _slots(M, topo):
    hier = next(p for p in M.alltoall_plans(topo)
                if p.name == "alltoall_hierarchical")
    return (M.WorkloadSlot(name="allreduce", nbytes=4 << 20,
                           plan=M.striped_plan(0.5)),
            M.WorkloadSlot(name="moe", nbytes=8 << 20, op="all-to-all",
                           plan=hier),
            M.WorkloadSlot(name="bcast", nbytes=1 << 20,
                           plan=M.multicast_plan(hierarchical=True),
                           after=("allreduce",)))


@pytest.mark.parametrize("key", ["inter:2,intra:2", "inter:2,intra:4"])
def test_workload_simulator_and_joint_tuning_equal_jax(key, tmp_path):
    gb = {"nvlink": 0.2, "ib": 0.02}
    jt, tt = J.PlanTopology.from_key(key), T.PlanTopology.from_key(key)
    jw = J.StepWorkload(topology=jt, slots=_slots(J, jt))
    tw = T.StepWorkload(topology=tt, slots=_slots(T, tt))
    assert tw.to_dict() == jw.to_dict()
    assert tw.signature() == jw.signature()
    for derate in (None, {"ib": 0.5}):
        js = J.simulate_workload(jw, jax_gbps(gb), derate=derate and
                                 jax_gbps(derate))
        ts = T.simulate_workload(tw, gb, derate=derate)
        assert ts.makespan_s == js.makespan_s
        assert ts.finish_s == js.finish_s and ts.start_s == js.start_s
        assert ts.link_busy_s == to_port(js.link_busy_s)
        assert ts.occupancy == {(_LINKS[l], o): c
                                for (l, o), c in js.occupancy.items()}
        assert ts.contended_slots == js.contended_slots
        assert T.workload_modeled_time_s(tw, gb, derate=derate) == \
            J.workload_modeled_time_s(jw, jax_gbps(gb),
                                      derate=derate and jax_gbps(derate))
    assert T.derated_link_gbps(gb, {"ib": {"derate": 0.25}}) == \
        to_port(J.derated_link_gbps(jax_gbps(gb), {"dcn": {"derate": 0.25}}))
    two = (0.5, 0.7)
    jtab, jcmp = J.jointly_tune(jw, link_gbps=jax_gbps(gb),
                                stripe_ratios=two)
    ttab, tcmp = T.jointly_tune(tw, link_gbps=gb, stripe_ratios=two)
    assert tcmp == to_port(jcmp)
    assert ttab.to_dict() == to_port(jtab.to_dict())
    cands = T.default_candidates(tw, stripe_ratios=two)
    assert {k: [p.to_dict() for p in v] for k, v in cands.items()} == {
        k: [p.to_dict() for p in v] for k, v in
        J.default_candidates(jw, stripe_ratios=two).items()}
    assert {k: p.name for k, p in T.independent_plans(tw, cands,
                                                      gb).items()} == \
        {k: p.name for k, p in J.independent_plans(
            jw, J.default_candidates(jw, stripe_ratios=two),
            jax_gbps(gb)).items()}
    path = tmp_path / "joint.json"
    jtab.save(str(path))
    again = T.JointPlanTable.load(str(path))
    assert again.to_dict() == jtab.to_dict()
    assert T.JointPlanTable.from_dict(again.to_dict()).to_dict() == \
        jtab.to_dict()
    assert {k: p.to_dict() for k, p in again.lookup(tw).items()} == \
        {k: p.to_dict() for k, p in jtab.lookup(jw).items()}
    # an unknown workload falls back to the per-plan table
    table = T.PlanTable()
    table.put(tt, "float32", T.size_bucket(64 << 20),
              T.flavor_plan("two_dimensional"))
    other = T.StepWorkload(topology=tt, slots=(T.WorkloadSlot(
        name="allreduce", nbytes=64 << 20),))
    jtable = J.PlanTable.from_dict(table.to_dict())
    jother = J.StepWorkload.from_dict(other.to_dict())
    assert again.slot_plan(other, "allreduce", table).name == \
        jtab.slot_plan(jother, "allreduce", jtable).name


def test_plan_slots_and_a13_refusals():
    T.clear_plan_slots()
    try:
        T.register_plan_slot("moe", nbytes=100, op="all-to-all",
                             owners=("moe",))
        T.register_plan_slot("moe", nbytes=50, op="all-to-all",
                             owners=("moe",))
        assert T.registered_slots()["moe"]["nbytes"] == 100
        topo = T.PlanTopology.from_key("inter:2,intra:2")
        wl = T.reconstruct_workload(topo)
        assert [s.name for s in wl.slots] == ["moe"]
        # occupancy evidence filters the slots (empty: every slot)
        assert [s.name for s in T.reconstruct_workload(
            topo, timelines={}).slots] == ["moe"]
        assert T.reconstruct_workload(
            topo, timelines={"nvlink": {"fsdp": [(0.0, 1.0)]}}) is None
        assert [s.name for s in T.reconstruct_workload(
            topo, timelines={"nvlink": {"moe": [(0.0, 1.0)]}}).slots] == [
                "moe"]
        plan = T.alltoall_plans(topo)[0]
        assert T.resolve_slot_plan("moe", None) is None
        T.set_slot_plan("moe", plan)
        assert T.resolve_slot_plan("moe", None) is plan
        assert T.get_slot_plan("moe") is plan
    finally:
        T.clear_plan_slots()
    # the tuner's span, attribution and timeline inputs take empty input
    tuner = T.OnlineTuner(topology=T.PlanTopology.from_key("intra:4"))
    for call, want in ((lambda: tuner.ingest([]), 0),
                       (lambda: tuner.observe_attribution({}), None),
                       (lambda: tuner.observe_timelines({}), None),
                       (lambda: tuner.observations.ingest_spans([]), 0),
                       (lambda: tuner.observations.ingest_events([]), 0)):
        assert call() == want
    assert tuner._timelines == {} and list(tuner._stall_fracs) == []
    rec = object()
    assert T.OnlineTuner(topology=tuner.topology,
                         flight=rec)._flight is rec


def _degraded_samples(steps=8):
    """JAX's degraded-link scenario (its test's ``degraded_dcn_events``):
    8 MiB at 0.5 GB/s on the inter-node hop, 1 MiB at 16 GB/s on
    NVLink."""
    out = []
    for _ in range(steps):
        out.append(("dcn", 8 << 20, (8 << 20) / 0.5e9))
        out.append(("ici", 1 << 20, (1 << 20) / 16e9))
    return out


@pytest.mark.parametrize("mode", ["per_plan", "fallback", "joint"])
def test_online_retune_decision_equals_jax(mode):
    """The same observations give the same decision (link names renamed);
    JAX's tuner is fed through its own store, the port's through
    ``observations.add`` and ``observe_payload``."""
    key = "inter:2,intra:4"
    kw = {"min_samples": 1}
    if mode == "fallback":
        kw["fallback_gbps"] = {"dcn": 2.0}
    if mode == "joint":
        kw.update(joint=True, fallback_gbps={"ici": 0.2, "dcn": 0.02})
    jtun = J.OnlineTuner(topology=J.PlanTopology.from_key(key), **kw)
    if "fallback_gbps" in kw:
        kw["fallback_gbps"] = to_port(kw["fallback_gbps"])
    ttun = T.OnlineTuner(topology=T.PlanTopology.from_key(key), **kw)
    samples = _degraded_samples()
    if mode == "fallback":
        samples = [s for s in samples if s[0] == "ici"]
    for M, tun in ((J, jtun), (T, ttun)):
        M.clear_plan_slots()
        if mode == "joint":
            M.register_plan_slot("allreduce", nbytes=4 << 20,
                                 op="all-reduce",
                                 owners=("plan:", "fsdp", "collective"))
            M.register_plan_slot("moe", nbytes=8 << 20, op="all-to-all",
                                 owners=("moe",))
            continue
        for link, nbytes, sec in samples:
            if M is J:
                tun.observations.add(link, nbytes, sec)
                b = J.size_bucket(nbytes)
                tun._payload_max[b] = max(tun._payload_max.get(b, 0),
                                          nbytes)
            else:
                tun.observations.add(_LINKS[link], nbytes, sec)
                tun.observe_payload(nbytes)
    try:
        assert jtun.on_regression([{"bucket": "dcn_comm", "ratio": 4.0}])
        assert ttun.on_regression([{"bucket": "ib_comm", "ratio": 4.0}])
        for M in (J, T):
            if mode == "joint":
                M.clear_plan_slots()
                M.register_plan_slot("allreduce", nbytes=4 << 20,
                                     op="all-reduce",
                                     owners=("plan:", "fsdp", "collective"))
                M.register_plan_slot("moe", nbytes=8 << 20,
                                     op="all-to-all", owners=("moe",))
            if M is J:
                want = jtun.retune()
            else:
                got = ttun.retune()
        assert want is not None
        assert got == to_port(want)
        assert ttun.observations.summary() == to_port(
            jtun.observations.summary())
        # the decision applies: the table, the pin and a joint slot
        ttun.apply_decision(got, step=5)
        assert T.active_plan_table_meta() == {
            "table_hash": got["table_hash"], "swap_step": 5}
        assert T.plan_table_hash(ttun.table) == got["table_hash"]
        if mode == "joint":
            assert T.get_slot_plan("moe").name == \
                got["joint"]["slot_plans"]["moe"]["name"]
        assert ttun.state()["table_hash"] == got["table_hash"]
    finally:
        for M in (J, T):
            M.clear_plan_slots()
            M.clear_active_plan_table()


def test_recommend_prefetch_depth_equals_jax():
    for fracs, cur, nb in (([0.2] * 5, 1, 4), ([0.2] * 5, 3, 4),
                           ([0.01, 0.3, 0.02], 0, 4), ([], 2, 4),
                           ([0.5, 0.1], 0, 2)):
        assert T.recommend_prefetch_depth(fracs, cur, nb) == \
            J.recommend_prefetch_depth(fracs, cur, nb)


def test_bench_joint_document_equals_jax():
    import sys
    sys.path.insert(0, REPO)
    from benchmarks.bench_joint import run_joint_sweep as jrun
    from chainermn_tpu_torch.benchmarks import bench_joint
    gb = {"nvlink": 0.2, "ib": 0.02}
    for key in ("inter:2,intra:4", "inter:2,intra:2"):
        got = bench_joint.run_joint_sweep(key, gb, 4096 << 10, 8192 << 10)
        want = jrun(key, jax_gbps(gb), 4096 << 10, 8192 << 10)
        assert got == to_port(want)
    doc = bench_joint.main(["--out", os.devnull])
    assert doc["comparison"]["speedup"] >= 1.0


# ---- the executor on gloo worlds ---------------------------------------------

INT8 = {"name": "int8", "stochastic": False}
FP8 = {"name": "fp8", "stochastic": False}


def exec_plans(world):
    """The gradient plans the executor is held to JAX on, at ``world``
    ranks with ``intra_size`` 2."""
    t = T.PlanTopology(axes=(("inter", world // 2), ("intra", 2)))
    out = list(T.candidate_plans(t, wire_dtypes=("bfloat16", "float16"),
                                 stripe_ratios=(0.6,)))
    out += [
        T.multicast_plan(root=1, name="mc_root1"),
        T.multicast_plan(wire_dtype="bfloat16", root=world - 1,
                         name="mc_bf16_last"),
        T.Plan(name="ring_intra", packing="leaf",
               stages=(T.Stage(op="p2p", scope="intra"),)),
        T.Plan(name="ring_inter_bf16", packing="flat",
               stages=(T.Stage(op="p2p", scope="inter",
                               wire_dtype="bfloat16"),)),
        T.Plan(name="two_dimensional_native_f16", packing="flat",
               stages=(T.Stage(op="reduce-scatter", scope="intra",
                               wire_dtype="float16"),
                       T.Stage(op="all-reduce", scope="inter"),
                       T.Stage(op="all-gather", scope="intra",
                               lowering="native"))),
        T.Plan(name="ident_bf16", packing="flat", stages=(
            T.Stage(op="all-reduce",
                    compression={"name": "none",
                                 "wire_dtype": "bfloat16"}),)),
        T.Plan(name="flat_f16_stage_bf16", packing="flat",
               wire_dtype="float16",
               stages=(T.Stage(op="all-reduce", wire_dtype="bfloat16"),)),
    ]
    if world > 2:
        out.append(T.multicast_plan(hierarchical=True, root=3,
                                    topology=t, name="mc_hier_root3"))
    return out


def quant_plans():
    return [T.compressed_two_dimensional(dict(INT8)),
            T.compressed_two_dimensional(dict(FP8)),
            T.striped_plan(0.6, dcn_comp=dict(INT8))]


def _trees(rng, w):
    return {"tree/rand/w": rng.randn(w, 3, 37).astype(np.float32),
            "tree/rand/b": (rng.randn(w, 5) * 10).astype(np.float32),
            "tree/exact/w": (rng.randint(-16, 17, (w, 3, 37)) / 8.0
                             ).astype(np.float32),
            "tree/exact/b": (rng.randint(-16, 17, (w, 5)) / 8.0
                             ).astype(np.float32),
            "tree/q0/w": (rng.randn(w, 40, 50) * 0.01).astype(np.float32),
            "tree/q1/w": (rng.randn(w, 40, 50) * 0.01).astype(np.float32),
            "tree/q2/w": (rng.randn(w, 40, 50) * 0.01).astype(np.float32)}


_WORLDS = {}


def world_run(w, tmp_path_factory):
    """The worker's run of ``w`` ranks (once a module)."""
    if w not in _WORLDS:
        rng = np.random.RandomState(w)
        t = T.PlanTopology(axes=(("inter", w // 2), ("intra", 2)))
        inp = {"intra_size": np.asarray(2),
               "parts": np.asarray("plans,quant,a2a,refuse"),
               "plans": np.asarray(json.dumps(
                   [p.to_dict() for p in exec_plans(w)])),
               "qplans": np.asarray(json.dumps(
                   [p.to_dict() for p in quant_plans()])),
               "a2aplans": np.asarray(json.dumps(
                   [p.to_dict() for p in
                    T.alltoall_plans(t, stripe_ratios=(0.5,))])),
               "a2a/buf": rng.rand(w, w, 3, 5).astype(np.float32),
               "a2a/w": rng.randn(w, w, 3, 5).astype(np.float32),
               **_trees(rng, w)}
        outs = torch_dist_worker.launch(
            "plan", inp, w, tmp_path_factory.mktemp(f"plan{w}"))
        _WORLDS[w] = (inp, outs)
    return _WORLDS[w]


_JCOMMS = {}


def jcomm(w):
    if w not in _JCOMMS:
        _JCOMMS[w] = jcreate("naive", mesh=init_topology(
            devices=jax.devices()[:w], intra_size=2).mesh)
    return _JCOMMS[w]


def _tree(inp, name):
    pre = f"tree/{name}/"
    return {k[len(pre):]: jnp.asarray(v) for k, v in inp.items()
            if k.startswith(pre)}


def _stacked(outs, prefix, leaf):
    return np.stack([o[f"{prefix}/{leaf}"] for o in outs])


_UNIT = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def _whole_world_sum(plan):
    """Whether a stage of ``plan`` sums over all four ranks, and the
    coarsest wire it rounds in."""
    wires = [plan.wire_dtype or "float32"]
    full = False
    for grp in plan.stage_groups():
        for st in grp.stages:
            if st.scope == "all" and st.op == "all-reduce":
                full = True
            if st.wire_dtype:
                wires.append(st.wire_dtype)
            if st.compression and st.compression.get("wire_dtype"):
                wires.append(st.compression["wire_dtype"])
    return full, max(_UNIT[w] for w in wires)


@pytest.mark.parametrize("world", [2, 4])
def test_executor_matches_jax(world, tmp_path_factory):
    inp, outs = world_run(world, tmp_path_factory)
    jc = jcomm(world)
    for plan in exec_plans(world):
        jp = J.load_plan(plan.to_dict())
        for tname in ("rand", "exact"):
            tree = _tree(inp, tname)
            want = jc.run_spmd(lambda g: J.execute_plan(jp, jc, g), tree)
            full, u = _whole_world_sum(plan)
            for leaf in tree:
                got = _stacked(outs, f"pl/{plan.name}/{tname}", leaf)
                w = np.asarray(want[leaf])
                assert got.dtype == w.dtype and got.shape == w.shape
                if world == 2 or tname == "exact" or not full:
                    # values: JAX's masked-psum gather turns -0.0 into 0.0
                    assert np.array_equal(got, w), (plan.name, tname, leaf)
                else:
                    x = np.asarray(tree[leaf])
                    bound = 2 * (world - 1) * u * np.abs(x).mean(0) * \
                        (1 + u) + 1e-30
                    assert np.all(np.abs(got - w) <= bound), (
                        plan.name, leaf, np.abs(got - w).max())


@pytest.mark.parametrize("world", [2, 4])
def test_census_of_issued_collectives(world, tmp_path_factory):
    """What the executor issued, mapped onto JAX's census kinds, is
    ``plan_census_kinds`` of the stages over more than one rank."""
    _, outs = world_run(world, tmp_path_factory)
    topo = T.PlanTopology(axes=(("inter", world // 2), ("intra", 2)))
    for plan in exec_plans(world):
        want = list(T.issued_census_kinds(plan, topo))
        got = [k for k in outs[0][f"census/{plan.name}"].tolist() if k]
        assert got == want, plan.name
        if world == 4:
            assert want == list(J.plan_census_kinds(
                J.load_plan(plan.to_dict()),
                J.PlanTopology.from_key(topo.key()))), plan.name


@pytest.mark.parametrize("world", [2, 4])
def test_per_hop_quantized_plans_match_jax(world, tmp_path_factory):
    """int8 / fp8 on the inter-node hop (and a striped plan with an int8
    stripe), deterministic, over 3 EF steps: each step's mean and each
    hop's final residual bit for bit against JAX's ``execute_plan(states=)``
    (int8 codes sum exactly in any order; fp8 codes in float16 in rank
    order on both sides)."""
    inp, outs = world_run(world, tmp_path_factory)
    jc = jcomm(world)
    jtopo = jc.plan_topology()
    steps = ("q0", "q1", "q2")
    for plan in quant_plans():
        jp = J.load_plan(plan.to_dict())
        n = int(np.prod(inp["tree/q0/w"].shape[1:]))
        st = J.init_plan_compression_states(jp, jtopo, n)
        st = jax.tree.map(lambda a: jnp.broadcast_to(a, (world,) + a.shape),
                          st)
        for k in steps:
            mean, st = jc.run_spmd(
                lambda g, s: J.execute_plan(jp, jc, g, states=s),
                _tree(inp, k), st)
            got = _stacked(outs, f"qt/{plan.name}/{k}", "w")
            assert np.array_equal(got, np.asarray(mean["w"])), (plan.name,
                                                                k)
        for hop, s in st.items():
            got = _stacked(outs, f"qt/{plan.name}/ef", str(hop))
            assert np.array_equal(got, np.asarray(s.ef)), (plan.name, hop)


@pytest.mark.parametrize("world", [2, 4])
def test_alltoall_plans_match_jax(world, tmp_path_factory):
    """Every exchange plan (flat, hierarchical, narrow inter-node wires,
    striped) equals JAX's ``execute_alltoall`` exactly, and the full-width
    ones equal the raw all-to-all; the gradient (the cotangent exchanged
    by the same plan) equals JAX's."""
    inp, outs = world_run(world, tmp_path_factory)
    jc = jcomm(world)
    jtopo = jc.plan_topology()
    buf, w = jnp.asarray(inp["a2a/buf"]), jnp.asarray(inp["a2a/w"])
    ref = np.stack([o["a2a/ref"] for o in outs])
    t = T.PlanTopology(axes=(("inter", world // 2), ("intra", 2)))
    for plan in T.alltoall_plans(t, stripe_ratios=(0.5,)):
        jp = J.load_plan(plan.to_dict())
        want = jc.run_spmd(lambda b: J.execute_alltoall(jp, jtopo, b), buf)
        got = np.stack([o[f"a2a/{plan.name}"] for o in outs])
        assert np.array_equal(got, np.asarray(want)), plan.name
        narrow = any(st.wire_dtype for g in plan.stage_groups()
                     for st in g.stages)
        if not narrow:
            assert np.array_equal(got, ref), plan.name
        gwant = jc.run_spmd(lambda b, ww: jax.grad(lambda bb: jnp.sum(
            J.execute_alltoall(jp, jtopo, bb) * ww))(b), buf, w)
        ggot = np.stack([o[f"a2a/{plan.name}/grad"] for o in outs])
        assert np.array_equal(ggot, np.asarray(gwant)), plan.name
        census = [k for k in outs[0][f"a2a/{plan.name}/census"].tolist()
                  if k]
        # the forward's exchanges (each a hop over more than one rank)
        assert census == list(T.issued_census_kinds(plan, t)), plan.name


@pytest.mark.parametrize("world", [2, 4])
def test_executor_refusals(world, tmp_path_factory):
    """JAX's refusals: a mis-sized per-hop state, states for a leaf plan,
    and (the communicator's seam) a missing hop's state."""
    _, outs = world_run(world, tmp_path_factory)
    for o in outs:
        assert bool(o["refuse/mis_sized"])
        assert bool(o["refuse/leaf_states"])
        assert bool(o["refuse/missing"])
