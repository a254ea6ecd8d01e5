"""The observability hooks of the port's planner, serving engine, FSDP and
compressors against the JAX package's, and the benches' ``--metrics``.

* ``execute_plan(pobs=)`` / ``execute_alltoall(pobs=)``: the
  ``plan_stage_begin``/``_end`` events (stage, op, scope, payload bytes,
  stripe group, in stage order within a group) and the ``plan_stage_*``
  metrics equal JAX's ``PlanObs`` over the same plan and topology (a world of one, JAX
  on a one-device CPU mesh), with the port's link classes in JAX's places
  (``nvlink`` for ``ici``, ``ib`` for ``dcn``); the outputs equal those of
  ``pobs=None``, bit for bit.
* The serving engine's ``serving_*`` family, FSDP's ``fsdp_overlap_*``
  family and ``fsdp_{leg}_{edge}`` events, and the ``compression_*``
  family carry JAX's names, kinds and labels (and its counts and bytes
  where the two layouts agree).
* Each bench's ``--metrics`` appends enveloped JSONL records.
* ``bench_allreduce --traced`` writes ``tracing_overhead/v1`` (the plan's
  stage events recorded, the noise guard's fields) and ``--replay-spans``
  the ``online_tune/v1`` decision, without a device.
"""

import json

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch import observability as pobs

LINK = {"ici": "nvlink", "dcn": "ib"}


@pytest.fixture(autouse=True)
def _observability_off():
    yield
    from chainermn_tpu import observability as jobs
    for obs in (pobs, jobs):
        obs.disable()
        obs.reset_flight_recorder()
        obs.get_registry().reset()


def _jax_on():
    from chainermn_tpu import observability as jobs
    jobs.get_registry().reset()
    jobs.reset_flight_recorder()
    jobs.enable()
    return jobs


def _stage_events(recorder, link_map=None):
    out = []
    for e in recorder.snapshot():
        if not e["kind"].startswith("plan_stage_"):
            continue
        e = {k: v for k, v in e.items() if k not in ("ts", "mono", "seq")}
        if link_map:
            e["link"] = link_map.get(e["link"], e["link"])
        out.append(e)
    return out


def _stage_metrics(reg, link_map=None):
    rows = []
    for r in reg.snapshot():
        if not r["name"].startswith("plan_stage_"):
            continue
        lab = dict(r["labels"])
        if link_map:
            lab["link"] = link_map.get(lab["link"], lab["link"])
        val = r["count"] if r["type"] == "histogram" else r["value"]
        rows.append((r["name"], tuple(sorted(lab.items())), val))
    return sorted(rows)


def _plans():
    from chainermn_tpu_torch.planner import flavor_plan, striped_plan
    return [flavor_plan("flat"), flavor_plan("hierarchical"),
            flavor_plan("two_dimensional"), flavor_plan("xla", "bfloat16"),
            flavor_plan("naive"), striped_plan(0.5)]


def _grads(rng):
    return {"a": rng.randn(6, 5).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "c": rng.randn(3, 3).astype(np.float32)}


@pytest.mark.parametrize("idx", range(6))
def test_execute_plan_spans_are_jax_s(idx):
    import jax

    from chainermn_tpu import create_communicator as jcreate
    from chainermn_tpu.parallel.topology import init_topology
    from chainermn_tpu.planner import Plan as JPlan
    from chainermn_tpu.planner import execute_plan as jexecute
    from chainermn_tpu_torch.planner import execute_plan

    plan = _plans()[idx]
    g = _grads(np.random.RandomState(idx))
    # JAX: PlanObs bound by execute_plan itself when observability is on
    jobs = _jax_on()
    jcomm = jcreate("naive", mesh=init_topology(
        devices=jax.devices()[:1]).mesh)
    jplan = JPlan.from_dict(plan.to_dict())
    jout = jcomm.run_spmd(lambda t: jexecute(jplan, jcomm, t),
                          {k: v[None] for k, v in g.items()})
    jax.effects_barrier()
    jev = _stage_events(jobs.get_flight_recorder())
    jmet = _stage_metrics(jobs.get_registry())
    # the port: an explicit PlanObs
    comm = create_communicator("naive", device="cpu")
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    off = execute_plan(plan, comm, tg)
    pobs.enable()
    hook = pobs.get_plan_obs(comm)
    on = execute_plan(plan, comm, tg, pobs=hook)
    pev = _stage_events(pobs.get_flight_recorder())
    pmet = _stage_metrics(pobs.get_registry())
    for k in g:
        assert torch.equal(on[k], off[k]), k
        np.testing.assert_allclose(on[k].numpy(), np.asarray(jout[k])[0],
                                   rtol=1e-2 if plan.wire_dtype else 1e-6)
    # within a stripe group the stages run in order; XLA interleaves the
    # independent groups of a striped plan, the port runs them in turn
    def by_group(evs):
        return sorted(evs, key=lambda e: e.get("group", -1))

    assert pev and by_group(pev) == by_group(
        [dict(e, link=LINK[e["link"]]) for e in jev])
    assert pmet == _stage_metrics(jobs.get_registry(), LINK) == \
        sorted(r for r in pmet)
    assert jmet  # JAX recorded too
    # stage order: every begin is followed by its own end
    kinds = [e["kind"] for e in pev]
    assert kinds == ["plan_stage_begin", "plan_stage_end"] * (len(pev) // 2)


def test_execute_alltoall_spans_are_jax_s():
    import jax

    from chainermn_tpu import create_communicator as jcreate
    from chainermn_tpu.parallel.topology import init_topology
    from chainermn_tpu.planner import Plan as JPlan
    from chainermn_tpu.planner import execute_alltoall as jexchange
    from chainermn_tpu.observability.spans import get_plan_obs as jget
    from chainermn_tpu_torch.planner import alltoall_plans, execute_alltoall

    comm = create_communicator("naive", device="cpu")
    topo = comm.plan_topology()
    jobs = _jax_on()
    jcomm = jcreate("naive", mesh=init_topology(
        devices=jax.devices()[:1]).mesh)
    buf = np.random.RandomState(5).randn(1, 4, 6).astype(np.float32)
    for plan in alltoall_plans(topo)[:3]:
        jobs.get_registry().reset()
        jobs.reset_flight_recorder()
        jplan = JPlan.from_dict(plan.to_dict())
        jtopo = jcomm.plan_topology()
        jcomm.run_spmd(lambda b: jexchange(jplan, jtopo, b,
                                           pobs=jget(jcomm)), buf[None])
        jax.effects_barrier()
        pobs.get_registry().reset()
        pobs.reset_flight_recorder()
        pobs.enable()
        tb = torch.from_numpy(buf.copy())
        off = execute_alltoall(plan, comm, tb)
        on = execute_alltoall(plan, comm, tb, pobs=pobs.get_plan_obs(comm))
        assert torch.equal(on, off)
        jev = _stage_events(jobs.get_flight_recorder(), LINK)
        assert _stage_events(pobs.get_flight_recorder()) == jev and jev
        assert _stage_metrics(pobs.get_registry()) == \
            _stage_metrics(jobs.get_registry(), LINK)


def test_plan_obs_off_path_adds_nothing():
    """``pobs=None`` records nothing, and a plan run with observability on
    but no hook records nothing either (the caller passes the hook)."""
    from chainermn_tpu_torch.planner import execute_plan, flavor_plan
    comm = create_communicator("naive", device="cpu")
    pobs.enable()
    execute_plan(flavor_plan("two_dimensional"), comm,
                 {"a": torch.ones(8)})
    assert _stage_events(pobs.get_flight_recorder()) == []
    assert _stage_metrics(pobs.get_registry()) == []


def _family(reg, prefix):
    """``{(name, type, label keys)}`` of a registry's ``prefix`` metrics."""
    return {(r["name"], r["type"], tuple(sorted(r["labels"])))
            for r in reg.snapshot() if r["name"].startswith(prefix)}


def test_serving_family_is_jax_s():
    from chainermn_tpu.models.transformer import TransformerLM as JLM
    from chainermn_tpu.serving import InferenceEngine as JEngine
    from chainermn_tpu.serving import ServingConfig as JConfig
    from chainermn_tpu_torch import weights
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.serving import (InferenceEngine, Router,
                                             ServingConfig)
    from torch_flax_parity import perturbed_variables

    lm = dict(vocab=64, d_model=32, n_layers=1, n_heads=2, max_len=64)
    jm = JLM(attention_impl="xla", **lm)
    variables = perturbed_variables(jm, np.zeros((1, 4), np.int32))
    tm = TransformerLM(lm["vocab"], lm["d_model"], lm["n_layers"],
                       lm["n_heads"], lm["max_len"], "xla", device="cpu")
    weights.load_flax_variables(tm, variables)
    cfg = dict(max_seqs=2, num_pages=16, page_size=4, max_pages_per_seq=6,
               chunk_tokens=4)
    rng = np.random.RandomState(0)
    reqs = [(list(map(int, rng.randint(1, 64, size=n))), m)
            for n, m in ((5, 3), (9, 4), (3, 2))]
    jobs = _jax_on()
    pobs.enable()
    jeng = JEngine(jm, variables, JConfig(**cfg))
    teng = InferenceEngine(tm, ServingConfig(**cfg))
    for p, m in reqs:
        jeng.submit(p, m)
        teng.submit(p, m)
    while not (jeng.idle() and teng.idle()):
        jr, tr = jeng.step(), teng.step()
        assert tr.plan == jr.plan
    fam_p = _family(pobs.get_registry(), "serving_")
    assert fam_p == _family(jobs.get_registry(), "serving_") and fam_p
    for name in ("serving_steps", "serving_admitted", "serving_retired",
                 "serving_prefill_tokens", "serving_generated_tokens"):
        assert pobs.get_registry().get(name).value() == \
            jobs.get_registry().get(name).value(), name
    assert pobs.get_registry().get("serving_retired").value() == \
        len(teng.completions) == 3
    kinds = {e["kind"] for e in pobs.get_flight_recorder().snapshot()}
    assert {"serving_begin", "serving_end"} <= kinds
    ops = {e.get("op") for e in pobs.get_flight_recorder().snapshot()}
    assert {"serving_step", "serving_forward"} <= ops
    steps = pobs.build_step_trees(pobs.get_flight_recorder().snapshot())
    assert len(steps) == pobs.get_registry().get("serving_steps").value()
    router = Router([InferenceEngine(tm, ServingConfig(**cfg))])
    router.submit(reqs[0][0], 2, session="s")
    assert pobs.get_registry().get("serving_router_dispatched").value(
        replica="0") == 1


def test_fsdp_family_is_jax_s():
    import jax
    import optax

    from chainermn_tpu import create_communicator as jcreate
    from chainermn_tpu.parallel.fsdp import fsdp_init as jinit
    from chainermn_tpu.parallel.fsdp import make_fsdp_train_step as jstep
    from chainermn_tpu.parallel.topology import init_topology
    from chainermn_tpu.training.trainer import put_global_batch
    from chainermn_tpu_torch.parallel import (fsdp_init,
                                              make_fsdp_train_step)

    rng = np.random.RandomState(0)
    w = rng.randn(4, 3).astype(np.float32) * 0.1
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 3).astype(np.float32)
    # JAX: one bucket, the float32 wire, one step with observability on
    jobs = _jax_on()
    jcomm = jcreate("xla", mesh=init_topology(devices=jax.devices()[:1]).mesh)
    params = {"w": jax.numpy.asarray(w)}
    state, meta = jinit(jcomm, params, optax.sgd(0.1))
    step = jstep(jcomm, lambda p, b: jax.numpy.mean(
        (b[0] @ p["w"] - b[1]) ** 2), optax.sgd(0.1), meta, donate=False)
    state, _ = step(state, put_global_batch(jcomm, (x, y)))
    jax.effects_barrier()
    # the port: the same one-bucket step
    pobs.enable()
    comm = create_communicator("xla", device="cpu")
    lin = torch.nn.Linear(4, 3, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    pstate, pmeta = fsdp_init(comm, lin, torch.optim.SGD(
        lin.parameters(), lr=0.1))
    pstep = make_fsdp_train_step(
        comm, lambda b: torch.mean((lin(b[0]) - b[1]) ** 2), pstate, pmeta)
    pstep((torch.from_numpy(x), torch.from_numpy(y)))
    fam = _family(pobs.get_registry(), "fsdp_overlap_")
    assert fam == _family(jobs.get_registry(), "fsdp_overlap_") and fam

    def edges(rec):
        return sorted((e["kind"], e["bucket"], e["nbytes"], e["link"])
                      for e in rec.snapshot()
                      if e["kind"].startswith("fsdp_"))

    assert edges(pobs.get_flight_recorder()) == [
        (k, b, n, LINK[link]) for k, b, n, link
        in edges(jobs.get_flight_recorder())]
    for leg in ("gather", "scatter"):
        assert pobs.get_registry().get("fsdp_overlap_bytes").value(
            leg=leg, bucket="0") == jobs.get_registry().get(
                "fsdp_overlap_bytes").value(leg=leg, bucket="0")
    assert pobs.get_registry().get(
        "fsdp_overlap_dispatch_seconds").count() == 1


def test_compression_family_is_jax_s():
    import jax

    from chainermn_tpu import create_communicator as jcreate
    from chainermn_tpu.compression import resolve_compressor as jresolve
    from chainermn_tpu.parallel.topology import init_topology
    from chainermn_tpu_torch.compression import resolve_compressor

    rng = np.random.RandomState(1)
    g = {"a": rng.randn(300).astype(np.float32),
         "b": rng.randn(40, 3).astype(np.float32)}
    jobs = _jax_on()
    jcomm = jcreate("naive", mesh=init_topology(
        devices=jax.devices()[:1]).mesh)
    spec = {"name": "int8", "stochastic": False}
    comp = jresolve(spec)
    st0 = jcomm.init_compression_state(
        {k: jax.numpy.asarray(v) for k, v in g.items()}, comp)
    st0 = jax.tree.map(lambda a: jax.numpy.broadcast_to(a, (1,) + a.shape),
                       st0)
    jcomm.run_spmd(lambda t, s: jcomm.allreduce_grad(
        t, compressor=comp, state=s), {k: v[None] for k, v in g.items()},
        st0)
    jax.effects_barrier()
    pobs.enable()
    comm = create_communicator("naive", device="cpu")
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    pcomp = resolve_compressor(spec)
    state = comm.init_compression_state(tg, pcomp)
    comm.allreduce_grad(tg, compressor=pcomp, state=state)
    fam = _family(pobs.get_registry(), "compression_")
    assert fam == _family(jobs.get_registry(), "compression_") and fam
    lab = dict(seam="allreduce", bucket="0", compressor="int8")
    for name in ("compression_bits_per_param",
                 "compression_wire_bytes_saved"):
        assert pobs.get_registry().get(name).value(**lab) == \
            jobs.get_registry().get(name).value(**lab), name
    assert pobs.get_registry().get("compression_residual_norm").value(
        **lab) == pytest.approx(jobs.get_registry().get(
            "compression_residual_norm").value(**lab), rel=1e-5)
    spans = [e for e in pobs.get_flight_recorder().snapshot()
             if e["kind"].startswith("compute_")]
    assert [e["kind"] for e in spans] == ["compute_begin", "compute_end"] * 2
    assert [e["op"] for e in spans[::2]] == ["compress:allreduce",
                                             "decompress:allreduce"]


def _envelope_ok(rec):
    return {"kind", "ts", "git_sha", "device_kind"} <= set(rec)


def test_bench_metrics_write_enveloped_jsonl(tmp_path):
    from chainermn_tpu_torch.benchmarks import (bench_allreduce,
                                                bench_compression,
                                                bench_fsdp_overlap,
                                                bench_serving)
    path = str(tmp_path / "m.jsonl")
    bench_allreduce.main(["--device", "cpu", "--mb", "0.01", "--iters", "2",
                          "--warmup", "1", "--communicators", "naive,xla",
                          "--metrics", path])
    bench_compression.main(["--device", "cpu", "--layers", "2", "--width",
                            "16", "--batch", "4", "--buckets", "1",
                            "--iters", "1", "--warmup", "1",
                            "--compressors", "none,int8", "--no-assert",
                            "--metrics", path])
    bench_fsdp_overlap.main(["--device", "cpu", "--layers", "2", "--width",
                             "16", "--batch", "4", "--buckets", "1",
                             "--prefetch", "0", "--iters", "1", "--warmup",
                             "1", "--metrics", path])
    recs = pobs.read_jsonl(path)
    kinds = [r["kind"] for r in recs]
    assert kinds == ["bench_allreduce"] * 2 + ["bench_compression"] * 2 + \
        ["bench_fsdp_overlap"]
    assert all(_envelope_ok(r) for r in recs)
    spath = str(tmp_path / "s.jsonl")
    try:
        rc = bench_serving.main(["--device", "cpu", "--requests", "4",
                                 "--max-new", "3", "--prefix-share", "0",
                                 "--metrics", spath])
    finally:
        pobs.disable()
    assert rc in (0, 1)
    srecs = pobs.read_jsonl(spath)
    skinds = [r["kind"] for r in srecs]
    assert skinds[:2] == ["bench_serving", "bench_serving"]
    assert "span_summary" in srecs[0]
    names = {r["name"] for r in srecs if r["kind"] == "metric"}
    assert {"serving_steps", "serving_generated_tokens"} <= names


def test_a13b_routes_still_raise(tmp_path):
    """``--traced`` and ``--replay-spans`` run: the traced A/B on a world
    of one (the bf16 wire's plan, its casts through the plain cast on the
    CPU) and the replay of the committed degraded span dump."""
    import os
    from chainermn_tpu_torch.benchmarks import bench_allreduce
    for flag in ("--traced", "--replay-spans"):
        out = str(tmp_path / f"{flag[2:]}.json")
        if flag == "--traced":
            doc = bench_allreduce.main([
                flag, out, "--device", "cpu", "--communicators", "xla",
                "--allreduce-grad-dtype", "bfloat16", "--mb", "0.25",
                "--iters", "3", "--warmup", "1", "--repeats", "2"])
            assert doc["schema"] == "tracing_overhead/v1"
            assert doc["plan"] == "xla" and doc["timer"] == "host"
            assert doc["events_per_traced_run"] > 0
            assert len(doc["per_repeat_pct"]) == 2
            assert {"tracing_overhead_pct", "raw_overhead_pct",
                    "spread_pct", "noise_dominated", "time_ms_off",
                    "time_ms_on", "streaming_collect_ms"} <= set(doc)
            assert pobs.get_flight_recorder() is None  # left as found
        else:
            data = os.path.join(os.path.dirname(__file__), "data",
                                "degraded_dcn_spans.json")
            doc = bench_allreduce.main([flag, data, "--replay-out", out])
            assert doc["schema"] == "online_tune/v1"
            assert doc["retune"]["swap"] is True
        assert json.load(open(out))["schema"] == doc["schema"]
