"""The port's expert parallelism (``chainermn_tpu_torch/parallel/
expert.py``) against the JAX package's, on the CPU.

Twins of ``tests/test_tensor_expert_parallel.py``'s MoE tests, on gloo
worlds of 1, 2 and 4 ranks (``torch_dist_worker.py`` mode ``tpep``)
against JAX's ``moe_apply`` / ``ExpertParallelMLP`` inside ``shard_map``
on a mesh of as many CPU devices; rank r holds experts ``[r E/P, (r+1)
E/P)`` and tokens ``[r N, (r+1) N)`` and is held to device r.  Float32
within 1e-5; the routing integers (top-k indices, capacity slots, kept
choices) and the expert loads as counts exactly.  Cases, each at every
world (8 experts: several a rank below 8 ranks; ``one``: one a rank):

* top-1 and top-2 without truncation, also against dense routing;
* top-2 at JAX's default capacity (choices dropped);
* the statistics under balanced and collapsed routers;
* top-2 capacity priority (first choices win the buckets);
* the aux loss's gradient on the logits (toward balance);
* per-expert scales' gradients landing on the routed experts only;
* the capacity-truncation residual;
* ``ExpertParallelMLP`` from flax's leaves: its output and the gradient of
  every leaf (the router's summed over the ranks, each expert's whole on
  its owner) against JAX's replicated-parameter gradients;
* the expert-count mismatch refusal, JAX's message.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker
from chainermn_tpu.parallel.expert import (ExpertParallelMLP as JMoE,
                                           moe_apply as jmoe)
from chainermn_tpu_torch.parallel.expert import moe_apply
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D, H, E = 16, 16, 32, 8
TOL = 1e-5
WORLDS = (1, 2, 4)
KINDS = ("mlp", "id", "double")


def _cases(p):
    """``{case: inputs}`` for a world of ``p`` (global tokens ``p N``)."""
    rng = np.random.RandomState(10 + p)
    n = p * N
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    even = (np.arange(n) % 2 == 0)[:, None]
    one = max(p, 2)

    def case(logits, cap, k, kind="mlp", experts=E, **extra):
        out = {"x": f32(n, D), "logits": logits.astype(np.float32),
               "meta": np.asarray([cap, k, KINDS.index(kind)])}
        if kind == "mlp":
            out.update(we=f32(experts, D, H) * 0.2,
                       wo=f32(experts, H, D) * 0.2)
        out.update(extra)
        return out

    two_hot = lambda a, b: np.where(  # noqa: E731
        even, np.eye(E)[a] * 5.0 + np.eye(E)[b] * 2.0,
        np.eye(E)[b] * 5.0 + np.eye(E)[a] * 2.0)
    return {
        "top1": case(f32(n, E) * 2.0, N, 1),
        "top2": case(f32(n, E) * 2.0, 2 * N, 2),
        "default": case(f32(n, E) * 2.0, -1, 2),
        "one": case(f32(n, one) * 2.0, N, 1, experts=one),
        "balanced": case(np.eye(E)[np.arange(n) % E] * 4.0, N, 1, "id"),
        "collapsed": case(np.eye(E)[np.zeros(n, int)] * 20.0, 2, 1, "id"),
        "priority": case(two_hot(0, 1), N // 2, 2, "double"),
        "truncation": case(np.eye(E)[np.zeros(n, int)] * 10.0, 1, 1),
        "aux_grad": case(np.eye(E)[np.zeros(n, int)] * 2.0, N, 1, "id"),
        "routed": case(np.where(even, np.eye(E)[np.zeros(n, int)] * 9.0,
                                np.eye(E)[np.ones(n, int)] * 9.0), N, 1,
                       "id", w=np.ones((E, D), np.float32)),
        "module": case(f32(n, E), -1, 2, "id"),
    }


def _jfn(kind, we=None, wo=None):
    if kind == "id":
        return lambda t: t
    if kind == "double":
        return lambda t: 2.0 * t

    def mlp(t):
        if t.ndim == 2:
            return jnp.dot(nn.gelu(jnp.dot(t, we[0])), wo[0])
        return jnp.einsum("eah,ehd->ead",
                          nn.gelu(jnp.einsum("ead,edh->eah", t, we)), wo)
    return mlp


def _jax_routing(logits, cap, k, n):
    """JAX's routing integers, transcribed from ``moe_apply``."""
    e = logits.shape[-1]
    c = cap if cap is not None else max(1, 2 * k * n // e)
    gates = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, topi = lax.top_k(gates, k)
    flat = jax.nn.one_hot(topi, e, dtype=jnp.int32).transpose(1, 0, 2) \
        .reshape(k * n, e)
    slot = ((jnp.cumsum(flat, axis=0) - 1) * flat).sum(-1).reshape(k, n).T
    return topi, slot, slot < c


def _jax_case(p, name, c):
    mesh = Mesh(np.array(jax.devices()[:p]), ("ep",))
    cap, k, kind = (int(v) for v in c["meta"])
    cap = None if cap < 0 else cap
    kind = KINDS[kind]
    x, logits = jnp.asarray(c["x"]), jnp.asarray(c["logits"])
    ep = P("ep")
    if name == "aux_grad":
        def aux_of(lg):
            return jax.shard_map(
                lambda xx, ll: jmoe(_jfn(kind), ll, xx, "ep", capacity=cap,
                                    top_k=k, return_stats=True)[1]
                ["aux_loss"], mesh=mesh, in_specs=(ep, ep),
                out_specs=P())(x, lg)
        return {"g_logits": jax.jit(jax.grad(aux_of))(logits)}
    if name == "routed":
        epd = logits.shape[1] // p

        def loss(w_):
            def body(xx, ll):
                me = lax.axis_index("ep")
                wl = lax.dynamic_slice_in_dim(w_, me * epd, epd, axis=0)
                fn = (lambda t: t * wl[0]) if epd == 1 \
                    else (lambda t: t * wl[:, None, :])
                y = jmoe(fn, ll, xx, "ep", capacity=cap, top_k=k)
                return lax.psum((y ** 2).sum(), "ep")
            return jax.shard_map(body, mesh=mesh, in_specs=(ep, ep),
                                 out_specs=P())(x, logits)
        return {"g_w": jax.jit(jax.grad(loss))(jnp.asarray(c["w"]))}
    if name == "module":
        moe = JMoE(hidden=H, axis_name="ep", top_k=k, num_experts=E,
                   with_stats=True)
        params = jax.jit(jax.shard_map(
            lambda xx: moe.init(jax.random.key(3), xx), mesh=mesh,
            in_specs=ep, out_specs=P(), check_vma=False))(x)

        def loss(pp):
            def body(pq, xx):
                y, st = moe.apply(pq, xx)
                return lax.psum((y ** 2).sum(), "ep") + st["aux_loss"], y
            return jax.shard_map(body, mesh=mesh, in_specs=(P(), ep),
                                 out_specs=(P(), ep))(pp, x)
        grads, y = jax.jit(jax.grad(loss, has_aux=True))(params)
        return {"params": jax.tree.map(np.asarray, params["params"]),
                "grads": jax.tree.map(np.asarray, grads["params"]),
                "y": np.asarray(y)}

    def body(xx, ll, *w):
        fn = _jfn(kind, *w)
        y, st = jmoe(fn, ll, xx, "ep", capacity=cap, top_k=k,
                     return_stats=True)
        topi, slot, keep = _jax_routing(ll, cap, k, xx.shape[0])
        return y, st, topi, slot, keep

    ws = [jnp.asarray(c[w]) for w in ("we", "wo") if w in c]
    y, st, topi, slot, keep = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(ep, ep) + (ep,) * len(ws),
        out_specs=(ep, P(), ep, ep, ep)))(x, logits, *ws)
    return jax.tree.map(np.asarray, dict(y=y, topi=topi, slot=slot,
                                         keep=keep, **st))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    res = {}
    for p in WORLDS:
        cases = _cases(p)
        refs = {name: _jax_case(p, name, c) for name, c in cases.items()}
        inputs = {f"ep/{name}/{k}": v for name, c in cases.items()
                  for k, v in c.items()}
        m = refs["module"]["params"]
        inputs["ep/module/router_kernel"] = m["router"]["kernel"]
        inputs["ep/module/router_bias"] = m["router"]["bias"]
        for leaf in ("up_kernel", "up_bias", "down_kernel", "down_bias"):
            inputs[f"ep/module/{leaf}"] = m[leaf]
        outs = torch_dist_worker.launch("tpep", inputs, p,
                                        tmp_path_factory.mktemp(f"ep{p}"))
        res[p] = (cases, refs, outs)
    return res


def _rows(r):
    return slice(r * N, (r + 1) * N)


def _dense(c, k):
    """The no-truncation output by dense routing: each token through its
    top-k experts, weighted by the (renormalised for k > 1) gates."""
    gates = jax.nn.softmax(jnp.asarray(c["logits"]), -1)
    topv, topi = lax.top_k(gates, k)
    comb = topv / topv.sum(-1, keepdims=True) if k > 1 else topv
    x, we, wo = (jnp.asarray(c[w]) for w in ("x", "we", "wo"))
    out = 0.0
    for j in range(k):
        idx = topi[:, j]
        yj = jnp.einsum("nh,nhd->nd", nn.gelu(jnp.einsum(
            "nd,ndh->nh", x, we[idx])), wo[idx])
        out = out + yj * comb[:, j][:, None]
    return np.asarray(out)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("case", ["top1", "top2", "default", "one",
                                  "balanced", "collapsed", "priority",
                                  "truncation"])
def test_moe_apply_matches_jax(worlds, p, case):
    """Output within 1e-5 of JAX's; routing integers and loads exact."""
    _, refs, outs = worlds[p]
    ref = refs[case]
    for r, out in enumerate(outs):
        pre = f"ep/{case}/"
        np.testing.assert_allclose(out[pre + "y"], ref["y"][_rows(r)],
                                   rtol=TOL, atol=TOL)
        for k in ("topi", "slot", "keep"):
            np.testing.assert_array_equal(out[pre + k], ref[k][_rows(r)],
                                          err_msg=k)
        np.testing.assert_array_equal(
            np.rint(out[pre + "expert_load"] * p * N),
            np.rint(ref["expert_load"] * p * N))
        np.testing.assert_array_equal(
            np.rint((1 - out[pre + "overflow_fraction"]) * p * N),
            np.rint((1 - ref["overflow_fraction"]) * p * N))
        np.testing.assert_allclose(out[pre + "aux_loss"], ref["aux_loss"],
                                   rtol=TOL)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("case,k", [("top1", 1), ("top2", 2), ("one", 1)])
def test_no_truncation_matches_dense_routing(worlds, p, case, k):
    cases, _, outs = worlds[p]
    want = _dense(cases[case], k)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"ep/{case}/y"], want[_rows(r)],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("p", WORLDS)
def test_stats_balanced_and_collapsed(worlds, p):
    """Balanced routing: aux at its minimum 1, uniform load, no overflow;
    a collapsed router: aux near E, overflow (N - C) / N."""
    _, _, outs = worlds[p]
    for out in outs:
        assert abs(float(out["ep/balanced/aux_loss"]) - 1.0) < 1e-5
        assert float(out["ep/balanced/overflow_fraction"]) == 0.0
        np.testing.assert_allclose(out["ep/balanced/expert_load"],
                                   np.full(E, 1 / E), atol=1e-6)
        assert float(out["ep/collapsed/aux_loss"]) > E * 0.9
        np.testing.assert_allclose(
            float(out["ep/collapsed/overflow_fraction"]), (N - 2) / N,
            atol=1e-6)
        assert float(out["ep/collapsed/expert_load"][0]) > 0.99


@pytest.mark.parametrize("p", WORLDS)
def test_top2_capacity_priority(worlds, p):
    """Every first choice kept, every second dropped: y = combine_1st x
    2x, the combine weight renormalised over both selected gates."""
    cases, _, outs = worlds[p]
    c = cases["priority"]
    gates = np.asarray(jax.nn.softmax(jnp.asarray(c["logits"]), -1))
    topv = -np.sort(-gates, axis=-1)[:, :2]
    want = (topv[:, 0] / topv.sum(-1))[:, None] * 2.0 * c["x"]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(float(out["ep/priority/overflow_fraction"]),
                                   0.5, atol=1e-6)
        np.testing.assert_allclose(out["ep/priority/y"], want[_rows(r)],
                                   rtol=1e-5, atol=1e-5)
        assert out["ep/priority/keep"][:, 0].all()
        assert not out["ep/priority/keep"][:, 1].any()


@pytest.mark.parametrize("p", WORLDS)
def test_aux_loss_gradient_matches_jax_and_pushes_toward_balance(worlds, p):
    _, refs, outs = worlds[p]
    g = np.concatenate([o["ep/aux_grad/g_logits"] for o in outs])
    np.testing.assert_allclose(g, refs["aux_grad"]["g_logits"], rtol=TOL,
                               atol=1e-7)
    assert g[:, 0].mean() > 0, "the gradient pushes e0's logits down"
    assert g[:, 1:].mean() < 0, "and the starved experts' up"


@pytest.mark.parametrize("p", WORLDS)
def test_expert_grads_land_on_routed_experts(worlds, p):
    """Each rank's scales' gradient equals JAX's rows of its experts;
    nonzero exactly on experts 0 and 1 (the routed ones)."""
    _, refs, outs = worlds[p]
    g = np.concatenate([o["ep/routed/g_w"] for o in outs])
    np.testing.assert_allclose(g, refs["routed"]["g_w"], rtol=TOL,
                               atol=TOL)
    assert np.abs(g[0]).sum() > 0 and np.abs(g[1]).sum() > 0
    np.testing.assert_allclose(g[2:], 0.0, atol=1e-6)


@pytest.mark.parametrize("p", WORLDS)
def test_capacity_truncation_residual(worlds, p):
    """Capacity 1, every token to expert 0: each rank's first token is
    transformed, the rest pass through unchanged."""
    cases, _, outs = worlds[p]
    x = cases["truncation"]["x"]
    for r, out in enumerate(outs):
        got, xs = out["ep/truncation/y"], x[_rows(r)]
        np.testing.assert_allclose(got[1:], xs[1:], rtol=1e-6)
        assert not np.allclose(got[0], xs[0], atol=1e-3)


@pytest.mark.parametrize("p", WORLDS)
def test_expert_parallel_mlp_every_leaf_gradient(worlds, p):
    """``ExpertParallelMLP`` from flax's leaves (top 2, JAX's capacity):
    the output and the gradient of ``psum(sum y^2) + aux`` for the router
    (summed over the ranks) and each rank's expert rows."""
    _, refs, outs = worlds[p]
    ref = refs["module"]
    epd = E // p
    for r, out in enumerate(outs):
        pre = "ep/module/"
        np.testing.assert_allclose(out[pre + "y"], ref["y"][_rows(r)],
                                   rtol=TOL, atol=TOL)
        g = ref["grads"]
        np.testing.assert_allclose(out[pre + "g/router.weight"],
                                   g["router"]["kernel"].T, rtol=1e-4,
                                   atol=TOL)
        np.testing.assert_allclose(out[pre + "g/router.bias"],
                                   g["router"]["bias"], rtol=1e-4, atol=TOL)
        for leaf in ("up_kernel", "up_bias", "down_kernel", "down_bias"):
            np.testing.assert_allclose(out[pre + "g/" + leaf],
                                       g[leaf][r * epd:(r + 1) * epd],
                                       rtol=1e-4, atol=TOL, err_msg=leaf)


def test_moe_rejects_expert_count_mismatch():
    """JAX's message, on a world of one."""
    rng = np.random.RandomState(5)
    x = rng.randn(E * 4, D).astype(np.float32)
    bad = rng.randn(E * 4, E + 2).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("ep",))
    with pytest.raises(ValueError, match="experts") as want:
        jax.jit(jax.shard_map(
            lambda xx, ll: jmoe(lambda t: t, ll, xx, "ep", num_experts=E),
            mesh=mesh, in_specs=(P("ep"), P("ep")),
            out_specs=P("ep")))(x, bad)
    with pytest.raises(ValueError, match="experts") as got:
        moe_apply(lambda t: t, torch.from_numpy(bad), torch.from_numpy(x),
                  num_experts=E)
    assert str(got.value) == str(want.value)


def test_planner_routes_raise_naming_a11():
    """The planner's routes are ported (A11): on a world of one the flat
    exchange plan is the raw path bit for bit, ``moe_plan_topology`` is
    the communicator's, the layer keeps its plan; and the per-hop spans
    (``plan_obs=``, ported with A13 (a)) record the exchanges' stages."""
    from chainermn_tpu_torch.parallel import expert
    from chainermn_tpu_torch.planner import alltoall_plans
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, D).astype(np.float32))
    logits = torch.from_numpy(rng.randn(4, E).astype(np.float32))
    topo = expert.moe_plan_topology(None)
    assert topo.key() == "inter:1,intra:1"
    flat = alltoall_plans(topo)[0]
    want = moe_apply(lambda t: 2.0 * t, logits, x, num_experts=E)
    got = moe_apply(lambda t: 2.0 * t, logits, x, num_experts=E,
                    plan=flat, plan_topology=topo)
    assert torch.equal(got, want)
    # the per-hop spans are ported (A13 a): a PlanObs records both
    # exchanges' stages, and the output is the same bits
    from chainermn_tpu_torch.observability import (
        FlightRecorder, MetricsRegistry, PlanObs)
    rec, reg = FlightRecorder(), MetricsRegistry()
    got = moe_apply(lambda t: 2.0 * t, logits, x, num_experts=E,
                    plan=flat, plan_topology=topo,
                    plan_obs=PlanObs(rec, reg))
    assert torch.equal(got, want)
    kinds = [e["kind"] for e in rec.snapshot()]
    assert kinds == ["plan_stage_begin", "plan_stage_end"] * 2
    assert {e["plan"] for e in rec.snapshot()} == {flat.name}
    assert reg.get("plan_stage_seconds").count(
        plan=flat.name, stage="0", op="all-to-all",
        scope=flat.stages[0].scope, link="ib", group="-") == 2
    mlp = expert.ExpertParallelMLP(D, H, plan=flat, device="cpu")
    assert mlp.plan is flat
