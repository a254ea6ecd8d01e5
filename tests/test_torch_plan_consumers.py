"""The collective planner's consumers in the port, on the CPU.

* ``moe_apply(plan=)``: every exchange plan (flat, bf16 flat, and on four
  ranks the hierarchical two-hop forms) against ``plan=None`` -- bit for
  bit where the wire is the payload's -- and against JAX's
  ``moe_apply(plan=)`` in ``shard_map`` on an (inter, intra) mesh of the
  same shape, outputs and the gradient of the summed squares; a MoE
  ``TransformerLM(moe_plan=)`` against one without.
* ``broadcast_inference_params(plan=)`` with flat, hierarchical,
  non-zero-root and bf16-wire multicast plans, and
  ``Router.distribute_weights``' default plan: root's tree on every rank,
  bit for bit (int8 codes and their scales included).
* The serving engine: ``ServingConfig(moe_plan=)`` on an expert-parallel
  world gives the tokens of ``moe_plan=None``, and a plan table rank 0
  registers mid-run is installed by every rank on the same serving step.
* The checkpoint's ``__plan_table_meta__`` sidecar: the round trip and its
  two refusals (a different live table, no live table).
* ``create_multi_node_optimizer(compression=<Plan>)``: one EF state a
  quantized hop, the same weights as threading the states through
  ``allreduce_grad(compressor=plan, state=)`` by hand (on 2 and 4 ranks),
  and JAX's two refusals.
* ``OnlineTuner.maybe_swap`` over an ``auto`` communicator: rank 0's
  decision, broadcast on the object plane, swaps every rank's table on the
  same step (the same hash and pin everywhere).
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import chainermn_tpu.planner as J
import torch_dist_worker
from chainermn_tpu.parallel.expert import moe_apply as jmoe
from chainermn_tpu_torch import create_communicator, \
    create_multi_node_optimizer
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.planner import (
    PlanTable, PlanTopology, alltoall_plans, clear_active_plan_table,
    compressed_two_dimensional, flavor_plan, multicast_plan,
    plan_table_hash, set_active_plan_table)
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D = 12, 6     # tokens a rank, model width


def moe_plans(w):
    t = PlanTopology(axes=(("inter", w // 2), ("intra", 2)))
    return alltoall_plans(t)


def bcast_plans(w):
    t = PlanTopology(axes=(("inter", w // 2), ("intra", 2)))
    out = [multicast_plan(root=1, name="mc_root1"),
           multicast_plan(root=0, wire_dtype="bfloat16", name="mc_bf16")]
    if w > 2:
        out.append(multicast_plan(hierarchical=True, root=3, topology=t,
                                  name="mc_hier_root3"))
    return out


_RUNS = {}


def world_run(w, tmp_path_factory):
    if w not in _RUNS:
        rng = np.random.RandomState(20 + w)
        inp = {"intra_size": np.asarray(2),
               "parts": np.asarray("moe,bcast,engine,opt,tuner"),
               "moeplans": np.asarray(json.dumps(
                   [p.to_dict() for p in moe_plans(w)])),
               "bplans": np.asarray(json.dumps(
                   [p.to_dict() for p in bcast_plans(w)])),
               "moe/x": rng.randn(w, N, D).astype(np.float32),
               "moe/logits": rng.randn(w, N, 2 * w).astype(np.float32),
               "moe/toks": rng.randint(0, 32, (w, 2, 8)),
               "bc/w": rng.randn(w, 4, 3).astype(np.float32),
               "opt/x": rng.randn(w, 4, 6).astype(np.float32)}
        _RUNS[w] = (inp, torch_dist_worker.launch(
            "planuse", inp, w, tmp_path_factory.mktemp(f"planuse{w}")))
    return _RUNS[w]


def _jax_moe(w, plan, x, logits):
    """JAX's ``moe_apply(2 t, plan=)`` and d/dx of the summed squares on
    an (inter, intra) mesh."""
    mesh = Mesh(np.array(jax.devices()[:w]).reshape(w // 2, 2),
                ("inter", "intra"))
    axes = ("inter", "intra")
    spec = P(axes)
    jp = None if plan is None else J.load_plan(plan.to_dict())

    def body(xx, ll):
        y = jmoe(lambda t: 2.0 * t, ll, xx, axes, plan=jp)
        return y, lax.psum((y ** 2).sum(), axes)

    def loss(xx, ll):
        return jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                             out_specs=(spec, P()))(xx, ll)[1]

    y, _ = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=(spec, P())))(x, logits)
    gx = jax.jit(jax.grad(loss))(x, logits)
    return np.asarray(y), np.asarray(gx)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_apply_plans(world, tmp_path_factory):
    inp, outs = world_run(world, tmp_path_factory)
    x = inp["moe/x"].reshape(world * N, D)
    logits = inp["moe/logits"].reshape(world * N, -1)
    stack = lambda k: np.concatenate([o[k] for o in outs])  # noqa: E731
    base_y, base_g = stack("moe/none/y"), stack("moe/none/gx")
    jy, jg = _jax_moe(world, None, x, logits)
    np.testing.assert_allclose(base_y, jy, rtol=1e-6, atol=1e-6)
    for plan in moe_plans(world):
        y, g = stack(f"moe/{plan.name}/y"), stack(f"moe/{plan.name}/gx")
        py, pg = _jax_moe(world, plan, x, logits)
        narrow = any(st.wire_dtype for grp in plan.stage_groups()
                     for st in grp.stages)
        if not narrow:
            # the exchange is the raw all-to-all's data movement
            assert np.array_equal(y, base_y), plan.name
            assert np.array_equal(g, base_g), plan.name
        # against JAX's plan path: the same function of the same values
        np.testing.assert_allclose(y, py, rtol=1e-6, atol=1e-6,
                                   err_msg=plan.name)
        np.testing.assert_allclose(g, pg, rtol=1e-5, atol=1e-5,
                                   err_msg=plan.name)
    for o in outs:
        assert np.array_equal(o["lm/plan"], o["lm/none"])
        assert np.all(np.isfinite(o["lm/plan"]))


@pytest.mark.parametrize("world", [2, 4])
def test_multicast_weights_exact(world, tmp_path_factory):
    _, outs = world_run(world, tmp_path_factory)
    roots = {"mc_root1": 1, "mc_bf16": 0, "mc_hier_root3": 3, "router": 0}
    for name, root in roots.items():
        if name == "mc_hier_root3" and world == 2:
            continue
        mine = {k[len("bc/mine/"):]: v for k, v in outs[root].items()
                if k.startswith("bc/mine/")}
        assert set(mine) == {"w", "h", "ids", "q/m/int8_codes",
                             "q/m/int8_scale"}
        for r, o in enumerate(outs):
            for k, v in mine.items():
                if name == "mc_bf16" and k in ("w", "q/m/int8_scale"):
                    # a bf16 wire rounds float32 leaves once (exactly the
                    # cast); bf16, int64 and int8 leaves pass unchanged
                    v = torch.from_numpy(v).to(torch.bfloat16).float() \
                        .numpy()
                assert np.array_equal(o[f"bc/{name}/{k}"], v), (name, r, k)


@pytest.mark.parametrize("world", [2, 4])
def test_engine_moe_plan_and_table_pickup(world, tmp_path_factory):
    _, outs = world_run(world, tmp_path_factory)
    table = PlanTable()
    table.put(PlanTopology(axes=(("inter", world // 2), ("intra", 2))),
              "float32", "<=4KiB", flavor_plan("flat"))
    for o in outs:
        assert np.array_equal(o["engine/plan/tokens"],
                              o["engine/none/tokens"])
        assert len(o["engine/plan/tokens"]) == 12
        # rank 0 registered the table before step 2; every rank installed
        # it on that step
        assert o["engine/pickups"].tolist() == [2]
        assert str(o["engine/hash"]) == plan_table_hash(table)
        assert int(o["engine/swap_step"]) == 40


@pytest.mark.parametrize("world", [2, 4])
def test_optimizer_per_hop_plan(world, tmp_path_factory):
    _, outs = world_run(world, tmp_path_factory)
    for o in outs:
        assert np.array_equal(o["opt/opt"], o["opt/manual"])
        assert o["opt/hops"].tolist() == [1]
    assert np.array_equal(outs[0]["opt/opt"], outs[-1]["opt/opt"])


@pytest.mark.parametrize("world", [2, 4])
def test_online_tuner_swaps_every_rank(world, tmp_path_factory):
    _, outs = world_run(world, tmp_path_factory)
    pins = {str(o["tuner/pin"]) for o in outs}
    hashes = {str(o["tuner/hash"]) for o in outs}
    assert all(bool(o["tuner/swapped"]) for o in outs)
    assert len(pins) == 1 and len(hashes) == 1
    pin = json.loads(pins.pop())
    assert pin["swap_step"] == 7 and pin["table_hash"] == hashes.pop()
    # the degraded inter-node link moves the 8 MiB pick off flat
    assert {str(o["tuner/pick"]) for o in outs} != {"flat"}


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    clear_active_plan_table()
    if created:
        dist.destroy_process_group()


def test_optimizer_plan_refusals(world1):
    comm = create_communicator("naive", device="cpu")
    lin = torch.nn.Linear(3, 2)
    plan = compressed_two_dimensional({"name": "int8", "stochastic": False})
    for kw in ({"zero": True}, {"double_buffering": True}):
        with pytest.raises(NotImplementedError, match="per-hop"):
            create_multi_node_optimizer(
                torch.optim.SGD(lin.parameters(), lr=0.1), comm,
                compression=plan, **kw)
    with pytest.raises(ValueError, match="no quantizing"):
        create_multi_node_optimizer(
            torch.optim.SGD(lin.parameters(), lr=0.1), comm,
            compression=flavor_plan("flat"))
    opt = create_multi_node_optimizer(
        torch.optim.SGD(lin.parameters(), lr=0.1), comm, compression=plan)
    assert set(opt.comp_state) == {1} and opt.comp_state[1].hop == 1


def test_checkpoint_plan_table_sidecar(world1, tmp_path):
    """A save after a hot-swap pins the table's hash; a resume refuses a
    different live table and no live table, and continues under the same
    one.  The sidecar is JAX's key and JSON."""
    comm = create_communicator("naive", device="cpu")
    topo = comm.plan_topology()
    table = PlanTable()
    table.put(topo, "float32", "<=1MiB", flavor_plan("two_dimensional"))
    other = PlanTable()
    other.put(topo, "float32", "<=1MiB", flavor_plan("flat"))
    state = {"w": torch.arange(6.0), "step": torch.tensor(3)}
    ckpt = create_multi_node_checkpointer(comm, str(tmp_path), name="s")
    clear_active_plan_table()
    ckpt.save(state, 1)   # no swap yet: no sidecar
    files = list(tmp_path.glob("s.1.*"))
    assert files and "__plan_table_meta__" not in np.load(files[0]).files
    meta = set_active_plan_table(table, step=7)
    assert meta == {"table_hash": plan_table_hash(table), "swap_step": 7}
    assert plan_table_hash(table) == J.plan_table_hash(
        J.PlanTable.from_dict(table.to_dict()))
    ckpt.save(state, 2)
    saved = np.load(next(tmp_path.glob("s.2.*")))
    assert json.loads(str(saved["__plan_table_meta__"])) == meta
    target = {"w": torch.zeros(6), "step": torch.tensor(0)}
    got, gen = ckpt.resume(target)
    assert gen == 2 and torch.equal(got["w"], state["w"])
    set_active_plan_table(other, step=9)
    with pytest.raises(ValueError, match="pins plan table"):
        ckpt.resume(target)
    clear_active_plan_table()
    with pytest.raises(ValueError, match="no active plan table"):
        ckpt.resume(target)
