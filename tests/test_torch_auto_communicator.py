"""The planner's communicator seams, port against port, on the CPU.

* Each of the seven flavors (and ``xla`` with a bfloat16 and a float16
  wire): its own ``allreduce_grad`` bit for bit against
  ``execute_plan(comm.plan())`` of the same gradients, on gloo worlds of 2
  and 4 ranks (``intra_size`` 2; ``single_node`` with the world as its
  node), so a flavor can delegate to the executor without moving a bit.
* ``create_communicator("auto", plan_table=...)``: a table miss runs the
  flat plan; per-bucket selection keyed on the dominant dtype; the table
  as a path, a dict or a ``PlanTable`` (and one that fails to load
  raises); ``swap_plan_table``; on a world of one a bf16-wire plan still
  rounds through bf16 (the stage's cast runs without its collective);
  on 2 and 4 ranks the auto mean equals ``execute_plan`` of its pick bit
  for bit, and double-buffered training through a table that picks the
  bf16 flat plan equals the ``xla`` flavor with the bf16 wire; the MNIST
  example with ``--communicator auto`` (no table: the flat plan) gives the
  flat flavor's losses on 2 ranks.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch.communicators import AutoCommunicator
from chainermn_tpu_torch.planner import (
    PlanTable, PlanTopology, candidate_plans, execute_plan, flavor_plan,
    size_bucket)
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LABELS = [label for label, name, _ in torch_dist_worker.FLAVORS
          if name != "pure_nccl"]


def _table(topo_key: str) -> dict:
    """The trees' buckets on ``topo_key``: the small trees and the linear
    model take the bf16 flat plan, the 8 KB trees the bf16 2-D plan."""
    topo = PlanTopology.from_key(topo_key)
    zoo = {p.name: p for p in candidate_plans(topo)}
    table = PlanTable()
    table.put(topo, "float32", "<=4KiB", zoo["flat_bfloat16"])
    table.put(topo, "float32", "<=64KiB", zoo["two_dimensional_bfloat16"])
    return table.to_dict()


_RUNS = {}


def world_run(w, tmp_path_factory):
    if w not in _RUNS:
        rng = np.random.RandomState(10 + w)
        tmp = tmp_path_factory.mktemp(f"auto{w}")
        parts = "flavors,auto" + (",mnist" if w == 2 else "")
        inp = {"intra_size": np.asarray(2), "parts": np.asarray(parts),
               "table": np.asarray(json.dumps(
                   _table(f"inter:{w // 2},intra:2"))),
               "out_dir": np.asarray(str(tmp)),
               "db/x": rng.randn(w, 4, 6).astype(np.float32),
               "tree/rand/w": rng.randn(w, 3, 37).astype(np.float32),
               "tree/rand/b": (rng.randn(w, 5) * 100).astype(np.float32),
               "tree/big/w": rng.randn(w, 40, 50).astype(np.float32)}
        _RUNS[w] = (inp, torch_dist_worker.launch("plan", inp, w, tmp))
    return _RUNS[w]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("label", LABELS)
def test_flavor_equals_its_plan_bit_for_bit(label, world,
                                            tmp_path_factory):
    inp, outs = world_run(world, tmp_path_factory)
    keys = [k for k in outs[0] if k.startswith(f"fl/{label}/own/")]
    assert len(keys) == 3
    for r, o in enumerate(outs):
        for k in keys:
            got, want = o[k.replace("/own/", "/plan/")], o[k]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(_bits(got), _bits(want)), (label, r, k)
    # and it is the world's mean
    for k in keys:
        leaf = k.split("/own/")[1]
        x = inp[f"tree/{leaf}"]
        tol = 4e-3 if label.startswith("xla_") else 1e-5
        np.testing.assert_allclose(outs[0][k], x.mean(0), rtol=tol,
                                   atol=tol * np.abs(x).max())


@pytest.mark.parametrize("world", [2, 4])
def test_auto_picks_by_bucket_and_equals_its_plan(world, tmp_path_factory):
    _, outs = world_run(world, tmp_path_factory)
    for o in outs:
        assert str(o["auto/pick/rand"]) == "flat_bfloat16"
        assert str(o["auto/pick/big"]) == "two_dimensional_bfloat16"
        for k in o:
            if k.startswith("auto/own/"):
                assert np.array_equal(
                    _bits(o[k]), _bits(o[k.replace("/own/", "/plan/")])), k


@pytest.mark.parametrize("world", [2, 4])
def test_auto_double_buffered_equals_xla_bf16(world, tmp_path_factory):
    """Three double-buffered SGD steps through the table's bf16 flat plan
    end on the ``xla`` flavor's bf16-wire weights, bit for bit (both cast
    in, sum in bf16 and cast back with the 1/size mean)."""
    _, outs = world_run(world, tmp_path_factory)
    for o in outs:
        assert np.array_equal(_bits(o["db/auto/w"]), _bits(o["db/xla/w"]))
    assert np.array_equal(outs[0]["db/auto/w"], outs[-1]["db/auto/w"])


def test_mnist_example_auto_equals_flat(tmp_path_factory):
    _, outs = world_run(2, tmp_path_factory)
    for o in outs:
        assert np.array_equal(o["mnist/auto/loss"], o["mnist/flat/loss"])
        assert np.all(np.isfinite(o["mnist/auto/loss"]))


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def test_auto_table_forms_miss_and_swap(world1, tmp_path):
    topo_key = "inter:1,intra:1"
    table = _table(topo_key)
    path = tmp_path / "table.json"
    PlanTable.from_dict(table).save(str(path))
    small = {"w": torch.linspace(-3, 3, 101)}
    for form in (table, str(path), PlanTable.from_dict(table)):
        comm = create_communicator("auto", device="cpu", plan_table=form)
        assert isinstance(comm, AutoCommunicator)
        assert comm.plan_table.to_dict() == PlanTable.from_dict(
            table).to_dict()
        assert comm.plan_for(400, "float32").name == "flat_bfloat16"
        assert comm.plan_for(8000, torch.float32).name == \
            "two_dimensional_bfloat16"
        # the nearest bucket for a size no entry holds; a dtype miss
        assert comm.plan_for(1 << 20, "float32").name == \
            "two_dimensional_bfloat16"
        assert comm.plan_for(400, "float16").name == "flat"
        # a world of one still rounds through the plan's bf16 wire
        got = comm.allreduce_grad(small)["w"]
        assert torch.equal(got, small["w"].to(torch.bfloat16).float())
    # no table: the flat plan, the identity on one rank
    bare = create_communicator("auto", device="cpu")
    assert bare.plan().name == "flat" and not bare.plan_table.entries
    assert torch.equal(bare.allreduce_grad(small)["w"], small["w"])
    # swap: the next call selects from the new table
    bare.swap_plan_table(table)
    assert torch.equal(bare.allreduce_grad(small)["w"],
                       small["w"].to(torch.bfloat16).float())
    bare.swap_plan_table(PlanTable())
    assert torch.equal(bare.allreduce_grad(small)["w"], small["w"])
    # the dominant dtype keys the lookup
    mixed = {"a": torch.ones(300), "b": torch.ones(10, dtype=torch.float16)}
    comm = create_communicator("auto", device="cpu", plan_table=table)
    assert comm._select(mixed).name == "flat_bfloat16"
    out = comm.allreduce_grad(mixed)
    assert out["b"].dtype == torch.float16
    assert torch.equal(out["a"], torch.ones(300))
    # a module's gradients are replaced in place
    lin = torch.nn.Linear(3, 2)
    for p in lin.parameters():
        p.grad = torch.full_like(p, 1.0 / 3.0)
    comm.allreduce_grad(lin)
    assert torch.equal(lin.weight.grad, torch.full(
        (2, 3), 1.0 / 3.0).to(torch.bfloat16).float())
    # a plan given as the compressor takes a tree (as a quantizer does)
    with pytest.raises(TypeError, match="tree of tensors"):
        comm.allreduce_grad(lin, compressor=flavor_plan("flat"))
    with pytest.raises(FileNotFoundError):
        create_communicator("auto", device="cpu",
                            plan_table=str(tmp_path / "missing.json"))
    with pytest.raises(ValueError, match="schema"):
        create_communicator("auto", device="cpu",
                            plan_table={"schema": "bogus/v9"})
    assert size_bucket(400) == "<=4KiB"


def test_flavor_plans_and_topology(world1):
    """Each flavor's ``plan()`` is JAX's fixed plan (xla's wire threaded
    in), and the communicator's topology is (inter, intra)."""
    for name in ("naive", "flat", "hierarchical", "two_dimensional",
                 "single_node", "non_cuda_aware", "xla"):
        comm = create_communicator(name, device="cpu")
        assert comm.plan().to_dict() == flavor_plan(name).to_dict()
        assert comm.plan_topology().key() == "inter:1,intra:1"
    comm = create_communicator("pure_nccl", device="cpu",
                               allreduce_grad_dtype="bfloat16")
    assert comm.plan().to_dict() == flavor_plan(
        "xla", wire_dtype="bfloat16").to_dict()
    g = {"w": torch.linspace(-1, 1, 33)}
    assert torch.equal(execute_plan(comm.plan(), comm, g)["w"],
                       comm.allreduce_grad(g)["w"])
