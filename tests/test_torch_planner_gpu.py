"""The collective planner on the card.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
nothing else, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_planner_gpu.py

On an NCCL world of one card (a scope of one rank runs no collective, but
its wire casts run, through the cast kernel):

* a bf16-wire plan (the flat bf16 plan, the 2-D bf16 plan, a per-stage
  float16 wire) on the card gives the CPU's bits for the same gradients,
  with the ``cast_scale`` launches the plan's casts make (2 for the flat
  plan: in, and back with the mean);
* ``create_communicator("auto", plan_table=...)`` runs: its pick's mean,
  bit-equal to the ``xla`` flavor with the bf16 wire, and the exchange
  plans on a ``[P, ...]`` buffer.

The worlds of every card run under ``multi_gpu_check.py --parts planner``.
"""

import importlib
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chainermn_tpu_torch import init_distributed
    init_distributed()
    return torch.device("cuda")


def _same(a, b):
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(view), b.view(view))


def _grads(dev):
    g = torch.Generator().manual_seed(0)
    return {"w": (torch.randn(1000, 257, generator=g) * 3).to(dev),
            "b": torch.randn(333, generator=g).to(dev),
            "h": torch.randn(64, generator=g).to(torch.bfloat16).to(dev)}


@pytest.mark.parametrize("name,casts", [
    ("flat_bfloat16", 2), ("two_dimensional_bfloat16", 2),
    ("f16_stage", 4)])
def test_wire_plans_card_equals_cpu(cuda, name, casts):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.planner import (
        Plan, Stage, candidate_plans, execute_plan)
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    comm = create_communicator("naive")
    zoo = {p.name: p for p in candidate_plans(comm.plan_topology())}
    zoo["f16_stage"] = Plan(name="f16_stage", packing="flat", stages=(
        Stage(op="all-reduce", scope="intra", wire_dtype="float16"),
        Stage(op="all-reduce", scope="inter", wire_dtype="float16")))
    plan = zoo[name]
    g = {k: v for k, v in _grads(cuda).items() if k != "h"}
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    got = execute_plan(plan, comm, g)
    torch.cuda.synchronize()
    assert cs.launch_counts()["cast_scale"] == casts
    want = execute_plan(plan, comm, {k: v.cpu() for k, v in g.items()})
    for k in g:
        assert _same(got[k], want[k]), k
    # the wire rounded: not the identity
    assert not torch.equal(got["w"], g["w"])


def test_auto_on_nccl_world_of_one(cuda):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.planner import (
        PlanTable, alltoall_plans, candidate_plans, execute_alltoall,
        size_bucket)
    comm = create_communicator("xla", allreduce_grad_dtype=torch.bfloat16)
    topo = comm.plan_topology()
    bf16 = next(p for p in candidate_plans(topo)
                if p.name == "flat_bfloat16")
    table = PlanTable()
    g = _grads(cuda)
    nbytes = sum(v.numel() * v.element_size() for v in g.values())
    table.put(topo, "float32", size_bucket(nbytes), bf16)
    auto = create_communicator("auto", plan_table=table.to_dict())
    assert auto._select(g).name == "flat_bfloat16"
    got, want = auto.allreduce_grad(g), comm.allreduce_grad(g)
    for k in g:
        assert _same(got[k], want[k]), k
    assert got["h"].dtype == torch.bfloat16
    buf = torch.randn(1, 7, 5, device=cuda)
    for plan in alltoall_plans(topo):
        out = execute_alltoall(plan, auto, buf)
        wire = plan.stages[0].wire_dtype
        ref = buf if wire is None else buf.to(torch.bfloat16).float()
        assert torch.equal(out, ref), plan.name
