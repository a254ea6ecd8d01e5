"""Observability on the card, held to the path without it.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
nothing else, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_observability_gpu.py

On an NCCL world of one card:

* ``execute_plan`` of bf16-wire plans with ``pobs=get_plan_obs(comm)``
  gives the bits of ``pobs=None`` and the same ``cast_scale`` launches,
  with one ``plan_stage_begin``/``_end`` pair a stage, in stage order and
  in time order (the hook synchronizes the stream before each stamp);
* the MNIST example on the float16 wire with ``--observability`` gives
  the parameters of the run without it, bit for bit, and 2 x iterations
  cast launches in both; its ``metrics.jsonl`` holds the float16
  ``allreduce_grad`` calls;
* a bucketed FSDP step with observability on gives the shards of the
  step without it, bit for bit, and one begin/end pair a bucket's gather
  and reduce-scatter a step, each end no earlier than its begin (the
  edges' CUDA events, read at the step's end).
"""

import importlib
import json
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
    yield torch.device("cuda")
    from chainermn_tpu_torch import observability as obs
    obs.disable()
    obs.reset_flight_recorder()
    obs.get_registry().reset()


def _same(a, b):
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(view), b.view(view))


def _plans():
    from chainermn_tpu_torch.planner import Plan, flavor_plan
    two_d = flavor_plan("two_dimensional")
    return [flavor_plan("xla", "bfloat16"),
            Plan(name="two_dimensional_bf16", packing="flat",
                 wire_dtype="bfloat16", stages=two_d.stages),
            flavor_plan("hierarchical")]


@pytest.mark.parametrize("idx", range(3))
def test_plan_spans_on_the_card(cuda, idx):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.planner import execute_plan
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    plan = _plans()[idx]
    comm = create_communicator("xla")
    g = torch.Generator().manual_seed(idx)
    grads = {"w": torch.randn(1000, 257, generator=g).to(cuda),
             "b": torch.randn(333, generator=g).to(cuda)}
    runs = {}
    for label in ("off", "on"):
        pobs = None
        if label == "on":
            obs.enable()
            pobs = obs.get_plan_obs(comm)
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        runs[label] = (execute_plan(plan, comm, grads, pobs=pobs),
                       cs.launch_counts()["cast_scale"])
    (off, c_off), (on, c_on) = runs["off"], runs["on"]
    assert c_on == c_off
    assert all(_same(on[k], off[k]) for k in grads)
    evs = [e for e in obs.get_flight_recorder().snapshot()
           if e["kind"].startswith("plan_stage_")]
    want = [(edge, i) for i in range(len(plan.stages))
            for edge in ("begin", "end")]
    assert [(e["kind"][len("plan_stage_"):], e["stage"]) for e in evs] == \
        want
    assert all(a["ts"] <= b["ts"] for a, b in zip(evs, evs[1:]))
    assert {e["link"] for e in evs} <= {"nvlink", "ib"}


def test_mnist_observability_on_the_card(cuda, tmp_path):
    from chainermn_tpu_torch.examples import train_mnist
    from chainermn_tpu_torch import observability as obs
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    flags = ["--epoch", "1", "--unit", "1000", "--batchsize", "100",
             "--communicator", "xla", "--allreduce-grad-dtype", "float16",
             "--double-buffering", "--prefetch", "0"]
    runs = {}
    for label, extra in (("off", []), ("on", ["--observability"])):
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        try:
            res = train_mnist.main(flags + extra + [
                "--out", str(tmp_path / label)])
            torch.cuda.synchronize()
        finally:
            obs.disable()
        runs[label] = (res, cs.launch_counts()["cast_scale"])
    (off, c_off), (on, c_on) = runs["off"], runs["on"]
    iters = on["log"][-1]["iteration"]
    assert c_on == c_off == 2 * iters
    for (k, a), b in zip(off["model"].state_dict().items(),
                         on["model"].state_dict().values()):
        assert _same(a, b), k
    recs = [json.loads(ln) for ln in open(tmp_path / "on" / "metrics.jsonl")]
    calls = [r for r in recs if r.get("name") == "comm_collective_bytes"
             and r["labels"].get("op") == "allreduce_grad"]
    assert calls and calls[0]["labels"]["dtype"] == "float16"


def test_fsdp_observability_on_the_card(cuda):
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.benchmarks.bench_fsdp_overlap import tanh_mlp
    from chainermn_tpu_torch.parallel.fsdp import (fsdp_init,
                                                   make_fsdp_train_step)
    comm = create_communicator("xla")
    g = torch.Generator().manual_seed(0)
    xs, ys = (torch.randn(32, 256, generator=g).to(cuda) for _ in range(2))
    steps, shards = 3, {}
    for label in ("off", "on"):
        if label == "on":
            obs.enable()
            obs.install_flight_recorder()
        model = tanh_mlp(4, 256, 0, cuda)
        state, meta = fsdp_init(comm, model, torch.optim.Adam(
            model.parameters(), lr=1e-3), num_buckets=2)
        step = make_fsdp_train_step(
            comm, lambda b: torch.mean((model(b[0]) - b[1]) ** 2), state,
            meta, prefetch=1)
        for _ in range(steps):
            step((xs, ys))
        shards[label] = [s.detach().clone() for s in state.flat_shards()]
    assert len(shards["on"]) == len(shards["off"])
    assert all(_same(a, b) for a, b in zip(shards["on"], shards["off"]))
    evs = [e for e in obs.get_flight_recorder().snapshot()
           if e["kind"].startswith("fsdp_")]
    for leg in ("gather", "scatter"):
        for k in range(meta.num_buckets):
            seq = [(e["kind"].rsplit("_", 1)[1], e["mono"]) for e in evs
                   if e["kind"].startswith(f"fsdp_{leg}_")
                   and e["bucket"] == k]
            assert [edge for edge, _ in seq] == ["begin", "end"] * steps
            assert all(b[1] <= e[1] for b, e in zip(seq[::2], seq[1::2]))
            assert obs.get_registry().histogram(
                "fsdp_overlap_seconds").count(
                    leg=leg, bucket=str(k)) == steps
