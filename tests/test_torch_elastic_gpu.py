"""The elastic runtime on the card.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
nothing else, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_elastic_gpu.py

On an NCCL world of one card:

* the async backend's snapshot of a CUDA state (copied into pinned host
  memory on the current stream) writes the synchronous backend's file
  bits;
* a save followed by in-place Adam steps on the card still writes the
  save's step (the persist thread writes after the steps);
* ``resume_resized`` brings a 2-rank gloo world's FSDP generation (two
  buckets, Adam) onto the card: the consolidated parameters and moments
  are the saved ones, bit for bit, and a step runs.
"""

import os
import sys
import threading

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chainermn_tpu_torch import create_communicator, init_distributed
    init_distributed()
    return create_communicator("naive")


def _cuda_state(seed):
    from test_torch_elastic import _state
    return {k: v.cuda() if torch.is_tensor(v) else v
            for k, v in _state(seed).items()}


def test_async_snapshot_of_a_cuda_state_is_the_sync_file(cuda, tmp_path):
    from test_torch_elastic import _members

    from chainermn_tpu_torch.extensions.checkpoint import \
        create_multi_node_checkpointer
    sync = create_multi_node_checkpointer(cuda, str(tmp_path / "s"), "c",
                                          keep=0)
    asy = create_multi_node_checkpointer(cuda, str(tmp_path / "a"), "c",
                                         keep=0, backend="async")
    for g in range(3):
        st = _cuda_state(g)
        sync.save(st, g)
        asy.save(st, g)
    assert asy.drain(timeout=60)
    for g in range(3):
        assert _members(sync._file(g)) == _members(asy._inner._file(g))
    restored, gen = asy.resume(_cuda_state(0))
    assert gen == 2 and restored["w"].is_cuda
    assert torch.equal(restored["w"], _cuda_state(2)["w"])
    asy.finalize()


def test_save_then_step_in_place_on_the_card(cuda, tmp_path, monkeypatch):
    from chainermn_tpu_torch.extensions.checkpoint import \
        create_multi_node_checkpointer
    from chainermn_tpu_torch.optim import (init_optimizer_state,
                                           optimizer_state_tree)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    model = torch.nn.Linear(1024, 1024, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    x = torch.randn(256, 1024, device=dev, generator=g)

    def step():
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()

    def state():
        return {"model": dict(model.state_dict()),
                "opt": optimizer_state_tree(opt)}

    step()
    asy = create_multi_node_checkpointer(cuda, str(tmp_path), "al", keep=0,
                                         backend="async")
    gate = threading.Event()
    real = asy._inner._persist
    monkeypatch.setattr(asy._inner, "_persist",
                        lambda a, it: (gate.wait(60), real(a, it)))
    want = {k: v.detach().cpu().clone() for k, v in model.state_dict()
            .items()}
    want_opt = {i: {k: v.detach().cpu().clone() for k, v in st.items()}
                for i, st in optimizer_state_tree(opt).items()}
    asy.save(state(), 1)
    for _ in range(3):   # queued right behind the snapshot's copies
        step()
    torch.cuda.synchronize()
    assert not torch.equal(model.weight.cpu(), want["weight"])
    gate.set()
    assert asy.drain(timeout=60)
    init_optimizer_state(opt)
    restored, gen = asy.resume(state())
    assert gen == 1
    for k, v in want.items():
        assert torch.equal(restored["model"][k].cpu(), v), k
    for i, st in want_opt.items():
        for k, v in st.items():
            assert torch.equal(restored["opt"][i][k].cpu(), v), (i, k)
    asy.finalize()


def test_resume_resized_from_a_cpu_world_onto_the_card(cuda, tmp_path):
    import json

    import torch.nn.functional as F
    from test_torch_elastic import _WORKER, _consolidated

    from chainermn_tpu_torch.elastic import resume_resized
    from chainermn_tpu_torch.extensions.checkpoint import \
        create_multi_node_checkpointer
    from chainermn_tpu_torch.optim import init_optimizer_state
    from chainermn_tpu_torch.parallel.fsdp import (fsdp_init,
                                                   make_fsdp_train_step)
    from chainermn_tpu_torch.utils.proc_world import spawn_world
    saved, resumed = str(tmp_path / "a"), str(tmp_path / "r")
    spawn_world(_WORKER, n_procs=2, device="cpu", timeout=240,
                log_dir=str(tmp_path / "logs"),
                env={"RESIZE_RUNS": json.dumps([{
                    "name": "plain", "comp": None, "load": None, "gen": 5,
                    "steps": 2, "save": saved}])})
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4)).to(dev)
    state, meta = fsdp_init(cuda, model,
                            torch.optim.Adam(model.parameters(), lr=0.01),
                            num_buckets=2)
    init_optimizer_state(state.inner)
    src = create_multi_node_checkpointer(cuda, saved, "rs", keep=0)
    tree, gen, report = resume_resized(src, {"fsdp": state}, cuda)
    assert gen == 5 and report["from_world"] == 2 and report["to_world"] == 1
    assert all(s.is_cuda for s in state.flat_shards())
    create_multi_node_checkpointer(cuda, resumed, "rs", keep=0).save(
        {"fsdp": state}, 5)
    a, b = _consolidated(saved, 5, 2), _consolidated(resumed, 5, 1)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all(), k
    step = make_fsdp_train_step(
        cuda, lambda bt: F.mse_loss(model(bt[0]), bt[1]), state, meta)
    x = torch.randn(16, 8, device=dev)
    assert torch.isfinite(torch.as_tensor(step((x, x[:, :4]))))
