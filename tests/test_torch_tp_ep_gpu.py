"""Tensor and expert parallelism on the card.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
``chip_smoke.py`` only, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_tp_ep_gpu.py

* the MoE LM (float32, TF32 off, 2 layers of d 256, T 512): one loss and
  gradient on the card (the flash kernels) against the CPU (their plain
  versions), the card's routing replayed (``chip_smoke.moe_card_vs_cpu``):
  loss within 1e-4, gradients within 1e-3 relative L2, every routing
  decision the CPU's own, each flash kernel once a layer;
* a tensor-parallel shard (``tp_size`` 2, no communicator: one rank's
  partial sums) through the flash kernels on the card against the CPU, in
  float32: logits and every gradient within 1e-4 relative L2;
* the flash forward at a tensor-parallel rank's serving shapes (8 and 4
  heads, bf16 and float32) against its plain version
  (``chip_smoke.serving_case``);
* the tensor- and expert-parallel exchanges on an NCCL world of one card
  and of every card (one process a card; skips with fewer than two):
  Column/Row-parallel layers, ``moe_apply``'s all-to-alls with several
  experts a rank, and an engine at ``tp_size`` = the world (dense LM)
  and ``ep_size`` = the world (MoE LM), each against the same on one rank.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

SMALL = dict(vocab=512, d_model=256, n_layers=2, n_heads=4, max_len=512)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_moe_lm_on_the_card_equals_the_cpu(cuda):
    res = chip_smoke.moe_card_vs_cpu(torch, cuda, SMALL, SMALL["max_len"])
    assert res["loss_rel"] <= 1e-4 and res["grad_rel"] <= 1e-3, res
    assert res["flips"] == 0, res
    assert res["counts"] == {w: SMALL["n_layers"] for w in res["counts"]}


def test_tp_shard_on_the_card_equals_the_cpu(cuda):
    import importlib
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.utils.compare import no_tf32, rel_l2
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    toks = torch.randint(0, SMALL["vocab"], (2, 256),
                         generator=torch.Generator().manual_seed(3))
    runs, state = [], None
    with no_tf32():
        for d in (cuda, torch.device("cpu")):
            m = TransformerLM(**SMALL, attention_impl="flash", tp_size=2,
                              device=d, generator=torch.Generator(d)
                              .manual_seed(4))
            state = state or {k: v.detach().cpu() for k, v in
                              m.state_dict().items()}
            m.load_state_dict(state)
            fa.reset_launch_counts()
            logits = m(toks.to(d))
            logits.square().mean().backward()
            runs.append((logits.detach().cpu(), {
                k: p.grad.cpu() for k, p in m.named_parameters()},
                fa.launch_counts()))
    (lk, gk, ck), (lp, gp, cp) = runs
    assert rel_l2(lk, lp) <= 1e-4
    assert max(rel_l2(gk[k], gp[k]) for k in gp) <= 1e-4
    assert ck == {w: SMALL["n_layers"] for w in ck}
    assert not any(cp.values())


@pytest.mark.parametrize("h", chip_smoke.P27_TP_HEADS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_at_a_tp_rank_serving_shape(cuda, h, dtype):
    import importlib
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    kv = importlib.import_module("chainermn_tpu_torch.serving.kv_cache")
    for tq in (chip_smoke.SERVE_SHAPE[1], 5):
        err = chip_smoke.serving_case(fa, kv, torch, cuda,
                                      getattr(torch, dtype), tq, h, h=h)
        assert err[1] <= chip_smoke.FLASH_TOL[dtype], (tq, err)


def check_tp_ep(out_path=None):
    """Every exchange on this process's NCCL world (initialized from the
    environment if it is not yet); rank 0 writes a summary to
    ``out_path``."""
    import torch.nn.functional as F
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel import (
        ColumnParallelDense, RowParallelDense, moe_apply)
    from chainermn_tpu_torch.serving import InferenceEngine, ServingConfig
    comm = create_communicator("naive")
    assert dist.get_backend() == "nccl"
    n, r, dev = comm.size, comm.rank, comm.device
    gen = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn(32, 16 * n, generator=gen), torch.randn(
        16 * n, 32, generator=gen)
    x = torch.randn(8, 32, generator=gen)
    sl = slice(r * 16, (r + 1) * 16)
    col = ColumnParallelDense(32, 16, comm, device=dev)
    gcol = ColumnParallelDense(32, 16, comm, gather_output=True, device=dev)
    row = RowParallelDense(16, 32, comm, device=dev)
    with torch.no_grad():
        for c in (col, gcol):
            c.weight.copy_(w1[:, sl].T)
            c.bias.zero_()
        row.weight.copy_(w2[sl].T)
        row.bias.zero_()
    with torch.no_grad():
        full = F.gelu(x @ w1, approximate="tanh") @ w2
        got = row(F.gelu(col(x.to(dev)), approximate="tanh")).cpu()
        torch.testing.assert_close(got, full, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(gcol(x.to(dev)).cpu(), x @ w1,
                                   rtol=1e-4, atol=1e-4)
    # moe_apply: 4 experts a rank; every rank routes the same tokens, so
    # the output is the world-of-one output
    e = 4 * n
    xs = torch.randn(64, 32, generator=gen)
    logits = torch.randn(64, e, generator=gen)
    scale = torch.randn(e, 32, generator=gen)
    mine = scale[r * 4:(r + 1) * 4].to(dev)
    y = moe_apply(lambda t: t * mine[:, None, :], logits.to(dev),
                  xs.to(dev), comm, top_k=2).cpu()
    one = moe_apply(lambda t: t * scale[:, None, :], logits, xs, top_k=2)
    torch.testing.assert_close(y, one, rtol=1e-5, atol=1e-5)
    # engines over the whole world: tp_size n (dense), ep_size n (MoE)
    prompts = [[3, 5, 7, 11], [2, 4], [9, 8, 7, 6, 5]]
    base = dict(page_size=4, num_pages=32, max_seqs=2, chunk_tokens=4,
                max_pages_per_seq=8)
    out = {}
    for label, cfg, par in (
            ("tp", dict(n_heads=2 * n, n_kv_heads=n), dict(tp_size=n)),
            ("ep", dict(n_heads=2, moe_experts=2 * n, moe_top_k=2),
             dict(ep_size=n))):
        model = TransformerLM(64, 32 * n, 2, max_len=64, device=dev,
                              generator=torch.Generator(dev).manual_seed(1),
                              **cfg)
        comm.bcast_data(model)
        toks = {}
        for world, kw in (("one", {}), ("all", par)):
            eng = InferenceEngine(model, ServingConfig(**base, **kw),
                                  comm=comm if kw else None,
                                  plane=comm if kw else None)
            if r == 0 or not kw:
                for p in prompts:
                    eng.submit(p, 5)
            while not comm.bcast_obj(eng.idle(), root=0) if kw \
                    else not eng.idle():
                eng.step()
            toks[world] = sorted((c.rid, c.tokens) for c in eng.completions)
        assert toks["one"] == toks["all"], (label, toks)
        out[label] = toks["all"]
    every = comm.allgather_obj(out)
    assert all(o == every[0] for o in every)
    if r == 0 and out_path:
        with open(out_path, "w") as f:
            json.dump({"world": n, **out}, f)
    comm.barrier()


def test_tp_ep_world_of_one(cuda):
    created = not dist.is_initialized()
    try:
        check_tp_ep()
    finally:
        if created:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tp_ep_world_of_every_card(cuda, tmp_path):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("an NCCL world of several ranks needs two CUDA cards "
                    "(one a rank)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=REPO)
    out = tmp_path / "tp_ep.json"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
                                  f"{log[-4000:]}"
    assert json.loads(out.read_text())["world"] == n


if __name__ == "__main__":
    # one rank of test_tp_ep_world_of_every_card
    check_tp_ep(sys.argv[1])
    dist.destroy_process_group()
