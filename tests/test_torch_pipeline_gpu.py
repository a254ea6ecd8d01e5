"""Pipeline parallelism on the card.

Marked ``gpu`` (skips without a CUDA card); imports torch, the port and
``chip_smoke.py`` only, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_pipeline_gpu.py

* 1F1B against GPipe and against one sequential pass, through the flash
  kernels (float32, TF32 off, the LM's blocks at d 256, T 512, M 4) on a
  world of one, each flash kernel launched exactly as the schedule says
  (1F1B: the forward 2 L M times, dK/dV and dQ L M times; GPipe L M
  each): loss within 1e-4, gradients within 1e-3 relative L2;
* the same on an NCCL world of every card, one block a stage (one process
  a card; skips with fewer than two), every stage's gradients against the
  sequential pass its process runs over the whole model.
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

SMALL = dict(vocab=512, d_model=256, n_heads=4)
SEQ, M = 512, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def check_pipeline(blocks_per_stage=2, out_path=None):
    """This rank's stage: 1F1B and GPipe against the sequential pass over
    the whole model (built on every rank from the same seed)."""
    import importlib
    from chainermn_tpu_torch import create_communicator, init_distributed
    from chainermn_tpu_torch.utils.compare import (
        no_tf32, step_agrees, step_errors)
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    init_distributed()
    comm = create_communicator("flat")
    r, n, b = comm.rank, comm.size, blocks_per_stage
    cfg = dict(SMALL, n_layers=b * n, max_len=SEQ)
    dev = comm.device
    res = {}
    with no_tf32():
        _, params, x, tgt, stage_fn, loss_fn = chip_smoke._p28_setup(
            torch, dev, torch.float32, cfg, "flash", SEQ, m=M,
            blocks=slice(r * b, (r + 1) * b))
        fa.reset_launch_counts()
        res["1f1b"] = chip_smoke._p28_1f1b(comm, stage_fn, loss_fn, params,
                                           x, tgt)
        counts_1f1b = fa.launch_counts()
        fa.reset_launch_counts()
        lg, gg = chip_smoke._p28_gpipe(comm, stage_fn, loss_fn, params, x,
                                       tgt)
        counts_gpipe = fa.launch_counts()
        res["gpipe"] = (lg, {k: v.clone() for k, v in gg.items()})
        _, fparams, fx, ftgt, fstage, floss = chip_smoke._p28_setup(
            torch, dev, torch.float32, cfg, "flash", SEQ, m=M)
        y = fstage(fparams, fx)
        ls = sum(floss(y[i:i + 1], ftgt[i:i + 1]) for i in range(M)) / M
        ls.backward()
    # this stage's blocks in the whole model's names
    want = {k: fparams[f"{r * b + int(k.split('.')[0])}."
                       f"{k.split('.', 1)[1]}"].grad for k in params}
    for name, (loss, grads) in res.items():
        lrel, grel, worst = step_errors([float(loss)], [float(ls)], grads,
                                        want)
        assert step_agrees(lrel, grel), (name, r, lrel, grel, worst)
    assert counts_1f1b == {"flash_fwd": 2 * b * M, "flash_bwd_dkv": b * M,
                           "flash_bwd_dq": b * M}, counts_1f1b
    assert counts_gpipe == {w: b * M for w in counts_gpipe}, counts_gpipe
    if r == 0 and out_path:
        with open(out_path, "w") as f:
            json.dump({"world": n}, f)
    comm.barrier()


def test_1f1b_gpipe_and_sequential_world_of_one(cuda):
    created = not dist.is_initialized()
    try:
        check_pipeline()
    finally:
        if created:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pipeline_world_of_every_card(cuda, tmp_path):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("an NCCL world of several ranks needs two CUDA cards "
                    "(one a rank)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=REPO)
    out = tmp_path / "pp.json"
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
    # one rank of test_pipeline_world_of_every_card: one block a stage
    check_pipeline(1, sys.argv[1])
    dist.destroy_process_group()
