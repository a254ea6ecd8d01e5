"""Gradient compression on the card.

Marked ``gpu`` (skips without a CUDA card); imports torch, numpy, the port
and nothing else, so that the machine with the card runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_compression_gpu.py

* the fp8 in-wire sum (``quantize.sum_wire``: float16 in rank order from
  +0, one rounding) and ``to_e4m3fn`` on the card give the CPU's bits;
* int8 and fp8 ``allreduce_grad`` (deterministic, 3 EF steps) on an NCCL
  world of one card and of every card (one process a card; skips with
  fewer than two) give, on every rank, the bits of the same protocol run
  on the CPU in one process (each rank's codes encoded, summed in wire
  arithmetic, decoded): the means, residuals, exponents and steps;
* a quantized FSDP bucket's step on the card against the CPU.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chainermn_tpu_torch.communicators import _packing  # noqa: E402
from chainermn_tpu_torch.compression import (  # noqa: E402
    Fp8Compressor, Int8Compressor)
from chainermn_tpu_torch.compression import quantize as q  # noqa: E402

pytestmark = pytest.mark.gpu

N = 300_007   # gradient elements a rank (not a multiple of the chunk)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.element_size() == 1:
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_e4m3_cast_and_sum_rule_on_the_card(cuda):
    f16 = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(
        torch.float16)
    f16 = f16[torch.isfinite(f16)]
    assert _same(q.to_e4m3fn(f16.to(cuda)), q.to_e4m3fn(f16))
    rng = np.random.RandomState(0)
    for w in (2, 4, 8):
        x = rng.randn(w, 50000) * 10.0 ** rng.uniform(-3, 2, (w, 50000))
        x = torch.from_numpy(np.clip(x, -448 / w, 448 / w).astype(
            np.float32))
        x[:, :100] = -0.0
        codes = q.to_e4m3fn(x)
        assert _same(q.sum_wire(codes.to(cuda), torch.float8_e4m3fn),
                     q.sum_wire(codes, torch.float8_e4m3fn))
        i8 = torch.from_numpy(rng.randint(-127 // w, 127 // w + 1,
                                          (w, 50000)).astype(np.int8))
        assert _same(q.sum_wire(i8.to(cuda), torch.int8),
                     q.sum_wire(i8, torch.int8))


def _grads(rank):
    rng = np.random.RandomState(100 + rank)
    return {"w": torch.from_numpy((rng.randn(N) * 10.0 ** rng.uniform(
        -4, -1, N)).astype(np.float32)),
        "b": torch.from_numpy(rng.randn(77).astype(np.float32))}


def _cpu_protocol(comp, world, steps):
    """The W-rank exchange in one process on the CPU: every rank's codes,
    their in-wire sum, each rank's decode.  ``{rank: [(mean, state)]}``."""
    grads = [_grads(r) for r in range(world)]
    bufs = [_packing.pack(g, comm_dtype=torch.float32)[0][0] for g in grads]
    states = [comp.init_state(N + 77) for _ in range(world)]
    out = {r: [] for r in range(world)}
    for _ in range(steps):
        enc = [comp.compress(b, s, rank=r, world_size=world)
               for r, (b, s) in enumerate(zip(bufs, states))]
        summed = q.sum_wire(torch.stack([c for c, _ in enc]),
                            comp.wire_dtype) if world > 1 else enc[0][0]
        for r, (_, s) in enumerate(enc):
            o, states[r] = comp.decompress(summed, s, world_size=world)
            # unpack's mean: a multiply by 1/world rounded to float32
            out[r].append((o[:N + 77] * torch.tensor(
                1.0 / world, dtype=torch.float32), states[r]))
    return out


def check_world(out_path=None):
    """This rank of an NCCL world: int8 and fp8 ``allreduce_grad`` for 3
    steps against the CPU protocol, bit for bit."""
    from chainermn_tpu_torch import create_communicator, init_distributed
    init_distributed()
    comm = create_communicator("flat")
    r, n = comm.rank, comm.size
    g = {k: v.to(comm.device) for k, v in _grads(r).items()}
    for comp in (Int8Compressor(stochastic=False),
                 Fp8Compressor(stochastic=False)):
        want = _cpu_protocol(comp, n, 3)[r]
        st = comm.init_compression_state(g, comp)
        for step in range(3):
            mean, st = comm.allreduce_grad(g, compressor=comp, state=st)
            flat = _packing.pack(mean, comm_dtype=torch.float32)[0][0]
            wm, ws = want[step]
            assert _same(flat, wm), (comp.name, step, r)
            for k in ("ef", "scale", "step"):
                assert _same(getattr(st, k), getattr(ws, k)), (
                    comp.name, step, k, r)
    if r == 0 and out_path:
        with open(out_path, "w") as f:
            f.write(str(n))
    comm.barrier()


def test_allreduce_grad_world_of_one(cuda):
    created = not dist.is_initialized()
    try:
        check_world()
    finally:
        if created:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_allreduce_grad_world_of_every_card(cuda, tmp_path):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("an NCCL world of several ranks needs two CUDA cards "
                    "(one a rank)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=REPO)
    out = tmp_path / "world.txt"
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
    assert int(out.read_text()) == n


def fsdp_int8_run(dev, out_path):
    """Six int8 FSDP steps (2 buckets, deterministic) of a tanh MLP on a
    world of one on ``dev``: the losses and the EF states, saved."""
    from chainermn_tpu_torch import create_communicator, init_distributed
    from chainermn_tpu_torch.benchmarks.bench_fsdp_overlap import tanh_mlp
    from chainermn_tpu_torch.parallel import fsdp_init, make_fsdp_train_step
    from chainermn_tpu_torch.utils.compare import no_tf32
    init_distributed(dev)
    comm = create_communicator("flat", device=dev)
    with no_tf32():
        model = tanh_mlp(4, 64, 0, comm.device)
        state, meta = fsdp_init(comm, model, torch.optim.SGD(
            model.parameters(), lr=0.1), num_buckets=2,
            bucket_compressors=Int8Compressor(stochastic=False,
                                              chunk_size=64))
        x = torch.linspace(-1, 1, 8 * 64).reshape(8, 64).to(comm.device)
        step = make_fsdp_train_step(
            comm, lambda b: torch.mean(model(b) ** 2), state, meta)
        losses = [float(step(x)) for _ in range(6)]
    torch.save({"losses": losses,
                "comp": [{k: getattr(c, k).cpu() for k in ("scale", "step")}
                         for c in state.comp]}, out_path)


def test_fsdp_int8_bucket_step_card_equals_cpu(cuda, tmp_path):
    """Six int8 FSDP steps of a tanh MLP on the card and, in a gloo
    process of its own, on the CPU: the losses within 1e-6 relative (the
    products' rounding), the exponents and steps equal."""
    created = not dist.is_initialized()
    try:
        fsdp_int8_run(None, tmp_path / "card.pt")
    finally:
        if created:
            dist.destroy_process_group()
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(WORLD_SIZE="1", RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=REPO)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--fsdp-cpu",
                    str(tmp_path / "cpu.pt")], env=env, check=True,
                   timeout=300)
    card, cpu = (torch.load(tmp_path / f) for f in ("card.pt", "cpu.pt"))
    for a, b in zip(card["losses"], cpu["losses"]):
        assert abs(a - b) <= 1e-6 * abs(b), (card["losses"], cpu["losses"])
    for a, b in zip(card["comp"], cpu["comp"]):
        assert torch.equal(a["scale"], b["scale"])
        assert torch.equal(a["step"], b["step"])


if __name__ == "__main__":
    if sys.argv[1] == "--fsdp-cpu":
        # the CPU side of test_fsdp_int8_bucket_step_card_equals_cpu
        fsdp_int8_run("cpu", sys.argv[2])
    else:
        # one rank of test_allreduce_grad_world_of_every_card
        check_world(sys.argv[1])
    dist.destroy_process_group()
