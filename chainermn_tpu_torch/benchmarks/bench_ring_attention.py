"""Sequence-parallel attention microbenchmark.

Counterpart of ``benchmarks/bench_ring_attention.py``: times ring and
Ulysses attention on a sequence sharded over the ranks of the world (one
GPU each under ``torchrun``; a ring of one rank without it) beside the
single-shard baselines, at each sequence length: the forward pass, causal,
``--iters`` calls after ``--warmup``, host clock around calls that end in a
device synchronise.  Rows (one JSON object each with ``--json``):

* ``ring``: :func:`~chainermn_tpu_torch.parallel.ring_attention`, plain
  online softmax;
* ``ring_flash``: the same with the CUDA flash kernels per block (not in
  the JAX benchmark; it is the long-context example's fused path);
* ``ulysses``: :func:`~chainermn_tpu_torch.parallel.ulysses_attention`;
* ``single_device``: the plain attention over the whole sequence, on each
  rank;
* ``single_device_flash``: ``flash_attention`` over the whole sequence.

``tokens_per_sec`` counts the whole sequence (``batch * seq_len``) a call.
bf16 on the card, float32 on the CPU.  A row that runs out of device
memory records ``"error": "OutOfMemoryError"``, as the JAX benchmark
records its failures; any other failure raises.

    python -m chainermn_tpu_torch.benchmarks.bench_ring_attention \\
        --seq-lens 2048,8192 --json
    torchrun --nproc_per_node 4 -m \\
        chainermn_tpu_torch.benchmarks.bench_ring_attention --json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.parallel.sequence import (
    attention, ring_attention, ulysses_attention)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seq-lens", default="1024,4096",
                   help="comma-separated global sequence lengths")
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    return p.parse_args(argv)


def _impls(comm):
    return {
        "ring": lambda q, k, v: ring_attention(q, k, v, comm, causal=True),
        "ring_flash": lambda q, k, v: ring_attention(
            q, k, v, comm, causal=True, attn_fn=flash_attention),
        "ulysses": lambda q, k, v: ulysses_attention(q, k, v, comm,
                                                     causal=True),
        "single_device": lambda q, k, v: attention(q, k, v, causal=True),
        "single_device_flash": lambda q, k, v: flash_attention(q, k, v,
                                                               True),
    }


def _time(fn, args, iters, warmup, sync):
    out = fn(*args)
    for _ in range(warmup):
        out = fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync()
    del out
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> list:
    """Run the rows; returns them (rank 0 prints them)."""
    args = parse_args(argv)
    created = not dist.is_initialized()
    comm = create_communicator("xla", device=args.device)
    try:
        return _run(args, comm)
    finally:
        if created:
            dist.destroy_process_group()


def _run(args, comm) -> list:
    dev = comm.device
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    n, me = comm.size, comm.rank

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)
        comm.allreduce(torch.zeros(1, device=dev))  # ranks end together

    results = []
    for t in (int(s) for s in args.seq_lens.split(",")):
        if t % n:
            raise ValueError(f"--seq-lens: {t} is not divisible by the "
                             f"{n} ranks")
        rng = np.random.RandomState(0)
        full = [torch.from_numpy(
            rng.randn(args.batch, t, args.heads, args.head_dim)
            .astype(np.float32) * 0.3).to(dev, dtype) for _ in range(3)]
        blk = [x[:, me * (t // n):(me + 1) * (t // n)].contiguous()
               for x in full]
        with torch.no_grad():
            for name, fn in _impls(comm).items():
                inputs = full if name.startswith("single") else blk
                row = {"impl": name, "seq_len": t, "devices": n}
                try:
                    dt = _time(fn, inputs, args.iters, args.warmup, sync)
                    row.update(time_ms=round(dt * 1e3, 3),
                               tokens_per_sec=round(args.batch * t / dt, 1))
                except torch.cuda.OutOfMemoryError as e:
                    row["error"] = type(e).__name__
                    torch.cuda.empty_cache()
                results.append(row)
                if me == 0:
                    print(json.dumps(row) if args.json else row,
                          file=sys.stdout if args.json else sys.stderr,
                          flush=True)
    return results


if __name__ == "__main__":
    main()
