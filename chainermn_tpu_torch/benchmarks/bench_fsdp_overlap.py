"""Bucketed-FSDP overlap sweep: bucket count x prefetch depth.

Counterpart of ``benchmarks/bench_fsdp_overlap.py``: sweeps
``fsdp_init(num_buckets=K)`` x ``make_fsdp_train_step(prefetch=D)`` over a
tanh MLP (``--layers`` layers of ``--width`` x ``--width`` and a bias,
float32, Adam at 1e-3), on every rank of the world (one GPU each under
``torchrun``; a world of one without it), and for every configuration
(a) times the step and (b) checks the schedule.

The JAX benchmark checks the schedule by counting collectives in the
compiled HLO; PyTorch has no compiled program to read, so the step's own
counters take its place (``step.stats``, the last timed step's): K
all-gathers and K reduce-scatters per dtype buffer a step, at most D + 1
gathers issued and not yet consumed (``max_in_flight``, which is exactly
``min(D + 1, K)``), and with ``--wire-dtype`` four wire casts per float
buffer per bucket (``casts``), each a ``cast_scale`` kernel launch on the
card (``cast_scale_launches``, counted by the kernel's wrapper over the
timed steps).  ``--no-assert`` reports them without asserting.

Times: ``step_ms`` is the mean over ``--iters`` steps after ``--warmup``,
between two CUDA events on the card (``event_ms``: the stream's elapsed
time, the host not waiting between steps, so a step whose launches take
longer than its kernels shows the host's time) or on the host's clock on
the CPU (``host_ms``); gloo finishes each collective before the next is
issued, so CPU times cannot show overlap.  ``--metrics PATH`` appends one
record a config (``kind`` ``bench_fsdp_overlap``, with the common
envelope) to a metrics JSONL on rank 0, as JAX's does.

    python -m chainermn_tpu_torch.benchmarks.bench_fsdp_overlap \\
        --buckets 1,2,4 --prefetch 0,1
    torchrun --nproc_per_node 4 -m \\
        chainermn_tpu_torch.benchmarks.bench_fsdp_overlap --json
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import numpy as np
import torch
from torch import nn

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.parallel import buckets as bucket_mod
from chainermn_tpu_torch.parallel.fsdp import (
    fsdp_init, make_fsdp_train_step)


# the module, not the function the ops package re-exports
cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")


class TanhLayer(nn.Module):
    """``tanh(x @ w + b)``."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(w.shape[1], device=w.device))

    def forward(self, x):
        return torch.tanh(x @ self.w + self.b)


def tanh_mlp(layers: int, width: int, seed: int, device) -> nn.Sequential:
    """The JAX benchmark's model: ``layers`` tanh layers, weights
    ``randn / sqrt(width)`` from ``RandomState(seed)``, biases 0."""
    rng = np.random.RandomState(seed)
    return nn.Sequential(*[TanhLayer(torch.tensor(
        rng.randn(width, width) / np.sqrt(width), dtype=torch.float32,
        device=device)) for _ in range(layers)])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--buckets", default="1,2,4",
                   help="comma-separated num_buckets sweep")
    p.add_argument("--prefetch", default="0,1",
                   help="comma-separated prefetch-depth sweep")
    p.add_argument("--layers", type=int, default=8,
                   help="MLP depth (one weight and bias per layer)")
    p.add_argument("--width", type=int, default=256,
                   help="MLP width (payload scales with width^2)")
    p.add_argument("--batch", type=int, default=4,
                   help="per-rank batch size")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--wire-dtype", default=None,
                   help="wire dtype for both collective legs")
    p.add_argument("--no-assert", action="store_true",
                   help="report the schedule counters without asserting "
                        "them (debugging a changed partitioner)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line per config")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append one record per config to this metrics "
                        "JSONL (rank 0)")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    return p.parse_args(argv)


def expected(meta, prefetch: int, wire) -> dict:
    """The counters one step must show: per dtype buffer of every bucket
    one gather and one reduce-scatter; ``min(D + 1, K)`` gathers in
    flight at most; four wire casts per float buffer."""
    bufs = [k for bl in meta.buckets for k in bl.pack_meta[1]]
    floats = sum(1 for k in bufs if getattr(torch, k).is_floating_point
                 and wire is not None and getattr(torch, k) != wire)
    return {"gathers": len(bufs), "reduce_scatters": len(bufs),
            "max_in_flight": min(prefetch + 1, meta.num_buckets),
            "casts": 4 * floats}


def main(argv=None) -> list:
    args = parse_args(argv)
    comm = create_communicator("xla", device=args.device)
    dev = comm.device
    cuda = dev.type == "cuda"
    wire = getattr(torch, args.wire_dtype) if args.wire_dtype else None
    g = torch.Generator().manual_seed(1000 + comm.rank)
    xs = torch.randn(args.batch, args.width, generator=g).to(dev)
    ys = torch.randn(args.batch, args.width, generator=g).to(dev)
    rows = []
    for k in [int(b) for b in args.buckets.split(",")]:
        for d in [int(p) for p in args.prefetch.split(",")]:
            model = tanh_mlp(args.layers, args.width, 0, dev)
            payload = sum(p.numel() * p.element_size()
                          for p in model.parameters())
            desc = bucket_mod.describe_buckets(bucket_mod.partition_buckets(
                list(model.parameters()), num_buckets=k))
            state, meta = fsdp_init(comm, model, torch.optim.Adam(
                model.parameters(), lr=1e-3), num_buckets=k)
            step = make_fsdp_train_step(
                comm, lambda b: torch.mean((model(b[0]) - b[1]) ** 2),
                state, meta, wire_dtype=wire, prefetch=d)
            for _ in range(args.warmup):
                loss = step((xs, ys))
            float(loss)
            cs.reset_launch_counts()
            if cuda:
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
            else:
                h0 = time.perf_counter()
            for _ in range(args.iters):
                loss = step((xs, ys))
            if cuda:
                t1.record()
                t1.synchronize()
                ms = t0.elapsed_time(t1) / args.iters
            else:
                float(loss)
                ms = (time.perf_counter() - h0) * 1e3 / args.iters
            stats = step.stats
            want = expected(meta, d, wire)
            launches = cs.launch_counts()["cast_scale"]
            ok = ({key: stats[key] for key in want} == want
                  and (not cuda or launches == want["casts"] * args.iters))
            if not args.no_assert:
                assert ok, (f"schedule counters at num_buckets={k} "
                            f"prefetch={d}: {stats}, cast_scale launches "
                            f"{launches} over {args.iters} steps (expected "
                            f"{want} a step)")
            row = {"num_buckets": meta.num_buckets, "prefetch": d,
                   "devices": comm.size,
                   "payload_mib": round(payload / (1 << 20), 3),
                   "step_ms": ms, "timer": "event_ms" if cuda
                   else "host_ms",
                   "all_gathers": stats["gathers"],
                   "reduce_scatters": stats["reduce_scatters"],
                   "max_in_flight": stats["max_in_flight"],
                   "casts": stats["casts"],
                   "cast_scale_launches": launches,
                   "wire_dtype": args.wire_dtype,
                   "schedule_ok": ok, "final_loss": float(loss),
                   "bucket_balance": round(desc["max_over_mean"], 3),
                   "backend": "cuda" if cuda else "cpu"}
            rows.append(row)
            if comm.rank == 0:
                if args.metrics:
                    from chainermn_tpu_torch.observability.sinks import (
                        append_metrics)
                    append_metrics(args.metrics, row, "bench_fsdp_overlap")
                if args.json:
                    print(json.dumps(row), flush=True)
                else:
                    print(f"K={meta.num_buckets} D={d}: {ms:.3f} ms, "
                          f"{stats['gathers']} gathers / "
                          f"{stats['reduce_scatters']} scatters / "
                          f"{stats['max_in_flight']} in flight / "
                          f"{stats['casts']} casts "
                          f"({'ok' if ok else 'MISMATCH'})", file=sys.stderr)
            del step, state, model
    if not cuda and comm.rank == 0:
        print("note: gloo executes collectives one at a time -- CPU times "
              "validate the harness only; measure overlap on the cards",
              file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
