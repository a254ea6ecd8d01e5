"""Gradient-compression sweep: compressor x bucket count.

Counterpart of ``benchmarks/bench_compression.py``: sweeps
``fsdp_init(bucket_compressors=...)`` (``--compressors``: ``none``,
``none:<dtype>``, ``int8``, ``fp8``) x ``num_buckets`` (``--buckets``) over
the tanh MLP of :mod:`.bench_fsdp_overlap` (Adam at 1e-3), on every rank
of the world (one GPU each under ``torchrun``; a world of one without
it), and for every configuration (a) times the step and (b) checks the
wire.

The JAX benchmark reads the wire from the compiled HLO (collective counts
and the reduce-scatters' operand bytes); here the step's own counters
(``step.stats`` of the last timed step) count the bytes this rank hands
to each collective: the schedule must hold exactly K all-gathers and K
reduce-scatters, as the uncompressed one of the same K does (compression
adds no collective: the exponents ride the gather, the saturation flags
the scatter), and the reduce-scatters' bytes (``rs_wire_bytes``) must
shrink against the float32 ``none`` row by at least ``--min-ratio``
(3.5x for int8: the flag slot after each destination's slice costs the
rest).  ``--no-assert`` reports without asserting.

Times as in :mod:`.bench_fsdp_overlap` (CUDA events on the card, the
host's clock on the CPU, where gloo runs the collectives one at a time and
the times only validate the harness).  ``--metrics PATH`` appends one
record a config (``kind`` ``bench_compression``, with the common envelope)
to a metrics JSONL on rank 0, as JAX's does.

    python -m chainermn_tpu_torch.benchmarks.bench_compression --buckets 1,4
    torchrun --nproc_per_node 4 -m \\
        chainermn_tpu_torch.benchmarks.bench_compression --json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from chainermn_tpu_torch.benchmarks.bench_fsdp_overlap import tanh_mlp
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.compression import NoCompression
from chainermn_tpu_torch.parallel.fsdp import (
    fsdp_init, make_fsdp_train_step)

COMPRESSORS = ["none", "none:bfloat16", "int8", "fp8"]


def bucket_compressors(label: str):
    """``--compressors`` entry -> ``fsdp_init``'s ``bucket_compressors``."""
    if label == "none":
        return None
    if label.startswith("none:"):
        return NoCompression(wire_dtype=label.split(":", 1)[1])
    return label  # a registry name (int8 / fp8)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--compressors", default=",".join(COMPRESSORS),
                   help="comma-separated sweep: none, none:<dtype>, int8, "
                        "fp8")
    p.add_argument("--buckets", default="1,4",
                   help="comma-separated num_buckets sweep")
    p.add_argument("--prefetch", type=int, default=0,
                   help="prefetch depth of every configuration")
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--batch", type=int, default=4,
                   help="per-rank batch size")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--min-ratio", type=float, default=3.5,
                   help="required int8-vs-f32 reduce-scatter wire shrink "
                        "factor")
    p.add_argument("--no-assert", action="store_true",
                   help="report the census without asserting it")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line per config")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append one record per config to this metrics "
                        "JSONL (rank 0)")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    p.add_argument("--planner-census", action="store_true",
                   help="also print the per-hop plans' modeled wire bytes "
                        "per hop for the model's packed gradients")
    return p.parse_args(argv)


def planner_census(topology, nbytes: int) -> list:
    """The per-hop compressed plans (int8 / fp8 on the inter-node hop of
    the two-dimensional chain) beside the flat float32 and bfloat16 plans:
    each one's wire dtype and modeled bytes per hop for ``nbytes`` of
    float32 gradients on ``topology`` (``planner.plan_wire_dtypes``,
    ``plan_wire_bytes``, ``plan_dcn_bytes``)."""
    from chainermn_tpu_torch.planner import (
        compressed_two_dimensional, flavor_plan, plan_census_kinds,
        plan_dcn_bytes, plan_wire_bytes, plan_wire_dtypes)
    plans = [flavor_plan("flat"), flavor_plan("xla", "bfloat16"),
             flavor_plan("two_dimensional")]
    if topology.inter_size > 1:
        plans += [compressed_two_dimensional(
            {"name": c, "stochastic": False}) for c in ("int8", "fp8")]
    return [{"plan": p.name, "topology": topology.key(), "bytes": nbytes,
             "kinds": list(plan_census_kinds(p, topology)),
             "wire_dtypes": list(plan_wire_dtypes(p, topology)),
             "wire_bytes": plan_wire_bytes(p, topology, nbytes),
             "dcn_bytes": plan_dcn_bytes(p, topology, nbytes)}
            for p in plans]


def main(argv=None) -> list:
    args = parse_args(argv)
    comm = create_communicator("xla", device=args.device)
    dev = comm.device
    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(1000 + comm.rank)
    xs = torch.randn(args.batch, args.width, generator=g).to(dev)
    ys = torch.randn(args.batch, args.width, generator=g).to(dev)
    labels = [c.strip() for c in args.compressors.split(",") if c.strip()]
    rows = []
    for k in [int(b) for b in args.buckets.split(",")]:
        base = None  # the float32 census this K is held to
        for label in labels:
            model = tanh_mlp(args.layers, args.width, 0, dev)
            payload = sum(p.numel() * p.element_size()
                          for p in model.parameters())
            state, meta = fsdp_init(
                comm, model, torch.optim.Adam(model.parameters(), lr=1e-3),
                num_buckets=k, bucket_compressors=bucket_compressors(label))
            step = make_fsdp_train_step(
                comm, lambda b: torch.mean((model(b[0]) - b[1]) ** 2),
                state, meta, prefetch=args.prefetch)
            for _ in range(args.warmup):
                loss = step((xs, ys))
            float(loss)
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
            st = step.stats
            if label == "none":
                base = dict(st)
            ratio = (base["scatter_bytes"] / st["scatter_bytes"]
                     if base and st["scatter_bytes"] else None)
            ok = (st["gathers"] == meta.num_buckets
                  and st["reduce_scatters"] == meta.num_buckets)
            if base is not None:
                # compression must not change the collective schedule
                ok = ok and (st["gathers"] == base["gathers"] and
                             st["reduce_scatters"] == base["reduce_scatters"])
            if label == "int8" and ratio is not None:
                ok = ok and ratio >= args.min_ratio
            if not args.no_assert:
                assert ok, (
                    f"wire census mismatch at compressor={label} "
                    f"num_buckets={k}: {st} ratio={ratio} (expected "
                    f"{meta.num_buckets} gathers/scatters, int8 ratio >= "
                    f"{args.min_ratio}, schedule identical to uncompressed "
                    f"{base})")
            row = {"compressor": label, "num_buckets": meta.num_buckets,
                   "prefetch": args.prefetch, "devices": comm.size,
                   "payload_mib": round(payload / (1 << 20), 3),
                   "step_ms": ms,
                   "timer": "event_ms" if cuda else "host_ms",
                   "all_gathers": st["gathers"],
                   "reduce_scatters": st["reduce_scatters"],
                   "ag_wire_bytes": st["gather_bytes"] * comm.size,
                   "rs_wire_bytes": st["scatter_bytes"] * comm.size,
                   "wire_ratio_vs_f32": ratio,
                   "census_ok": ok, "final_loss": float(loss),
                   "backend": "cuda" if cuda else "cpu"}
            rows.append(row)
            if comm.rank == 0:
                if args.metrics:
                    from chainermn_tpu_torch.observability.sinks import (
                        append_metrics)
                    append_metrics(args.metrics, row, "bench_compression")
                if args.json:
                    print(json.dumps(row), flush=True)
                else:
                    print(f"K={meta.num_buckets} {label}: {ms:.3f} ms, "
                          f"{st['gathers']}g/{st['reduce_scatters']}rs, "
                          f"scatter bytes {row['rs_wire_bytes']} ratio="
                          f"{ratio} ({'ok' if ok else 'MISMATCH'})",
                          file=sys.stderr)
            del step, state, model
    if args.planner_census:
        payload = sum(p.numel() * 4 for p in tanh_mlp(
            args.layers, args.width, 0, dev).parameters())
        for row in planner_census(comm.plan_topology(), payload):
            rows.append(dict(row, kind="planner_census"))
            if comm.rank == 0:
                print(json.dumps(row) if args.json else
                      f"plan {row['plan']}: wire {row['wire_dtypes']}, "
                      f"bytes by hop {row['wire_bytes']}", file=sys.stderr
                      if not args.json else sys.stdout, flush=True)
    if not cuda and comm.rank == 0:
        print("note: gloo runs collectives one at a time -- CPU times "
              "validate the harness only; measure bandwidth on the cards",
              file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
