"""How often a ``torch.profiler`` capture loses kernels on the card.

The measurement behind :data:`..utils.trace.TRIES` and
:data:`..utils.trace.PAD_S`.  :func:`..utils.trace.device_time` sums the
kernels of one capture, and a capture can lose kernels at the edges of its
window (the trace module's docstring says how).  This script takes many
captures (:func:`..utils.trace.capture`) of the targets ``device_time``
times in the two benchmarks -- the bench's train step (ResNet-50, batch
256, :func:`.bench.build`, 3 calls a capture) and the probe's three
products at M = 802,816 (the CUDA kernels, 5 calls a capture) -- in
rounds: each round captures each target once with no host time at the
window's edges and once with ``PAD_S`` at each, in alternating order.
Before the rounds it runs the bench's step for ``--age`` seconds, so that
the process is as old as ``chip_smoke.py``'s at its probe and bench
phases.

For each capture it records whether it was complete
(:func:`..utils.trace.complete`), its device events, and the gap from the
host clock just before the first timed call to the first marker kernel's
start in the trace (microseconds; negative: the trace puts the kernel
before its launch).  Prints one JSON document with, per target and
padding, the captures, the incomplete ones, the event counts seen and the
gaps' range; ``--out`` also writes it with every capture's record.

    python -m chainermn_tpu_torch.benchmarks.bench_device_time --rounds 20
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

import torch

PROBE_M = 256 * 56 * 56   # the probe's default M
PROBE_BM = {"wgrad": 8192, "dgrad": 1024, "fwd1x1": 1024}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--age", type=float, default=120.0,
                   help="seconds of bench steps before the first round")
    p.add_argument("--out", default=None, help="also write the document "
                   "and every capture's record here")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (there is no CPU path)")
    return p.parse_args(argv)


def targets(dev):
    """``{name: (fn, args, calls a capture)}``: the bench's step and the
    probe's three kernel products."""
    from chainermn_tpu_torch.benchmarks import bench
    from chainermn_tpu_torch.benchmarks import bench_conv_probe as bcp
    from chainermn_tpu_torch.ops import probe_matmul as pm
    step, batch, _, _ = bench.build(dev)
    out = {"bench_step": (step, (batch,), bench.DEVICE_TIME_STEPS)}
    for name, (sa, sb, kern, _) in bcp.probe_cases(PROBE_M).items():
        a, b = bcp.operands(dev, sa, sb)
        out[f"probe_{name}"] = (getattr(pm, kern), (a, b, PROBE_BM[name]),
                                bcp.STEPS)
    return out


def _first_marker_us(path):
    """Start of the first marker kernel in the trace, in microseconds of
    the Unix epoch, or None when the capture lost it."""
    from chainermn_tpu_torch.utils import trace
    doc = trace._load(path)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    starts = [e["ts"] for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") == "kernel"
              and trace.MARKER in e.get("name", "")]
    return float(min(starts)) + base_us if starts else None


def one_capture(fn, args, steps, path, pad_s):
    """A capture of ``steps`` calls; returns its record."""
    from chainermn_tpu_torch.utils import trace
    calls = []

    def timed(*a):
        calls.append(time.time_ns() / 1e3)
        return fn(*a)

    events, out = trace.capture(timed, args, steps, path, pad_s=pad_s)
    trace.fence(out)
    marker = _first_marker_us(path)
    host = calls[steps]  # the first call after the profiler's warm-up step
    return {"pad_s": pad_s, "complete": trace.complete(events, steps),
            "events": len(events),
            "markers": sum(1 for n, _, _ in events if trace.MARKER in n),
            "gap_us": None if marker is None else marker - host}


def main(argv=None) -> dict:
    from chainermn_tpu_torch.parallel.topology import env_int, resolve_device
    from chainermn_tpu_torch.utils import trace
    args = parse_args(argv)
    dev = resolve_device(args.device, env_int("LOCAL_RANK") or 0)
    if dev.type != "cuda":
        raise RuntimeError("bench_device_time measures the profiler on the "
                           "card; there is no CPU path")
    t_start = time.perf_counter()
    jobs = targets(dev)
    step, step_args, _ = jobs["bench_step"]
    n, loss = 0, None
    while time.perf_counter() - t_start < args.age:
        loss = step(*step_args)
        n += 1
        if n % 20 == 0:
            trace.fence(loss)
    if loss is not None:
        trace.fence(loss)
    log(f"bench_device_time: {n} bench steps, process age "
        f"{time.perf_counter() - t_start:.1f} s")
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, trace.TRACE_NAME)
        for r in range(args.rounds):
            pads = (0.0, trace.PAD_S) if r % 2 == 0 else (trace.PAD_S, 0.0)
            for name, (fn, fargs, steps) in jobs.items():
                for pad in pads:
                    rec = one_capture(fn, fargs, steps, path, pad)
                    rec.update(target=name, round=r,
                               age_s=time.perf_counter() - t_start)
                    records.append(rec)
            log(f"bench_device_time: round {r}: " + json.dumps(
                [(x["target"], x["pad_s"], x["complete"], x["events"],
                  x["gap_us"]) for x in records[-2 * len(jobs):]]))
    summary = collections.defaultdict(lambda: {
        "captures": 0, "incomplete": 0, "events": set(), "gap_us": []})
    for rec in records:
        s = summary[f"{rec['target']} pad {rec['pad_s']}"]
        s["captures"] += 1
        s["incomplete"] += not rec["complete"]
        s["events"].add(rec["events"])
        if rec["gap_us"] is not None:
            s["gap_us"].append(rec["gap_us"])
    doc = {"suite": "device_time_captures",
           "device_kind": torch.cuda.get_device_name(dev),
           "torch": torch.__version__, "pad_s": trace.PAD_S,
           "age_s": [records[0]["age_s"], records[-1]["age_s"]]
           if records else None,
           "summary": {k: {"captures": v["captures"],
                           "incomplete": v["incomplete"],
                           "events": sorted(v["events"]),
                           "gap_us": [min(v["gap_us"]), max(v["gap_us"])]
                           if v["gap_us"] else None}
                       for k, v in summary.items()}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(doc, records=records), f, indent=1)
            f.write("\n")
    print(json.dumps(doc), flush=True)
    return doc


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
