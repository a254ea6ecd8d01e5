"""Double-buffering split check -- one command.

Counterpart of the JAX package's ``tools/check_db_overlap.py``.  JAX's
claim is that XLA's combiner keeps the pending-gradient all-reduce and
the loss psum as two collectives, so the pending one is schedulable from
program start.  The port's form of the claim: in ``make_train_step``
under the double-buffered optimizer (``optimizers.
_DoubleBufferingOptimizer``), ``torch.profiler`` on the card shows each
step's pending-gradient all-reduce and the loss all-reduce as two
distinct NCCL kernels, and the pending one -- issued at update t with
``async_op=True`` and waited at update t+1 -- still runs while step t+1's
forward does.

The step's forward is bracketed by two marker kernels
(``torch.cuda._sleep``) on the compute stream; the NCCL all-reduce
kernels of ``--steps`` profiled steps are read from the Chrome trace with
their start and end times.  Verdicts:

* ``split`` -- two NCCL all-reduce kernels a step, and the pending
  all-reduce of step t overlaps the forward window of step t+1 on every
  step pair (exit 0);
* ``merged`` / ``serialized`` -- one kernel a step, or no overlap
  (exit 1);
* ``not judgeable`` -- a world of one (the plan executor issues no
  collective over one rank), as JAX's tool reports a single device
  (exit 0).

Run it on every rank of the world (rank 0 writes the document)::

    torchrun --standalone --nproc_per_node 4 -m \
        chainermn_tpu_torch.tools.check_db_overlap --out DB_OVERLAP.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional


def _kernels(trace_path: str) -> List[dict]:
    """Device kernels of a Chrome trace: ``{"name", "ts", "end", "tid"}``
    (microseconds), in start order."""
    with open(trace_path) as fh:
        doc = json.load(fh)
    out = [{"name": e["name"], "ts": float(e["ts"]),
            "end": float(e["ts"]) + float(e["dur"]),
            "tid": e.get("tid")}
           for e in doc.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") == "kernel"
           and "dur" in e]
    out.sort(key=lambda k: k["ts"])
    return out


def judge(kernels: List[dict], steps: int, world: int,
          marker: str = "spin_kernel") -> dict:
    """The verdict from a profiled window of ``steps`` steps: the NCCL
    all-reduce kernels, the forward windows (between each step's two
    marker kernels) and, per step pair, whether step t's pending
    all-reduce overlapped step t+1's forward."""
    marks = [k for k in kernels if marker in k["name"]]
    fwd = [(marks[2 * i]["end"], marks[2 * i + 1]["ts"])
           for i in range(len(marks) // 2)]
    ars = [k for k in kernels
           if "nccl" in k["name"].lower()
           and "allreduce" in k["name"].lower().replace("_", "")]
    doc = {"n_all_reduce": len(ars), "steps": steps, "world": world,
           "forward_windows_us": [[a, b] for a, b in fwd],
           "all_reduce_us": [[k["ts"], k["end"], k["tid"]] for k in ars],
           "all_reduce_names": sorted({k["name"] for k in ars})}
    if world < 2:
        doc["verdict"] = ("not judgeable: a world of one -- the plan "
                          "executor issues no collective over one rank; "
                          "run on >= 2 cards")
        doc["ok"] = True
        return doc
    if len(fwd) != steps:
        doc["verdict"] = (f"incomplete capture: {len(fwd)} forward "
                          f"windows of {steps} steps")
        doc["ok"] = False
        return doc
    per_step = len(ars) / steps
    # which all-reduce is the pending one: a blocking all-reduce may run on
    # the compute stream (the markers'), the pending one (async_op=True)
    # on NCCL's own; on one stream they alternate in issue order
    # (update t's pending, then step t's loss)
    compute = marks[0]["tid"] if marks else None
    side = [k for k in ars if k["tid"] != compute]
    pending = side if side and len(side) != len(ars) else ars[0::2]
    overlaps = []
    for t in range(min(steps - 1, len(pending))):
        pend = pending[t]
        nxt0, nxt1 = fwd[t + 1]
        overlaps.append(max(0.0, min(pend["end"], nxt1)
                            - max(pend["ts"], nxt0)))
    doc["pending_overlap_us"] = overlaps
    doc["all_reduce_per_step"] = per_step
    split = len(ars) == 2 * steps
    overlapped = bool(overlaps) and all(o is not None and o > 0.0
                                        for o in overlaps)
    if not split:
        doc["verdict"] = (f"merged: {len(ars)} NCCL all-reduce kernels in "
                          f"{steps} steps (2 a step expected: the pending "
                          "gradients and the loss)")
    elif not overlapped:
        doc["verdict"] = ("serialized: two all-reduces a step, but the "
                          "pending one did not run during the next "
                          "forward on every step pair")
    else:
        doc["verdict"] = ("split: pending-gradient all-reduce separate "
                          "from the loss all-reduce, and in flight across "
                          "the next forward")
    doc["ok"] = split and overlapped
    return doc


def run(steps: int = 4, n_units: int = 4096, batch: int = 4096,
        device: Optional[str] = None) -> dict:
    """Profile ``steps`` double-buffered MLP steps on this rank and judge
    them (:func:`judge`).  A collective: every rank of the world runs
    it.  The MLP's width sets the pending all-reduce's bytes (4096 units:
    20 M float32 gradients): it must outlast the host's gap between one
    step's update and the next forward's launch for the overlap to
    show."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import MLP
    from chainermn_tpu_torch.optimizers import (create_multi_node_optimizer,
                                                make_train_step)
    from chainermn_tpu_torch.runtime.bootstrap import init_distributed
    from chainermn_tpu_torch.utils.trace import MARKER, MARKER_CYCLES
    topo = init_distributed(device=device)
    dev = topo.device
    if dev.type != "cuda":
        raise RuntimeError("check_db_overlap profiles NCCL kernels on the "
                           "card; there is no CUDA device here")
    comm = create_communicator("xla", device=dev)
    model = MLP(n_units, 10, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    comm.bcast_data(model)
    optimizer = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm,
        double_buffering=True)
    g = torch.Generator(device=dev).manual_seed(1 + comm.rank)
    x = torch.randn(batch, 784, device=dev, generator=g)
    y = torch.randint(0, 10, (batch,), device=dev, generator=g)

    def loss_fn(b):
        torch.cuda._sleep(MARKER_CYCLES)   # the forward begins
        out = F.cross_entropy(model(b[0]), b[1])
        torch.cuda._sleep(MARKER_CYCLES)   # ... and ends
        return out

    step = make_train_step(comm, loss_fn, optimizer)
    for _ in range(3):
        step((x, y))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="db_overlap_") as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(steps):
                step((x, y))
            torch.cuda.synchronize()
            time.sleep(0.05)
        prof.export_chrome_trace(path)
        kernels = _kernels(path)
    step.finalize()
    doc = judge(kernels, steps, comm.size, marker=MARKER)
    doc.update({"suite": "db_overlap_check", "backend": "nccl",
                "n_devices": comm.size, "rank": comm.rank,
                "device": torch.cuda.get_device_name(dev),
                "n_units": n_units, "batch": batch,
                "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                           time.gmtime())})
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--units", type=int, default=4096)
    ap.add_argument("--batchsize", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="the card by default (a CPU run raises)")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    created = not dist.is_initialized()
    doc = run(args.steps, args.units, args.batchsize, args.device)
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    stamp_envelope(doc, "db_overlap_check/v1")
    if doc["rank"] == 0:
        print(json.dumps(doc), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(doc, f, indent=2)
                f.write("\n")
    ok = doc["ok"]
    if created:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
