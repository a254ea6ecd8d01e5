"""Attribution smoke -- the attribution acceptance check, runnable anywhere.

Counterpart of the JAX package's ``tools/attribution_smoke.py``.  Spawns a
world of ``--n-procs`` ranks (2 by default; one torch process a rank:
gloo on the CPU with ``--device cpu``, NCCL on the cards otherwise),
trains a small MNIST-shaped MLP through the port's ``StandardUpdater``
with the flight recorder and ``StepTelemetry`` on, runs the cross-rank
clock handshake, and dumps ``flight_<rank>.json`` per rank.  The parent
then rebuilds the span trees the way ``obs_report --flight
--attribution`` does and checks JAX's acceptance criteria:

* the per-rank bucket decomposition sums to the measured step time
  within 5% on every step;
* the cross-rank critical path names a concrete ``(rank, span)`` pair;
* the Chrome/Perfetto trace-event export round-trips through
  ``json.loads`` with well-formed complete ("X") events.

Writes an ``attribution_smoke/v1`` JSON artifact and exits nonzero on any
violation::

    python -m chainermn_tpu_torch.tools.attribution_smoke --device cpu
    python -m chainermn_tpu_torch.tools.attribution_smoke --n-procs 4
"""

import argparse
import json
import os
import sys
import tempfile
from typing import Optional

from chainermn_tpu_torch.utils.proc_world import spawn_world

TOLERANCE = 0.05  # buckets must sum to the measured step time within 5%

_WORKER = r"""
import json, os, sys
os.environ["CHAINERMN_TPU_OBSERVABILITY"] = "1"
sys.path.insert(0, os.environ["CHAINERMN_TPU_REPO"])
import numpy as np
import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.datasets import TupleDataset
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import MLP
from chainermn_tpu_torch.observability import clock_handshake, get_flight_recorder
from chainermn_tpu_torch.observability.straggler import StepTelemetry
from chainermn_tpu_torch.training import StandardUpdater
from chainermn_tpu_torch.utils.proc_world import worker_device

torch.set_num_threads(1)
topo = cmn.init_distributed(device=worker_device())
steps = int(os.environ.get("ATTR_SMOKE_STEPS", "6"))
out_dir = os.environ["ATTR_SMOKE_OUT"]

fr = get_flight_recorder()
assert fr is not None, "observability switch did not take"

comm = cmn.create_communicator("hierarchical", device=topo.device)
dev = comm.device
model = MLP(32, 10, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
comm.bcast_data(model)
optimizer = cmn.create_multi_node_optimizer(
    torch.optim.Adam(model.parameters(), lr=1e-2), comm)

def loss_fn(batch):
    x, y = batch
    return F.cross_entropy(model(x), y.long())

step = cmn.make_train_step(comm, loss_fn, optimizer)

rng = np.random.RandomState(7 + comm.rank)
x = rng.randn(256, 784).astype(np.float32)
y = (rng.rand(256) * 10).astype(np.int32)
it = SerialIterator(TupleDataset(x, y), 64, shuffle=False)

updater = StandardUpdater(it, step, comm)
updater.telemetry = StepTelemetry(comm=comm)  # device_block phase too
for _ in range(steps):
    updater.update()

hs = clock_handshake(comm)
path = fr.dump(out_dir, rank=comm.rank, reason="attribution_smoke",
               extra={"clock": {"rank": comm.rank, "offsets": {"0": hs}}})

med = fr.trailing_step_median()
print("RESULT " + json.dumps({
    "rank": comm.rank, "steps": steps, "dump": path,
    "offset_s": hs["offset_s"], "rtt_s": hs["rtt_s"],
    "median_step_s": med,
    "dropped_events": fr.dropped_events,
    "device": str(dev),
}), flush=True)
comm.barrier()
torch.distributed.destroy_process_group()
"""


def run_world(steps: int, dump_dir: str, timeout: float = 600.0,
              n_procs: int = 2, device: Optional[str] = None) -> dict:
    return spawn_world(_WORKER, n_procs=n_procs, device=device,
                       timeout=timeout,
                       log_dir=os.path.join(dump_dir, "logs"),
                       env={"ATTR_SMOKE_STEPS": str(steps),
                            "ATTR_SMOKE_OUT": dump_dir})


def check_dumps(dumps, checks):
    """Run the acceptance asserts over loaded flight dumps; appends
    ``{"name", "ok", ...}`` rows to ``checks`` and returns the
    attribution report + trace document."""
    from chainermn_tpu_torch.observability import attribution as _attr

    events_by_rank = {int(d["rank"]): d.get("events", []) for d in dumps}
    offsets = {}
    for d in dumps:
        own = ((d.get("clock") or {}).get("offsets") or {}).get("0")
        if own is not None:
            offsets[int(d["rank"])] = float(own.get("offset_s", 0.0))
    rep = _attr.attribution_report(events_by_rank, offsets=offsets)

    # 1. every (step, rank): buckets sum to the measured step time <= 5%
    worst = 0.0
    n_attr = 0
    for st in rep["steps"]:
        for r, a in st["ranks"].items():
            n_attr += 1
            worst = max(worst, abs(a["sum_frac"] - 1.0))
    checks.append({"name": "buckets_sum_to_step_time",
                   "ok": n_attr > 0 and worst <= TOLERANCE,
                   "attributed_steps": n_attr,
                   "worst_sum_frac_err": worst, "tolerance": TOLERANCE})

    # 2. the critical path names a concrete (rank, span) pair
    cp = next((st["critical_path"] for st in rep["steps"]
               if st.get("critical_path")), [])
    named = bool(cp) and all("rank" in e and e.get("name") for e in cp)
    checks.append({"name": "critical_path_names_rank_and_span",
                   "ok": named,
                   "path": [(e.get("rank"), e.get("name")) for e in cp]})

    # 3. trace-event JSON round-trips with well-formed "X" events
    trees = _attr.merge_ranks(events_by_rank, offsets)
    trace = json.loads(json.dumps(_attr.to_trace_events(trees)))
    xs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    wellformed = bool(xs) and all(
        isinstance(e.get("ts"), (int, float)) and e.get("dur", 0) >= 0
        and e.get("name") and "pid" in e and "tid" in e for e in xs)
    checks.append({"name": "trace_json_round_trips", "ok": wellformed,
                   "n_complete_events": len(xs)})
    return rep, trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6,
                    help="train steps per controller (default 6)")
    ap.add_argument("--out", default="ATTRIBUTION.json", metavar="PATH",
                    help="artifact path (attribution_smoke/v1 JSON)")
    ap.add_argument("--dump-dir", default=None, metavar="DIR",
                    help="where workers drop flight_<rank>.json "
                         "(default: a temp dir)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--n-procs", type=int, default=2,
                    help="ranks of the world (default 2)")
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="run the ranks on the CPU (gloo); default: one "
                         "card a rank (NCCL)")
    args = ap.parse_args(argv)

    dump_dir = args.dump_dir or tempfile.mkdtemp(prefix="attr_smoke_")
    os.makedirs(dump_dir, exist_ok=True)
    results = run_world(args.steps, dump_dir, timeout=args.timeout,
                        n_procs=args.n_procs, device=args.device)

    dumps = []
    for r in sorted(results):
        with open(results[r]["dump"]) as f:
            dumps.append(json.load(f))

    checks = []
    rep, trace = check_dumps(dumps, checks)
    ok = all(c["ok"] for c in checks)

    doc = {
        "kind": "attribution_smoke/v1",
        "ok": ok,
        "n_ranks": len(dumps),
        "steps_per_rank": args.steps,
        "checks": checks,
        "offsets": rep.get("offsets", {}),
        "summary": rep.get("summary", {}),
        "n_trace_events": len(trace.get("traceEvents", [])),
        "worker_results": {str(r): results[r] for r in sorted(results)},
    }
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    cpu = args.device == "cpu"
    stamp_envelope(doc, "attribution_smoke/v1", n_devices=len(dumps),
                   device_kind="cpu" if cpu else None,
                   backend="cpu" if cpu else "cuda")
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)

    for c in checks:
        print(f"  [{'ok' if c['ok'] else 'FAIL'}] {c['name']}")
    print(f"attribution smoke: {'OK' if ok else 'FAILED'} "
          f"({len(dumps)} rank(s), artifact {args.out})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
