"""Contention smoke -- the contention acceptance check, runnable anywhere.

Counterpart of the JAX package's ``tools/contention_smoke.py``.  Spawns a
world of ``--n-procs`` ranks (2 by default; one torch process a rank:
gloo on the CPU with ``--device cpu``, NCCL on the cards otherwise) and
runs the two-workload contention scenario the observatory exists for:

* **FSDP gathers** -- a bucketed-FSDP MLP trains for a few steps with the
  flight recorder on, so it carries real ``fsdp_{gather,scatter}`` bucket
  edges (``nvlink`` link class) inside real step windows;
* **MoE all-to-all** -- each worker emits the hierarchical dispatch
  plan's stage schedule (intra ``nvlink`` / inter ``ib`` hops,
  ``alltoall_*`` plan name) through the same
  :class:`~chainermn_tpu_torch.observability.spans.PlanObs` edge hook the
  plan executor uses.  The hops are *modeled*, as in JAX's smoke: the
  parent translates the all-to-all bundle into an FSDP gather window
  inside a step (:func:`shift_bundle`).

The parent rebuilds the ``contention/v1`` report the way
``obs_report --flight --contention`` does and checks JAX's criteria:

1. the overlap matrix is non-empty and names the fsdp x moe pair on the
   ``nvlink`` link class;
2. per-link occupancy reconciles with the ``ici_comm``/``dcn_comm``
   attribution buckets for the same steps (``consistency_ok``);
3. per-link rates are internally consistent (contended <= busy <= span);
4. the ``overlapping-collectives`` rule of the port's ``lint_step`` fires
   on the same events;
5. the streaming telemetry aggregator gathered a fleet document over the
   live world.

Writes a ``contention_smoke/v1`` JSON artifact and exits nonzero on any
violation::

    python -m chainermn_tpu_torch.tools.contention_smoke --device cpu
    python -m chainermn_tpu_torch.tools.contention_smoke --n-procs 2
"""

import argparse
import json
import os
import sys
import tempfile
from typing import Optional

from chainermn_tpu_torch.utils.proc_world import spawn_world

#: the modeled all-to-all dispatch schedule the worker emits -- the
#: hierarchical plan's hop structure (dispatch intra->inter, combine
#: intra->inter), one PlanObs begin/end pair per hop
MOE_PLAN = "alltoall_hier_bfloat16_dcn"
MOE_HOPS = (  # (stage, op, scope, link, nbytes)
    (0, "all_to_all", "intra", "nvlink", 1 << 16),
    (1, "all_to_all", "inter", "ib", 1 << 14),
    (2, "all_to_all", "intra", "nvlink", 1 << 16),
    (3, "all_to_all", "inter", "ib", 1 << 14),
)

_WORKER = r"""
import json, os, sys, time
os.environ["CHAINERMN_TPU_OBSERVABILITY"] = "1"
sys.path.insert(0, os.environ["CHAINERMN_TPU_REPO"])
import torch

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.observability import (
    TelemetryAggregator, clock_handshake, get_flight_recorder)
from chainermn_tpu_torch.observability.spans import get_plan_obs
from chainermn_tpu_torch.parallel.fsdp import fsdp_init, make_fsdp_train_step
from chainermn_tpu_torch.utils.proc_world import worker_device

torch.set_num_threads(1)
topo = cmn.init_distributed(device=worker_device())
steps = int(os.environ.get("CONT_SMOKE_STEPS", "4"))
out_dir = os.environ["CONT_SMOKE_OUT"]
hops = json.loads(os.environ["CONT_SMOKE_HOPS"])
moe_plan = os.environ["CONT_SMOKE_PLAN"]

fr = get_flight_recorder()
assert fr is not None, "observability switch did not take"

comm = cmn.create_communicator("flat", device=topo.device)
dev = comm.device

# ---- workload 1: bucketed-FSDP training (real fsdp_gather/scatter
# edges inside real step windows) --------------------------------------
n_layers, width = 6, 16
g = torch.Generator(device=dev).manual_seed(0)
model = torch.nn.Sequential(*[torch.nn.Linear(width, width, device=dev)
                              for _ in range(n_layers)])
with torch.no_grad():
    for p in model.parameters():
        p.copy_(torch.randn(p.shape, device=dev, generator=g) / 4.0)
opt = torch.optim.Adam(model.parameters(), lr=1e-2)
state, meta = fsdp_init(comm, model, opt, num_buckets=2)

def loss_fn(batch):
    x, y = batch
    for layer in model:
        x = torch.tanh(layer(x))
    return torch.mean((x - y) ** 2)

step = make_fsdp_train_step(comm, loss_fn, state, meta, prefetch=1)
gb = torch.Generator(device=dev).manual_seed(1 + comm.rank)
batch = (torch.randn(4, width, device=dev, generator=gb),
         torch.randn(4, width, device=dev, generator=gb))

for i in range(steps):
    t0 = time.perf_counter()
    loss = step(batch)
    float(loss)
    fr.record_step(time.perf_counter() - t0, i + 1)

# ---- workload 2: modeled MoE all-to-all dispatch (the hierarchical
# plan's hop schedule through the executor's PlanObs edge hook) --------
pobs = get_plan_obs(comm)
assert pobs is not None, "plan obs unavailable with observability on"
for _round in range(2):
    for stage, op, scope, link, nbytes in hops:
        pobs.edge("begin", moe_plan, stage, op, scope, link, nbytes)
        time.sleep(0.002)
        pobs.edge("end", moe_plan, stage, op, scope, link, nbytes)

# ---- streaming fleet telemetry over the live world -------------------
agg = TelemetryAggregator(comm)
fleet = agg.collect(steps)
fleet_info = None
if fleet is not None:
    fleet_info = {"n_ranks": fleet["n_ranks"],
                  "links": sorted(fleet["occupancy"]),
                  "overlap_rows": len(fleet["overlap"]),
                  "stragglers": fleet["stragglers"]}

hs = clock_handshake(comm)
path = fr.dump(out_dir, rank=comm.rank, reason="contention_smoke",
               extra={"clock": {"rank": comm.rank, "offsets": {"0": hs}}})

print("RESULT " + json.dumps({
    "rank": comm.rank, "steps": steps, "dump": path,
    "offset_s": hs["offset_s"], "rtt_s": hs["rtt_s"],
    "median_step_s": fr.trailing_step_median(),
    "dropped_events": fr.dropped_events,
    "fleet": fleet_info, "device": str(dev),
}), flush=True)
comm.barrier()
torch.distributed.destroy_process_group()
"""


def run_world(steps: int, dump_dir: str, timeout: float = 600.0,
              n_procs: int = 2, device: Optional[str] = None) -> dict:
    return spawn_world(_WORKER, n_procs=n_procs, device=device,
                       timeout=timeout,
                       log_dir=os.path.join(dump_dir, "logs"),
                       env={"CONT_SMOKE_STEPS": str(steps),
                            "CONT_SMOKE_OUT": dump_dir,
                            "CONT_SMOKE_HOPS": json.dumps(MOE_HOPS),
                            "CONT_SMOKE_PLAN": MOE_PLAN})


def shift_bundle(events):
    """The modeled-overlap cut (JAX's): translate one rank's all-to-all
    plan-stage bundle onto its latest completed FSDP gather or scatter
    window inside a step, scaled so every hop lands inside that step and
    the first hop straddles the window's end edge (the overlap is then
    hand-computable: ``eps`` past the anchor edge).  Ranks without such a
    window fall back to the middle half of their first step.  Returns
    ``(events, mode)`` with mode ``"gather"`` / ``"step"`` / ``None``."""
    steps_w = [(e["ts"] - e["dur_s"], e["ts"]) for e in events
               if e.get("kind") == "step" and e.get("dur_s")]
    bundle = [e for e in events
              if str(e.get("kind", "")).startswith("plan_stage_")]
    n_hops = max(sum(1 for e in bundle
                     if str(e["kind"]).endswith("_begin")), 1)
    anchor = None  # (f0, f1, s1) with the max f1 over completed pairs
    open_f = {}
    for e in events:
        k = str(e.get("kind", ""))
        if k in ("fsdp_gather_begin", "fsdp_scatter_begin"):
            open_f[(k.split("_")[1], e.get("bucket"))] = e["ts"]
        elif k in ("fsdp_gather_end", "fsdp_scatter_end"):
            f0 = open_f.pop((k.split("_")[1], e.get("bucket")), None)
            if f0 is None or e["ts"] <= f0:
                continue
            mid = 0.5 * (f0 + e["ts"])
            for s0, s1 in steps_w:
                if s0 <= mid <= s1 and e["ts"] < s1 and (
                        anchor is None or e["ts"] > anchor[1]):
                    anchor = (f0, e["ts"], s1)
    target = None
    mode = None
    if anchor is not None:
        f0, f1, s1 = anchor
        eps = 0.5 * min(f1 - f0, 0.9 * (s1 - f1) / n_hops)
        start = f1 - eps
        stop = s1 - 0.05 * (s1 - start)
        if eps > 0.0 and stop > f1:
            target, mode = (start, stop), "gather"
    if target is None and steps_w:
        s0, s1 = steps_w[0]
        if s1 > s0:
            quarter = 0.25 * (s1 - s0)
            target, mode = (s0 + quarter, s1 - quarter), "step"
    if target is None or not bundle:
        return list(events), None
    a0 = min(e["ts"] for e in bundle)
    a1 = max(e["ts"] for e in bundle)
    if a1 <= a0:
        return list(events), None
    g0, g1 = target
    scale = (g1 - g0) / (a1 - a0)
    out = []
    for e in events:
        if str(e.get("kind", "")).startswith("plan_stage_"):
            e = dict(e, ts=g0 + (e["ts"] - a0) * scale)
        out.append(e)
    return out, mode


def check_dumps(dumps, checks, worker_results=None):
    """Shift, rebuild the contention/v1 report, and run the acceptance
    checks; appends ``{"name", "ok", ...}`` rows to ``checks`` and returns
    the report."""
    from chainermn_tpu_torch.observability import contention as _cont

    events_by_rank = {}
    modes = {}
    for d in dumps:
        ev, mode = shift_bundle(d.get("events", []))
        events_by_rank[int(d["rank"])] = ev
        modes[int(d["rank"])] = mode
    offsets = {}
    for d in dumps:
        own = ((d.get("clock") or {}).get("offsets") or {}).get("0")
        if own is not None:
            offsets[int(d["rank"])] = float(own.get("offset_s", 0.0))
    checks.append({"name": "bundle_shifted_into_gather_window",
                   "ok": all(m is not None for m in modes.values())
                   and "gather" in modes.values(),
                   "modes": {str(r): m for r, m in sorted(modes.items())}})

    rep = _cont.contention_report(events_by_rank, offsets=offsets)

    # 1. the overlap matrix names the fsdp x moe pair on nvlink
    pairs = {(row["link"], tuple(row["owners"])): row["contended_s"]
             for row in rep["overlap"]}
    hit = pairs.get(("nvlink", ("fsdp", "moe")), 0.0)
    checks.append({"name": "overlap_matrix_names_fsdp_x_moe_on_nvlink",
                   "ok": hit > 0.0, "contended_s": hit,
                   "n_cells": len(pairs)})

    # 2. occupancy reconciles with the ici_comm/dcn_comm buckets
    checks.append({"name": "occupancy_matches_attribution_buckets",
                   "ok": bool(rep["consistency"]) and rep["consistency_ok"],
                   "rows": len(rep["consistency"]),
                   "worst_abs_err_s": max(
                       (r["abs_err_s"] for r in rep["consistency"]),
                       default=None)})

    # 3. rate accounting is internally consistent per link
    rates_ok = bool(rep["rates"])
    for link, row in rep["rates"].items():
        rates_ok = rates_ok and (
            row["contended_s"] <= row["busy_s"] + 1e-9
            and row["busy_s"] <= row["span_s"] + 1e-9)
    rates_ok = rates_ok and rep["rates"].get(
        "nvlink", {}).get("contended_s", 0.0) > 0.0
    checks.append({"name": "link_rates_contended_within_busy_within_span",
                   "ok": rates_ok,
                   "rates": {l: {k: row[k] for k in
                                 ("busy_s", "contended_s", "span_s",
                                  "derate")}
                             for l, row in rep["rates"].items()}})

    # 4. the overlapping-collectives lint fires on the same events
    from chainermn_tpu_torch.analysis.lint import lint_step
    lrep = lint_step(None, flight_events=events_by_rank,
                     rules=["overlapping-collectives"],
                     raise_on_error=False, name="contention_smoke")
    hits = [f for f in lrep.findings
            if f.rule == "overlapping-collectives"]
    names_fsdp = any("fsdp" in f.details.get("identities", [])
                     for f in hits)
    checks.append({"name": "overlapping_collectives_lint_fires",
                   "ok": bool(hits) and names_fsdp,
                   "findings": [f.as_dict() for f in hits]})

    # 5. streaming aggregator gathered a fleet doc over the live world
    if worker_results is not None:
        fleet = (worker_results.get(0) or {}).get("fleet")
        checks.append({"name": "streaming_fleet_doc_gathered_on_rank0",
                       "ok": bool(fleet)
                       and fleet.get("n_ranks") == len(dumps),
                       "fleet": fleet})
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="FSDP train steps per rank (default 4)")
    ap.add_argument("--out", default="CONTENTION.json", metavar="PATH",
                    help="artifact path (contention_smoke/v1 JSON)")
    ap.add_argument("--dump-dir", default=None, metavar="DIR",
                    help="where workers drop flight_<rank>.json "
                         "(default: a temp dir)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--n-procs", type=int, default=2,
                    help="ranks of the world (default 2)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="run the ranks on the CPU (gloo); default and "
                         "'cuda': one card a rank (NCCL)")
    args = ap.parse_args(argv)
    device = "cpu" if args.device == "cpu" else None

    dump_dir = args.dump_dir or tempfile.mkdtemp(prefix="cont_smoke_")
    os.makedirs(dump_dir, exist_ok=True)
    results = run_world(args.steps, dump_dir, timeout=args.timeout,
                        n_procs=args.n_procs, device=device)

    dumps = []
    for r in sorted(results):
        with open(results[r]["dump"]) as f:
            dumps.append(json.load(f))

    checks = []
    rep = check_dumps(dumps, checks, worker_results=results)
    ok = all(c["ok"] for c in checks)

    doc = {
        "kind": "contention_smoke/v1",
        "ok": ok,
        "n_ranks": len(dumps),
        "steps_per_rank": args.steps,
        "checks": checks,
        "report": rep,
        "worker_results": {str(r): results[r] for r in sorted(results)},
    }
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    stamp_envelope(doc, "contention_smoke/v1", n_devices=len(dumps),
                   backend="gloo" if device == "cpu" else "nccl")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)

    for c in checks:
        print(f"  [{'ok' if c['ok'] else 'FAIL'}] {c['name']}")
    print(f"contention smoke: {'OK' if ok else 'FAILED'} "
          f"({len(dumps)} rank(s), artifact {args.out})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
