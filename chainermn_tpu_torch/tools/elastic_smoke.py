"""Elastic smoke -- the elastic runtime's acceptance chaos test.

Counterpart of the JAX package's ``tools/elastic_smoke.py``.  Two legs,
one ``elastic_smoke/v1`` artifact:

* **Async checkpoint A/B** (in-process, a world of one on ``--device``):
  save the same multi-MB state through the synchronous ``npz`` backend
  and through the ``async`` backend.  The sync save stalls the step loop
  for the whole npz write; the async save must keep the on-step stall to
  the device-to-host snapshot while the persist thread writes.
  ``async_ckpt.stall_ms`` (the median) feeds the perf gate's
  ``--elastic`` rule (async strictly below sync).

* **Chaos** (a world of 2 ranks under the elastic supervisor): train
  JAX's MNIST-shaped MLP (784 inputs, 64 hidden, batch 64, Adam 1e-2) with
  per-step checkpoints, SIGKILL rank 1 mid-run -- no cleanup, the
  preemption model -- and require that the supervisor (a) harvests the
  survivor's watchdog or crash flight dump, (b) writes a
  ``restart_manifest/v1`` embedding the dump and an attribution report,
  and (c) relaunches a world that resumes from the newest consistent
  generation (through ``resume_resized``) with at most ONE step of work
  lost, reproducing the uninterrupted run's losses within
  :data:`LOSS_TOLERANCE`.

``--device cpu`` runs everything on the CPU (gloo); by default the A/B
state and the ranks are on the cards (NCCL, one card a rank).
``--chaos-start-device cpu --resize-schedule 2,1`` starts the chaos world
(and the uninterrupted baseline) on the CPU and relaunches it at another
size on ``--device`` (two NCCL ranks cannot share one card, so a
one-card machine runs the first attempt on the CPU).  Exits nonzero on
any violation::

    python -m chainermn_tpu_torch.tools.elastic_smoke --device cpu \\
        --out ELASTIC.json
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

LOSS_TOLERANCE = 1e-4   # resumed trajectory vs uninterrupted, per step
MAX_LOST_STEPS = 1      # the "<1 step of work lost" acceptance bound

_WORKER = r"""
import json, os, signal, sys
os.environ["CHAINERMN_TPU_OBSERVABILITY"] = "1"
sys.path.insert(0, os.environ["CHAINERMN_TPU_REPO"])
import numpy as np
import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.elastic import resume_resized
from chainermn_tpu_torch.elastic.supervisor import scan_latest_generation
from chainermn_tpu_torch.extensions.checkpoint import \
    create_multi_node_checkpointer
from chainermn_tpu_torch.models import MLP
from chainermn_tpu_torch.observability import start_watchdog
from chainermn_tpu_torch.optim import (init_optimizer_state,
                                       load_optimizer_state_tree,
                                       optimizer_state_tree)
from chainermn_tpu_torch.runtime.control_plane import get_control_plane
from chainermn_tpu_torch.utils.proc_world import worker_device

torch.set_num_threads(1)
topo = cmn.init_distributed(device=worker_device())
steps = int(os.environ["ELASTIC_SMOKE_STEPS"])
ckpt_dir = os.environ["ELASTIC_SMOKE_CKPT"]
kill_step = int(os.environ.get("ELASTIC_SMOKE_KILL_STEP", "-1"))
kill_rank = int(os.environ.get("ELASTIC_SMOKE_KILL_RANK", "1"))
attempt = int(os.environ.get("CHAINERMN_TPU_ELASTIC_ATTEMPT", "0"))

comm = cmn.create_communicator("hierarchical", device=topo.device)
dev = comm.device
wd = start_watchdog(
    control_plane=get_control_plane() if comm.size > 1 else None,
    out_dir=os.environ.get("CHAINERMN_TPU_FLIGHT_DIR", "."), rank=comm.rank)

model = MLP(64, 10, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
comm.bcast_data(model)
adam = torch.optim.Adam(model.parameters(), lr=1e-2)
optimizer = cmn.create_multi_node_optimizer(adam, comm)

def loss_fn(batch):
    x, y = batch
    return F.cross_entropy(model(x), y)

step = cmn.make_train_step(comm, loss_fn, optimizer)

def state():
    return {"model": dict(model.state_dict()),
            "optimizer": optimizer_state_tree(adam)}

ckpt = create_multi_node_checkpointer(comm, ckpt_dir, name="chaos", keep=4)
gen, report = None, {}
if scan_latest_generation(ckpt_dir, "chaos") is not None:
    # the live state a snapshot must match: Adam has no state before its
    # first step, so take one that changes nothing
    init_optimizer_state(adam)
    restored, gen, report = resume_resized(ckpt, state(), comm)
    if gen is not None:
        model.load_state_dict(restored["model"])
        load_optimizer_state_tree(adam, restored["optimizer"])
start = 0 if gen is None else gen + 1
# the resume decision on stderr: a failed attempt's view lands in the
# restart manifest's stderr_tails, so a desync is diagnosable post hoc
print(f"elastic_smoke rank{comm.rank} attempt={attempt} "
      f"resumed_from={gen} start={start} world={comm.size} device={dev}",
      file=sys.stderr, flush=True)

def batch_for(t):
    # a seed a STEP, no rank term: every rank cuts the same global batch,
    # so the baseline and the chaos run see the same data at step t
    # whichever attempt and world size run it
    rng = np.random.default_rng(10_000 + t)
    x = rng.standard_normal((64, 784)).astype(np.float32)
    y = (rng.random(64) * 10).astype(np.int64)
    n = 64 // comm.size
    sl = slice(comm.rank * n, (comm.rank + 1) * n)
    return (torch.from_numpy(x[sl]).to(dev), torch.from_numpy(y[sl]).to(dev))

losses = {}
for t in range(start, steps):
    losses[t] = float(step(batch_for(t)))
    if attempt == 0 and t == kill_step and comm.rank == kill_rank:
        # preemption model: the computed-but-unsaved step t dies with the
        # process -- at most ONE step of work to redo after the resume
        os.kill(os.getpid(), signal.SIGKILL)
    ckpt.save(state(), t)
ckpt.finalize()
if wd is not None:
    wd.stop()
print("RESULT " + json.dumps({
    "rank": comm.rank, "resumed_from": gen, "start": start,
    "world": comm.size, "device": str(dev),
    "resize": {k: v for k, v in report.items() if k != "plan_table"},
    "losses": {str(k): v for k, v in losses.items()}}), flush=True)
comm.barrier()
torch.distributed.destroy_process_group()
"""


# ---- async checkpoint A/B ---------------------------------------------------

def run_async_ab(n_saves: int = 6, device=None) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from chainermn_tpu_torch import create_communicator, init_distributed
    from chainermn_tpu_torch.extensions.checkpoint import \
        create_multi_node_checkpointer

    own_world = not dist.is_initialized()
    if own_world:
        init_distributed(device=device)
    comm = create_communicator("flat", device=device)
    gen = np.random.default_rng(0)
    # a few MB of state so the sync npz write is a measurable stall
    state = {f"w{i}": torch.from_numpy(
        gen.standard_normal((512, 512)).astype(np.float32)).to(comm.device)
        for i in range(8)}
    nbytes = sum(t.numel() * t.element_size() for t in state.values())

    root = tempfile.mkdtemp(prefix="elastic_ab_")
    try:
        sync = create_multi_node_checkpointer(
            comm, os.path.join(root, "sync"), name="ab", keep=2,
            backend="npz")
        sync_ms = []
        for i in range(n_saves):
            t0 = time.perf_counter()
            sync.save(state, i)
            sync_ms.append((time.perf_counter() - t0) * 1e3)
        sync.finalize()

        async_ = create_multi_node_checkpointer(
            comm, os.path.join(root, "async"), name="ab", keep=2,
            backend="async")
        for i in range(n_saves):
            async_.save(state, i)
            time.sleep(0.01)  # the "step compute" the persist hides under
        async_.drain()
        resumable = async_.latest_consistent_generation()
        async_.finalize()
        stall_ms = list(async_.stall_ms)
        persist_ms = list(async_.persist_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if own_world:
            dist.destroy_process_group()

    med = sorted(stall_ms)[len(stall_ms) // 2]
    med_sync = sorted(sync_ms)[len(sync_ms) // 2]
    return {
        "n_saves": n_saves,
        "state_bytes": nbytes,
        "device": str(comm.device),
        "stall_ms": round(med, 3),
        "sync_stall_ms": round(med_sync, 3),
        "stall_ms_all": [round(v, 3) for v in stall_ms],
        "sync_stall_ms_all": [round(v, 3) for v in sync_ms],
        "persist_ms": [round(v, 3) for v in persist_ms],
        "speedup": round(med_sync / med, 3) if med > 0 else None,
        "last_generation_resumable": resumable,
        "ok": med < med_sync and resumable == n_saves - 1,
    }


# ---- chaos leg --------------------------------------------------------------

def run_chaos(steps: int, kill_step: int, work_root: str, timeout: float,
              device=None, resize_schedule=None,
              start_device="same") -> dict:
    from chainermn_tpu_torch.elastic.supervisor import (Supervisor,
                                                        SupervisorConfig)
    from chainermn_tpu_torch.utils.proc_world import (kill_world,
                                                      launch_world,
                                                      wait_world)

    base_ckpt = os.path.join(work_root, "ckpt_baseline")
    chaos_ckpt = os.path.join(work_root, "ckpt_chaos")
    dump_dir = os.path.join(work_root, "dumps")
    out_dir = os.path.join(work_root, "manifests")
    for d in (base_ckpt, chaos_ckpt, dump_dir, out_dir,
              os.path.join(work_root, "baseline_dumps")):
        os.makedirs(d, exist_ok=True)
    schedule = list(resize_schedule or [2])
    first = device if start_device == "same" else start_device
    devices = [first, device]

    # the uninterrupted baseline: the same worker, no kill, as attempt 0,
    # beside the supervised world (its own ports and checkpoints)
    t0 = time.perf_counter()
    baseline = launch_world(_WORKER, schedule[0],
                            os.path.join(work_root, "baseline_logs"), first,
                            env={"ELASTIC_SMOKE_STEPS": str(steps),
                                 "ELASTIC_SMOKE_CKPT": base_ckpt,
                                 "ELASTIC_SMOKE_KILL_STEP": "-1",
                                 "CHAINERMN_TPU_FLIGHT_DIR": os.path.join(
                                     work_root, "baseline_dumps")})

    cfg = SupervisorConfig(
        n_procs=schedule[0], max_restarts=2,
        attempt_timeout_s=timeout, dump_dir=dump_dir, out_dir=out_dir,
        ckpt_path=chaos_ckpt, ckpt_name="chaos",
        resize_schedule=schedule if len(schedule) > 1 else None,
        device_schedule=devices,
        env={
            "ELASTIC_SMOKE_STEPS": str(steps),
            "ELASTIC_SMOKE_CKPT": chaos_ckpt,
            "ELASTIC_SMOKE_KILL_STEP": str(kill_step),
            "ELASTIC_SMOKE_KILL_RANK": "1",
            # a fast heartbeat so the SURVIVOR's watchdog notices the
            # killed peer and dumps inside the supervisor's grace window
            "CHAINERMN_TPU_WATCHDOG_HEARTBEAT": "0.2",
            "CHAINERMN_TPU_WATCHDOG_HB_TIMEOUT": "1.5",
        })
    sup = Supervisor(_WORKER, cfg)
    try:
        outcome = sup.run()
        base_losses = {int(k): v for k, v in wait_world(
            baseline, timeout)[0]["losses"].items()}
        baseline_s = time.perf_counter() - t0
    except RuntimeError as e:
        kill_world(baseline)
        # restart budget exhausted -- emit a failing, inspectable artifact
        # (manifests are on disk) instead of crashing the smoke
        return {
            "steps": steps, "kill_step": kill_step, "killed_rank": 1,
            "supervisor_error": str(e),
            "manifest": sup.manifests[0] if sup.manifests else None,
            "restarts": max(len(sup.attempts) - 1, 0),
            "checks": [{"name": "supervisor_recovered", "ok": False,
                        "error": str(e)}],
            "ok": False,
        }

    results = outcome["results"]
    resumed = results[0]["resumed_from"]
    lost = (kill_step - resumed) if resumed is not None else steps
    chaos_losses = {int(k): v for k, v in results[0]["losses"].items()}
    overlap = sorted(set(base_losses) & set(chaos_losses))
    max_delta = max((abs(base_losses[t] - chaos_losses[t])
                     for t in overlap), default=float("inf"))

    manifest_path = outcome["manifests"][0] if outcome["manifests"] else None
    manifest = None
    n_dumps = 0
    attribution_ok = False
    if manifest_path:
        with open(manifest_path) as f:
            manifest = json.load(f)
        n_dumps = len(manifest.get("flight_dumps", []))
        attribution_ok = isinstance(manifest.get("attribution"), dict) \
            and "error" not in manifest["attribution"]

    checks = [
        {"name": "supervisor_restarted_once",
         "ok": len(outcome["attempts"]) == 2,
         "attempts": len(outcome["attempts"])},
        {"name": "lost_steps_within_bound",
         "ok": lost <= MAX_LOST_STEPS, "lost_steps": lost,
         "bound": MAX_LOST_STEPS},
        {"name": "resumed_losses_match_uninterrupted",
         "ok": bool(overlap) and max_delta <= LOSS_TOLERANCE,
         "steps_compared": len(overlap), "max_delta": max_delta,
         "tolerance": LOSS_TOLERANCE},
        {"name": "manifest_embeds_flight_dump",
         "ok": manifest is not None and n_dumps >= 1,
         "n_dumps": n_dumps},
        {"name": "manifest_carries_attribution",
         "ok": attribution_ok},
    ]
    return {
        "steps": steps, "kill_step": kill_step, "killed_rank": 1,
        "resumed_from": resumed, "lost_steps": lost,
        "restarts": len(outcome["attempts"]) - 1,
        "steps_compared": len(overlap),
        "max_loss_delta": max_delta, "loss_tolerance": LOSS_TOLERANCE,
        "baseline_losses": {str(k): v for k, v in sorted(
            base_losses.items())},
        "chaos_losses": {str(k): v for k, v in sorted(
            chaos_losses.items())},
        "baseline_s": baseline_s,
        "attempts": [{k: a[k] for k in ("attempt", "world", "device",
                                        "resume_generation", "duration_s")}
                     for a in outcome["attempts"]],
        "resize": results[0].get("resize"),
        "manifest": manifest_path,
        "manifest_reason": (manifest or {}).get("reason"),
        "n_embedded_dumps": n_dumps,
        "evidence": (manifest or {}).get("evidence"),
        "checks": checks,
        "ok": all(c["ok"] for c in checks),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12,
                    help="total train steps (default 12)")
    ap.add_argument("--kill-step", type=int, default=7,
                    help="step at which rank 1 SIGKILLs itself (default 7)")
    ap.add_argument("--out", default="ELASTIC.json", metavar="PATH",
                    help="artifact path (elastic_smoke/v1 JSON)")
    ap.add_argument("--work-dir", default=None, metavar="DIR",
                    help="checkpoints/dumps/manifests root "
                         "(default: a temp dir, removed on success)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--skip-chaos", action="store_true",
                    help="run only the in-process async A/B leg")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="the A/B leg's state and the chaos world's ranks: "
                         "the CPU (gloo) or one card a rank (NCCL; the "
                         "default)")
    ap.add_argument("--resize-schedule", default="2",
                    help="comma-separated world size per attempt, e.g. "
                         "'2,1' = start with 2 ranks, restart with 1 "
                         "(default 2)")
    ap.add_argument("--chaos-start-device", choices=("cpu", "cuda", "same"),
                    default="same",
                    help="device of the baseline and the chaos world's "
                         "first attempt (default: --device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.device == "cpu" else None
    start = {"cpu": "cpu", "cuda": None}.get(args.chaos_start_device,
                                             "same")

    async_ab = run_async_ab(device=device)
    print(f"async_ckpt: stall {async_ab['stall_ms']:.2f} ms vs sync "
          f"{async_ab['sync_stall_ms']:.2f} ms "
          f"(x{async_ab['speedup']}) over {async_ab['state_bytes']} bytes "
          f"on {async_ab['device']}", file=sys.stderr)

    keep_work = args.work_dir is not None
    work_root = args.work_dir or tempfile.mkdtemp(prefix="elastic_smoke_")
    os.makedirs(work_root, exist_ok=True)
    chaos = None
    if not args.skip_chaos:
        chaos = run_chaos(args.steps, args.kill_step, work_root,
                          args.timeout, device=device,
                          resize_schedule=[int(s) for s in
                                           args.resize_schedule.split(",")],
                          start_device=start)
        for c in chaos["checks"]:
            print(f"chaos {'ok' if c['ok'] else 'FAIL':>6} {c['name']}",
                  file=sys.stderr)

    ok = async_ab["ok"] and (chaos is None or chaos["ok"])
    doc = {
        "kind": "elastic_smoke/v1",
        "ok": ok,
        "async_ckpt": async_ab,
        "chaos": chaos,
    }
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    # the A/B leg's device names the artifact's cell in the run ledger
    stamp_envelope(doc, "elastic_smoke/v1", n_devices=1,
                   device_kind="cpu" if device == "cpu" else None,
                   backend="cpu" if device == "cpu" else "cuda")
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    print(json.dumps({"ok": ok,
                      "async_stall_ms": async_ab["stall_ms"],
                      "lost_steps": chaos.get("lost_steps")
                      if chaos else None}),
          flush=True)
    if ok and not keep_work:
        shutil.rmtree(work_root, ignore_errors=True)
    elif not ok:
        print(f"elastic_smoke: FAIL -- evidence under {work_root}",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
