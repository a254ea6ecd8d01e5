"""Elastic supervisor CLI -- launch, watch, manifest, relaunch.

Counterpart of the JAX package's ``tools/elastic_run.py``: a thin front
end over :class:`chainermn_tpu_torch.elastic.supervisor.Supervisor`.  It
launches an N-rank world running WORKER (a Python source file following
the ``spawn_world`` convention -- bootstrap from the environment contract,
e.g. ``init_distributed(device=proc_world.worker_device())``, print a
``RESULT {json}`` line), one card a rank unless ``--device cpu``, and when
a rank dies or wedges it harvests the flight dumps, writes a
``restart_manifest/v1`` and relaunches from the newest consistent
checkpoint generation.  ``--resize-schedule`` makes relaunches elastic:
attempt *k* runs with the *k*-th world size, and workers resume through
``resume_resized`` when the world size changed::

    python -m chainermn_tpu_torch.tools.elastic_run worker.py --n-procs 2 \
        --ckpt-path ck --dump-dir dumps --out-dir out --max-restarts 3

Exits 0 when an attempt completes cleanly, 1 when the restart budget is
exhausted (manifests are on disk either way).
"""

import argparse
import json
import sys

from chainermn_tpu_torch.elastic.supervisor import (Supervisor,
                                                    SupervisorConfig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("worker", help="worker source file (spawn_world "
                                   "convention: env bootstrap + RESULT line)")
    ap.add_argument("--n-procs", type=int, default=2)
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="run the ranks on the CPU (gloo); default: one "
                         "card a rank (NCCL)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--attempt-timeout-s", type=float, default=600.0)
    ap.add_argument("--ckpt-path", default=None,
                    help="checkpoint dir (resume-generation reporting)")
    ap.add_argument("--ckpt-name", default="snapshot")
    ap.add_argument("--dump-dir", default=".",
                    help="where children write flight dumps")
    ap.add_argument("--out-dir", default=".",
                    help="where restart manifests land")
    ap.add_argument("--resize-schedule", default=None,
                    help="comma-separated world size per attempt, e.g. "
                         "'2,1' = start with 2 ranks, restart with 1")
    ap.add_argument("--env", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="extra child env (repeatable; watchdog knobs "
                         "ride here)")
    args = ap.parse_args(argv)

    with open(args.worker) as f:
        worker_src = f.read()

    extra_env = {}
    for kv in args.env:
        k, _, v = kv.partition("=")
        extra_env[k] = v

    schedule = None
    if args.resize_schedule:
        schedule = [int(s) for s in args.resize_schedule.split(",")]

    cfg = SupervisorConfig(
        n_procs=args.n_procs, device=args.device,
        max_restarts=args.max_restarts,
        attempt_timeout_s=args.attempt_timeout_s,
        dump_dir=args.dump_dir, out_dir=args.out_dir,
        ckpt_path=args.ckpt_path, ckpt_name=args.ckpt_name,
        resize_schedule=schedule, env=extra_env)
    sup = Supervisor(worker_src, cfg)
    try:
        outcome = sup.run()
    except RuntimeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"attempts": outcome["attempts"],
                      "manifests": outcome["manifests"],
                      "results": {str(k): v for k, v in
                                  outcome["results"].items()}},
                     indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
