"""Joint-vs-independent plan tuning under the shared-link workload model.

Counterpart of ``benchmarks/bench_joint.py``, device-free and
deterministic: the two-slot step workload (the gradient all-reduce and the
MoE dispatch / combine all-to-all) on one topology, each slot tuned alone
(``plan_modeled_time_s`` argmin over its candidate zoo) and both tuned
together (``planner.jointly_tune``: coordinate descent under the
fair-share link simulator), with both workload makespans.  Link rates are
the card's classes (``nvlink=X,ib=Y`` GB/s); the document is JAX's with
``ici``/``dcn`` read as ``nvlink``/``ib``.

    python -m chainermn_tpu_torch.benchmarks.bench_joint \\
        --topology inter:2,intra:4 --link-gbps nvlink=0.2,ib=0.02
"""

from __future__ import annotations

import argparse
import json
import sys
import time

JOINT_SWEEP_SCHEMA = "joint_sweep/v1"


def run_joint_sweep(topology_key, link_gbps, allreduce_bytes, moe_bytes,
                    dtype="float32", stripe_ratios=None):
    """The modeled sweep: the ``joint_sweep/v1`` document body (no
    envelope), a pure function of its arguments."""
    from chainermn_tpu_torch.planner.ir import PlanTopology
    from chainermn_tpu_torch.planner.plans import (
        STRIPE_RATIOS, alltoall_plans, candidate_plans)
    from chainermn_tpu_torch.planner.schedule import (
        StepWorkload, WorkloadSlot, jointly_tune, simulate_workload)

    topology = PlanTopology.from_key(topology_key)
    ratios = STRIPE_RATIOS if stripe_ratios is None else tuple(stripe_ratios)
    workload = StepWorkload(topology=topology, slots=(
        WorkloadSlot(name="allreduce", nbytes=int(allreduce_bytes),
                     dtype=dtype, op="all-reduce"),
        WorkloadSlot(name="moe", nbytes=int(moe_bytes),
                     dtype=dtype, op="all-to-all"),
    ))
    candidates = {
        "allreduce": candidate_plans(topology, stripe_ratios=ratios),
        "moe": alltoall_plans(topology),
    }
    table, cmp = jointly_tune(workload, candidates, link_gbps)
    joint_plans = table.entries[cmp["signature"]]
    sched = simulate_workload(workload.with_plans(joint_plans), link_gbps)
    occupancy = {
        f"{link}/{owner}": {k: round(v, 9) for k, v in cell.items()}
        for (link, owner), cell in sorted(sched.occupancy.items())}
    return {
        "schema": JOINT_SWEEP_SCHEMA,
        "kind": "joint_sweep",
        "modeled": True,
        "topology": topology.key(),
        "dtype": dtype,
        "link_gbps": {k: float(v) for k, v in sorted(link_gbps.items())},
        "workload": workload.to_dict(),
        "signature": cmp["signature"],
        "n_candidates": {name: len(zoo)
                         for name, zoo in sorted(candidates.items())},
        "comparison": cmp,
        "joint_occupancy": occupancy,
        "joint_link_busy_s": dict(sorted(sched.link_busy_s.items())),
        "joint_table": table.to_dict(),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--topology", default="inter:2,intra:4",
                   help="planner topology key")
    p.add_argument("--link-gbps", default="nvlink=0.2,ib=0.02",
                   help="link rates, nvlink=X,ib=Y in GB/s")
    p.add_argument("--allreduce-kib", type=int, default=4096,
                   help="packed gradient all-reduce payload (KiB)")
    p.add_argument("--moe-kib", type=int, default=8192,
                   help="MoE exchange block payload (KiB)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--stripe-ratios", default=None,
                   help="comma-separated striped-candidate ratios "
                        "(default: the STRIPE_RATIOS ladder)")
    p.add_argument("--out", default=None,
                   help="write the joint_sweep/v1 document here "
                        "(default: stdout)")
    args = p.parse_args(argv)

    from chainermn_tpu_torch.benchmarks.bench_allreduce import (
        parse_link_gbps)
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    from chainermn_tpu_torch.planner.ir import PlanTopology

    link_gbps = parse_link_gbps(args.link_gbps)
    ratios = None if args.stripe_ratios is None else [
        float(r) for r in str(args.stripe_ratios).split(",") if r.strip()]
    doc = run_joint_sweep(args.topology, link_gbps,
                          args.allreduce_kib << 10, args.moe_kib << 10,
                          dtype=args.dtype, stripe_ratios=ratios)
    doc["timestamp"] = time.time()
    stamp_envelope(doc, n_devices=PlanTopology.from_key(args.topology).size,
                   backend="modeled")
    blob = json.dumps(doc, indent=2) + "\n"
    cmp = doc["comparison"]
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob)
        print(f"joint sweep: independent "
              f"{cmp['independent']['modeled_s']:.6f}s -> joint "
              f"{cmp['joint']['modeled_s']:.6f}s ({cmp['speedup']:.4f}x, "
              f"changed {cmp['changed_slots']}) -> {args.out}",
              file=sys.stderr)
    else:
        print(blob, end="")
    return doc


if __name__ == "__main__":
    main()
