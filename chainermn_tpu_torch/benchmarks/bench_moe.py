"""MoE benchmark: the matched-loss leg.

Counterpart of ``benchmarks/bench_moe.py``'s default mode (``--out``): a
FLOP-matched pair trained side by side -- a MoE
:class:`~chainermn_tpu_torch.models.TransformerLM` (``--experts`` experts,
top 1: each token through one expert of the dense MLP's width, the same
per-token MLP compute and ``E`` times the MLP parameters) against its
dense twin, on a mixture task (each sequence follows one of ``--modes``
affine token maps ``t' = (a_m t + c_m) mod vocab``: easy within a mode,
the modes conflict, so per-mode expert capacity is what lowers the loss).
SGD with momentum 0.9 at ``--lr`` on a fresh batch a step; the loss is
the mean over the ranks of each rank's cross entropy plus ``aux_weight``
times the summed ``aux_loss`` (the MoE run).  The document
(``moe_bench/v1``, JAX's keys) records both loss curves and whether the
MoE's tail mean (the last eighth of the steps) lands at or below the
dense one's.

The global batch is ``--batch-per-device x --devices`` sequences, split
over the ranks of the world (one process a GPU under ``torchrun``, the
experts over the same ranks); a single process trains the whole batch.
The batches are drawn from ``numpy.random.RandomState(seed + step)``
where JAX draws with ``jax.random``: the same task, other sequences.

``--sweep OUT.json`` times every candidate all-to-all plan
(``planner.alltoall_plans``: flat, hierarchical NVLink + inter-node,
narrow inter-node wires, striped with ``--stripe-ratios``) across the
``--sweep-sizes-kb`` ladder on the world's ``(inter, intra)`` ranks, each
checked against ``comm.alltoall`` first (bit for bit, or within the
narrow wire's rounding), and writes ``allreduce_sweep/v1`` rows -- the
autotuner's schema, so ``autotune_from_rows`` builds the MoE exchange's
plan table from them.  ``--link-gbps nvlink=X,ib=Y`` adds the modeled
wire time; ``dcn_largest`` records the inter-node bytes of the flat and
the narrow hierarchical exchange at the largest size.

    python -m chainermn_tpu_torch.benchmarks.bench_moe --device cpu \\
        --out moe_bench.json
    torchrun --nproc_per_node 4 -m chainermn_tpu_torch.benchmarks.bench_moe \\
        --intra-size 2 --sweep alltoall_sweep.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

MOE_BENCH_SCHEMA = "moe_bench/v1"


def mixture_batch(rng, batch, seq, vocab, n_modes):
    """``[batch, seq]`` int64 tokens, each row following one of
    ``n_modes`` affine maps from a random first token."""
    mode = rng.randint(0, n_modes, size=batch)
    a = 2 * rng.randint(1, vocab // 2, size=n_modes) + 1
    c = rng.randint(0, vocab, size=n_modes)
    toks = np.empty((batch, seq), np.int64)
    toks[:, 0] = rng.randint(0, vocab, size=batch)
    for i in range(1, seq):
        toks[:, i] = (a[mode] * toks[:, i - 1] + c[mode]) % vocab
    return torch.from_numpy(toks)


def _train(model, stream, steps, lr, aux_weight, comm, rows):
    """SGD-with-momentum loop; the per-step cross entropy (the mean over
    the ranks, so the same on every rank) and the global parameter
    count."""
    from chainermn_tpu_torch.examples.train_moe_lm import (
        moe_loss, sum_replicated_gradients)
    from chainermn_tpu_torch.functions import allreduce
    import torch.nn.functional as F
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    dev = next(model.parameters()).device
    losses = []
    for i in range(steps):
        toks = stream(i)[rows].to(dev)
        opt.zero_grad(set_to_none=True)
        if model.moe_experts:
            loss, ce = moe_loss(model, toks, aux_weight, comm)[:2]
        else:
            logits = model(toks)
            ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                 toks[:, 1:].reshape(-1))
            if comm is not None:
                ce = allreduce(comm, ce, op="mean")
            loss = ce
        loss.backward()
        if comm is not None:
            sum_replicated_gradients(model, comm)
        opt.step()
        losses.append(float(ce.detach()))
    p = 1 if comm is None else comm.size
    from chainermn_tpu_torch.parallel.expert import expert_parameter_names
    local = expert_parameter_names(model)
    n_params = sum(v.numel() * (p if k in local else 1)
                   for k, v in model.named_parameters())
    return losses, n_params


def moe_bench(args):
    """``--out``: the matched-loss leg; returns the document."""
    import torch.distributed as dist
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.runtime.bootstrap import init_distributed
    created = not dist.is_initialized()
    topo = init_distributed(device=args.device)
    world = topo.size
    batch = args.batch_per_device * args.devices
    if batch % world or args.experts % world:
        raise ValueError(f"{world} ranks must divide the batch ({batch}) "
                         f"and --experts ({args.experts})")
    comm = create_communicator("naive", device=args.device) \
        if world > 1 else None
    per = batch // world
    rows = slice(topo.rank * per, (topo.rank + 1) * per)

    def stream(i):
        return mixture_batch(np.random.RandomState(args.seed + i), batch,
                             args.seq, args.vocab, args.modes)

    common = dict(vocab=args.vocab, d_model=args.d_model,
                  n_layers=args.layers, n_heads=args.heads,
                  max_len=args.seq, attention_impl="xla", device=topo.device)
    t0 = time.perf_counter()
    gen = lambda: torch.Generator(topo.device).manual_seed(args.seed)  # noqa
    moe = TransformerLM(moe_experts=args.experts, moe_top_k=1,
                        moe_comm=comm, generator=gen(), **common)
    moe_losses, moe_params = _train(moe, stream, args.steps, args.lr,
                                    args.aux_weight, comm, rows)
    dense = TransformerLM(generator=gen(), **common)
    dense_losses, dense_params = _train(dense, stream, args.steps, args.lr,
                                        0.0, comm, rows)
    tail = max(args.steps // 8, 1)       # a tail mean, not one lucky step
    moe_final = float(np.mean(moe_losses[-tail:]))
    dense_final = float(np.mean(dense_losses[-tail:]))
    doc = {"schema": MOE_BENCH_SCHEMA,
           "backend": topo.device.type,
           "n_devices": world,
           "task": {"kind": "affine_mixture", "vocab": args.vocab,
                    "seq": args.seq, "modes": args.modes, "batch": batch,
                    "steps": args.steps},
           "flop_matched": {"moe_top_k": 1, "experts": args.experts,
                            "comment": "top_k=1 routes each token "
                            "through exactly one expert of the same "
                            "hidden width as the dense MLP: identical "
                            "per-token MLP FLOPs, E x the parameters"},
           "moe": {"losses": [round(v, 4) for v in moe_losses],
                   "final_loss": round(moe_final, 4),
                   "n_params": moe_params},
           "dense": {"losses": [round(v, 4) for v in dense_losses],
                     "final_loss": round(dense_final, 4),
                     "n_params": dense_params},
           "moe_at_or_below_dense": moe_final <= dense_final,
           "elapsed_s": round(time.perf_counter() - t0, 1),
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    stamp_envelope(doc)
    if topo.rank == 0:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(doc, f, indent=2)
                f.write("\n")
        print(json.dumps({"moe_final": doc["moe"]["final_loss"],
                          "dense_final": doc["dense"]["final_loss"],
                          "moe_at_or_below_dense":
                              doc["moe_at_or_below_dense"]}), flush=True)
    if created:
        dist.destroy_process_group()
    return doc


SWEEP_SIZES_KB = "64,1024,4096"


def sweep(args) -> dict:
    """``--sweep``: every candidate all-to-all plan across the payload
    ladder (see the module note)."""
    from chainermn_tpu_torch.benchmarks.bench_allreduce import (
        card_line, parse_link_gbps, time_calls)
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    from chainermn_tpu_torch.planner import (
        SWEEP_SCHEMA, candidate_plans, execute_alltoall, load_plan,
        plan_dcn_bytes, plan_modeled_time_s)
    from chainermn_tpu_torch.planner.ir import dtype_itemsize

    comm = create_communicator("naive", intra_size=args.intra_size,
                               device=args.device)
    topo = comm.plan_topology()
    p = topo.size
    ratios = tuple(float(s) for s in args.stripe_ratios.split(",")) \
        if args.stripe_ratios else ()
    link_gbps = parse_link_gbps(args.link_gbps) if args.link_gbps else None
    plans = list(candidate_plans(topo, op="all-to-all",
                                 stripe_ratios=ratios))
    if args.plan:
        plans.append(load_plan(args.plan))
    dtype = getattr(torch, args.dtype)
    item = dtype_itemsize(args.dtype)
    rows, dcn_summary = [], []
    for kb in (float(s) for s in args.sweep_sizes_kb.split(",")):
        # the exchanged unit is this rank's [P, m] block buffer
        m = max(int(kb * 1024 / item) // p, 1)
        payload = p * m * item
        # values in [0, 1): inside every narrow wire's range
        g = torch.Generator().manual_seed(comm.rank)
        x = torch.rand((p, m), generator=g).to(dtype).to(comm.device)
        want = comm.alltoall(x)
        size_dcn = {}
        for plan in plans:
            def call(plan=plan):
                return execute_alltoall(plan, comm, x)

            got = call()
            narrow = any(st.wire_dtype not in (None, args.dtype)
                         for grp in plan.stage_groups()
                         for st in grp.stages)
            if narrow:
                # narrow wires round (bf16 ~2^-8 relative, fp8 ~2^-2)
                err = float((got.float() - want.float()).abs().max())
                assert err <= 0.12, (plan.name, err)
            else:
                assert torch.equal(got, want), plan.name
            dt = time_calls(call, comm, args.iters, args.warmup)
            dcn = plan_dcn_bytes(plan, topo, payload, dtype=args.dtype)
            row = {"topology": topo.key(), "dtype": args.dtype,
                   "bytes": payload, "plan": plan.name, "us": dt * 1e6,
                   "dcn_bytes": dcn, "plan_spec": plan.to_dict()}
            if link_gbps:
                modeled = plan_modeled_time_s(plan, topo, payload,
                                              link_gbps, dtype=args.dtype)
                row["us_measured"] = row["us"]
                row["us_modeled_wire"] = modeled * 1e6
                row["us"] = row["us"] + modeled * 1e6
            size_dcn[plan.name] = dcn
            rows.append(row)
        flat = size_dcn.get("alltoall_flat")
        bf16 = size_dcn.get("alltoall_hier_bfloat16_dcn")
        if flat and bf16:
            narrow = {n: b for n, b in size_dcn.items()
                      if n.startswith("alltoall_hier") and n.endswith("_dcn")}
            best = min(narrow, key=lambda n: narrow[n])
            dcn_summary.append({
                "bytes": payload, "flat_dcn_bytes": flat,
                "bf16_dcn_bytes": bf16, "bf16_shrink_x": flat / bf16,
                "best_narrow_plan": best,
                "best_narrow_dcn_bytes": narrow[best]})
    doc = {"schema": SWEEP_SCHEMA, "collective": "all-to-all",
           **card_line(comm), "n_devices": p, "topology": topo.key(),
           "timer": "event" if comm.device.type == "cuda" else "host",
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "rows": rows}
    if link_gbps:
        doc["link_gbps"] = link_gbps
    if ratios:
        doc["stripe_ratios"] = list(ratios)
    if dcn_summary:
        doc["dcn"] = dcn_summary
        doc["dcn_largest"] = max(dcn_summary, key=lambda r: r["bytes"])
    if comm.rank == 0:
        stamp_envelope(doc)
        with open(args.sweep, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(json.dumps({"rows": len(rows), "plans": len(plans),
                          "topology": topo.key()}), flush=True)
    return doc


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", metavar="OUT.json", default=None,
                   help="the all-to-all plan sweep mode (see the module "
                        "note)")
    p.add_argument("--sweep-sizes-kb", default=SWEEP_SIZES_KB,
                   help="comma-separated per-rank payload sizes in KiB")
    p.add_argument("--dtype", default="float32",
                   help="the swept exchange's dtype")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--intra-size", type=int, default=None)
    p.add_argument("--link-gbps", default=None, metavar="nvlink=X,ib=Y",
                   help="add the modeled wire time to each swept row")
    p.add_argument("--stripe-ratios", default=None,
                   help="comma-separated NVLink-stripe ratios adding "
                        "striped all-to-all candidates to the sweep")
    p.add_argument("--plan", metavar="PLAN.json", default=None,
                   help="also sweep this plan file")
    p.add_argument("--out", metavar="OUT.json", default=None,
                   help="matched-loss mode: write the moe_bench/v1 "
                        "document here")
    p.add_argument("--device", default=None,
                   help="cuda (the default, one card a rank) or cpu")
    p.add_argument("--devices", type=int, default=8,
                   help="the global batch is --batch-per-device x this")
    p.add_argument("--vocab", type=int, default=32)
    p.add_argument("--seq", type=int, default=16)
    p.add_argument("--d-model", type=int, default=16)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--modes", type=int, default=8)
    p.add_argument("--batch-per-device", type=int, default=8)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--aux-weight", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if bool(args.sweep) == bool(args.out):
        p.error("pass exactly one of --sweep or --out")
    if args.sweep:
        import torch.distributed as dist
        created = not dist.is_initialized()
        try:
            return sweep(args)
        finally:
            if created and dist.is_initialized():
                dist.destroy_process_group()
    return moe_bench(args)


if __name__ == "__main__":
    main()
