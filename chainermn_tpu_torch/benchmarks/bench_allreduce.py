"""Allreduce microbenchmark and the collective planner's sweep.

Counterpart of ``benchmarks/bench_allreduce.py``.  Three modes, on every rank
of the world (one GPU each under ``torchrun``; a world of one without it):

* default -- times ``allreduce_grad`` of one ``--mb`` MiB buffer per rank
  (rank r holds r everywhere, so the mean is ``(n - 1) / 2``) for each
  flavor of ``--communicators`` and reports the ring bus bandwidth
  ``2 (n - 1) / n * bytes / time``; ``--plan PLAN.json`` adds that plan
  through the executor as ``plan:<name>``; ``--scaling`` repeats it on
  sub-worlds of 2, 4, ... ranks (efficiency against the smallest);
* ``--sweep OUT.json`` -- times every candidate plan
  (``planner.candidate_plans``, plus ``--plan``) at each size of
  ``--sweep-sizes-kb``, each checked for the mean first, and writes
  ``allreduce_sweep/v1`` rows ``{topology, dtype, bytes, plan, us,
  dcn_bytes, plan_spec}`` -- what :func:`~chainermn_tpu_torch.planner.
  autotune_from_rows` turns into the plan table of ``create_communicator(
  "auto", plan_table=...)``.  ``--link-gbps nvlink=X,ib=Y`` adds the cost
  model's wire time (``planner.plan_modeled_time_s``) to each row, the raw
  time kept in ``us_measured``, as JAX's does;
* ``--census OUT.json`` -- runs every candidate plan once with the
  executor's collectives recorded (``planner.record_collectives``) and
  holds them, mapped onto JAX's HLO census kinds
  (``planner.census_of_record``: a default all-gather and a multicast are
  JAX's masked-psum ``all-reduce``), to ``planner.plan_census_kinds`` of
  the stages that issue a collective (a stage over one rank issues none,
  where JAX's census counts it);
* ``--traced OUT.json`` -- what the per-stage span hooks cost: the plan
  of the first ``--communicators`` flavor (``comm.plan()``, or
  ``--plan``) through ``execute_plan`` at ``--mb`` MiB, ``--repeats``
  interleaved pairs of an arm without observability and an arm with a
  flight recorder and ``pobs=get_plan_obs(comm)`` (a stream synchronize
  and an event at each stage edge), plus one
  ``TelemetryAggregator.collect`` a repeat amortized over ``--iters``
  calls into the on arm; writes ``tracing_overhead/v1`` with
  :func:`overhead_stats`' noise guard (the per-repeat paired overheads
  and their spread);
* ``--replay-spans FILE`` -- no device: feeds a span dump (a flight dump,
  a JSON event list or an event JSONL; JAX's ``"ici"``/``"dcn"`` read as
  ``"nvlink"``/``"ib"``) through the online tuner and writes the
  ``online_tune/v1`` re-tune decision (``--replay-topology``,
  ``--replay-table``, ``--replay-out``, ``--stripe-ratios``,
  ``--link-gbps`` for links the dump does not observe).

Times are the least of 3 medians over ``--iters`` calls, each call between
CUDA events on the card (NCCL; where the device waits on the host, the
host's time a call shows), the host's clock on the CPU (gloo; the times
there only validate the harness).
``--metrics PATH`` appends one record a flavor (``kind``
``bench_allreduce``, with the common envelope) to a metrics JSONL on rank
0, as JAX's does.

    python -m chainermn_tpu_torch.benchmarks.bench_allreduce --mb 64
    python -m chainermn_tpu_torch.benchmarks.bench_allreduce \\
        --sweep sweep.json
    python -m chainermn_tpu_torch.benchmarks.bench_allreduce \
        --communicators xla --allreduce-grad-dtype bfloat16 --mb 97.5 \
        --traced traced.json
    python -m chainermn_tpu_torch.benchmarks.bench_allreduce \
        --replay-spans tests/data/degraded_dcn_spans.json \
        --replay-out online_tune.json
    torchrun --nproc_per_node 4 -m \\
        chainermn_tpu_torch.benchmarks.bench_allreduce --intra-size 2 \\
        --sweep sweep4.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.observability.sinks import append_metrics
from chainermn_tpu_torch.planner.ir import dtype_itemsize


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mb", type=float, default=64.0,
                   help="payload size in MiB")
    p.add_argument("--dtype", default="float32",
                   help="gradient dtype before any communication cast")
    p.add_argument("--allreduce-grad-dtype", default=None,
                   help="communication dtype for the xla communicator")
    p.add_argument("--communicators", default="naive,xla,hierarchical",
                   help="comma-separated flavor list")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--intra-size", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' for a gloo world (default: this rank's GPU)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line per flavor")
    p.add_argument("--scaling", action="store_true",
                   help="time sub-worlds of 2, 4, ... ranks per flavor and "
                        "report the efficiency against the smallest")
    p.add_argument("--plan", metavar="PLAN.json", default=None,
                   help="also time this plan file through the executor")
    p.add_argument("--sweep", metavar="OUT.json", default=None,
                   help="sweep every candidate plan over --sweep-sizes-kb "
                        "and write allreduce_sweep/v1 rows")
    p.add_argument("--sweep-sizes-kb", default="4,64,1024,16384",
                   help="comma-separated payload sizes in KiB for --sweep")
    p.add_argument("--stripe-ratios", default=None,
                   help="comma-separated NVLink-stripe ratios adding "
                        "striped candidates to the sweep")
    p.add_argument("--link-gbps", default=None, metavar="nvlink=X,ib=Y",
                   help="add the cost model's wire time to each swept row")
    p.add_argument("--census", metavar="OUT.json", default=None,
                   help="record the collectives each candidate plan issues "
                        "and hold them to plan_census_kinds")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append one record per flavor to this metrics "
                        "JSONL (rank 0)")
    p.add_argument("--traced", metavar="OUT.json", default=None,
                   help="A/B the per-stage span hooks' cost on the first "
                        "flavor's plan and write tracing_overhead/v1")
    p.add_argument("--repeats", type=int, default=3,
                   help="interleaved off/on pairs for --traced (the least "
                        "of each arm is its time)")
    p.add_argument("--replay-spans", metavar="FILE", default=None,
                   help="feed a span dump through the online tuner and "
                        "write its re-tune decision (no device)")
    p.add_argument("--replay-topology", default="inter:2,intra:4",
                   metavar="KEY",
                   help="PlanTopology key the replayed spans were recorded "
                        "on")
    p.add_argument("--replay-table", metavar="FILE", default=None,
                   help="baseline plan table of the re-tune (default: "
                        "empty, i.e. the flat fallback plan)")
    p.add_argument("--replay-out", metavar="OUT.json", default=None,
                   help="write the --replay-spans document here (default: "
                        "stdout)")
    return p.parse_args(argv)


def parse_link_gbps(spec):
    """``"nvlink=300,ib=25"`` -> ``{"nvlink": 300.0, "ib": 25.0}``, the
    classes checked against ``planner.LINK_CLASS`` (a typo raises rather
    than pricing a link as free)."""
    from chainermn_tpu_torch.planner.compiler import validate_link_gbps
    out = {}
    for part in str(spec).split(","):
        if not part.strip():
            continue
        name, sep, val = part.partition("=")
        if not sep:
            raise ValueError(
                f"--link-gbps expects nvlink=X,ib=Y (GB/s), got {spec!r}")
        out[name.strip()] = float(val)
    if not out:
        raise ValueError(
            f"--link-gbps expects nvlink=X,ib=Y (GB/s), got {spec!r}")
    try:
        return validate_link_gbps(out)
    except ValueError as e:
        raise ValueError(f"--link-gbps: {e}") from None


def rank_buffer(comm, n_elems: int, dtype: str) -> torch.Tensor:
    """This rank's buffer: its rank everywhere (the mean is (n-1)/2)."""
    return torch.full((n_elems,), float(comm.rank),
                      dtype=getattr(torch, dtype), device=comm.device)


def time_calls(fn, comm, iters: int, warmup: int, rounds: int = 3) -> float:
    """Seconds a call of ``fn()``: the least of ``rounds`` medians, each
    over ``iters`` calls, a call between two CUDA events on the card (the
    host's clock on the CPU), with Python's garbage collector held off.
    A median drops the odd collection or preemption; the least round drops
    the card's slow start after an idle spell (a first round up to 15x
    the rest on a world of one).  Every rank times its own calls (the
    collectives keep them in step)."""
    import gc
    import statistics
    for _ in range(warmup):
        fn()
    cuda = comm.device.type == "cuda"
    best = float("inf")
    gc_was = gc.isenabled()
    gc.disable()
    try:
        for _ in range(rounds):
            if cuda:
                torch.cuda.synchronize(comm.device)
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(iters + 1)]
                marks[0].record()
                for ev in marks[1:]:
                    fn()
                    ev.record()
                marks[-1].synchronize()
                took = [a.elapsed_time(b) / 1e3
                        for a, b in zip(marks, marks[1:])]
            else:
                took = []
                for _ in range(iters):
                    h0 = time.perf_counter()
                    fn()
                    took.append(time.perf_counter() - h0)
            best = min(best, statistics.median(took))
    finally:
        if gc_was:
            gc.enable()
    return best


def check_mean(out, comm, what: str, rtol: float = 1e-2) -> None:
    """The mean of the ranks' buffers is (n - 1) / 2 everywhere."""
    want = (comm.size - 1) / 2.0
    got = out.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if err > rtol * max(abs(want), 1.0):
        raise AssertionError(f"{what}: mean off by {err} (want {want})")


def card_line(comm) -> dict:
    """The device the numbers were taken on (name and power limit on the
    card)."""
    if comm.device.type != "cuda":
        return {"backend": "cpu"}
    from chainermn_tpu_torch.utils.gpu_info import smi_line
    return {"backend": "cuda", "card": smi_line(comm.device.index or 0)}


def _write(path: str, doc: dict, comm) -> None:
    if comm.rank == 0:
        from chainermn_tpu_torch.observability.ledger import stamp_envelope
        stamp_envelope(doc)
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")


def sweep(args) -> dict:
    """``--sweep``: every candidate plan at every size (see the module
    note)."""
    from chainermn_tpu_torch.planner import (
        SWEEP_SCHEMA, candidate_plans, execute_plan, load_plan,
        plan_compressed_hops, plan_dcn_bytes, plan_modeled_time_s)
    comm = create_communicator("naive", intra_size=args.intra_size,
                               device=args.device)
    topo = comm.plan_topology()
    ratios = tuple(float(s) for s in args.stripe_ratios.split(",")) \
        if args.stripe_ratios else ()
    link_gbps = parse_link_gbps(args.link_gbps) if args.link_gbps else None
    plans = list(candidate_plans(topo, stripe_ratios=ratios))
    if args.plan:
        plans.append(load_plan(args.plan))
    item = dtype_itemsize(args.dtype)
    rows, dcn_summary = [], []
    for kb in (float(s) for s in args.sweep_sizes_kb.split(",")):
        n_elems = max(int(kb * 1024 / item), 1)
        payload = n_elems * item
        g = rank_buffer(comm, n_elems, args.dtype)
        size_dcn = {}
        for plan in plans:
            def call(plan=plan):
                return execute_plan(plan, comm, g)

            check_mean(call(), comm, f"plan {plan.name} at {payload} B")
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
            size_dcn[plan.name] = (dcn, bool(plan_compressed_hops(plan,
                                                                  topo)))
            rows.append(row)
            if comm.rank == 0:
                print(f"sweep {plan.name:>24} @ {payload:>10} B: "
                      f"{row['us']:.3f} us, inter-node {dcn:.1f} B",
                      file=sys.stderr)
        compressed = {p: b for p, (b, q) in size_dcn.items() if q and b}
        base = size_dcn.get("flat_bfloat16",
                            size_dcn.get("flat", (None, False)))[0]
        if compressed and base:
            best = min(compressed, key=lambda p: compressed[p])
            dcn_summary.append({
                "bytes": payload,
                "baseline_plan": ("flat_bfloat16" if "flat_bfloat16"
                                  in size_dcn else "flat"),
                "baseline_dcn_bytes": base,
                "best_compressed_plan": best,
                "best_compressed_dcn_bytes": compressed[best],
                "shrink_x": base / compressed[best]})
    doc = {"schema": SWEEP_SCHEMA, **card_line(comm), "n_devices": comm.size,
           "topology": topo.key(),
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
    _write(args.sweep, doc, comm)
    if comm.rank == 0:
        print(json.dumps({"rows": len(rows), "plans": len(plans),
                          "topology": topo.key()}), flush=True)
    return doc


def census(args) -> dict:
    """``--census``: the collectives each candidate plan issues, mapped
    onto JAX's census kinds, against ``plan_census_kinds``."""
    from chainermn_tpu_torch.planner import (
        candidate_plans, census_of_record, execute_plan, flavor_plan,
        load_plan, record_collectives)
    from chainermn_tpu_torch.planner.compiler import issued_census_kinds
    comm = create_communicator("naive", intra_size=args.intra_size,
                               device=args.device)
    topo = comm.plan_topology()
    n_elems = max(int(args.mb * (1 << 20) / dtype_itemsize(args.dtype)), 1)
    g = rank_buffer(comm, n_elems, args.dtype)
    plans = list(candidate_plans(topo))
    names = {p.name for p in plans}
    plans += [flavor_plan(f) for f in ("single_node", "non_cuda_aware")
              if f not in names and (f != "single_node"
                                     or topo.inter_size == 1)]
    if args.plan:
        plans.append(load_plan(args.plan))
    doc = {"suite": "collective_census", **card_line(comm),
           "n_devices": comm.size, "topology": topo.key(),
           "payload_mib": args.mb, "plans": {}}
    for plan in plans:
        with record_collectives() as rec:
            out = execute_plan(plan, comm, g)
        check_mean(out, comm, f"plan {plan.name}")
        issued = list(census_of_record(rec))
        want = list(issued_census_kinds(plan, topo))
        doc["plans"][plan.name] = {"issued": [c for c, _ in rec],
                                   "census": issued, "expected": want,
                                   "match": issued == want}
    doc["all_match"] = all(v["match"] for v in doc["plans"].values())
    _write(args.census, doc, comm)
    if comm.rank == 0:
        print(json.dumps({k: v["census"] for k, v in doc["plans"].items()}),
              flush=True)
    if not doc["all_match"]:
        raise AssertionError(
            "issued collectives differ from plan_census_kinds: " +
            json.dumps({k: v for k, v in doc["plans"].items()
                        if not v["match"]}))
    return doc


def load_events(path):
    """Events of a flight dump (``{"events": [...]}``), a JSON event list
    or an event JSONL; undecodable JSONL lines are skipped."""
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head in ("[", "{"):
            try:
                doc = json.load(f)
            except json.JSONDecodeError:
                doc = None
            if isinstance(doc, list):
                return doc
            if isinstance(doc, dict):
                return list(doc.get("events", []))
            f.seek(0)
        events = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return events


def replay(args) -> dict:
    """``--replay-spans``: reproduce an online re-tune decision offline,
    through the SAME observation store and decision path the live loop
    uses (``planner.online.OnlineTuner``): completed ``plan_stage`` spans
    become observed per-link rates, the candidate zoo is re-priced at
    those rates, and the document records whether the tuner would swap
    and at what modeled speedup.  Deterministic and device-free."""
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    from chainermn_tpu_torch.planner.autotune import PlanTable
    from chainermn_tpu_torch.planner.ir import PlanTopology
    from chainermn_tpu_torch.planner.online import (
        ONLINE_TUNE_SCHEMA, OnlineTuner)
    from chainermn_tpu_torch.planner.plans import STRIPE_RATIOS

    events = load_events(args.replay_spans)
    topology = PlanTopology.from_key(args.replay_topology)
    ratios = STRIPE_RATIOS if args.stripe_ratios is None else tuple(
        float(r) for r in str(args.stripe_ratios).split(",") if r.strip())
    fallback = parse_link_gbps(args.link_gbps) if args.link_gbps else None
    table = PlanTable.load(args.replay_table) if args.replay_table else None
    tuner = OnlineTuner(topology=topology, dtype=args.dtype, table=table,
                        stripe_ratios=ratios, fallback_gbps=fallback,
                        min_samples=1)
    n_spans = tuner.ingest(events)
    regressions = [e for e in events
                   if e.get("kind") == "attribution_regression"]
    tuner.on_regression(regressions)
    decision = tuner.retune()
    doc = {
        "schema": ONLINE_TUNE_SCHEMA,
        "source": os.path.basename(args.replay_spans),
        "topology": topology.key(),
        "dtype": args.dtype,
        "n_events": len(events),
        "n_spans": n_spans,
        "regression_events": len(regressions),
        "observed_gbps": tuner.observations.observed_gbps(1),
        "timestamp": time.time(),
        "retune": None,
    }
    if decision is not None:
        doc["retune"] = {k: decision[k] for k in (
            "best_speedup", "swap", "threshold", "table_hash",
            "rows_merged", "cells")}
    stamp_envelope(doc)
    blob = json.dumps(doc, indent=2) + "\n"
    if args.replay_out:
        with open(args.replay_out, "w") as f:
            f.write(blob)
        best = (doc["retune"] or {}).get("best_speedup")
        print(f"replay: {n_spans} plan-stage spans, observed "
              f"{doc['observed_gbps']}, retune_speedup="
              f"{best if best is not None else 'n/a'} "
              f"-> {args.replay_out}", file=sys.stderr)
    else:
        print(blob, end="")
    return doc


def overhead_stats(off_s, on_s, collect_s_per_iter=0.0):
    """Noise-aware summary of a paired A/B overhead measurement.

    ``off_s``/``on_s`` are per-repeat times (seconds per iteration) for
    the instrumented-off and instrumented-on arms; ``collect_s_per_iter``
    is amortized into every on-arm sample.  Returns the published
    ``tracing_overhead_pct`` plus the honesty fields:

    * ``raw_overhead_pct`` — the min-vs-min center, sign preserved;
    * ``per_repeat_pct`` — the paired overhead of each repeat (repeat i's
      on arm vs repeat i's off arm), the spread's raw material;
    * ``spread_pct`` — max-min across the paired repeats;
    * ``noise_dominated`` — True when the spread swallows the center
      (spread >= max(|center|, 1.0)) **or** the center is negative:
      tracing cannot make the program faster, so a negative center is a
      measurement-noise artifact, not a win.  When set, the published
      pct is clamped at 0 instead of advertising the artifact.
    """
    off_s = [float(t) for t in off_s]
    on_s = [float(t) + float(collect_s_per_iter) for t in on_s]
    if not off_s or not on_s:
        raise ValueError("overhead_stats needs at least one repeat "
                         "per arm")
    per_repeat = [(on - off) / off * 100.0
                  for off, on in zip(off_s, on_s)]
    center = (min(on_s) - min(off_s)) / min(off_s) * 100.0
    spread = (max(per_repeat) - min(per_repeat)) \
        if len(per_repeat) > 1 else 0.0
    noise_dominated = spread >= max(abs(center), 1.0) or center < 0.0
    published = max(center, 0.0) if noise_dominated else center
    return {
        "tracing_overhead_pct": round(published, 3),
        "raw_overhead_pct": round(center, 3),
        "per_repeat_pct": [round(p, 3) for p in per_repeat],
        "spread_pct": round(spread, 3),
        "noise_dominated": noise_dominated,
    }


def traced(args) -> dict:
    """``--traced``: what the per-stage span hooks cost (see the module
    note).  Both arms run the same plan through ``execute_plan``; the on
    arm adds the flight recorder and the stage hook, which synchronizes
    the stream and records an event at each stage edge.  Each arm's time
    is the least over ``--repeats`` of :func:`time_calls`, and
    :func:`overhead_stats` guards the published overhead against the
    pairs' spread."""
    from chainermn_tpu_torch.observability import flight_recorder as _flight
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    from chainermn_tpu_torch.observability.spans import get_plan_obs
    from chainermn_tpu_torch.observability.streaming import \
        TelemetryAggregator
    from chainermn_tpu_torch.planner import execute_plan, load_plan

    flavor = args.communicators.split(",")[0]
    kw = {}
    if args.allreduce_grad_dtype and flavor in ("xla", "pure_nccl"):
        kw["allreduce_grad_dtype"] = args.allreduce_grad_dtype
    comm = create_communicator(flavor, intra_size=args.intra_size,
                               device=args.device, **kw)
    plan = load_plan(args.plan) if args.plan else comm.plan()
    n_elems = int(args.mb * (1 << 20) / dtype_itemsize(args.dtype))
    g = rank_buffer(comm, n_elems, args.dtype)

    def run_arm(pobs):
        def call():
            return execute_plan(plan, comm, g, pobs=pobs)
        check_mean(call(), comm, f"--traced plan {plan.name}")
        return time_calls(call, comm, args.iters, args.warmup)

    had_recorder = _flight.get_flight_recorder() is not None
    times = {"off": [], "on": []}
    collects = []
    events_recorded = 0
    try:
        for i in range(max(int(args.repeats), 1)):
            if not had_recorder:
                _flight.reset_flight_recorder()
            times["off"].append(run_arm(None))
            fr = _flight.install_flight_recorder()
            before = len(fr.snapshot()) + fr.dropped_events
            times["on"].append(run_arm(get_plan_obs(comm)))
            events_recorded = len(fr.snapshot()) + fr.dropped_events \
                - before
            # the streaming window ride-along: one telemetry collect an
            # emit interval (= iters calls), amortized into the on arm
            agg = TelemetryAggregator(comm)
            c0 = time.perf_counter()
            agg.collect(i)
            collects.append(time.perf_counter() - c0)
    finally:
        if not had_recorder:
            _flight.reset_flight_recorder()
    if events_recorded <= 0:
        raise AssertionError("--traced: the traced arm recorded no "
                             "plan_stage events; the A/B is meaningless")
    collect_s = min(collects)
    per_iter_collect = collect_s / max(int(args.iters), 1)
    stats = overhead_stats(times["off"], times["on"], per_iter_collect)
    doc = {"schema": "tracing_overhead/v1", **card_line(comm),
           "n_devices": comm.size,
           "communicator": flavor,
           "plan": plan.name,
           "payload_mib": args.mb,
           "iters": args.iters,
           "repeats": args.repeats,
           "timer": "event" if comm.device.type == "cuda" else "host",
           "time_ms_off": round(min(times["off"]) * 1e3, 4),
           "time_ms_on": round((min(times["on"]) + per_iter_collect)
                               * 1e3, 4),
           "times_ms_off": [t * 1e3 for t in times["off"]],
           "times_ms_on": [t * 1e3 for t in times["on"]],
           "streaming_collect_ms": round(collect_s * 1e3, 4),
           "events_per_traced_run": events_recorded,
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    doc.update(stats)
    if comm.rank == 0:
        stamp_envelope(doc, n_devices=comm.size, backend=doc["backend"])
        if stats["noise_dominated"]:
            print(f"--traced: noise-dominated measurement (center "
                  f"{stats['raw_overhead_pct']}%, spread "
                  f"{stats['spread_pct']}% over {len(times['off'])} "
                  f"repeats) -- publishing clamped overhead "
                  f"{stats['tracing_overhead_pct']}%", file=sys.stderr)
        with open(args.traced, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(json.dumps({k: doc[k] for k in (
            "tracing_overhead_pct", "noise_dominated", "time_ms_off",
            "time_ms_on")}), flush=True)
    return doc


def flavors(args) -> list:
    """The default mode: each flavor's ``allreduce_grad`` (and ``--plan``)
    timed at ``--mb`` MiB (see the module note)."""
    from chainermn_tpu_torch.planner import execute_plan, load_plan
    base = create_communicator("naive", intra_size=args.intra_size,
                               device=args.device)
    world = base.size
    counts = [world]
    if args.scaling:
        counts = [c for c in (2 ** k for k in range(1, 12)) if c < world]
        counts.append(world)
    n_elems = int(args.mb * (1 << 20) / dtype_itemsize(args.dtype))
    names = args.communicators.split(",")
    plan = load_plan(args.plan) if args.plan else None
    if plan is not None:
        names.append(f"plan:{plan.name}")
    rows, first = [], {}
    for name in names:
        flavor = "naive" if name.startswith("plan:") else name
        kw = {}
        if args.allreduce_grad_dtype and flavor in ("xla", "pure_nccl"):
            kw["allreduce_grad_dtype"] = args.allreduce_grad_dtype
        for count in counts:
            if count == world:
                try:
                    comm = create_communicator(
                        flavor, intra_size=args.intra_size,
                        device=args.device, **kw)
                except ValueError as e:
                    if base.rank == 0:
                        print(f"{name}@{count}: skipped ({e})",
                              file=sys.stderr)
                    continue
            else:
                # every rank builds the sub-worlds (collective); ranks past
                # the count sit this size out
                sub = base.split(int(base.rank >= count), base.rank)
                if base.rank >= count:
                    continue
                comm = sub
            g = rank_buffer(comm, n_elems, args.dtype)
            if plan is not None and name.startswith("plan:"):
                def call(comm=comm, g=g):
                    return execute_plan(plan, comm, g)
            else:
                def call(comm=comm, g=g):
                    return comm.allreduce_grad(g)
            check_mean(call(), comm, name)
            dt = time_calls(call, comm, args.iters, args.warmup)
            n = comm.size
            payload = n_elems * dtype_itemsize(args.dtype)
            busbw = 2 * (n - 1) / n * payload / dt / 1e9
            row = {"communicator": name, "devices": n,
                   "payload_mib": payload / (1 << 20),
                   "time_ms": dt * 1e3, "busbw_gbps": busbw,
                   **card_line(comm)}
            if args.scaling:
                first.setdefault(name, (n, busbw))
                bn, bb = first[name]
                row["efficiency_vs"] = bn
                row["scaling_efficiency"] = busbw / bb if bb else None
            rows.append(row)
            if comm.rank == 0:
                if args.metrics:
                    append_metrics(args.metrics, row, "bench_allreduce")
                if args.json:
                    print(json.dumps(row), flush=True)
                else:
                    print(f"{name:>16}: {n} ranks, {row['payload_mib']} "
                          f"MiB, {row['time_ms']:.3f} ms, "
                          f"{busbw:.2f} GB/s bus", file=sys.stderr)
    return rows


def main(argv=None):
    args = parse_args(argv)
    if args.replay_spans:
        # the replay touches no device: it runs before any process group
        return replay(args)
    import torch.distributed as dist
    created = not dist.is_initialized()
    try:
        if args.traced:
            return traced(args)
        if args.census:
            return census(args)
        if args.sweep:
            return sweep(args)
        return flavors(args)
    finally:
        # a process group this call created goes with it
        if created and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
