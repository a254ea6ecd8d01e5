"""perf_gate -- fail loudly when a tracked benchmark regresses.

Counterpart of the JAX package's ``tools/perf_gate.py``, over the port's
planner and run ledger; every mode exits nonzero on a gate failure::

    python -m chainermn_tpu_torch.tools.perf_gate --budgets BUDGETS.json
    python -m chainermn_tpu_torch.tools.perf_gate --planner SWEEP.json \
        [--table plan_table.json] [--require-striped N] [--out G.json]
    python -m chainermn_tpu_torch.tools.perf_gate --online-tune OT.json
    python -m chainermn_tpu_torch.tools.perf_gate --joint JOINT.json
    python -m chainermn_tpu_torch.tools.perf_gate --serving SERVING.json
    python -m chainermn_tpu_torch.tools.perf_gate --moe SWEEP.json \
        [--moe-bench MOE_BENCH.json] [--table t.json]
    python -m chainermn_tpu_torch.tools.perf_gate --elastic ELASTIC.json
    python -m chainermn_tpu_torch.tools.perf_gate --ledger LEDGER.json

1. ``--budgets``: the newest artifact matching each budget's glob (under
   ``--root``, the repo root by default) against its budget, with
   ``max_regression_pct`` slack; a missing artifact is skipped unless
   ``--strict``.
2. ``--planner``: autotune a ``bench_allreduce --sweep`` artifact and pass
   only if the tuned table strictly beats the best fixed flavor somewhere
   (and, with ``--require-striped N``, striped plans win N cells).
3. ``--online-tune``: the online tuner's replay must decide to swap with a
   modeled speedup at or above ``--retune-threshold`` and pin a hash.
4. ``--joint``: the joint schedule must beat independent tuning by
   ``--joint-threshold`` and change at least one slot's plan.
5. ``--serving``: strict serving floors (prefix-cache speedup, spec
   tokens per verify pass, session affinity).
6. ``--moe``: hierarchical all-to-all wins, the narrow inter-node wire's
   byte shrink and (``--moe-bench``) the matched-loss leg.
7. ``--elastic``: an ``elastic_smoke/v1`` artifact's async stall below the
   sync stall (and below the ``async_ckpt_stall_ms`` budget when the
   budgets file has one), at most ``elastic_resume_lost_steps`` lost
   steps, both legs' own checks green and a flight dump in the restart
   manifest.
8. ``--ledger``: budget check with longitudinal baselines from the run
   ledger, chosen only among records of the same ``(device_kind,
   schema)`` cell: an H100 run is never held to a TPU's or a CPU host's
   floor, nor the other way.

The floors default to :file:`perf_budgets.json` beside this module: the
port's own, holding the ratio and rule criteria and only such time or
throughput floors as the card has measured itself (each names the card
and its power limit).  The JAX package's budgets are TPU and CPU-host
readings and are never the port's.
"""

import argparse
import glob
import json
import os
import sys

# the repository root (budget artifact globs resolve under it)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BUDGETS_SCHEMA = "perf_budgets/v1"
PLANNER_GATE_SCHEMA = "planner_gate/v1"
ONLINE_TUNE_SCHEMA = "online_tune/v1"
SERVING_SCHEMA = "bench_serving/v2"
MOE_GATE_SCHEMA = "moe_gate/v1"
MOE_BENCH_SCHEMA = "moe_bench/v1"
LEDGER_GATE_SCHEMA = "ledger_gate/v1"
JOINT_SWEEP_SCHEMA = "joint_sweep/v1"
ELASTIC_SCHEMA = "elastic_smoke/v1"
FLAT_ALLTOALL = "alltoall_flat"


def _dig(doc, dotted):
    """Resolve a dotted key path ('parsed.value') into a JSON doc."""
    cur = doc
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            raise KeyError(
                f"key path {dotted!r} broke at {part!r} "
                f"(have: {sorted(cur) if isinstance(cur, dict) else cur!r})")
        cur = cur[part]
    return float(cur)


def check_budgets(args):
    with open(args.budgets) as f:
        budgets = json.load(f)
    if budgets.get("schema") != BUDGETS_SCHEMA:
        print(f"perf_gate: unsupported budgets schema "
              f"{budgets.get('schema')!r} (want {BUDGETS_SCHEMA!r})",
              file=sys.stderr)
        return 2
    max_reg = float(args.max_regression_pct
                    if args.max_regression_pct is not None
                    else budgets.get("max_regression_pct", 3.0))
    root = args.root or _REPO
    rows = []
    failed = 0
    for m in budgets.get("metrics", []):
        matches = sorted(glob.glob(os.path.join(root, m["artifact"])),
                         key=os.path.getmtime)
        row = {"name": m["name"], "artifact": m["artifact"],
               "unit": m.get("unit"), "budget": float(m["budget"])}
        if not matches:
            row["status"] = "missing"
            if args.strict:
                failed += 1
        else:
            row["path"] = os.path.relpath(matches[-1], root)
            try:
                value = _dig(json.load(open(matches[-1])), m["key"])
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                row["status"] = f"unreadable: {e}"
                failed += 1
                rows.append(row)
                continue
            row["value"] = value
            # metrics default to higher-is-better throughputs; a metric
            # with "direction": "lower" (wire bytes, latency) regresses
            # when the value climbs ABOVE budget instead
            direction = m.get("direction", "higher")
            if direction not in ("higher", "lower"):
                row["status"] = f"bad direction {direction!r}"
                failed += 1
                rows.append(row)
                continue
            row["direction"] = direction
            if direction == "lower":
                reg = (value - row["budget"]) / row["budget"] * 100.0
            else:
                reg = (row["budget"] - value) / row["budget"] * 100.0
            row["regression_pct"] = round(reg, 2)
            if reg > max_reg:
                row["status"] = "FAIL"
                failed += 1
            else:
                row["status"] = "ok"
        rows.append(row)
        print(f"perf_gate {row['status']:>9} {row['name']}: "
              f"value={row.get('value', '-')} budget={row['budget']} "
              f"({row.get('regression_pct', '-')}% vs {max_reg}% allowed)",
              file=sys.stderr)
    report = {"schema": BUDGETS_SCHEMA, "max_regression_pct": max_reg,
              "root": root, "metrics": rows,
              "ok": failed == 0}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps({"ok": report["ok"], "failed": failed,
                      "checked": len(rows)}), flush=True)
    return 0 if failed == 0 else 1


def planner_gate(args):
    from chainermn_tpu_torch.planner import (
        SWEEP_SCHEMA, autotune_from_rows, validate_sweep_rows)

    with open(args.planner) as f:
        sweep = json.load(f)
    if sweep.get("schema") != SWEEP_SCHEMA:
        print(f"perf_gate: unsupported sweep schema "
              f"{sweep.get('schema')!r} (want {SWEEP_SCHEMA!r})",
              file=sys.stderr)
        return 2
    rows = sweep.get("rows", [])
    validate_sweep_rows(rows)
    table, comparison = autotune_from_rows(rows)
    wins = [c for c in comparison
            if c["speedup"] is not None and c["speedup"] > 1.0]
    striped_wins = [c for c in comparison
                    if c.get("striped_speedup") is not None
                    and c["striped_speedup"] > 1.0]
    for c in comparison:
        speedup = c["speedup"]
        if speedup is None:
            print(f"perf_gate      {c['topology']} {c['dtype']} "
                  f"{c['bucket']}: no fixed baseline in sweep",
                  file=sys.stderr)
            continue
        mark = "WIN " if speedup > 1.0 else "    "
        stripe = ""
        if c.get("striped_speedup") is not None:
            stripe = (f" [striped beats best single "
                      f"{c['best_single_plan']} x{c['striped_speedup']:.3f}]")
        print(f"perf_gate {mark} {c['topology']} {c['dtype']} "
              f"{c['bucket']:>9}: tuned={c['tuned_plan']} "
              f"({c['tuned_us']:.1f} us) vs best_fixed="
              f"{c['best_fixed_plan']} ({c['best_fixed_us']:.1f} us) "
              f"speedup={speedup:.3f}{stripe}", file=sys.stderr)
    ok = bool(wins)
    if args.require_striped:
        ok = ok and len(striped_wins) >= args.require_striped
    table.meta.update({"sweep": os.path.basename(args.planner),
                       "backend": sweep.get("backend"),
                       "n_devices": sweep.get("n_devices")})
    if args.table:
        table.save(args.table)
        print(f"perf_gate: plan table ({len(table.entries)} cells) "
              f"-> {args.table}", file=sys.stderr)
    artifact = {"schema": PLANNER_GATE_SCHEMA,
                "sweep": os.path.basename(args.planner),
                "backend": sweep.get("backend"),
                "n_devices": sweep.get("n_devices"),
                "topology": sweep.get("topology"),
                "cells": comparison,
                "tuned_wins": len(wins),
                "striped": {
                    "wins": len(striped_wins),
                    "best_speedup": (max(c["striped_speedup"]
                                         for c in striped_wins)
                                     if striped_wins else None),
                    "required": args.require_striped,
                },
                "ok": ok}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
            f.write("\n")
    print(json.dumps({"ok": ok, "tuned_wins": len(wins),
                      "striped_wins": len(striped_wins),
                      "cells": len(comparison)}), flush=True)
    if not ok:
        if args.require_striped and len(striped_wins) < args.require_striped:
            print(f"perf_gate: FAIL — striped plans win only "
                  f"{len(striped_wins)} cell(s), gate requires "
                  f"{args.require_striped}; link striping is not paying "
                  f"for itself on this topology", file=sys.stderr)
        else:
            print("perf_gate: FAIL — tuned table never beats the best "
                  "fixed flavor; autotuning is not paying for itself on "
                  "this topology", file=sys.stderr)
    return 0 if ok else 1


def online_tune_gate(args):
    """Gate a ``bench_allreduce --replay-spans`` artifact: the online
    tuner replaying the committed degraded-link span dump must decide to
    swap, with a modeled retune speedup at or above ``--retune-threshold``
    — the "re-tuning must pay for itself" acceptance criterion for the
    attribution-closed loop."""
    with open(args.online_tune) as f:
        doc = json.load(f)
    if doc.get("schema") != ONLINE_TUNE_SCHEMA:
        print(f"perf_gate: unsupported online-tune schema "
              f"{doc.get('schema')!r} (want {ONLINE_TUNE_SCHEMA!r})",
              file=sys.stderr)
        return 2
    threshold = float(args.retune_threshold)
    retune = doc.get("retune")
    problems = []
    if not isinstance(retune, dict):
        problems.append("no retune decision in artifact (tuner saw no "
                        "observations?)")
        retune = {}
    best = retune.get("best_speedup")
    if best is None:
        problems.append("retune.best_speedup missing")
    elif float(best) < threshold:
        problems.append(f"retune.best_speedup {float(best):.3f} below "
                        f"gate threshold {threshold}")
    if not retune.get("swap"):
        problems.append("tuner declined to swap (retune.swap falsy)")
    if not retune.get("table_hash"):
        problems.append("retune.table_hash missing — swapped table "
                        "would not be pinnable in checkpoint sidecars")
    for c in retune.get("cells", []):
        sp = c.get("speedup")
        sp_s = f"x{sp:.3f}" if sp is not None else "(no speedup)"
        print(f"perf_gate      {c.get('topology')} {c.get('dtype')} "
              f"{str(c.get('bucket')):>9}: {c.get('old_plan')} -> "
              f"{c.get('new_plan')} {sp_s}", file=sys.stderr)
    ok = not problems
    report = {"schema": ONLINE_TUNE_SCHEMA + "+gate",
              "artifact": os.path.basename(args.online_tune),
              "threshold": threshold,
              "best_speedup": best,
              "swap": bool(retune.get("swap")),
              "table_hash": retune.get("table_hash"),
              "problems": problems,
              "ok": ok}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps({"ok": ok, "best_speedup": best,
                      "threshold": threshold}), flush=True)
    if not ok:
        for p in problems:
            print(f"perf_gate: FAIL — {p}", file=sys.stderr)
    return 0 if ok else 1


def joint_gate(args):
    """Gate a ``bench_joint`` artifact: the jointly-tuned workload must
    beat independent per-communicator tuning by ``--joint-threshold``
    under the shared-link model, AND change at least one slot's plan —
    the ceded-link acceptance criterion for the global collective
    scheduler (a "joint win" that picks the same plans everywhere is
    just the independent tuner with extra steps)."""
    with open(args.joint) as f:
        doc = json.load(f)
    if doc.get("schema") != JOINT_SWEEP_SCHEMA:
        print(f"perf_gate: unsupported joint-sweep schema "
              f"{doc.get('schema')!r} (want {JOINT_SWEEP_SCHEMA!r})",
              file=sys.stderr)
        return 2
    threshold = float(args.joint_threshold)
    cmp = doc.get("comparison")
    problems = []
    if not isinstance(cmp, dict):
        problems.append("no comparison block in artifact")
        cmp = {}
    speedup = cmp.get("speedup")
    if speedup is None:
        problems.append("comparison.speedup missing")
    elif float(speedup) < threshold:
        problems.append(f"comparison.speedup {float(speedup):.4f} below "
                        f"gate threshold {threshold} — joint tuning "
                        f"does not pay for itself on this workload")
    changed = cmp.get("changed_slots", [])
    if not changed:
        problems.append("comparison.changed_slots empty — the joint "
                        "schedule picked the independently-tuned plans "
                        "(no ceded-link decision to gate)")
    if not cmp.get("signature"):
        problems.append("comparison.signature missing — joint table "
                        "entry would not be recallable by workload")
    ind = cmp.get("independent", {})
    joint = cmp.get("joint", {})
    for row in cmp.get("slots", []):
        name = row.get("slot")
        mark = " *" if name in changed else ""
        print(f"perf_gate      slot {str(name):>10}: "
              f"{row.get('independent_plan')} -> "
              f"{row.get('joint_plan')}{mark}", file=sys.stderr)
    ind_s, joint_s = ind.get("modeled_s"), joint.get("modeled_s")
    if ind_s is not None and joint_s is not None:
        print(f"perf_gate      workload {cmp.get('signature')}: "
              f"independent {float(ind_s):.6f}s -> joint "
              f"{float(joint_s):.6f}s", file=sys.stderr)
    ok = not problems
    report = {"schema": JOINT_SWEEP_SCHEMA + "+gate",
              "artifact": os.path.basename(args.joint),
              "threshold": threshold,
              "speedup": speedup,
              "changed_slots": changed,
              "signature": cmp.get("signature"),
              "problems": problems,
              "ok": ok}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps({"ok": ok, "speedup": speedup,
                      "changed_slots": changed,
                      "threshold": threshold}), flush=True)
    if not ok:
        for p in problems:
            print(f"perf_gate: FAIL — {p}", file=sys.stderr)
    return 0 if ok else 1


def serving_gate(args):
    """Gate a ``bench_serving`` artifact against the serving floors in
    the budgets file.  Unlike budget mode, the floors are STRICT — no
    ``max_regression_pct`` slack: ``prefix.speedup`` at or above the
    ``serving_prefix_cache_speedup`` budget and
    ``spec.accept_tokens_per_step`` strictly above the
    ``serving_spec_accept_tokens_per_step`` budget.  The sections must
    be present (run the bench with ``--prefix-share`` and ``--spec-k``);
    a fleet section additionally pins the session-affinity invariant."""
    with open(args.serving) as f:
        doc = json.load(f)
    if doc.get("schema") != SERVING_SCHEMA:
        print(f"perf_gate: unsupported serving schema "
              f"{doc.get('schema')!r} (want {SERVING_SCHEMA!r})",
              file=sys.stderr)
        return 2
    floors_path = args.floors or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "perf_budgets.json")
    with open(floors_path) as f:
        budgets = json.load(f)
    floor = {m["name"]: float(m["budget"])
             for m in budgets.get("metrics", [])}
    problems = []
    checks = []

    def _check(name, key, bound, strict):
        try:
            value = _dig(doc, key)
        except KeyError:
            problems.append(f"{key} missing from artifact — rerun "
                            f"bench_serving.py with the section enabled")
            checks.append({"name": name, "key": key, "floor": bound,
                           "value": None, "ok": False})
            return
        ok = value > bound if strict else value >= bound
        if not ok:
            op = ">" if strict else ">="
            problems.append(f"{key} = {value:.3f}, floor requires "
                            f"{op} {bound}")
        checks.append({"name": name, "key": key, "floor": bound,
                       "value": value, "ok": ok})
        print(f"perf_gate {'ok' if ok else 'FAIL':>9} {name}: "
              f"value={value:.3f} floor={bound}", file=sys.stderr)

    _check("serving_prefix_cache_speedup", "prefix.speedup",
           floor.get("serving_prefix_cache_speedup", 1.3), strict=False)
    _check("serving_spec_accept_tokens_per_step",
           "spec.accept_tokens_per_step",
           floor.get("serving_spec_accept_tokens_per_step", 1.0),
           strict=True)
    if "fleet" in doc and not doc["fleet"].get("session_affinity_ok"):
        problems.append("fleet.session_affinity_ok is false — a session "
                        "was served by more than one replica")
    ok = not problems
    report = {"schema": SERVING_SCHEMA + "+gate",
              "artifact": os.path.basename(args.serving),
              "floors": floors_path,
              "checks": checks,
              "problems": problems,
              "ok": ok}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps({"ok": ok,
                      "checked": len(checks)}), flush=True)
    if not ok:
        for p in problems:
            print(f"perf_gate: FAIL — {p}", file=sys.stderr)
    return 0 if ok else 1


def moe_gate(args):
    """Gate a ``bench_moe --sweep`` artifact: the hierarchical all-to-all
    dispatch must strictly beat the flat lowering in enough cells, the
    bf16-DCN wire must shrink cross-slice bytes at the largest payload,
    and (with ``--moe-bench``) the FLOP-matched MoE run must match or
    beat the dense baseline's final loss."""
    from chainermn_tpu_torch.planner import (
        SWEEP_SCHEMA, autotune_from_rows, validate_sweep_rows)

    with open(args.moe) as f:
        sweep = json.load(f)
    if sweep.get("schema") != SWEEP_SCHEMA:
        print(f"perf_gate: unsupported sweep schema "
              f"{sweep.get('schema')!r} (want {SWEEP_SCHEMA!r})",
              file=sys.stderr)
        return 2
    rows = sweep.get("rows", [])
    validate_sweep_rows(rows)
    problems = []

    # per (topology, dtype, bytes) cell: mean us per plan, tuned = min,
    # baseline = alltoall_flat in the same cell
    cells = {}
    for r in rows:
        key = (r["topology"], r["dtype"], int(r["bytes"]))
        cells.setdefault(key, {}).setdefault(r["plan"], []).append(
            float(r["us"]))
    comparison = []
    wins = []
    for (topo, dtype, nbytes), by_plan in sorted(cells.items()):
        means = {p: sum(v) / len(v) for p, v in by_plan.items()}
        tuned_plan = min(means, key=means.get)
        flat_us = means.get(FLAT_ALLTOALL)
        cell = {"topology": topo, "dtype": dtype, "bytes": nbytes,
                "tuned_plan": tuned_plan,
                "tuned_us": round(means[tuned_plan], 3),
                "flat_us": round(flat_us, 3) if flat_us else None,
                "speedup": (round(flat_us / means[tuned_plan], 3)
                            if flat_us else None)}
        win = (flat_us is not None and tuned_plan != FLAT_ALLTOALL
               and means[tuned_plan] < flat_us)
        cell["win"] = win
        if win:
            wins.append(cell)
        comparison.append(cell)
        mark = "WIN " if win else "    "
        print(f"perf_gate {mark} {topo} {dtype} {nbytes:>9}: "
              f"tuned={tuned_plan} ({cell['tuned_us']:.1f} us) vs "
              f"{FLAT_ALLTOALL} ({cell['flat_us']} us) "
              f"speedup={cell['speedup']}", file=sys.stderr)
    need = int(args.require_alltoall_wins)
    if len(wins) < need:
        problems.append(f"hierarchical dispatch beats {FLAT_ALLTOALL} in "
                        f"only {len(wins)} cell(s), gate requires {need}")

    # DCN shrink at the largest swept payload (bench_moe writes the
    # summary; recompute from rows if an older artifact lacks it)
    largest = sweep.get("dcn_largest")
    if not isinstance(largest, dict):
        top = max(int(r["bytes"]) for r in rows)
        flat = [r["dcn_bytes"] for r in rows
                if int(r["bytes"]) == top and r["plan"] == FLAT_ALLTOALL]
        bf16 = [r["dcn_bytes"] for r in rows
                if int(r["bytes"]) == top
                and r["plan"] == "alltoall_hier_bfloat16_dcn"]
        largest = {"bytes": top,
                   "flat_dcn_bytes": flat[0] if flat else None,
                   "bf16_dcn_bytes": bf16[0] if bf16 else None,
                   "bf16_shrink_x": (round(flat[0] / bf16[0], 3)
                                     if flat and bf16 and bf16[0] else None)}
    shrink = largest.get("bf16_shrink_x")
    need_shrink = float(args.require_dcn_shrink)
    if shrink is None:
        problems.append("bf16-DCN shrink not derivable (sweep is missing "
                        f"{FLAT_ALLTOALL} or alltoall_hier_bfloat16_dcn "
                        "rows at the largest payload)")
    elif float(shrink) < need_shrink:
        problems.append(f"bf16-DCN dispatch shrinks DCN bytes only "
                        f"x{float(shrink):.2f} at {largest.get('bytes')} B, "
                        f"gate requires x{need_shrink}")
    else:
        print(f"perf_gate        dcn shrink x{float(shrink):.2f} at "
              f"{largest.get('bytes')} B "
              f"({largest.get('flat_dcn_bytes')} -> "
              f"{largest.get('bf16_dcn_bytes')})", file=sys.stderr)

    # matched-loss leg: FLOP-matched MoE must not lose to dense
    matched = None
    if args.moe_bench:
        with open(args.moe_bench) as f:
            bench = json.load(f)
        if bench.get("schema") != MOE_BENCH_SCHEMA:
            print(f"perf_gate: unsupported moe-bench schema "
                  f"{bench.get('schema')!r} (want {MOE_BENCH_SCHEMA!r})",
                  file=sys.stderr)
            return 2
        moe_loss = _dig(bench, "moe.final_loss")
        dense_loss = _dig(bench, "dense.final_loss")
        matched = {"artifact": os.path.basename(args.moe_bench),
                   "moe_final_loss": moe_loss,
                   "dense_final_loss": dense_loss,
                   "ok": moe_loss <= dense_loss}
        if not matched["ok"]:
            problems.append(f"FLOP-matched MoE final loss {moe_loss:.4f} "
                            f"above dense baseline {dense_loss:.4f}")
        else:
            print(f"perf_gate        matched loss: moe {moe_loss:.4f} <= "
                  f"dense {dense_loss:.4f}", file=sys.stderr)

    # the tuned table still comes from the shared autotuner so the
    # moe_apply plan= seam loads it exactly like the 'auto' communicator
    table, _ = autotune_from_rows(rows)
    table.meta.update({"sweep": os.path.basename(args.moe),
                       "collective": sweep.get("collective", "all-to-all"),
                       "backend": sweep.get("backend"),
                       "n_devices": sweep.get("n_devices")})
    if args.table:
        table.save(args.table)
        print(f"perf_gate: all-to-all plan table ({len(table.entries)} "
              f"cells) -> {args.table}", file=sys.stderr)
    ok = not problems
    artifact = {"schema": MOE_GATE_SCHEMA,
                "sweep": os.path.basename(args.moe),
                "backend": sweep.get("backend"),
                "n_devices": sweep.get("n_devices"),
                "topology": sweep.get("topology"),
                "cells": comparison,
                "tuned_wins": len(wins),
                "required_wins": need,
                "dcn_largest": largest,
                "required_dcn_shrink_x": need_shrink,
                "matched_loss": matched,
                "problems": problems,
                "ok": ok}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
            f.write("\n")
    print(json.dumps({"ok": ok, "tuned_wins": len(wins),
                      "dcn_shrink_x": shrink,
                      "cells": len(comparison)}), flush=True)
    if not ok:
        for p in problems:
            print(f"perf_gate: FAIL — {p}", file=sys.stderr)
    return 0 if ok else 1


def elastic_gate(args):
    """Gate a ``tools/elastic_smoke.py`` artifact against the elastic
    floors in the budgets file: every chaos/async check must have
    passed, the on-step async checkpoint stall must sit at or under the
    ``async_ckpt_stall_ms`` budget (and measurably under the sync save
    it replaces), and the supervised restart must have lost at most
    ``elastic_resume_lost_steps`` steps of work."""
    with open(args.elastic) as f:
        doc = json.load(f)
    if doc.get("schema") != ELASTIC_SCHEMA:
        print(f"perf_gate: unsupported elastic schema "
              f"{doc.get('schema')!r} (want {ELASTIC_SCHEMA!r})",
              file=sys.stderr)
        return 2
    floors_path = args.floors or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "perf_budgets.json")
    with open(floors_path) as f:
        budgets = json.load(f)
    floor = {m["name"]: float(m["budget"])
             for m in budgets.get("metrics", [])}
    problems = []
    checks = []

    def _ceiling(name, key, bound):
        try:
            value = _dig(doc, key)
        except KeyError as e:
            problems.append(f"{key} missing from artifact ({e}) — rerun "
                            f"tools/elastic_smoke.py")
            checks.append({"name": name, "key": key, "ceiling": bound,
                           "value": None, "ok": False})
            return None
        ok = value <= bound
        if not ok:
            problems.append(f"{key} = {value:g}, ceiling is {bound:g}")
        checks.append({"name": name, "key": key, "ceiling": bound,
                       "value": value, "ok": ok})
        print(f"perf_gate {'ok' if ok else 'FAIL':>9} {name}: "
              f"value={value:g} ceiling={bound:g}", file=sys.stderr)
        return value

    if "async_ckpt_stall_ms" in floor:
        stall = _ceiling("async_ckpt_stall_ms", "async_ckpt.stall_ms",
                         floor["async_ckpt_stall_ms"])
    else:
        # no ceiling the card has measured: the rule below (async under
        # the sync save it replaces) is the whole stall gate
        try:
            stall = _dig(doc, "async_ckpt.stall_ms")
        except KeyError as e:
            problems.append(f"async_ckpt.stall_ms missing from artifact "
                            f"({e})")
            stall = None
    sync_stall = (doc.get("async_ckpt") or {}).get("sync_stall_ms")
    if stall is not None and sync_stall is not None \
            and stall >= float(sync_stall):
        problems.append(f"async stall {stall:g} ms does not beat the "
                        f"sync save it replaces ({sync_stall:g} ms) — "
                        f"the background persist is not paying")
    _ceiling("elastic_resume_lost_steps", "chaos.lost_steps",
             floor.get("elastic_resume_lost_steps", 1.0))
    for section in ("async_ckpt", "chaos"):
        sec = doc.get(section)
        if sec is None:
            problems.append(f"artifact has no {section} section — rerun "
                            f"tools/elastic_smoke.py without --skip-chaos")
        elif not sec.get("ok"):
            failed = [c["name"] for c in sec.get("checks", [])
                      if not c.get("ok")]
            problems.append(f"{section} leg failed its own checks"
                            + (f": {failed}" if failed else ""))
    chaos = doc.get("chaos") or {}
    if chaos and not chaos.get("n_embedded_dumps"):
        problems.append("restart manifest embeds no flight dump — the "
                        "incident evidence chain is broken")
    ok = not problems
    report = {"schema": ELASTIC_SCHEMA + "+gate",
              "artifact": os.path.basename(args.elastic),
              "floors": floors_path,
              "checks": checks,
              "restarts": chaos.get("restarts"),
              "lost_steps": chaos.get("lost_steps"),
              "async_speedup": (doc.get("async_ckpt") or {}).get("speedup"),
              "problems": problems,
              "ok": ok}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps({"ok": ok, "checked": len(checks),
                      "lost_steps": chaos.get("lost_steps")}), flush=True)
    if not ok:
        for p in problems:
            print(f"perf_gate: FAIL — {p}", file=sys.stderr)
    return 0 if ok else 1


def ledger_gate(args):
    """Budget check with per-(device_kind, schema) baselines from the
    run ledger.  For each tracked metric the newest matching artifact
    is classified; its baseline is the best prior value among ledger
    records sharing BOTH its artifact schema and its device kind
    (``baseline_source: "ledger"``), so a CPU-host rerun is held to CPU
    history and a future TPU run re-baselines against TPU history.  A
    cell with no prior record falls back to the static budget floor
    (``baseline_source: "budget"``)."""
    from chainermn_tpu_torch.observability.ledger import (
        _METRIC_PATHS, RunLedger, build_manifest, stamp_envelope)

    ledger = RunLedger.load(args.ledger)
    floors_path = args.floors or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "perf_budgets.json")
    with open(floors_path) as f:
        budgets = json.load(f)
    if budgets.get("schema") != BUDGETS_SCHEMA:
        print(f"perf_gate: unsupported budgets schema "
              f"{budgets.get('schema')!r} (want {BUDGETS_SCHEMA!r})",
              file=sys.stderr)
        return 2
    max_reg = float(args.max_regression_pct
                    if args.max_regression_pct is not None
                    else budgets.get("max_regression_pct", 3.0))
    root = args.root or _REPO
    rows = []
    failed = 0
    for m in budgets.get("metrics", []):
        matches = sorted(glob.glob(os.path.join(root, m["artifact"])),
                         key=os.path.getmtime)
        direction = m.get("direction", "higher")
        row = {"name": m["name"], "artifact": m["artifact"],
               "unit": m.get("unit"), "budget": float(m["budget"]),
               "direction": direction}
        if not matches:
            row["status"] = "missing"
            if args.strict:
                failed += 1
            rows.append(row)
            print(f"perf_gate {row['status']:>9} {row['name']}",
                  file=sys.stderr)
            continue
        path = matches[-1]
        row["path"] = os.path.relpath(path, root)
        try:
            doc = json.load(open(path))
            value = _dig(doc, m["key"])
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            row["status"] = f"unreadable: {e}"
            failed += 1
            rows.append(row)
            continue
        row["value"] = value
        manifest = build_manifest(doc, path, root=root)
        schema = manifest["artifact_schema"]
        dk = manifest["device_kind"]
        row["artifact_schema"] = schema
        row["device_kind"] = dk
        # the ledger metric whose extraction path IS this budget's key
        ledger_metric = next(
            (name for name, dotted in
             _METRIC_PATHS.get(schema or "", {}).items()
             if dotted == m["key"]), None)
        prior = [r for r in ledger.records(schema)
                 if r.get("device_kind") == dk
                 and ledger_metric in r.get("metrics", {})
                 and r.get("artifact") != row["path"]
                 and not r.get("noise_dominated")] \
            if ledger_metric else []
        if prior:
            pick = (max if direction == "higher" else min)
            base_rec = pick(prior,
                            key=lambda r: r["metrics"][ledger_metric])
            baseline = base_rec["metrics"][ledger_metric]
            row["baseline_source"] = "ledger"
            row["baseline_artifact"] = base_rec.get("artifact")
            row["baseline_round"] = base_rec.get("round")
        else:
            baseline = row["budget"]
            row["baseline_source"] = "budget"
        row["baseline"] = baseline
        denom = abs(baseline) or 1.0
        reg = ((value - baseline) if direction == "lower"
               else (baseline - value)) / denom * 100.0
        row["regression_pct"] = round(reg, 2)
        if reg > max_reg:
            row["status"] = "FAIL"
            failed += 1
        else:
            row["status"] = "ok"
        rows.append(row)
        print(f"perf_gate {row['status']:>9} {row['name']} "
              f"[{dk or '?'}/{schema or '?'}]: value={value} "
              f"baseline={baseline} ({row['baseline_source']}"
              + (f" {row.get('baseline_round')}"
                 if row.get('baseline_round') else "")
              + f") {row['regression_pct']}% vs {max_reg}% allowed",
              file=sys.stderr)
    report = stamp_envelope({
        "schema": LEDGER_GATE_SCHEMA,
        "ledger": os.path.basename(args.ledger),
        "floors": floors_path,
        "max_regression_pct": max_reg,
        "root": root,
        "metrics": rows,
        "ok": failed == 0,
    })
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    n_ledger = sum(1 for r in rows
                   if r.get("baseline_source") == "ledger")
    print(json.dumps({"ok": report["ok"], "failed": failed,
                      "checked": len(rows),
                      "ledger_baselines": n_ledger}), flush=True)
    return 0 if failed == 0 else 1


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--budgets", default=None, metavar="BUDGETS.json",
                        help="budget-check mode: checked-in budgets file "
                             f"(schema {BUDGETS_SCHEMA})")
    parser.add_argument("--root", default=None,
                        help="directory the budget artifact globs resolve "
                             "under (default: repo root)")
    parser.add_argument("--max-regression-pct", type=float, default=None,
                        help="override the budgets file's allowed "
                             "regression (default 3%%)")
    parser.add_argument("--strict", action="store_true",
                        help="budget mode: missing artifacts fail instead "
                             "of being skipped")
    parser.add_argument("--planner", default=None, metavar="SWEEP.json",
                        help="planner-gate mode: bench_allreduce --sweep "
                             "artifact to autotune and gate")
    parser.add_argument("--require-striped", type=int, default=0,
                        metavar="N",
                        help="planner mode: additionally require striped "
                             "plans to beat the best single-path plan in "
                             "at least N cells (the heterogeneous-link "
                             "striping acceptance criterion)")
    parser.add_argument("--table", default=None, metavar="TABLE.json",
                        help="planner mode: write the tuned plan table "
                             "here (load with create_communicator('auto', "
                             "plan_table=...))")
    parser.add_argument("--online-tune", default=None,
                        metavar="ONLINE_TUNE.json",
                        help="online-tune gate mode: bench_allreduce "
                             "--replay-spans artifact (schema "
                             f"{ONLINE_TUNE_SCHEMA}) that must show a "
                             "profitable retune decision")
    parser.add_argument("--retune-threshold", type=float, default=1.05,
                        help="online-tune mode: minimum modeled "
                             "retune.best_speedup to pass (default 1.05)")
    parser.add_argument("--serving", default=None, metavar="SERVING.json",
                        help="serving-gate mode: bench_serving artifact "
                             f"(schema {SERVING_SCHEMA}) that must clear "
                             "the strict serving floors "
                             "(serving_prefix_cache_speedup, "
                             "serving_spec_accept_tokens_per_step) from "
                             "the budgets file")
    parser.add_argument("--floors", default=None, metavar="BUDGETS.json",
                        help="serving mode: budgets file the floors are "
                             "read from (default: tools/perf_budgets.json "
                             "next to this script)")
    parser.add_argument("--moe", default=None, metavar="SWEEP.json",
                        help="MoE gate mode: bench_moe --sweep artifact "
                             "(all-to-all plan zoo) to autotune and gate")
    parser.add_argument("--moe-bench", default=None,
                        metavar="MOE_BENCH.json",
                        help="MoE mode: bench_moe --out matched-loss "
                             f"artifact (schema {MOE_BENCH_SCHEMA}); the "
                             "FLOP-matched MoE final loss must be at or "
                             "below the dense baseline")
    parser.add_argument("--require-alltoall-wins", type=int, default=2,
                        metavar="N",
                        help="MoE mode: cells where a non-flat plan must "
                             "strictly beat alltoall_flat (default 2)")
    parser.add_argument("--require-dcn-shrink", type=float, default=1.8,
                        metavar="X",
                        help="MoE mode: minimum bf16-DCN byte shrink at "
                             "the largest swept payload (default 1.8)")
    parser.add_argument("--joint", default=None, metavar="JOINT_SWEEP.json",
                        help="joint-schedule gate mode: bench_joint "
                             f"artifact (schema {JOINT_SWEEP_SCHEMA}) "
                             "whose jointly-tuned workload must beat "
                             "independent tuning and change >=1 slot")
    parser.add_argument("--joint-threshold", type=float, default=1.05,
                        help="joint mode: minimum modeled "
                             "comparison.speedup to pass (default 1.05)")
    parser.add_argument("--elastic", default=None, metavar="ELASTIC.json",
                        help="elastic gate mode: tools/elastic_smoke.py "
                             f"artifact (schema {ELASTIC_SCHEMA}) held to "
                             "the async_ckpt_stall_ms and "
                             "elastic_resume_lost_steps floors, with every "
                             "chaos check green and the restart manifest "
                             "carrying embedded flight-dump evidence")
    parser.add_argument("--ledger", default=None, metavar="LEDGER.json",
                        help="ledger-gate mode: run-ledger JSONL or "
                             "run_ledger/v1 snapshot; budget metrics are "
                             "held to the best prior value of the same "
                             "(device_kind, schema) cell instead of only "
                             "the static floor")
    parser.add_argument("--out", default=None, metavar="OUT.json",
                        help="write the gate report/artifact JSON here")
    args = parser.parse_args(argv)
    modes = [bool(args.budgets), bool(args.planner),
             bool(args.online_tune), bool(args.serving), bool(args.moe),
             bool(args.joint), bool(args.ledger), bool(args.elastic)]
    if sum(modes) != 1:
        parser.error("pass exactly one of --budgets, --planner, "
                     "--online-tune, --serving, --moe, --joint, "
                     "--ledger, or --elastic")
    if args.elastic:
        return elastic_gate(args)
    if args.planner:
        return planner_gate(args)
    if args.online_tune:
        return online_tune_gate(args)
    if args.joint:
        return joint_gate(args)
    if args.serving:
        return serving_gate(args)
    if args.moe:
        return moe_gate(args)
    if args.ledger:
        return ledger_gate(args)
    return check_budgets(args)


if __name__ == "__main__":
    sys.exit(main())
