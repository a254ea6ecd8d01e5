"""Render an observability metrics JSONL into human-readable tables.

Counterpart of the JAX package's ``tools/obs_report.py``; the text is
JAX's, with the card's link classes (``nvlink``/``ib``) where JAX's
documents say ``ici``/``dcn`` (the attribution buckets keep JAX's names,
``ici_comm``/``dcn_comm``).  Reads the one-record-per-line file the runtime sinks write — the
``MetricsReport`` extension (``<out>/metrics.jsonl``), ``bench.py
--metrics`` and ``benchmarks/bench_allreduce.py --metrics`` all share the
schema — and prints:

* per-collective summary   (calls / payload bytes / host latency, from
                            ``comm_collective_*`` metric lines);
* per-step summary         (phase breakdown + throughput, from
                            ``step_report`` lines);
* straggler section        (latest ``straggler_report`` line);
* bench results            (``bench`` / ``bench_allreduce`` lines);
* compression lane         (``compression_*`` metric lines — wire
                            bits/param, bytes saved, EF residual; also
                            available alone via ``--compression``.
                            ``plan:*`` seams from a per-hop compressed
                            plan get an extra per-stage table: wire
                            bytes moved + saturation per hop).

``--flight`` switches to hang-dump mode: merge the per-rank
``flight_<rank>.json`` files a watchdog (or crash handler) wrote into one
timeline, with the stalled collective highlighted and the desynchronized
rank named.  ``--lint`` renders a lint or protocol findings document,
``--ledger`` the run ledger and ``--diff`` a ``run_diff/v1`` document;
``--live`` follows a growing metrics file.

Usage::

    python -m chainermn_tpu_torch.tools.obs_report result/metrics.jsonl
    python -m chainermn_tpu_torch.tools.obs_report result/metrics.jsonl \
        --section collectives
    python -m chainermn_tpu_torch.tools.obs_report --flight result/
    python -m chainermn_tpu_torch.tools.obs_report --flight flight_0.json \
        flight_1.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

# The attribution/trace lanes rebuild span trees with the library code
# (chainermn_tpu_torch.observability.attribution); every other lane is
# stdlib-only.  Rendered text keeps JAX's wording, tool names included.


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v < 1e-3:
        return f"{v * 1e6:.0f}us"
    if v < 1.0:
        return f"{v * 1e3:.2f}ms"
    return f"{v:.3f}s"


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  ".join(c.rjust(w) for c, w in zip(cells, widths))
    out = [line(headers), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def _latest_metric_lines(records: List[dict]) -> Dict[tuple, dict]:
    """Metric snapshot lines are cumulative — keep only the newest line
    per (name, labels) series."""
    latest: Dict[tuple, dict] = {}
    for r in records:
        if r.get("kind") != "metric":
            continue
        key = (r.get("name"), tuple(sorted((r.get("labels") or {}).items())))
        latest[key] = r
    return latest


def collectives_section(records: List[dict]) -> str:
    latest = _latest_metric_lines(records)
    ops: Dict[tuple, dict] = {}
    for (name, labels), r in latest.items():
        ld = dict(labels)
        op = ld.get("op")
        if op is None or not str(name).startswith(
                ("comm_collective", "comm_object")):
            continue
        row = ops.setdefault((op, ld.get("comm", "?")), {})
        if name in ("comm_collective_calls", "comm_object_calls"):
            row["calls"] = row.get("calls", 0.0) + r.get("value", 0.0)
        elif name == "comm_collective_bytes":
            row["bytes"] = row.get("bytes", 0.0) + r.get("value", 0.0)
            row.setdefault("dtypes", set()).add(ld.get("dtype", "?"))
        elif name in ("comm_collective_seconds", "comm_object_seconds"):
            row["p50"] = (r.get("quantiles") or {}).get("0.5")
            row["count"] = r.get("count")
            row["sum"] = r.get("sum")
    if not ops:
        return "per-collective: no comm_collective_*/comm_object_* metrics"
    rows = []
    for (op, comm), d in sorted(ops.items()):
        calls = d.get("calls", 0)
        total_s = d.get("sum")
        rows.append([
            op, comm, f"{int(calls)}",
            _fmt_bytes(d.get("bytes", 0.0)) if "bytes" in d else "-",
            ",".join(sorted(d.get("dtypes", []))) or "-",
            _fmt_s(d.get("p50")),
            _fmt_s(total_s) if total_s is not None else "-",
        ])
    return "per-collective summary\n" + _table(
        ["op", "comm", "calls", "bytes", "dtype", "p50", "total"], rows)


def steps_section(records: List[dict]) -> str:
    reps = [r for r in records if r.get("kind") == "step_report"]
    if not reps:
        return "per-step: no step_report records"
    rows = []
    for r in reps:
        rows.append([
            str(r.get("iteration", "-")), str(r.get("epoch", "-")),
            str(r.get("steps", "-")),
            _fmt_s(r.get("data_load_s_mean")),
            _fmt_s(r.get("host_put_s_mean")),
            _fmt_s(r.get("dispatch_s_mean")),
            _fmt_s(r.get("device_block_s_mean")),
            _fmt_s(r.get("step_s_mean")),
            f"{r.get('examples_per_sec', 0.0):.1f}",
        ])
    return "per-step summary\n" + _table(
        ["iter", "epoch", "steps", "data_load", "host_put", "dispatch",
         "dev_block", "step", "ex/s"], rows)


def straggler_section(records: List[dict]) -> str:
    reps = [r for r in records if r.get("kind") == "straggler_report"]
    if not reps:
        return "straggler: no straggler_report records"
    r = reps[-1]
    head = (f"straggler report (latest, n_ranks={r.get('n_ranks')}, "
            f"median={_fmt_s(r.get('median_step_s'))}, "
            f"threshold={r.get('threshold')}x)")
    rows = []
    flagged = {s.get("rank") for s in r.get("stragglers", [])}
    for s in r.get("ranks", []):
        rows.append([
            str(s.get("rank", "-")), str(s.get("count", "-")),
            _fmt_s(s.get("mean_s")), _fmt_s(s.get("p50_s")),
            _fmt_s(s.get("p95_s")), _fmt_s(s.get("max_s")),
            "STRAGGLER" if s.get("rank") in flagged else "",
        ])
    return head + "\n" + _table(
        ["rank", "steps", "mean", "p50", "p95", "max", ""], rows)


def bench_section(records: List[dict]) -> str:
    reps = [r for r in records
            if r.get("kind") in ("bench", "bench_allreduce")]
    if not reps:
        return "bench: no bench records"
    keys: List[str] = []
    for r in reps:
        for k in r:
            if k not in ("kind", "ts") and k not in keys:
                keys.append(k)
    rows = [[r["kind"]] + [str(r.get(k, "-")) for k in keys] for r in reps]
    return "bench results\n" + _table(["kind"] + keys, rows)


def compression_section(records: List[dict]) -> str:
    """Gradient-compression lane: one row per (seam, bucket, compressor)
    series from the ``compression_*`` metric family — achieved wire
    bits/param, the implied ratio vs an f32 wire, cumulative bytes kept
    off the wire, and the error-feedback residual norm (the convergence
    health signal: decaying/flat-low is healthy, growing means the wire
    is too narrow for the gradient stream).

    ``plan:*`` seams (a compiled multi-hop plan with per-stage
    compression, docs/collective_planner.md) additionally get a per-hop
    table: the ``bucket`` label is the plan's stage index, so the lane
    shows each compressed hop's wire width, the cumulative bytes it
    actually moved, and the ``compression_saturated_chunks`` gauge —
    nonzero saturation on one stage means THAT hop's wire clipped hard
    last collective (its delayed scale escalates next step)."""
    latest = _latest_metric_lines(records)
    series: Dict[tuple, dict] = {}
    for (name, labels), r in latest.items():
        if not str(name).startswith("compression_"):
            continue
        ld = dict(labels)
        key = (ld.get("seam", "?"), ld.get("bucket", "?"),
               ld.get("compressor", "?"))
        d = series.setdefault(key, {})
        if name == "compression_bits_per_param":
            d["bits"] = r.get("value")
        elif name == "compression_wire_bytes_saved":
            d["saved"] = r.get("value", 0.0)
        elif name == "compression_residual_norm":
            d["residual"] = r.get("value")
        elif name == "compression_saturated_chunks":
            d["sat"] = r.get("value")
    if not series:
        return ("compression: no compression_* metrics "
                "(wire uncompressed or observability off)")
    rows = []
    for (seam, bucket, comp), d in sorted(series.items()):
        bits = d.get("bits")
        rows.append([
            seam, str(bucket), comp,
            f"{bits:.2f}" if bits is not None else "-",
            f"{32.0 / bits:.2f}x" if bits else "-",
            _fmt_bytes(d.get("saved", 0.0)) if "saved" in d else "-",
            f"{d['residual']:.3e}" if d.get("residual") is not None else "-",
        ])
    out = "compression summary\n" + _table(
        ["seam", "bucket", "compressor", "bits/param", "vs f32",
         "bytes saved", "ef residual"], rows)

    # per-hop plan lane: the bucket label of a plan:* seam is the stage
    # index inside the compiled plan, and saved = (f32 - wire) bytes, so
    # wire = saved * bits / (32 - bits) recovers the bytes the hop
    # actually moved (cumulative, like the saved counter)
    hop_rows = []
    for (seam, bucket, comp), d in sorted(series.items()):
        if not seam.startswith("plan:"):
            continue
        bits, saved, sat = d.get("bits"), d.get("saved"), d.get("sat")
        wire = (saved * bits / (32.0 - bits)
                if saved is not None and bits and bits < 32.0 else None)
        hop_rows.append([
            str(bucket), seam.split(":", 1)[1], comp,
            f"{bits:.2f}" if bits is not None else "-",
            _fmt_bytes(wire) if wire is not None else "-",
            _fmt_bytes(saved) if saved is not None else "-",
            f"{int(sat)}" + (" << CLIPPING" if sat else "")
            if sat is not None else "-",
        ])
    if hop_rows:
        out += "\n\nper-hop plan lane\n" + _table(
            ["stage", "scope", "compressor", "bits/param", "wire bytes",
             "bytes saved", "sat chunks"], hop_rows)
    return out


def serving_section(records: List[dict]) -> str:
    """Serving lane: one row per ``bench_serving`` run (continuous vs
    static throughput/latency from ``benchmarks/bench_serving.py``), the
    prefix-cache hit-rate lane (``bench_serving_prefix`` records +
    ``serving_prefix_*`` counters), the speculative-decoding acceptance
    lane (``bench_serving_spec`` records + ``serving_spec_*`` counters),
    the fleet lane, and the latest ``serving_*`` engine gauges (queue
    depth, active slots, free KV pages — the admission-control health
    signals)."""
    reps = [r for r in records if r.get("kind") == "bench_serving"]
    parts = []
    if reps:
        rows = []
        for r in reps:
            ttft = r.get("ttft_s") or {}
            ptok = r.get("per_token_s") or {}
            rows.append([
                str(r.get("policy", "?")),
                str(r.get("requests", "-")),
                str(r.get("generated_tokens", "-")),
                f"{r['tokens_per_sec']:.1f}"
                if r.get("tokens_per_sec") is not None else "-",
                _fmt_s(ttft.get("p50")), _fmt_s(ttft.get("p99")),
                _fmt_s(ptok.get("p50")), _fmt_s(ptok.get("p99")),
            ])
        parts.append("serving throughput\n" + _table(
            ["policy", "reqs", "tokens", "tok/s", "ttft p50",
             "ttft p99", "tok p50", "tok p99"], rows))
    latest = _latest_metric_lines(records)
    gauges = {str(name): r.get("value")
              for (name, _labels), r in latest.items()
              if str(name).startswith("serving_")}

    # prefix-cache hit-rate lane: the bench A/B rows, then the live
    # engine counters reduced to the two health ratios (hit rate by
    # admission and by token — diverging ratios mean hits land only on
    # short prompts)
    prows = []
    for r in (x for x in records if x.get("kind") == "bench_serving_prefix"):
        stats = (r.get("cached") or {}).get("stats") or {}
        hit_rate = (stats.get("hit_tokens", 0)
                    / max(stats.get("prompt_tokens", 0), 1))
        prows.append([
            "bench",
            f"{r['speedup']:.2f}x" if r.get("speedup") is not None else "-",
            str(stats.get("hits", "-")), str(stats.get("admits", "-")),
            f"{hit_rate * 100:.1f}%",
            str(stats.get("cached_pages", "-")),
            str(stats.get("evictions", "-")),
        ])
    if "serving_prefix_prompt_tokens" in gauges:
        hits = gauges.get("serving_prefix_hits", 0.0) or 0.0
        prows.append([
            "engine", "-",
            f"{int(hits)}",
            "-",
            f"{(gauges.get('serving_prefix_hit_tokens', 0.0) or 0.0) / max(gauges['serving_prefix_prompt_tokens'], 1.0) * 100:.1f}%",
            f"{int(gauges.get('serving_prefix_cached_pages', 0) or 0)}",
            f"{int(gauges.get('serving_prefix_evictions', 0) or 0)}",
        ])
    if prows:
        parts.append("prefix-cache lane\n" + _table(
            ["source", "speedup", "hits", "admits", "hit tokens",
             "cached pages", "evictions"], prows))

    # spec-decoding acceptance lane: accepted/proposed is draft quality,
    # out_tokens/rows is the budgeted tokens-per-verify-pass (<= 1.0
    # means speculation degenerated to plain decode)
    srows = []
    for r in (x for x in records if x.get("kind") == "bench_serving_spec"):
        sp = r.get("spec") or {}
        srows.append([
            "bench", str(r.get("k", "-")),
            str(sp.get("verify_rows", "-")),
            f"{r['acceptance_rate'] * 100:.1f}%"
            if r.get("acceptance_rate") is not None else "-",
            f"{r['accept_tokens_per_step']:.2f}"
            if r.get("accept_tokens_per_step") is not None else "-",
            f"{r['speedup']:.2f}x" if r.get("speedup") is not None else "-",
        ])
    if gauges.get("serving_spec_rows"):
        rows_n = gauges["serving_spec_rows"]
        proposed = gauges.get("serving_spec_proposed_tokens", 0.0) or 0.0
        srows.append([
            "engine", "-", f"{int(rows_n)}",
            f"{(gauges.get('serving_spec_accepted_tokens', 0.0) or 0.0) / max(proposed, 1.0) * 100:.1f}%",
            f"{(gauges.get('serving_spec_out_tokens', 0.0) or 0.0) / rows_n:.2f}",
            "-",
        ])
    if srows:
        parts.append("speculative-decoding lane\n" + _table(
            ["source", "k", "verify rows", "acceptance", "tokens/pass",
             "speedup"], srows))

    frows = []
    for r in (x for x in records if x.get("kind") == "bench_serving_fleet"):
        ttft = r.get("ttft_s") or {}
        frows.append([
            str(r.get("replicas", "-")), str(r.get("sessions", "-")),
            str(r.get("requests", "-")),
            f"{r['tokens_per_sec']:.1f}"
            if r.get("tokens_per_sec") is not None else "-",
            _fmt_s(ttft.get("p50")), _fmt_s(ttft.get("p99")),
            "ok" if r.get("session_affinity_ok") else "VIOLATED",
            str(r.get("prefix_hits", "-")),
        ])
    if frows:
        parts.append("fleet lane\n" + _table(
            ["replicas", "sessions", "reqs", "tok/s", "ttft p50",
             "ttft p99", "affinity", "prefix hits"], frows))

    if gauges:
        rows = [[k, f"{v:.6g}" if v is not None else "-"]
                for k, v in sorted(gauges.items())]
        parts.append("serving engine metrics\n" + _table(
            ["metric", "value"], rows))
    if not parts:
        return ("serving: no bench_serving records or serving_* metrics "
                "(run benchmarks/bench_serving.py --metrics)")
    return "\n\n".join(parts)


_BUCKET_COLS = ("compute", "ici_comm", "dcn_comm", "host_input",
                "checkpoint", "stall")


def _attr_row(label: str, a: dict) -> List[str]:
    b = a.get("buckets", {})
    return ([label, _fmt_s(a.get("step_s"))]
            + [_fmt_s(b.get(k, 0.0)) for k in _BUCKET_COLS]
            + [f"{a.get('sum_frac', 0.0) * 100:.1f}%"])


_ATTR_HEADERS = (["step", "total"] + list(_BUCKET_COLS) + ["sum"])


def _plan_table_lane(records: List[dict]) -> List[str]:
    """Plan-table lane: the online tuner's ``plan_table_state`` snapshot
    (current tuned plan per cell) plus its ``plan_table_swap`` decisions
    (last swap step, modeled speedup, the regression evidence that armed
    the retune)."""
    parts = []
    states = [r for r in records if r.get("kind") == "plan_table_state"]
    if states:
        st = states[-1]
        rows = [[c.get("topology", "?"), c.get("dtype", "?"),
                 c.get("bucket", "?"), c.get("plan", "?"),
                 "yes" if c.get("striped") else ""]
                for c in st.get("cells", [])]
        gbps = st.get("observed_gbps") or {}
        head = (f"plan table (online tuner, it{st.get('iteration', '?')}): "
                f"hash={st.get('table_hash', '?')} "
                f"last_swap_step={st.get('last_swap_step', '-')} "
                f"observed_gbps="
                + ",".join(f"{k}={v:.3g}" for k, v in sorted(gbps.items())))
        if rows:
            parts.append(head + "\n" + _table(
                ["topology", "dtype", "bucket", "plan", "striped"], rows))
        else:
            parts.append(head + "\n(no tuned cells yet)")
    swaps = [r for r in records if r.get("kind") == "plan_table_swap"]
    if swaps:
        rows = [[f"it{s.get('iteration', s.get('step', '?'))}",
                 str(s.get("table_hash", "?")),
                 (f"{s.get('best_speedup'):.3f}x"
                  if s.get("best_speedup") is not None else "-"),
                 "; ".join(
                     f"{e.get('bucket', '?')} x{e.get('ratio', 0):.1f} "
                     f"@it{e.get('iteration', '?')}"
                     for e in (s.get("evidence") or [])[-2:]) or "-"]
                for s in swaps]
        parts.append("plan-table swaps (step-boundary hot-swaps)\n"
                     + _table(["step", "new table", "speedup",
                               "evidence (last regressions)"], rows))
    return parts


def attribution_section(records: List[dict]) -> str:
    """Attribution lane (metrics mode): the ``step_attribution`` records
    the MetricsReport extension appends per emit — one bucket
    decomposition row each — plus the online watch's ``attribution_*``
    regression counters and the online tuner's plan-table lane."""
    reps = [r for r in records if r.get("kind") == "step_attribution"]
    parts = []
    if reps:
        rows = [_attr_row(f"it{r.get('iteration', '?')}", r) for r in reps]
        parts.append("step-time attribution (per emit, latest step)\n"
                     + _table(list(_ATTR_HEADERS), rows))
    latest = _latest_metric_lines(records)
    regs = []
    for (name, labels), r in latest.items():
        if name == "attribution_regressions_total":
            regs.append([dict(labels).get("bucket", "?"),
                         f"{int(r.get('value', 0))}"])
    if regs:
        parts.append("attribution regressions (rolling-baseline watch)\n"
                     + _table(["bucket", "count"], sorted(regs)))
    parts.extend(_plan_table_lane(records))
    if not parts:
        return ("attribution: no step_attribution records or "
                "attribution_* metrics (enable observability and the "
                "MetricsReport extension)")
    return "\n\n".join(parts)


def _render_contention_doc(doc: dict) -> str:
    """Tables for one ``contention/v1`` document (the post-hoc,
    clock-corrected observatory cut — contention_smoke.py /
    ``--flight`` rebuild it from flight dumps)."""
    parts = []
    head = (f"contention report ({doc.get('n_ranks', '?')} rank(s), "
            f"{doc.get('n_steps', '?')} step(s), links: "
            f"{','.join(doc.get('links', [])) or '-'})")
    rows = []
    for link in sorted(doc.get("timelines", {})):
        for owner, row in sorted(doc["timelines"][link].items()):
            rows.append([link, owner, _fmt_s(row.get("busy_s")),
                         str(row.get("n_intervals", "-"))])
    parts.append(head + ("\n" + _table(
        ["link", "owner", "busy", "intervals"], rows)
        if rows else "\nno comm spans in the window"))
    orows = [[str(o.get("link", "?")),
              " + ".join(o.get("owners", [])),
              _fmt_s(o.get("contended_s"))]
             for o in doc.get("overlap", [])]
    if orows:
        parts.append("overlap matrix (pairwise contended seconds)\n"
                     + _table(["link", "owners", "contended"], orows))
    else:
        parts.append("overlap matrix: no cross-subsystem overlap observed")
    rrows = []
    for link, r in sorted((doc.get("rates") or {}).items()):
        rrows.append([
            link, str(r.get("n_spans", "-")),
            _fmt_bytes(r.get("bytes", 0)),
            _fmt_s(r.get("busy_s")), _fmt_s(r.get("contended_s")),
            f"{r.get('modeled_gbps', 0.0):.3f}",
            f"{r.get('effective_gbps', 0.0):.3f}",
            f"{r.get('derate', 1.0):.2f}",
        ])
    if rrows:
        parts.append("link rates under overlap\n" + _table(
            ["link", "spans", "bytes", "busy", "contended",
             "modeled GB/s", "effective GB/s", "derate"], rrows))
    cons = doc.get("consistency")
    if cons is not None:
        bad = [c for c in cons if not c.get("ok")]
        parts.append(
            f"attribution consistency "
            f"(occupancy − priority shave == bucket, per rank/step/link): "
            f"{'OK' if doc.get('consistency_ok') else 'VIOLATED'} "
            f"({len(cons)} row(s), {len(bad)} violation(s))")
    return "\n\n".join(parts)


def _render_fleet_doc(doc: dict) -> str:
    """Tables for one streaming ``fleet_telemetry`` record (the live,
    per-window cut rank 0 folds from the control-plane gathers)."""
    parts = []
    head = (f"fleet telemetry @ step {doc.get('step', '?')} "
            f"({doc.get('n_ranks', '?')} rank(s), "
            f"dropped_events={doc.get('dropped_events', 0)})")
    rows = []
    for link in sorted(doc.get("occupancy", {})):
        for owner, row in sorted(doc["occupancy"][link].items()):
            per_rank = " ".join(
                f"r{r}={_fmt_s(v)}" for r, v in
                sorted(row.get("by_rank", {}).items(),
                       key=lambda kv: int(kv[0])))
            busy = _fmt_s(row.get("busy_s"))
            if row.get("truncated"):
                busy = f">={busy}"  # shipped intervals capped
            rows.append([link, owner, busy, per_rank or "-"])
    parts.append(head + ("\n" + _table(
        ["link", "owner", "busy", "per-rank busy"], rows)
        if rows else "\nno comm occupancy this window"))
    trunc = doc.get("truncated") or []
    if trunc:
        pairs = ", ".join(f"{link}/{owner}" for link, owner in trunc)
        parts.append(
            f"NOTE: interval lists truncated this window for {pairs} — "
            f"fleet busy and the live overlap matrix are lower bounds "
            f"there (per-rank busy stays exact; the post-hoc "
            f"contention_report is authoritative)")
    orows = [[str(o.get("link", "?")),
              " + ".join(o.get("owners", [])),
              _fmt_s(o.get("contended_s"))]
             for o in doc.get("overlap", [])]
    if orows:
        parts.append("live overlap matrix\n"
                     + _table(["link", "owners", "contended"], orows))
    st = doc.get("step_time") or {}
    if st:
        stragglers = set(doc.get("stragglers") or [])
        srows = [[f"r{r}", _fmt_s(v),
                  "STRAGGLER" if int(r) in stragglers else ""]
                 for r, v in sorted(st.items(), key=lambda kv: int(kv[0]))]
        parts.append("per-rank mean step time\n"
                     + _table(["rank", "mean step", ""], srows))
    slo = doc.get("slo") or {}
    if slo:
        hrows = []
        for name, row in sorted(slo.items()):
            q = row.get("quantiles") or {}
            hrows.append([name, str(row.get("count", "-")),
                          _fmt_s(q.get("p50")), _fmt_s(q.get("p95")),
                          _fmt_s(q.get("p99"))])
        parts.append("serving SLO percentiles (fleet-merged)\n"
                     + _table(["metric", "count", "p50", "p95", "p99"],
                              hrows))
    return "\n\n".join(parts)


def contention_section(records: List[dict]) -> str:
    """Contention lane (metrics mode): the latest streaming
    ``fleet_telemetry`` window plus the latest post-hoc
    ``contention_report`` document found in the JSONL."""
    parts = []
    fleet = [r for r in records if r.get("kind") == "fleet_telemetry"]
    if fleet:
        body = _render_fleet_doc(fleet[-1])
        if len(fleet) > 1:
            body += f"\n({len(fleet)} fleet window(s) in file, latest shown)"
        parts.append(body)
    cont = [r for r in records if r.get("kind") == "contention_report"]
    if cont:
        parts.append(_render_contention_doc(cont[-1]))
    if not parts:
        return ("contention: no fleet_telemetry or contention_report "
                "records (enable MetricsReport(stream_telemetry=True), "
                "or run tools/contention_smoke.py)")
    return "\n\n".join(parts)


SECTIONS = {
    "collectives": collectives_section,
    "steps": steps_section,
    "straggler": straggler_section,
    "bench": bench_section,
    "compression": compression_section,
    "serving": serving_section,
    "attribution": attribution_section,
    "contention": contention_section,
}


# ---------------------------------------------------------------------------
# --flight: merge per-rank flight recorder dumps into one timeline
# ---------------------------------------------------------------------------

def load_flight_dumps(paths: List[str]) -> List[dict]:
    """Load ``flight_<rank>.json`` dumps.  Each path is either a dump file
    or a directory to glob for ``flight_*.json``."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "flight_*.json"))))
        else:
            files.append(p)
    dumps = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            doc = json.load(fh)
        if doc.get("kind") != "flight_dump":
            print(f"warning: {f} is not a flight dump, skipping",
                  file=sys.stderr)
            continue
        doc["_path"] = f
        dumps.append(doc)
    dumps.sort(key=lambda d: d.get("rank", 0))
    return dumps


def _flight_analysis(dumps: List[dict]) -> dict:
    """Cross-rank desync verdict.  Prefer a dump's embedded analysis (the
    triggering rank computed one over the peer states it collected); fall
    back to recomputing from the per-rank collective_state sections."""
    best = None
    for d in dumps:
        a = d.get("analysis")
        if a and a.get("n_ranks", 0) > (best or {}).get("n_ranks", 0):
            best = a
    if best is not None and best.get("n_ranks", 0) >= len(dumps):
        return best
    states = {d.get("rank", i): d.get("collective_state", {})
              for i, d in enumerate(dumps)}
    try:
        from chainermn_tpu_torch.observability import identify_desync
        return identify_desync(states)
    except Exception:  # noqa: BLE001 — report tool must not die on import
        return best or {"stalled_collectives": [], "desynced_ranks": [],
                        "n_ranks": len(dumps)}


def _dump_dropped(d: dict) -> int:
    """Ring-overflow count of one dump (events the recorder overwrote
    before dumping — older dumps without the counter read as 0)."""
    v = d.get("dropped_events")
    if v is None:
        v = d.get("collective_state", {}).get("dropped_events", 0)
    return int(v or 0)


def flight_summary_section(dumps: List[dict]) -> str:
    rows = []
    for d in dumps:
        cs = d.get("collective_state", {})
        n_open = len(cs.get("open", []))
        rows.append([
            str(d.get("rank", "?")),
            d.get("reason", "-"),
            str(cs.get("event_seq", "-")),
            str(_dump_dropped(d)),
            str(n_open),
            str(len(d.get("threads", []))),
            d.get("_path", "-"),
        ])
    head = f"flight dumps ({len(dumps)} rank(s))"
    return head + "\n" + _table(
        ["rank", "reason", "events", "dropped", "open", "threads", "file"],
        rows)


def flight_desync_section(dumps: List[dict]) -> str:
    analysis = _flight_analysis(dumps)
    stalled = analysis.get("stalled_collectives", [])
    desynced = analysis.get("desynced_ranks", [])
    lines = []
    if desynced:
        lines.append("DESYNCHRONIZED rank(s): "
                     + ", ".join(str(r) for r in desynced))
    elif stalled:
        lines.append("stalled collective(s), no rank behind "
                     "(all waiting at the same front)")
    else:
        lines.append("no stalled collective across the merged dumps")
    rows = []
    for s in stalled:
        pos = s.get("positions", {})
        rows.append([
            s.get("op", "?"),
            str(s.get("seq", "?")),
            ",".join(str(r) for r in s.get("waiting_ranks", [])) or "-",
            ",".join(str(r) for r in s.get("desynced_ranks", [])) or "-",
            " ".join(f"r{r}={p}" for r, p in sorted(
                pos.items(), key=lambda kv: int(kv[0]))) or "-",
        ])
    out = "desync analysis\n" + "\n".join(lines)
    if rows:
        out += "\n" + _table(
            ["op", "seq", "waiting", "desynced", "positions"], rows)
    stragglers = analysis.get("compute_stragglers", [])
    if stragglers:
        srows = [[str(s.get("rank", "?")), str(s.get("op", "?")),
                  _fmt_s(s.get("age_s"))] for s in stragglers]
        out += ("\ncompute straggler(s) — rank(s) stuck in local compute "
                "(e.g. compress/decompress), not in a collective:\n"
                + _table(["rank", "op", "open for"], srows))
    return out


def flight_timeline_section(dumps: List[dict], max_events: int = 60) -> str:
    analysis = _flight_analysis(dumps)
    stalled = {(s.get("op"), s.get("seq"))
               for s in analysis.get("stalled_collectives", [])}
    open_keys = set()
    for d in dumps:
        for sp in d.get("collective_state", {}).get("open", []):
            open_keys.add((sp.get("op"), sp.get("op_seq")))
    merged = []
    for d in dumps:
        rank = d.get("rank", "?")
        for ev in d.get("events", []):
            merged.append((ev.get("ts", 0.0), rank, ev))
    merged.sort(key=lambda t: t[0])
    dropped = max(0, len(merged) - max_events)
    merged = merged[-max_events:]
    t0 = merged[0][0] if merged else 0.0
    rows = []
    for ts, rank, ev in merged:
        kind = ev.get("kind", "?")
        op = ev.get("op", ev.get("phase", ""))
        op_seq = ev.get("op_seq")
        detail = " ".join(
            f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in ev.items()
            if k not in ("kind", "op", "op_seq", "ts", "seq", "phase")
            and v is not None)
        mark = ""
        key = (op, op_seq)
        if kind.endswith("_begin") and key in stalled:
            mark = "<< STALLED"
        elif kind.endswith("_begin") and key in open_keys:
            mark = "<< open"
        rows.append([
            f"+{ts - t0:.3f}s", f"r{rank}", kind, str(op or "-"),
            str(op_seq) if op_seq is not None else "-",
            detail[:60], mark,
        ])
    head = "merged timeline"
    if dropped:
        head += (f" (showing last {max_events} of {max_events + dropped} "
                 f"merged events; {dropped} older event(s) truncated "
                 "here — raise --events to see them)")
    ring_lost = {d.get("rank", "?"): _dump_dropped(d) for d in dumps
                 if _dump_dropped(d)}
    if ring_lost:
        head += ("\nRING OVERFLOW: "
                 + ", ".join(f"rank {r} lost {n} event(s)"
                             for r, n in sorted(ring_lost.items(),
                                                key=lambda kv: str(kv[0])))
                 + " before the dump (CHAINERMN_TPU_FLIGHT_CAPACITY "
                   "bounds the ring)")
    if not rows:
        return head + "\nno events recorded"
    return head + "\n" + _table(
        ["t", "rank", "event", "op", "seq", "detail", ""], rows)


def _fsdp_spans(dumps: List[dict]) -> List[dict]:
    """Pair the bucketed-FSDP per-bucket collective events
    (``fsdp_{gather,scatter}_{begin,end}``, emitted by the train step's
    device-side callbacks) into spans: one dict per completed
    begin/end pair with rank, leg, bucket, start/end ts, and bytes."""
    spans = []
    open_spans: Dict[tuple, dict] = {}
    merged = []
    for d in dumps:
        rank = d.get("rank", "?")
        for ev in d.get("events", []):
            k = ev.get("kind", "")
            if k.startswith("fsdp_gather_") or k.startswith("fsdp_scatter_"):
                merged.append((ev.get("ts", 0.0), rank, ev))
    merged.sort(key=lambda t: t[0])
    for ts, rank, ev in merged:
        _, leg, edge = ev["kind"].split("_", 2)
        key = (rank, leg, ev.get("bucket"))
        if edge == "begin":
            open_spans[key] = {"rank": rank, "leg": leg,
                               "bucket": ev.get("bucket"), "t0": ts,
                               "nbytes": ev.get("nbytes", 0)}
        else:
            sp = open_spans.pop(key, None)
            if sp is not None:
                sp["t1"] = ts
                spans.append(sp)
    return spans


def flight_fsdp_lane_section(dumps: List[dict], width: int = 48) -> str:
    """Per-bucket FSDP collective lane: one bar row per (leg, bucket)
    under the step timeline, so overlap between bucket i's gather and
    bucket i-1's compute window (or its absence) is visible from a
    single dump.  Empty string when the dump has no fsdp_* events."""
    spans = _fsdp_spans(dumps)
    if not spans:
        return ""
    t0 = min(s["t0"] for s in spans)
    t1 = max(s["t1"] for s in spans)
    dt = max(t1 - t0, 1e-9)

    def bar(a: float, b: float) -> str:
        i = int((a - t0) / dt * (width - 1))
        j = max(int((b - t0) / dt * (width - 1)), i)
        return "." * i + "#" * (j - i + 1) + "." * (width - 1 - j)

    # lanes keyed (leg, bucket); gathers first (issue order), then
    # scatters (transpose order) — one row per span occurrence
    order = {"gather": 0, "scatter": 1}
    spans.sort(key=lambda s: (order.get(s["leg"], 2),
                              s.get("bucket") or 0, s["t0"]))
    rows = []
    for s in spans:
        rows.append([
            f"r{s['rank']}",
            f"{s['leg']} b{s['bucket']}",
            bar(s["t0"], s["t1"]),
            _fmt_s(s["t1"] - s["t0"]),
            _fmt_bytes(s.get("nbytes", 0)),
        ])
    head = (f"fsdp per-bucket collectives "
            f"({len(spans)} span(s), window {dt * 1e3:.3f} ms)")
    return head + "\n" + _table(
        ["rank", "lane", "timeline", "dur", "bytes"], rows)


def _dump_events_by_rank(dumps: List[dict]) -> Dict[int, List[dict]]:
    return {int(d.get("rank", i)): d.get("events", [])
            for i, d in enumerate(dumps)}


def _dump_offsets(dumps: List[dict]) -> Dict[int, float]:
    """Per-rank clock offsets INTO rank 0's timebase, from the
    watchdog-handshake ``clock`` sections embedded in the dumps.  A
    rank's own dump carries its offsets TO each peer (``local + off ≈
    peer``), so rank R's shift is its offset to rank 0; when R's dump
    lacks one, rank 0's offset to R (negated) is the fallback.  Dumps
    without clock sections (single-host runs) shift by zero."""
    out: Dict[int, float] = {}
    by_rank = {int(d.get("rank", i)): d for i, d in enumerate(dumps)}
    ref = by_rank.get(0, {})
    ref_offsets = (ref.get("clock") or {}).get("offsets", {})
    for r, d in by_rank.items():
        if r == 0:
            out[r] = 0.0
            continue
        own = ((d.get("clock") or {}).get("offsets", {})).get("0")
        if own is not None:
            out[r] = float(own.get("offset_s", 0.0))
        elif str(r) in ref_offsets:
            out[r] = -float(ref_offsets[str(r)].get("offset_s", 0.0))
        else:
            out[r] = 0.0
    return out


def flight_attribution_report(dumps: List[dict]) -> dict:
    """The cross-rank attribution document for a set of dumps (offsets
    applied from any embedded clock handshake)."""
    from chainermn_tpu_torch.observability import attribution as _attr

    return _attr.attribution_report(_dump_events_by_rank(dumps),
                                    offsets=_dump_offsets(dumps))


def flight_attribution_section(dumps: List[dict],
                               max_steps: int = 8) -> str:
    """Attribution lane (flight mode): per-step bucket decomposition on
    every rank plus the cross-rank critical path of the slowest step."""
    try:
        rep = flight_attribution_report(dumps)
    except Exception as e:  # noqa: BLE001 — report tool must not die
        return f"attribution: failed to build span trees ({e})"
    steps = rep.get("steps", [])
    if not steps:
        return ("attribution: no step spans in the dumps (no step/phase "
                "events recorded)")
    shown = steps[-max_steps:]
    rows = []
    for st in shown:
        for r, a in sorted(st.get("ranks", {}).items(),
                           key=lambda kv: int(kv[0])):
            rows.append(_attr_row(f"it{st.get('iteration', '?')} r{r}", a))
    head = (f"step-time attribution ({rep.get('n_steps')} step(s) x "
            f"{rep.get('n_ranks')} rank(s)")
    if len(shown) < len(steps):
        head += f", last {len(shown)} step(s) shown"
    head += ")"
    out = head + "\n" + _table(list(_ATTR_HEADERS), rows)
    slowest = max(steps, key=lambda s: s.get("step_s", 0.0))
    cp = slowest.get("critical_path", [])
    if cp:
        crows = [[f"r{e.get('rank', '?')}", e.get("kind", "?"),
                  e.get("name", "?"), _fmt_s(e.get("dur_s"))
                  + (f"  (blocked by r{e['blocked_by_rank']})"
                     if "blocked_by_rank" in e else "")]
                 for e in cp]
        out += (f"\n\ncritical path of the slowest step "
                f"(it{slowest.get('iteration', '?')}, "
                f"{_fmt_s(slowest.get('step_s'))})\n"
                + _table(["rank", "kind", "span", "dur"], crows))
    return out


def write_trace(dumps: List[dict], out_path: str) -> str:
    """Export the merged, offset-corrected timeline as Chrome/Perfetto
    trace-event JSON (open in chrome://tracing or ui.perfetto.dev)."""
    from chainermn_tpu_torch.observability import attribution as _attr

    trees = _attr.merge_ranks(_dump_events_by_rank(dumps),
                              offsets=_dump_offsets(dumps))
    doc = _attr.to_trace_events(trees)
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return out_path


def flight_contention_section(dumps: List[dict]) -> str:
    """Contention lane (flight mode): rebuild the full clock-corrected
    ``contention/v1`` document from the dumps' events and render it.
    Empty string when the dumps carry no comm spans."""
    try:
        from chainermn_tpu_torch.observability import contention as _cont
        doc = _cont.contention_report(_dump_events_by_rank(dumps),
                                      offsets=_dump_offsets(dumps))
    except Exception as e:  # noqa: BLE001 — report tool must not die
        return f"contention: failed to build occupancy timelines ({e})"
    if not doc.get("links"):
        return ""
    return _render_contention_doc(doc)


def flight_report(dumps: List[dict], max_events: int = 60) -> str:
    parts = [
        flight_summary_section(dumps),
        flight_desync_section(dumps),
        flight_timeline_section(dumps, max_events=max_events),
        flight_fsdp_lane_section(dumps),
        flight_contention_section(dumps),
        flight_attribution_section(dumps),
    ]
    return "\n\n".join(p for p in parts if p)


# ---------------------------------------------------------------------------
# --lint: render a cmn-lint findings JSON next to the flight timeline
# ---------------------------------------------------------------------------

def load_lint_doc(path: str) -> Optional[dict]:
    """Load a ``tools/cmn_lint.py --out`` findings document — the data-
    plane suite (``cmn_lint/v1``) or the control-plane protocol sweep
    (``protocol_lint/v1``, from ``--protocol``).  A directory is globbed
    for ``CMN_LINT_*.json`` / ``PROTOCOL_LINT_*.json`` (the
    multichip_day1.sh artifact names), newest taken."""
    if os.path.isdir(path):
        cands = sorted(glob.glob(os.path.join(path, "CMN_LINT_*.json"))
                       + glob.glob(os.path.join(path,
                                                "PROTOCOL_LINT_*.json")))
        if not cands:
            return None
        path = cands[-1]
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("suite") != "cmn_lint":
        print(f"warning: {path} is not a cmn_lint findings document",
              file=sys.stderr)
        return None
    doc["_path"] = path
    return doc


def lint_section(doc: dict) -> str:
    """Static-analysis lane: the trace-time verdict that complements the
    runtime flight timeline — what cmn-lint proved (or flagged) about the
    collective schedules BEFORE this run (docs/static_analysis.md)."""
    findings = doc.get("findings", [])
    reports = doc.get("reports", [])
    n_err = sum(1 for f in findings if f.get("severity") == "error")
    verdict = "CLEAN" if doc.get("ok") else f"{n_err} ERROR FINDING(S)"
    head = (f"cmn-lint static analysis ({doc.get('entry', '?')}: {verdict}, "
            f"{len(reports)} target(s) — {doc.get('_path', '')})")
    if not findings:
        skipped = sorted({r for rep in reports
                          for r in (rep.get("skipped") or {})})
        tail = (f"\nrules skipped everywhere: {', '.join(skipped)}"
                if skipped else "")
        out = head + "\nno findings — every linted schedule proved safe" \
            + tail
    else:
        rows = [[f.get("severity", "?"), f.get("rule", "?"),
                 f.get("target", "-"),
                 " ".join(str(f.get("message", "")).split())[:72]]
                for f in findings]
        out = head + "\n" + _table(["sev", "rule", "target", "finding"],
                                   rows)
    proto = doc.get("protocol")
    if proto:
        out += "\n\n" + protocol_section(proto)
    return out


def protocol_section(proto: dict) -> str:
    """Control-plane protocol lane (``cmn_lint --protocol``): the static
    object-plane model the protocol rules swept — call sites per
    subsystem and the reserved tag bands keeping concurrent protocols
    apart on a shared DCN wire (docs/observability.md, "Control-plane
    protocol")."""
    by_sub = proto.get("sites_by_subsystem") or {}
    head = (f"control-plane protocol model ({proto.get('n_sites', 0)} "
            f"call site(s), {proto.get('n_class_ops', 0)} class op "
            f"def(s), {len(proto.get('parse_errors') or [])} parse "
            f"error(s))")
    parts = [head]
    if by_sub:
        parts.append(_table(
            ["subsystem", "object-plane call sites"],
            [[k, str(v)] for k, v in sorted(by_sub.items())]))
    bands = proto.get("bands") or []
    if bands:
        parts.append(_table(
            ["band", "base", "width", "owner", "purpose"],
            [[b.get("name", "?"), str(b.get("base", "?")),
              str(b.get("width", "?")), b.get("owner", "?"),
              " ".join(str(b.get("doc", "")).split())[:48]]
             for b in bands]))
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# --ledger / --diff: the longitudinal lanes (run ledger & regression diff)
# ---------------------------------------------------------------------------

def ledger_section(path: str) -> str:
    """Run-ledger lane: every registered run, one row per
    ``run_manifest/v1`` record, plus the (device_kind, schema)
    baseline-selection grid ``perf_gate --ledger`` picks baselines
    from.  ``path`` is the ledger JSONL or a committed ``run_ledger/v1``
    snapshot (LEDGER_r*.json)."""
    from chainermn_tpu_torch.observability.ledger import RunLedger
    ledger = RunLedger.load(path)
    records = ledger.records()
    head = (f"run ledger ({path}: {len(records)} record(s), "
            f"{len(ledger.cells())} (device_kind, schema) cell(s))")
    if not records:
        return head + "\nledger is empty — run tools/ledger.py ingest"
    rows = []
    for r in sorted(records, key=RunLedger._order):
        metrics = r.get("metrics") or {}
        headline = ", ".join(f"{k}={v:g}" for k, v in
                             sorted(metrics.items())[:2]) or "-"
        rows.append([
            r.get("round") or "-",
            r.get("artifact_schema") or "?",
            r.get("device_kind") or "?",
            str(r.get("n_devices") or "-"),
            (r.get("git_sha") or "")[:8] or "-",
            "legacy" if r.get("legacy_envelope") else "stamped",
            headline,
        ])
    return head + "\n" + _table(
        ["round", "schema", "device", "ndev", "sha", "envelope",
         "headline metrics"], rows)


def diff_section(path: str) -> str:
    """Regression-diff lane: render a ``run_diff/v1`` document
    (tools/ledger.py diff) — the bucket drift table and the localized
    regression with its link/stage evidence."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != "run_diff/v1":
        return f"{path} is not a run_diff/v1 document"
    base = doc.get("baseline", {})
    cand = doc.get("candidate", {})
    head = (f"run diff ({base.get('label') or base.get('artifact')} -> "
            f"{cand.get('label') or cand.get('artifact')})")
    parts = [head]
    bucket_rows = [
        [r["bucket"], _fmt_s(r["base_s"]), _fmt_s(r["cand_s"]),
         f"{r['delta_s'] * 1e3:+.3f} ms",
         f"x{r['ratio']:.2f}" if r.get("ratio") else "-"]
        for r in doc.get("buckets", [])
        if r.get("base_s") or r.get("cand_s")]
    if bucket_rows:
        parts.append(_table(
            ["bucket", "baseline", "candidate", "delta", "ratio"],
            bucket_rows))
    metric_rows = [
        [r["metric"], f"{r.get('base', '-')}", f"{r.get('cand', '-')}",
         f"x{r['ratio']:.3f}" if r.get("ratio") else "-"]
        for r in doc.get("metrics", [])]
    if metric_rows:
        parts.append(_table(["metric", "baseline", "candidate", "ratio"],
                            metric_rows))
    for name, row in sorted((doc.get("histograms") or {}).items()):
        if row.get("grid_mismatch"):
            parts.append(f"histogram {name}: grid mismatch — "
                         f"quantile deltas not comparable")
            continue
        qs = ", ".join(
            f"{q} {_fmt_s(v.get('a'))} -> {_fmt_s(v.get('b'))}"
            for q, v in sorted(row.items()) if isinstance(v, dict))
        parts.append(f"histogram {name}: {qs}")
    reg = doc.get("regression")
    if reg:
        ev = reg.get("evidence") or {}
        stage = ev.get("stage") or {}
        lines = [f"REGRESSED: {reg['bucket']} "
                 f"+{reg['delta_s'] * 1e3:.3f} ms "
                 f"(x{reg['ratio']:.2f}, "
                 f"confidence {reg['confidence']:.2f})"]
        if ev.get("link"):
            lines.append(f"  link: {ev['link']}")
        if stage:
            lines.append(
                f"  worst stage: {stage.get('stage')} "
                f"{_fmt_s(stage.get('base_mean_s'))} -> "
                f"{_fmt_s(stage.get('cand_mean_s'))} mean"
                + (f", {stage.get('base_gbps'):.2f} -> "
                   f"{stage.get('cand_gbps'):.2f} GB/s"
                   if stage.get("base_gbps") and stage.get("cand_gbps")
                   else ""))
        parts.append("\n".join(lines))
    else:
        parts.append("no bucket regressed past the floors — runs are "
                     "equivalent at this resolution")
    return "\n\n".join(parts)


def _live_loop(path: str, names: List[str], interval: float = 2.0) -> int:
    """``--live``: tail-follow the metrics JSONL and re-render the
    selected sections whenever the file grows (the streaming aggregator
    appends a fleet_telemetry record per emit, so the contention lane
    updates live)."""
    import time as _time

    from chainermn_tpu_torch.observability import read_jsonl

    last_size = None
    try:
        while True:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = -1
            if size != last_size:
                last_size = size
                records = read_jsonl(path) if size > 0 else []
                body = "\n\n".join(SECTIONS[n](records) for n in names) \
                    if records else f"waiting for records in {path} ..."
                sys.stdout.write(
                    "\033[2J\033[H"
                    f"obs_report --live {path} "
                    f"(refresh {interval:g}s, ctrl-c to exit)\n\n"
                    + body + "\n")
                sys.stdout.flush()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", nargs="*",
                    help="metrics JSONL file, or (with --flight) "
                         "flight_*.json dump files / a directory of them")
    ap.add_argument("--section", choices=sorted(SECTIONS),
                    help="print only one section")
    ap.add_argument("--compression", action="store_true",
                    help="print only the gradient-compression lane "
                         "(shorthand for --section compression)")
    ap.add_argument("--serving", action="store_true",
                    help="print only the serving lane (shorthand for "
                         "--section serving)")
    ap.add_argument("--attribution", action="store_true",
                    help="print only the step-time attribution lane "
                         "(metrics mode: step_attribution records; with "
                         "--flight: per-step buckets + critical path "
                         "rebuilt from the dumps)")
    ap.add_argument("--contention", action="store_true",
                    help="print only the link-contention lane (metrics "
                         "mode: fleet_telemetry / contention_report "
                         "records; with --flight: the clock-corrected "
                         "occupancy timelines + overlap matrix rebuilt "
                         "from the dumps)")
    ap.add_argument("--live", action="store_true",
                    help="tail-follow the metrics JSONL and re-render "
                         "whenever it grows (defaults to the contention "
                         "+ steps + straggler lanes; combine with "
                         "--section/--contention to pick one)")
    ap.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="--live refresh poll interval in seconds "
                         "(default 2.0)")
    ap.add_argument("--flight", action="store_true",
                    help="merge per-rank flight_<rank>.json hang dumps "
                         "into one timeline")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="with --flight: also export the merged, clock-"
                         "corrected timeline as Chrome/Perfetto trace-"
                         "event JSON (chrome://tracing, ui.perfetto.dev)")
    ap.add_argument("--events", type=int, default=60, metavar="N",
                    help="max merged timeline events to print "
                         "(--flight mode, default 60)")
    ap.add_argument("--lint", metavar="PATH", default=None,
                    help="render a cmn-lint findings JSON (tools/"
                         "cmn_lint.py --out; a directory is globbed for "
                         "CMN_LINT_*.json) — alone, or as the static-"
                         "analysis lane after the --flight report")
    ap.add_argument("--ledger", metavar="PATH", default=None,
                    help="render the run ledger (tools/ledger.py "
                         "ingest: a ledger JSONL or a run_ledger/v1 "
                         "snapshot like LEDGER_r17.json) — every "
                         "registered run and the (device_kind, schema) "
                         "baseline grid")
    ap.add_argument("--diff", metavar="PATH", default=None,
                    help="render a run_diff/v1 document (tools/"
                         "ledger.py diff): bucket drift and the "
                         "localized regression")
    args = ap.parse_args(argv)

    if args.ledger or args.diff:
        parts = []
        if args.ledger:
            parts.append(ledger_section(args.ledger))
        if args.diff:
            parts.append(diff_section(args.diff))
        print("\n\n".join(parts))
        return 0

    lint_out = None
    if args.lint:
        doc = load_lint_doc(args.lint)
        if doc is None:
            print(f"no cmn_lint findings document at {args.lint}",
                  file=sys.stderr)
            return 1
        lint_out = lint_section(doc)

    if args.flight:
        dumps = load_flight_dumps(args.path)
        if not dumps:
            print(f"no flight dumps found in {' '.join(args.path)}",
                  file=sys.stderr)
            return 1
        if args.attribution:
            out = flight_attribution_section(dumps)
        elif args.contention:
            out = flight_contention_section(dumps) \
                or "contention: no comm spans in the dumps"
        else:
            out = flight_report(dumps, max_events=args.events)
        if args.trace:
            write_trace(dumps, args.trace)
            out += f"\n\ntrace-event JSON written to {args.trace}"
        if lint_out:
            out += "\n\n" + lint_out
        print(out)
        return 0

    if args.trace:
        ap.error("--trace needs --flight (the trace is rebuilt from "
                 "flight dumps)")

    if lint_out is not None and not args.path:
        print(lint_out)
        return 0
    if not args.path:
        ap.error("a metrics JSONL path is required (or --lint/--flight)")

    if args.live:
        section = args.section
        for flag, name in ((args.compression, "compression"),
                           (args.serving, "serving"),
                           (args.attribution, "attribution"),
                           (args.contention, "contention")):
            if flag and not section:
                section = name
        live_names = [section] if section else \
            ["contention", "steps", "straggler"]
        return _live_loop(args.path[0], live_names,
                          interval=args.interval)

    from chainermn_tpu_torch.observability import read_jsonl

    records = read_jsonl(args.path[0])
    if not records:
        print(f"no records in {args.path[0]}", file=sys.stderr)
        return 1
    if args.compression and not args.section:
        args.section = "compression"
    if args.serving and not args.section:
        args.section = "serving"
    if args.attribution and not args.section:
        args.section = "attribution"
    if args.contention and not args.section:
        args.section = "contention"
    names = [args.section] if args.section else \
        ["steps", "collectives", "straggler", "bench", "compression",
         "serving", "attribution", "contention"]
    out = "\n\n".join(SECTIONS[n](records) for n in names)
    if lint_out:
        out += "\n\n" + lint_out
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
