"""Run-ledger CLI -- backfill, diff, and trend the repo's run artifacts.

Counterpart of the JAX package's ``tools/ledger.py``.  Subcommands::

    python -m chainermn_tpu_torch.tools.ledger ingest [--root .]
        [--ledger runs.jsonl] [--out LEDGER.json]
    python -m chainermn_tpu_torch.tools.ledger diff A B [--out DIFF.json]
    python -m chainermn_tpu_torch.tools.ledger trend METRIC [--ledger ...]
        [--schema S] [--device-kind K]

``ingest`` walks every committed ``*_r*.json`` / ``BENCH_*.json``
artifact, classifies it against the schema registry, and appends one
``run_manifest/v1`` record per artifact (exit 1 if anything is
unknown-schema -- the census invariant).  ``diff`` compares two runs:
flight/span dumps get the full differential attribution
(``run_diff/v1`` with bucket/link/stage localization); a pair of
ledger-registered artifacts gets the metric-level diff.  ``trend``
prints one metric's trajectory per (device_kind, schema) cell.

``chainermn_tpu_torch.tools.perf_gate --ledger`` consumes the same ledger
for per-(device_kind, schema) baseline selection; ``chainermn_tpu_torch.
tools.obs_report --ledger/--diff`` renders the documents.  An artifact a
card wrote carries the card's name as its device kind and lands in a cell
of its own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _write(doc: dict, out: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def _is_span_dump(path: str) -> bool:
    """A diff operand with events is a span dump; anything else is
    treated as a ledger-registered artifact."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except Exception:
        return False
    if isinstance(doc, list):
        return bool(doc) and isinstance(doc[0], dict) \
            and "kind" in doc[0]
    return isinstance(doc, dict) and "events" in doc


def cmd_ingest(args) -> int:
    from chainermn_tpu_torch.observability.ledger import (
        RunLedger, ingest_artifacts)
    ledger = RunLedger(args.ledger)
    manifests, problems = ingest_artifacts(args.root, ledger)
    for p in problems:
        print(f"ledger ingest: UNKNOWN {p['artifact']}: {p['reason']}",
              file=sys.stderr)
    doc = ledger.to_doc()
    doc["problems"] = problems
    if args.out:
        _write(doc, args.out)
    print(json.dumps({
        "ingested": len(manifests),
        "unknown": len(problems),
        "cells": len(ledger.cells()),
        "ledger": args.ledger, "out": args.out,
        "ok": not problems,
    }))
    return 0 if not problems else 1


def cmd_diff(args) -> int:
    from chainermn_tpu_torch.observability import diffing
    from chainermn_tpu_torch.observability.ledger import build_manifest
    if _is_span_dump(args.a) and _is_span_dump(args.b):
        doc = diffing.diff_runs(args.a, args.b,
                                label_a=args.a, label_b=args.b)
    else:
        pair = []
        for path in (args.a, args.b):
            with open(path) as fh:
                pair.append(build_manifest(json.load(fh), path))
        doc = diffing.diff_manifests(*pair)
    if args.out:
        _write(doc, args.out)
    reg = doc.get("regression")
    if reg:
        ev = reg.get("evidence") or {}
        stage = (ev.get("stage") or {}).get("stage")
        print(f"run-diff: REGRESSED bucket={reg['bucket']} "
              f"delta={reg['delta_s'] * 1e3:.3f}ms "
              f"ratio={reg['ratio']:.2f}x "
              f"confidence={reg['confidence']:.2f}"
              + (f" stage={stage}" if stage else ""),
              file=sys.stderr)
    print(json.dumps({"regressed": doc.get("regressed", False),
                      "bucket": reg.get("bucket") if reg else None,
                      "out": args.out}))
    # a detected regression is the REPORT working, not a tool failure
    return 0


def cmd_trend(args) -> int:
    from chainermn_tpu_torch.observability.ledger import (
        RunLedger, ingest_artifacts)
    if args.ledger:
        ledger = RunLedger.load(args.ledger)
    else:
        ledger = RunLedger()
        ingest_artifacts(args.root, ledger)
    rows = ledger.trend(args.metric, artifact_schema=args.schema,
                        device_kind=args.device_kind)
    for r in rows:
        sha = (r.get("git_sha") or "")[:10]
        print(f"{r['round'] or '----'}  "
              f"{r['device_kind'] or '?':<12} {r['value']:<14g} "
              f"{r['artifact']}  {sha}", file=sys.stderr)
    print(json.dumps({"metric": args.metric, "points": len(rows),
                      "values": [r["value"] for r in rows]}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="run ledger: ingest / diff / trend")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("ingest", help="backfill committed artifacts")
    pi.add_argument("--root", default=_REPO)
    pi.add_argument("--ledger", default=None,
                    help="append-only JSONL ledger file (default: "
                         "in-memory only)")
    pi.add_argument("--out", default=None,
                    help="write a run_ledger/v1 snapshot document")
    pi.set_defaults(fn=cmd_ingest)

    pd = sub.add_parser("diff", help="diff two runs (span dumps or "
                                     "registered artifacts)")
    pd.add_argument("a")
    pd.add_argument("b")
    pd.add_argument("--out", default=None,
                    help="write the run_diff/v1 document")
    pd.set_defaults(fn=cmd_diff)

    pt = sub.add_parser("trend", help="one metric across the ledger")
    pt.add_argument("metric")
    pt.add_argument("--ledger", default=None,
                    help="ledger JSONL or run_ledger/v1 snapshot "
                         "(default: ingest --root fresh)")
    pt.add_argument("--root", default=_REPO)
    pt.add_argument("--schema", default=None)
    pt.add_argument("--device-kind", default=None)
    pt.set_defaults(fn=cmd_trend)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
