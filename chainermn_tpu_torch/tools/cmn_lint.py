"""cmn-lint CLI -- prove an entry point's collective schedules safe before
they run for real.

Counterpart of the JAX package's ``tools/cmn_lint.py`` (same flags but
``--no-hlo``: the port records schedules, there is no compiled view to
skip).  Lints a named example entry point (the same build the example
performs, at toy width) with every applicable rule of
``chainermn_tpu_torch.analysis`` and reports findings with stable rule
IDs.  The entry points run **dry**: one CPU process plays each rank of a
fake process group of ``--devices`` ranks, so no card and no other
process is needed.  Exit status is non-zero iff any error-severity
finding fired.

Usage::

    python -m chainermn_tpu_torch.tools.cmn_lint examples/mnist
    python -m chainermn_tpu_torch.tools.cmn_lint examples/mnist --json \
        --flavors xla,flat
    python -m chainermn_tpu_torch.tools.cmn_lint --protocol \
        --out PROTOCOL_LINT.json
    python -m chainermn_tpu_torch.tools.cmn_lint --protocol --events dumps/
    python -m chainermn_tpu_torch.tools.cmn_lint --list

Rendered JSON feeds ``python -m chainermn_tpu_torch.tools.obs_report
--lint`` (the findings lane next to the flight timeline).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="SPMD static analyzer of the port's steps (cmn-lint)")
    p.add_argument("entry", nargs="?",
                   help="entry point to lint (see --list)")
    p.add_argument("--json", action="store_true",
                   help="emit the findings document as JSON on stdout")
    p.add_argument("--out", default=None,
                   help="also write the findings JSON to this path "
                        "(the obs_report --lint artifact)")
    p.add_argument("--flavors", default=None,
                   help="comma-separated communicator flavors "
                        "(entry points that sweep flavors only; "
                        "default: all seven)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule IDs to run (default: all)")
    p.add_argument("--devices", type=int, default=8,
                   help="size of the dry world the entry points run in "
                        "(default 8 -- a world of one makes every "
                        "collective vacuous; serving/decode keeps its "
                        "tp=2 world, moe/train needs 8)")
    p.add_argument("--events", metavar="PATH", default=None,
                   help="lint RECORDED flight events instead of an "
                        "entry point: a flight_<rank>.json dump, a "
                        "directory of them, or a raw JSON event list -- "
                        "runs the dynamic rules (default: "
                        "overlapping-collectives) over the spans "
                        "rebuilt from the recording")
    p.add_argument("--artifacts", metavar="ROOT", default=None,
                   help="lint COMMITTED artifacts instead of an entry "
                        "point: walk ROOT for *_r*.json / BENCH_*.json "
                        "and run the longitudinal rules (default: "
                        "artifact-drift); combinable with --events")
    p.add_argument("--protocol", action="store_true",
                   help="lint the CONTROL PLANE instead of an entry "
                        "point: build the static protocol model of "
                        "every host object-plane call site "
                        "(analysis/protocol.py) and run the protocol "
                        "rules (tag-band-collision, lockstep-divergence, "
                        "unmatched-send-recv, wrapper-surface-drift); "
                        "with --events, additionally replays the "
                        "recorded per-rank object-plane sequences "
                        "against the model (protocol-replay-desync); "
                        "emits a protocol_lint/v1 document")
    p.add_argument("--protocol-root", metavar="PATH", default=None,
                   help="tree to extract the protocol model from "
                        "(default: the installed chainermn_tpu_torch "
                        "package)")
    p.add_argument("--list", action="store_true", dest="list_entries",
                   help="list entry points and rules, then exit")
    return p


def _load_events(path: str) -> dict:
    """``{rank: events}`` from a flight dump, a directory of
    ``flight_<rank>.json`` dumps, or a bare JSON event list."""
    import glob

    paths = sorted(glob.glob(os.path.join(path, "flight_*.json"))) \
        if os.path.isdir(path) else [path]
    if not paths:
        raise SystemExit(f"cmn-lint --events: no flight_*.json under {path}")
    out = {}
    for i, p in enumerate(paths):
        with open(p) as fh:
            doc = json.load(fh)
        if isinstance(doc, list):
            out[i] = doc
        else:
            out[int(doc.get("rank", i))] = doc.get("events", [])
    return out


def _write(doc: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")


def _static(args) -> int:
    """--protocol / --events / --artifacts: the device-free lanes."""
    from chainermn_tpu_torch.analysis.lint import lint_step
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    if args.rules:
        rules = args.rules.split(",")
    else:
        rules = []
        if args.protocol:
            rules += ["tag-band-collision", "lockstep-divergence",
                      "unmatched-send-recv", "wrapper-surface-drift"]
            if args.events:
                rules += ["protocol-replay-desync"]
        if args.events:
            rules += ["overlapping-collectives"]
        if args.artifacts:
            rules += ["artifact-drift"]
    entry = ":".join(filter(None, [
        (f"protocol:{args.protocol_root or 'chainermn_tpu_torch'}"
         if args.protocol else None),
        f"events:{args.events}" if args.events else None,
        f"artifacts:{args.artifacts}" if args.artifacts else None]))
    model = None
    if args.protocol:
        from chainermn_tpu_torch.analysis.protocol import extract_protocol
        model = extract_protocol(args.protocol_root)
    rep = lint_step(None,
                    flight_events=(_load_events(args.events)
                                   if args.events else None),
                    artifact_root=args.artifacts, protocol_root=model,
                    rules=rules, raise_on_error=False, name=entry)
    doc = {
        "suite": "cmn_lint",
        "entry": entry,
        "ok": rep.ok,
        "findings": [f.as_dict() for f in rep.findings],
        "reports": [rep.to_json()],
    }
    if args.protocol:
        # summarize the model the rules ran over (the full model on
        # request via analysis.extract_protocol().to_json())
        from chainermn_tpu_torch.runtime.control_plane import (
            RESERVED_TAG_BANDS)
        subsystems: dict = {}
        for s in model.sites:
            subsystems[s.subsystem] = subsystems.get(s.subsystem, 0) + 1
        doc["protocol"] = {
            "root": model.root,
            "n_sites": len(model.sites),
            "n_class_ops": len(model.class_ops),
            "sites_by_subsystem": subsystems,
            "bands": [b.as_dict() for b in RESERVED_TAG_BANDS.values()],
            "parse_errors": model.errors,
        }
    stamp_envelope(doc, "protocol_lint/v1" if args.protocol
                   else "cmn_lint/v1", backend="cpu")
    if args.out:
        _write(doc, args.out)
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        print(rep.render_text())
        verdict = "CLEAN" if rep.ok else \
            f"{len(rep.errors)} ERROR FINDING(S)"
        print(f"cmn-lint {doc['entry']}: {verdict} "
              f"({len(rep.findings)} finding(s))")
    return 0 if doc["ok"] else 1


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.protocol or args.events or args.artifacts:
        return _static(args)

    from chainermn_tpu_torch.analysis import all_rules
    from chainermn_tpu_torch.analysis.entrypoints import (
        ENTRY_POINTS, lint_entry_point)
    from chainermn_tpu_torch.observability.ledger import stamp_envelope

    if args.list_entries:
        print("entry points:")
        for name, entry in sorted(ENTRY_POINTS.items()):
            print(f"  {name}: {entry['help']}")
        print("rules:")
        for r in all_rules():
            print(f"  {r.id} [{r.severity}]: {r.summary}")
        return 0
    if not args.entry:
        _build_parser().error("an entry point is required (see --list)")

    flavors = args.flavors.split(",") if args.flavors else None
    rules = args.rules.split(",") if args.rules else None
    reports = lint_entry_point(args.entry, flavors=flavors, rules=rules,
                               world=args.devices)

    findings = [dict(f.as_dict()) for rep in reports for f in rep.findings]
    doc = {
        "suite": "cmn_lint",
        "entry": args.entry,
        "ok": all(rep.ok for rep in reports),
        "findings": findings,
        "reports": [rep.to_json() for rep in reports],
        "world": args.devices,
    }
    stamp_envelope(doc, "cmn_lint/v1", backend="cpu",
                   n_devices=args.devices)
    if args.out:
        _write(doc, args.out)
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        for rep in reports:
            print(rep.render_text())
        n_err = sum(len(rep.errors) for rep in reports)
        verdict = "CLEAN" if doc["ok"] else f"{n_err} ERROR FINDING(S)"
        print(f"cmn-lint {args.entry}: {verdict} "
              f"({len(reports)} target(s) linted)")
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
