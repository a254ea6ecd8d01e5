"""Restart manifests -- the paper trail of every supervisor relaunch.

Counterpart of ``chainermn_tpu/elastic/manifest.py``.  One
``restart_manifest/v1`` JSON per incident: why the attempt died (exit
codes, the watchdog's reason), the last flight dump each rank left
(embedded, with its ``dropped_events``/``ring_capacity`` so a truncated
evidence window is flagged), a best-effort cross-rank attribution report
rebuilt from the dumps' event rings, and what the next attempt resumes
from.  Written atomically next to the flight dumps; the perf gate's
``--elastic`` mode and the chaos harness check it.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, List, Optional

from chainermn_tpu_torch.observability.sinks import atomic_write_json

MANIFEST_SCHEMA = "restart_manifest/v1"


def load_flight_dumps(dump_dir: str) -> Dict[int, dict]:
    """All readable ``flight_<rank>.json`` dumps under ``dump_dir``,
    keyed by rank (unparseable files are skipped -- a crashing rank may
    leave a torn one despite the atomic rename when the disk fills)."""
    dumps: Dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(dump_dir,
                                              "flight_*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        try:
            rank = int(doc.get("rank",
                               os.path.basename(path)[7:-5]))
        except ValueError:
            continue
        dumps[rank] = doc
    return dumps


def _evidence(dumps: Dict[int, dict]) -> dict:
    """The truncation stamp over a set of flight dumps: any ring that
    overwrote events before dumping means the merged timeline is
    missing its oldest part (mirrors the fleet-telemetry
    ``windows_truncated`` convention)."""
    per_rank = {}
    truncated = False
    for r, d in sorted(dumps.items()):
        dropped = int(d.get("dropped_events", 0) or 0)
        cap = d.get("ring_capacity")
        per_rank[str(r)] = {"dropped_events": dropped,
                            "ring_capacity": cap}
        if dropped > 0:
            truncated = True
    return {"truncated": truncated, "per_rank": per_rank}


def _attribution(dumps: Dict[int, dict]) -> Optional[dict]:
    """Best-effort cross-rank attribution over the dumps' event rings
    (drift-corrected with the clock offsets the watchdog banked in the
    dump, when present).  None when no dump carries events -- the
    manifest still embeds the raw dumps."""
    from chainermn_tpu_torch.observability.attribution import \
        attribution_report

    events = {r: d.get("events") or [] for r, d in dumps.items()}
    if not any(events.values()):
        return None
    offsets = {}
    for r, d in dumps.items():
        clock = d.get("clock") or {}
        for peer, off in (clock.get("offsets") or {}).items():
            # offsets are relative to the dumping rank; rank 0's view
            # (or the lowest dumping rank's) anchors the merge
            if r == min(dumps):
                offsets[int(peer)] = float(off.get("offset_s", 0.0))
    try:
        return attribution_report(events, offsets=offsets or None)
    except Exception as e:  # never lose the manifest to analysis bugs
        return {"kind": "attribution_report", "error": repr(e)}


def build_restart_manifest(incident: int, reason: str,
                           dump_dir: str,
                           exit_codes: Dict[int, Optional[int]],
                           resume_generation: Optional[int],
                           attempt: int,
                           world_before: int, world_after: int,
                           watchdog_config: Optional[dict] = None,
                           resize: Optional[dict] = None,
                           extra: Optional[dict] = None) -> dict:
    """Assemble the ``restart_manifest/v1`` document for one incident.

    Embeds the harvested flight dumps verbatim (the last evidence each
    controller produced), the desync analysis of whichever dump carried
    peer states, a cross-rank attribution report rebuilt from the event
    rings, and the evidence-truncation stamp."""
    from chainermn_tpu_torch.observability.ledger import stamp_envelope

    dumps = load_flight_dumps(dump_dir)
    analysis = None
    for _, d in sorted(dumps.items()):
        if d.get("analysis"):
            analysis = d["analysis"]
            break
    doc = {
        "kind": "restart_manifest",
        "schema": MANIFEST_SCHEMA,
        "incident": int(incident),
        "attempt": int(attempt),
        "ts": time.time(),
        "reason": str(reason),
        "exit_codes": {str(r): c for r, c in sorted(exit_codes.items())},
        "world": {"before": int(world_before), "after": int(world_after)},
        "resume": {"generation": resume_generation,
                   "source": "latest_consistent_generation"},
        "evidence": _evidence(dumps),
        "flight_dumps": {str(r): d for r, d in sorted(dumps.items())},
        "desync": analysis,
        "attribution": _attribution(dumps),
    }
    if watchdog_config:
        doc["watchdog"] = dict(watchdog_config)
    if resize:
        doc["resize"] = dict(resize)
    if extra:
        doc.update(extra)
    return stamp_envelope(doc, MANIFEST_SCHEMA)


def write_restart_manifest(doc: dict, out_dir: str) -> str:
    """Atomically write ``restart_manifest_<incident>.json``; returns
    the path."""
    os.makedirs(out_dir or ".", exist_ok=True)
    path = os.path.join(out_dir or ".",
                        f"restart_manifest_{int(doc['incident'])}.json")
    atomic_write_json(path, doc)
    return path


__all__ = ["MANIFEST_SCHEMA", "build_restart_manifest",
           "load_flight_dumps", "write_restart_manifest"]
