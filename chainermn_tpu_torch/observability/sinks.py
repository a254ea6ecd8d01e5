"""The append-only JSONL sink of result records.

Counterpart of ``append_jsonl`` in ``chainermn_tpu/observability/sinks.py``
(the Prometheus exposition and the JSONL reader are not ported yet).
"""

from __future__ import annotations

import json


def append_jsonl(path: str, record: dict) -> None:
    """Append one JSON record as a single line (O(record), not O(file);
    the write is a single ``write`` call of one line, which POSIX appends
    atomically for sane line sizes)."""
    line = json.dumps(record, default=float, separators=(",", ":"))
    with open(path, "a") as f:
        f.write(line + "\n")


__all__ = ["append_jsonl"]
