"""What the port's benchmarks need of ``chainermn_tpu.observability``: the
common envelope stamped on every result document (:mod:`.ledger`) and the
append-only JSONL sink (:mod:`.sinks`).  The metrics registry, the flight
recorder, span summaries and the schema registry are not ported yet
(ROADMAP.md, Queue A13)."""

from chainermn_tpu_torch.observability.ledger import (
    detect_device_kind, git_sha, schema_version, stamp_envelope)
from chainermn_tpu_torch.observability.sinks import append_jsonl

__all__ = ["append_jsonl", "detect_device_kind", "git_sha", "schema_version",
           "stamp_envelope"]
