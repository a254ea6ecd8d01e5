"""The common envelope of a result document.

Counterpart of the envelope part of ``chainermn_tpu/observability/
ledger.py`` (``schema_version``, ``git_sha``, ``detect_device_kind``,
``stamp_envelope``): every document a benchmark writes carries its schema
and version, the device it ran on, the number of devices, the backend and
the commit, so that a run ledger can classify it later.  The schema
registry and the artifact classification are not ported yet (ROADMAP.md,
Queue A13 (c)).
"""

from __future__ import annotations

import os
import re
import subprocess
from typing import Dict, Optional


def schema_version(schema: Optional[str]) -> Optional[int]:
    """The integer version of a ``name/v<N>`` schema string."""
    if not schema:
        return None
    m = re.search(r"/v(\d+)$", schema)
    return int(m.group(1)) if m else None


_SHA_CACHE: Dict[str, Optional[str]] = {}


def git_sha(root: Optional[str] = None) -> Optional[str]:
    """HEAD commit of the repo at ``root`` (default: this file's repo);
    ``None`` outside a checkout or without git -- the envelope is then
    stamped without provenance rather than the writer failing."""
    root = os.path.abspath(root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    if root not in _SHA_CACHE:
        try:
            out = subprocess.run(
                ["git", "-C", root, "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=10)
            _SHA_CACHE[root] = out.stdout.strip() \
                if out.returncode == 0 and out.stdout.strip() else None
        except (OSError, subprocess.SubprocessError):
            _SHA_CACHE[root] = None
    return _SHA_CACHE[root]


def detect_device_kind() -> Optional[str]:
    """The name of CUDA device 0, or ``None`` without a card.  Used only
    as the stamp's fallback: a writer that knows better passes
    ``device_kind=``."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def stamp_envelope(doc: dict, schema: Optional[str] = None, *,
                   device_kind: Optional[str] = None,
                   n_devices: Optional[int] = None,
                   backend: Optional[str] = None,
                   root: Optional[str] = None) -> dict:
    """Stamp the common envelope onto ``doc`` in place (and return it).

    Present fields are never clobbered -- a writer that already records
    ``backend``/``n_devices`` keeps its values; the stamp fills the gaps
    (``schema_version`` from the schema string, ``device_kind`` from the
    card, ``git_sha`` from the checkout)."""
    if schema and not doc.get("schema"):
        doc["schema"] = schema
    if doc.get("schema") and doc.get("schema_version") is None:
        doc["schema_version"] = schema_version(doc["schema"])
    if device_kind is not None and doc.get("device_kind") is None:
        doc["device_kind"] = device_kind
    if doc.get("device_kind") is None:
        doc["device_kind"] = detect_device_kind()
    if n_devices is not None and doc.get("n_devices") is None:
        doc["n_devices"] = int(n_devices)
    if backend is not None and doc.get("backend") is None:
        doc["backend"] = backend
    if doc.get("git_sha") is None:
        doc["git_sha"] = git_sha(root)
    return doc


__all__ = ["detect_device_kind", "git_sha", "schema_version",
           "stamp_envelope"]
