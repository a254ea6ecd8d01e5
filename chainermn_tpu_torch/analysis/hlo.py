"""Collective parser over compiled HLO text.

Counterpart of ``chainermn_tpu/analysis/hlo.py``, copied: a pure-text
parser.  The port compiles no HLO; it reads HLO only as input data --
the committed TPU census artifacts (``CENSUS_r*.json``) and HLO text a
caller hands to ``lint_step(census=<text>)`` -- through
:func:`parse_hlo_collectives` and
:func:`~chainermn_tpu_torch.analysis.schedule.schedule_from_hlo`.  The
port's own step schedules come from the dispatch recorder
(:mod:`.schedule`).

Two HLO renderings the naive one-regex-per-line approach missed:

* **multi-line ops** — an instruction whose operand list or replica
  groups wrap across physical lines.  The parser first joins physical
  lines into logical instructions (a line that does not open a new
  ``name = shape op(...)`` binding continues the previous one).
* **async pairs** — on real TPU schedules collectives lower to
  ``all-reduce-start`` / ``all-reduce-done`` (likewise all-gather and
  collective-permute).  A start/done pair is ONE collective: it is
  counted once, at the start's position (issue order), with the payload
  read from the *done*'s result shape (the start's tuple shape would
  double-count) and the groups from the start (done ops carry none).  An
  unmatched start or done is recorded as a parse problem — the
  ``async-pair`` lint rule turns those into error findings, because an
  unmatched start in a schedule is exactly the shape of program the
  runtime hang watchdog ends up diagnosing on-mesh.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

HLO_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s8": 1, "u8": 1, "pred": 1,
}

#: base collective op kinds recognized (async suffixes handled separately)
COLLECTIVE_KINDS = (
    "all-reduce", "reduce-scatter", "all-gather", "all-to-all",
    "collective-permute", "ragged-all-to-all", "collective-broadcast",
)

_ASYNC_START = tuple(k + "-start" for k in COLLECTIVE_KINDS)
_ASYNC_DONE = tuple(k + "-done" for k in COLLECTIVE_KINDS)

# name = shape op(...) — the shape is either a tuple (...) or one token
_OP_RE = re.compile(
    r"(?P<name>%[\w.\-]+|[\w.\-]+)\s*=\s*"
    r"(?P<shape>\([^)]*\)|\S+)\s+"
    r"(?P<op>" + "|".join(
        re.escape(k) + "(?:-start|-done)?" for k in COLLECTIVE_KINDS)
    + r")\(")

# a new instruction binding starts a logical line; the HLO printer
# renders bindings with a SPACED " = " while instruction attributes
# (replica_groups=..., to_apply=...) use an unspaced "=" — that spacing
# is what separates a wrapped attribute line from a fresh binding
_BINDING_RE = re.compile(r"^\s*(?:ROOT\s+)?(?:%[\w.\-]+|[\w.\-]+)\s+=\s")
# computation headers / module lines never continue an instruction
_HEADER_RE = re.compile(
    r"^\s*(?:HloModule\b|ENTRY\b|%?[\w.\-]+\s*(?:\([^)]*\))?\s*->|\}|\{)")

_GROUPS_RE = re.compile(
    r"replica_groups=(\{(?:[^{}]|\{[^{}]*\})*\}"
    r"|\[[^\]]*\](?:<=\[[^\]]*\])?)")

_SHAPE_TOKEN_RE = re.compile(r"(\w+)\[([0-9,]*)\]")


@dataclass
class HloCollective:
    """One collective in a compiled HLO module (an async start/done pair
    folds into a single record)."""
    op: str                       # base kind, e.g. "all-reduce"
    nbytes: int                   # payload from the result shape
    groups: Optional[str]         # replica_groups text (or None)
    dtype: Optional[str]          # primary result dtype token, e.g. "f32"
    name: str = ""                # HLO instruction name
    is_async: bool = False        # came from a start/done pair
    line: int = 0                 # logical-line index (schedule order)

    def as_census_dict(self) -> dict:
        """The ``bench_allreduce.py --census`` artifact record shape —
        committed CENSUS_r*.json files compare on op/bytes/groups."""
        return {"op": self.op, "bytes": self.nbytes, "groups": self.groups,
                "dtype": self.dtype}


@dataclass
class HloParse:
    """Collectives plus any structural parse problems (unmatched async
    halves); ``ops`` is in schedule order (start position for pairs)."""
    ops: List[HloCollective] = field(default_factory=list)
    problems: List[dict] = field(default_factory=list)

    def kinds(self) -> Tuple[str, ...]:
        return tuple(o.op for o in self.ops)

    def count_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops:
            out[o.op] = out.get(o.op, 0) + 1
        return out


def _logical_lines(text: str) -> List[str]:
    """Join wrapped instruction renderings: a physical line that neither
    opens a new binding nor is a computation header continues the
    previous logical line."""
    out: List[str] = []
    for raw in text.splitlines():
        if not raw.strip():
            continue
        if out and not _BINDING_RE.match(raw) and not _HEADER_RE.match(raw):
            out[-1] += " " + raw.strip()
        else:
            out.append(raw)
    return out


def _shape_payload(shape_txt: str) -> Tuple[int, Optional[str]]:
    """(total bytes, primary dtype token) of a shape rendering."""
    size = 0
    dtype = None
    for dt, dims in _SHAPE_TOKEN_RE.findall(shape_txt):
        if dt not in HLO_DTYPE_BYTES:
            continue
        if dtype is None:
            dtype = dt
        count = 1
        for d in dims.split(","):
            if d:
                count *= int(d)
        size += count * HLO_DTYPE_BYTES[dt]
    return size, dtype


def _first_operand(line: str) -> Optional[str]:
    """Instruction name of the first operand inside the op's parens."""
    m = re.search(r"\(\s*(?:\([^)]*\)|\S+?)\s+(%[\w.\-]+|[\w.\-]+)", line)
    return m.group(1).lstrip("%") if m else None


def parse_hlo_collectives(hlo_text: str) -> HloParse:
    """Parse every collective out of optimized HLO text.

    Returns an :class:`HloParse`: records in schedule order with op kind,
    payload bytes, primary dtype, and replica groups; async
    start/done pairs folded into one record; unmatched halves reported in
    ``problems`` (``{"kind": "unmatched-async-start"|"unmatched-async-done",
    "op", "name", "line"}``).
    """
    parse = HloParse()
    pending_starts: Dict[str, HloCollective] = {}
    pending_order: List[str] = []
    for i, line in enumerate(_logical_lines(hlo_text)):
        m = _OP_RE.search(line)
        if not m:
            continue
        opname = m.group("op")
        name = m.group("name").lstrip("%")
        nbytes, dtype = _shape_payload(m.group("shape"))
        gm = _GROUPS_RE.search(line)
        groups = gm.group(1) if gm else None
        if opname.endswith("-start"):
            rec = HloCollective(op=opname[:-len("-start")], nbytes=nbytes,
                                dtype=dtype, groups=groups, name=name,
                                is_async=True, line=i)
            pending_starts[name] = rec
            pending_order.append(name)
            continue
        if opname.endswith("-done"):
            base = opname[:-len("-done")]
            src = _first_operand(line)
            start = pending_starts.pop(src, None) if src else None
            if start is None:
                # a done op whose start we never saw: count the
                # collective (payload is real) but flag the pairing
                parse.problems.append({"kind": "unmatched-async-done",
                                       "op": base, "name": name, "line": i})
                parse.ops.append(HloCollective(
                    op=base, nbytes=nbytes, dtype=dtype, groups=groups,
                    name=name, is_async=True, line=i))
                continue
            pending_order.remove(start.name)
            # ONE collective: start's position/groups, done's payload
            # (the start renders a tuple shape that double-counts)
            start.nbytes = nbytes or start.nbytes
            start.dtype = dtype or start.dtype
            parse.ops.append(start)
            continue
        parse.ops.append(HloCollective(
            op=opname, nbytes=nbytes, dtype=dtype, groups=groups,
            name=name, line=i))
    for name in pending_order:
        rec = pending_starts[name]
        parse.problems.append({"kind": "unmatched-async-start",
                               "op": rec.op, "name": name, "line": rec.line})
        parse.ops.append(rec)  # it is still issued — keep schedule order
    parse.ops.sort(key=lambda o: o.line)
    return parse


def collective_census(hlo_text: str) -> List[dict]:
    """Census-artifact view: op/bytes/groups/dtype dicts in schedule
    order — the exact rows ``bench_allreduce.py --census`` commits."""
    return [o.as_census_dict() for o in parse_hlo_collectives(hlo_text).ops]


__all__ = ["HLO_DTYPE_BYTES", "COLLECTIVE_KINDS", "HloCollective",
           "HloParse", "parse_hlo_collectives", "collective_census"]
