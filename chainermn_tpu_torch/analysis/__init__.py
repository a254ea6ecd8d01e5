"""cmn-lint -- SPMD static analysis of the port's steps and object plane.

Counterpart of ``chainermn_tpu/analysis``.  Every hang class the runtime
observability stack (flight recorder, hang watchdog) diagnoses *after* a
world is wedged is visible in a step's collective schedule before it
runs for real: JAX reads the schedule off a traced jaxpr, the port
records it from one run of the step under a ``TorchDispatchMode`` --
dry, on a fake process group of any world size, when a rank and a world
are given (:mod:`.schedule`).  This package is a
:class:`CollectiveSchedule` recorder, the HLO parser for the committed
TPU census artifacts, a rule registry (``schedule-desync``,
``census-drift``, ``unpinned-transpose``, ``captured-constant``,
``donation-alias``, ``wire-dtype-mismatch``, ``async-pair``, ...), the
:func:`lint_step` one-liner, and the named entry points behind
``python -m chainermn_tpu_torch.tools.cmn_lint``.

The *control-plane* half lives in ``analysis/protocol.py``: an AST
protocol model of every host object-plane call site (tags, roots, rank
guards, exception paths) feeding the ``tag-band-collision``,
``lockstep-divergence``, ``unmatched-send-recv``,
``wrapper-surface-drift``, and ``protocol-replay-desync`` rules --
``cmn_lint --protocol``.
"""

from chainermn_tpu_torch.analysis.captured import (
    CapturedConstantError,
    DEFAULT_MAX_BYTES,
    assert_no_captured_constants,
    find_captured_constants,
)
from chainermn_tpu_torch.analysis.hlo import (
    HloCollective,
    HloParse,
    collective_census,
    parse_hlo_collectives,
)
from chainermn_tpu_torch.analysis.lint import (
    LintContext,
    LintError,
    LintReport,
    allreduce_schedule,
    build_grad_probe,
    lint_step,
)
from chainermn_tpu_torch.analysis.protocol import (
    CallSite,
    ProtocolModel,
    extract_protocol,
    load_events_by_rank,
    replay_flight,
)
from chainermn_tpu_torch.analysis.rules import (
    Finding,
    all_rules,
    expected_issued_kinds,
    expected_kinds,
    get_rule,
    rule,
)
from chainermn_tpu_torch.analysis.schedule import (
    COLLECTIVE_KINDS,
    CollectiveOp,
    CollectiveSchedule,
    ScheduleRecorder,
    census_schedule,
    dry_world,
    extract_schedule,
    record,
    schedule_from_hlo,
)

__all__ = [
    "COLLECTIVE_KINDS", "CallSite", "CapturedConstantError",
    "CollectiveOp", "CollectiveSchedule", "DEFAULT_MAX_BYTES",
    "Finding", "HloCollective", "HloParse",
    "LintContext", "LintError", "LintReport", "ProtocolModel",
    "ScheduleRecorder", "all_rules", "allreduce_schedule",
    "assert_no_captured_constants", "build_grad_probe",
    "census_schedule", "collective_census", "dry_world",
    "expected_issued_kinds", "expected_kinds", "extract_protocol",
    "extract_schedule", "find_captured_constants", "get_rule",
    "lint_step", "load_events_by_rank", "parse_hlo_collectives", "record",
    "replay_flight", "rule", "schedule_from_hlo",
]
