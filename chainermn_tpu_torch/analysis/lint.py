"""``lint_step`` -- run every applicable cmn-lint rule on one train step.

Counterpart of ``chainermn_tpu/analysis/lint.py``.  The one-line
self-check::

    from chainermn_tpu_torch.analysis import lint_step
    lint_step(step, (model, optimizer), batch, comm=comm,
              loss=loss_fn, loss_args=(model, *batch),
              donate_argnums=(0,), census=True)

runs the step ONCE (``steps=`` more) under the dispatch recorder
(:mod:`.schedule`) -- then its ``finalize()``, so a double-buffered
step's last mean is waited for --, derives the auxiliary probes each rule
needs (the gradient probe for ``unpinned-transpose``, the recorded
``allreduce_grad`` for ``census-drift``), runs the registry, and raises
:class:`LintError` on any error-severity finding (``raise_on_error=False``
returns the :class:`LintReport` instead -- the CLI's path).  The recorder
only watches: the step's results are those of a bare run.

What the step mutates in place (its modules, its optimizer) is passed
as an argument and named in ``donate_argnums``, as the example above
does with ``(model, optimizer)``: ``captured-constant`` treats everything
reachable from the arguments as an input, and ``donation-alias`` holds
the donated state apart from the batch.  A step that issues collectives runs on the process group in place: a live
world issues them on every rank (every rank must lint), the fake group
of :func:`~.schedule.dry_world` issues nothing.

Inputs a rule needs that the caller did not provide make the rule
*skipped with a reason*, never a crash: ``lint_step(step, *args)`` with
nothing else still runs ``captured-constant`` / ``donation-alias`` /
``async-pair`` and reports the rest as skipped.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from chainermn_tpu_torch.analysis.captured import (DEFAULT_MAX_BYTES,
                                                   reachable_tensors,
                                                   storage_keys)
from chainermn_tpu_torch.analysis.rules import Finding, all_rules, get_rule
from chainermn_tpu_torch.analysis.schedule import (
    CollectiveSchedule, Recording, census_schedule, extract_schedule, record,
    schedule_from_hlo)


class LintError(AssertionError):
    """One or more error-severity lint findings.  The message is the
    rendered report; ``report`` carries the structured findings."""

    def __init__(self, report: "LintReport"):
        self.report = report
        super().__init__(report.render_text())


@dataclass
class LintReport:
    """Findings plus per-rule skip reasons for one linted target;
    ``outputs`` / ``schedule`` are the recorded runs' results and
    schedule (None when no rule ran the step)."""
    target: str = ""
    findings: List[Finding] = field(default_factory=list)
    skipped: Dict[str, str] = field(default_factory=dict)
    outputs: Any = field(default=None, repr=False, compare=False)
    schedule: Optional[CollectiveSchedule] = field(default=None, repr=False,
                                                   compare=False)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_json(self) -> dict:
        return {
            "suite": "cmn_lint",
            "target": self.target,
            "ok": self.ok,
            "findings": [f.as_dict() for f in self.findings],
            "skipped": dict(self.skipped),
        }

    def render_text(self) -> str:
        lines = [f"cmn-lint: {self.target or '<anonymous step>'} -- "
                 f"{len(self.errors)} error(s), "
                 f"{len(self.findings) - len(self.errors)} other finding(s), "
                 f"{len(self.skipped)} rule(s) skipped"]
        for f in self.findings:
            lines.append("  " + f.render())
        for rule_id, why in sorted(self.skipped.items()):
            lines.append(f"  [skipped] {rule_id}: {why}")
        return "\n".join(lines)

    def raise_for_errors(self) -> "LintReport":
        if self.errors:
            raise LintError(self)
        return self


class LintContext:
    """Lazy per-target inputs the rules read.

    Every derived input (the step's recording, the census schedule, the
    gradient probe, the variants' schedules) is computed at most once and
    memoized; a derivation that fails or lacks its inputs yields ``None``
    with the reason recorded in ``unavailable`` -- ``lint_step`` turns that
    into a skip, so one broken probe never hides the other rules'
    findings.
    """

    def __init__(self, fn, args, kwargs, *, name="", comm=None, flavor=None,
                 inter_size=None, plan=None, loss=None, loss_args=None,
                 donate_argnums=(), fsdp_meta=None, fsdp_state=None,
                 variants=None, census=False,
                 max_const_bytes=DEFAULT_MAX_BYTES, flight_events=None,
                 artifact_root=None, protocol_root=None, steps=1):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs or {}
        self.name = name or getattr(fn, "__name__", "") or "step"
        self.comm = comm
        # an explicit plan is a first-class census/wire spec
        # (census-drift and wire-dtype-mismatch read it); when only a
        # communicator is given its flavor names the spec instead
        self.plan = plan
        self.flavor = (flavor if flavor is not None
                       else getattr(comm, "flavor", None)
                       if plan is None else flavor)
        self.inter_size = (inter_size if inter_size is not None
                           else getattr(comm, "inter_size", 1) or 1)
        self.loss = loss
        self.loss_args = loss_args
        self.donate_argnums = tuple(donate_argnums or ())
        self.fsdp_meta = fsdp_meta
        self.fsdp_state = fsdp_state
        self._variants_spec = variants
        self.flight_events = flight_events
        self.artifact_root = artifact_root
        self.protocol_root = protocol_root
        self.census = census
        self.steps = int(steps)
        self.max_const_bytes = max_const_bytes
        self.unavailable: Dict[str, str] = {}
        self._cache: Dict[str, Any] = {}

    # -- memoized derivations -------------------------------------------

    def _memo(self, key: str, build: Callable[[], Any]):
        if key in self._cache:
            return self._cache[key]
        try:
            val = build()
        except Exception as e:  # noqa: BLE001 -- reason becomes the skip
            self.unavailable[key] = f"{type(e).__name__}: {e}"
            val = None
        self._cache[key] = val
        return val

    @property
    def recording(self) -> Optional[Recording]:
        """``steps`` runs of the step under one recorder, then its
        ``finalize()``; ``outputs`` holds the runs' results."""
        def build():
            if self.fn is None:
                self.unavailable["recording"] = "no step function given"
                return None
            known = storage_keys(self.args, self.kwargs)

            def run():
                return [self.fn(*self.args, **self.kwargs)
                        for _ in range(self.steps)]
            return record(run, label=self.name, comms=[self.comm],
                          known=known,
                          finalize=getattr(self.fn, "finalize", None))
        return self._memo("recording", build)

    @property
    def recording_if_run(self) -> Optional[Recording]:
        """The recording when a rule already made it (never runs the
        step)."""
        return self._cache.get("recording")

    @property
    def outputs(self) -> Optional[list]:
        rec = self.recording
        return None if rec is None else rec.result

    @property
    def schedule(self) -> Optional[CollectiveSchedule]:
        def build():
            rec = self.recording
            if rec is None:
                self.unavailable.setdefault(
                    "schedule", self.unavailable.get("recording",
                                                     "no recording"))
                return None
            return rec.schedule
        return self._memo("schedule", build)

    @property
    def census_schedule(self) -> Optional[CollectiveSchedule]:
        """The program census-drift checks against the declared spec, in
        JAX's census kinds.  ``census=True`` records the communicator's
        own ``allreduce_grad`` (:func:`allreduce_schedule`, the training
        seam); ``census=<CollectiveSchedule>`` audits that schedule (a
        recorded one is read in census kinds); ``census=<hlo text>``
        audits a compiled program's HLO (JAX's count); ``census=
        <callable>`` is invoked lazily (no args) to produce either -- the
        serving/router entry points put their OWN program (the decode
        step, the multicast weight distribution) under the same drift
        check this way."""
        def as_census(value, label):
            if isinstance(value, str):
                return schedule_from_hlo(value, label=label)
            if isinstance(value, CollectiveSchedule):
                return census_schedule(value, label=label) \
                    if value.origin == "recorded" else value
            raise TypeError(f"census gave {type(value).__name__}, want a "
                            f"CollectiveSchedule or HLO text")

        def build():
            if self.census is None or self.census is False:
                self.unavailable["census_schedule"] = "census=False"
                return None
            label = f"{self.name}:census"
            if isinstance(self.census, (str, CollectiveSchedule)):
                return as_census(self.census, label)
            if callable(self.census):
                try:
                    value = self.census()
                except Exception as e:  # noqa: BLE001 -- probe, not crash
                    self.unavailable["census_schedule"] = \
                        f"census probe failed: {e}"
                    return None
                try:
                    return as_census(value, label)
                except TypeError as e:
                    self.unavailable["census_schedule"] = \
                        f"census callable returned {type(value).__name__}"\
                        f", want a CollectiveSchedule or HLO text ({e})"
                    return None
            if self.comm is None:
                self.unavailable["census_schedule"] = "no communicator given"
                return None
            return census_schedule(
                allreduce_schedule(self.comm),
                label=f"{self.flavor or 'comm'}:allreduce_grad")
        return self._memo("census_schedule", build)

    @property
    def census_schedule_if_built(self) -> Optional[CollectiveSchedule]:
        return self._cache.get("census_schedule")

    @property
    def grad_probe(self) -> Optional[Dict[str, CollectiveSchedule]]:
        def build():
            if self.loss is None or self.loss_args is None:
                self.unavailable["grad_probe"] = \
                    "no loss/loss_args given (pass loss=, loss_args=)"
                return None
            if self.comm is None:
                self.unavailable["grad_probe"] = "no communicator given"
                return None
            return build_grad_probe(self.comm, self.loss, self.loss_args,
                                    label=self.name)
        return self._memo("grad_probe", build)

    @property
    def variants(self) -> Optional[Dict[str, CollectiveSchedule]]:
        def build():
            spec = self._variants_spec
            if not spec:
                self.unavailable["variants"] = \
                    "no variants given (pass variants={label: ...})"
                return None
            out: Dict[str, CollectiveSchedule] = {}
            for label, v in spec.items():
                if isinstance(v, CollectiveSchedule):
                    sched = v
                elif callable(v):
                    # a callable returning either a schedule or a step
                    # function (recorded with THIS context's args)
                    built = v()
                    sched = built if isinstance(built, CollectiveSchedule) \
                        else extract_schedule(built, *self.args, label=label,
                                              comms=[self.comm],
                                              **self.kwargs)
                elif isinstance(v, tuple):
                    vfn, vargs = v[0], tuple(v[1:])
                    sched = extract_schedule(vfn, *vargs, label=label,
                                             comms=[self.comm])
                else:
                    raise TypeError(
                        f"variants[{label!r}] must be a CollectiveSchedule, "
                        f"a callable, or a (fn, *args) tuple; got {type(v)}")
                sched.label = sched.label or label
                out[label] = sched
            return out
        return self._memo("variants", build)

    @property
    def flight_spans(self) -> Optional[Dict[int, list]]:
        """Per-rank paired spans rebuilt from flight-recorder events --
        the ``overlapping-collectives`` input.  ``flight_events`` is a
        flat event list (linted as rank 0) or ``{rank: events}``; a
        flight dump's ``events`` list feeds it directly."""
        def build():
            ev = self.flight_events
            if not ev:
                self.unavailable["flight_spans"] = \
                    "no flight_events given (pass flight_events=)"
                return None
            from chainermn_tpu_torch.observability.spans import pair_events
            if isinstance(ev, dict):
                by_rank = {int(r): list(e) for r, e in ev.items()}
            else:
                by_rank = {0: list(ev)}
            return {r: pair_events(e, rank=r)
                    for r, e in sorted(by_rank.items())}
        return self._memo("flight_spans", build)

    @property
    def protocol_model(self):
        """Static control-plane protocol model (``analysis/protocol.py``)
        -- the input of the tag-band-collision / lockstep-divergence /
        unmatched-send-recv / wrapper-surface-drift / replay rules.
        ``protocol_root=True`` walks the installed
        ``chainermn_tpu_torch`` package; a path walks that tree (the
        fixture tests' path); an already-built
        :class:`~chainermn_tpu_torch.analysis.protocol.ProtocolModel` (or
        its ``to_json()`` dict) is used as-is."""
        def build():
            root = self.protocol_root
            if not root:
                self.unavailable["protocol_model"] = \
                    "no protocol_root given (pass protocol_root=)"
                return None
            from chainermn_tpu_torch.analysis.protocol import (
                ProtocolModel, extract_protocol)
            if isinstance(root, ProtocolModel):
                return root
            if isinstance(root, dict):
                return ProtocolModel.from_json(root)
            return extract_protocol(None if root is True else root)
        return self._memo("protocol_model", build)

    @property
    def artifact_census(self) -> Optional[List[dict]]:
        """Every committed artifact under ``artifact_root``, parsed and
        classified against the run-ledger schema registry -- the
        ``artifact-drift`` input.  One row per artifact: ``path``
        (relative), ``doc``, ``classification`` (``None`` = unknown
        schema), ``manifest`` (the ``run_manifest/v1`` record, carrying
        device kind and modeled/measured link rates)."""
        def build():
            root = self.artifact_root
            if not root:
                self.unavailable["artifact_census"] = \
                    "no artifact_root given (pass artifact_root=)"
                return None
            from chainermn_tpu_torch.observability.ledger import (
                build_manifest, classify_artifact, iter_artifacts)
            rows: List[dict] = []
            for path in iter_artifacts(root):
                row = {"path": os.path.relpath(path, root)}
                try:
                    with open(path) as fh:
                        doc = json.load(fh)
                except Exception as e:  # noqa: BLE001 -- itself a finding
                    row["error"] = f"{type(e).__name__}: {e}"
                    rows.append(row)
                    continue
                cls = classify_artifact(doc, path)
                row["doc"] = doc
                row["classification"] = cls
                row["manifest"] = build_manifest(
                    doc, path, root=root, classification=cls)
                rows.append(row)
            return rows
        return self._memo("artifact_census", build)


def allreduce_schedule(comm, nelems: int = 1024, dtype=torch.float32,
                       plan=None) -> CollectiveSchedule:
    """Recorded ``allreduce_grad`` of the communicator over one flat
    ``nelems`` gradient on its device -- the census-drift probe (JAX's
    ``allreduce_hlo``).  It runs the communicator's OWN program (a
    ``LintContext.plan`` is the spec the program is checked AGAINST,
    never the program itself); ``plan=`` records
    ``allreduce_grad(g, compressor=plan)`` instead, to audit the plan
    executor's census including per-hop compression.  On a live world
    every rank must call it (it is a collective)."""
    grad = torch.zeros(int(nelems), dtype=dtype, device=comm.device)

    def run():
        if plan is not None:
            return comm.allreduce_grad([grad], compressor=plan)
        return comm.allreduce_grad([grad])
    return record(run, label=f"{getattr(comm, 'flavor', 'comm')}:"
                  "allreduce_grad", comms=[comm]).schedule


def build_grad_probe(comm, loss, loss_args, label: str = "") \
        -> Dict[str, CollectiveSchedule]:
    """Forward vs forward-and-backward collective schedules of ``loss``
    differentiated on this rank -- the ``make_train_step`` shape, where
    an unpinned collective backward is both visible (an extra backward
    all-reduce) and numerically wrong (gradients inflated by the group
    size).

    ``loss(params, *rest)`` must return a scalar per-rank loss (or an
    ``(loss, aux)`` tuple); ``loss_args = (params, *rest)``: ``params`` a
    module or a tree of tensors (copied as leaves that require grad),
    ``rest`` this rank's batch."""
    params, rest = loss_args[0], tuple(loss_args[1:])
    if isinstance(params, torch.nn.Module):
        leaves = [p for p in params.parameters() if p.requires_grad]
        probe_params = params
    else:
        from torch.utils._pytree import tree_map
        probe_params = tree_map(
            lambda x: x.detach().clone().requires_grad_(True)
            if isinstance(x, torch.Tensor) and x.is_floating_point()
            else x, params)
        leaves = [t for t in reachable_tensors(probe_params)
                  if t.requires_grad]

    def scalar():
        out = loss(probe_params, *rest)
        return out[0] if isinstance(out, tuple) else out

    def forward():
        with torch.no_grad():
            return scalar()

    def backward():
        return torch.autograd.grad(scalar(), leaves, allow_unused=True)

    return {
        "primal": record(forward, label=f"{label}:primal",
                         comms=[comm]).schedule,
        "grad": record(backward, label=f"{label}:grad",
                       comms=[comm]).schedule,
    }


def lint_step(fn, *args, comm=None, flavor=None, inter_size=None,
              plan=None, loss=None, loss_args=None, donate_argnums=(),
              fsdp_meta=None, fsdp_state=None, variants=None,
              census=False,
              max_const_bytes: int = DEFAULT_MAX_BYTES,
              flight_events=None, artifact_root=None, protocol_root=None,
              rules: Optional[Sequence[str]] = None,
              raise_on_error: bool = True, name: str = "",
              steps: int = 1, **kwargs) -> LintReport:
    """Lint one train step (and its optional auxiliary probes).

    ``fn``/``*args``: the step exactly as it is called; it runs
    ``steps`` times under the recorder, then ``fn.finalize()`` when the
    step has one.  Optional inputs unlock optional rules -- see
    :class:`LintContext`.  Returns the :class:`LintReport`; raises
    :class:`LintError` on error findings unless ``raise_on_error=False``.
    The step's results are on ``report.outputs``."""
    ctx = LintContext(fn, args, kwargs, name=name, comm=comm, flavor=flavor,
                      inter_size=inter_size, plan=plan,
                      loss=loss, loss_args=loss_args,
                      donate_argnums=donate_argnums, fsdp_meta=fsdp_meta,
                      fsdp_state=fsdp_state, variants=variants,
                      census=census,
                      max_const_bytes=max_const_bytes,
                      flight_events=flight_events,
                      artifact_root=artifact_root,
                      protocol_root=protocol_root, steps=steps)
    report = LintReport(target=ctx.name)
    selected = [get_rule(r) for r in rules] if rules else all_rules()
    for rule in selected:
        missing = rule.missing(ctx)
        if missing:
            reasons = [ctx.unavailable.get(m, f"{m} not provided")
                       for m in missing]
            report.skipped[rule.id] = "; ".join(reasons)
            continue
        try:
            report.findings.extend(rule.run(ctx))
        except Exception as e:  # noqa: BLE001 -- a crashed rule is a skip
            report.skipped[rule.id] = \
                f"rule crashed: {type(e).__name__}: {e}"
    report.findings.sort(
        key=lambda f: ("error", "warning", "info").index(f.severity))
    rec = ctx.recording_if_run
    report.outputs = None if rec is None else rec.result
    report.schedule = None if rec is None else rec.schedule
    if raise_on_error:
        report.raise_for_errors()
    return report


__all__ = ["LintContext", "LintError", "LintReport", "allreduce_schedule",
           "build_grad_probe", "lint_step"]
