"""Watchdog-driven auto-restart supervisor.

Counterpart of ``chainermn_tpu/elastic/supervisor.py``.  Launch the
N-rank world (:mod:`chainermn_tpu_torch.utils.proc_world`: one process per
rank, the ``CHAINERMN_TPU_*`` / ``torchrun`` environment contract), watch
the children, and when one dies -- SIGKILLed by a preemption, wedged past
its deadline, or crashed -- give the survivors' watchdogs a moment to
dump, kill the survivors (blocked in collectives against a dead peer, or
aborted by NCCL's own error handling, they hold their cards until they
exit), harvest every ``flight_<rank>.json`` the watchdog and crash
handlers left, write a ``restart_manifest/v1`` naming the incident, and
relaunch.  The relaunched workers resume from the newest consistent
generation themselves (:func:`~chainermn_tpu_torch.elastic.resize.
resume_resized`, which also reshards when the attempt runs another world
size -- the ``resize_schedule`` knob); with per-step saves that bounds
lost work to one step.

Where JAX chooses the CPU with ``JAX_PLATFORMS``, a child here runs on
``cuda:LOCAL_RANK`` unless its attempt's device is ``"cpu"``
(``device``, or ``device_schedule`` per attempt, as ``resize_schedule``).
A child's output goes to files under ``log_dir``, never to pipes the
supervisor only polls.  A world whose ranks all exit 0 but did not all
print a ``RESULT`` line is an error, not a success.

``python -m chainermn_tpu_torch.tools.elastic_run`` is the CLI over this
class; ``python -m chainermn_tpu_torch.tools.elastic_smoke`` drives it
under fault injection.
"""

from __future__ import annotations

import glob
import os
import re
import time
import zipfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from chainermn_tpu_torch.elastic.manifest import (build_restart_manifest,
                                                  write_restart_manifest)
from chainermn_tpu_torch.utils.proc_world import kill_world, launch_world


def scan_latest_generation(path: str, name: str = "snapshot",
                           n_ranks: Optional[int] = None) -> Optional[int]:
    """Newest generation in a checkpoint directory whose rank files form
    a complete, readable set -- the supervisor-side, communicator-free
    mirror of ``latest_consistent_generation`` and the resize path's
    all-rank scan.  ``n_ranks`` pins how many rank files make a
    generation complete (the next attempt's world size); without it a
    set contiguous from 0 is trusted, which over-reports when one rank
    raced a generation ahead before the crash (its lone ``rank0`` file
    would look complete).  Returns ``None`` when the directory holds
    nothing resumable."""
    try:
        names = os.listdir(path)
    except OSError:
        return None
    pat = re.compile(rf"^{re.escape(name)}\.(\d+)\.rank(\d+)\.npz$")
    by_gen: Dict[int, set] = {}
    for f in names:
        m = pat.match(f)
        if m:
            by_gen.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
    for g in sorted(by_gen, reverse=True):
        ranks = by_gen[g]
        want = set(range(len(ranks) if n_ranks is None else n_ranks))
        if not want <= ranks:
            # stale files of a LARGER pre-resize world are fine
            # (supersets); missing needed ranks are not
            continue
        ok = True
        for r in want:
            fn = os.path.join(path, f"{name}.{g}.rank{r}.npz")
            try:
                with zipfile.ZipFile(fn) as z:
                    if z.testzip() is not None:
                        ok = False
                        break
            except (OSError, zipfile.BadZipFile):
                ok = False
                break
        if ok:
            return g
    return None


@dataclass
class SupervisorConfig:
    """Knobs of one supervised run."""
    n_procs: int = 2                 # ranks per attempt
    #: device of every attempt's ranks: None is cuda:LOCAL_RANK, "cpu"
    #: the CPU (gloo)
    device: Optional[str] = None
    max_restarts: int = 3            # incidents tolerated before giving up
    attempt_timeout_s: float = 600.0
    dump_dir: str = "."              # where children write flight dumps
    out_dir: str = "."               # where restart manifests land
    ckpt_path: Optional[str] = None  # checkpoint dir (resume reporting)
    ckpt_name: str = "snapshot"
    repo: Optional[str] = None
    #: world size per attempt (index clamped to the last entry); None
    #: keeps ``n_procs`` -- a shrinking schedule is how a preempted run
    #: continues on the surviving cards (elastic resize)
    resize_schedule: Optional[Sequence[int]] = None
    #: device per attempt, as ``resize_schedule`` (None keeps ``device``)
    device_schedule: Optional[Sequence[Optional[str]]] = None
    #: extra env for every child (watchdog knobs ride here -- e.g.
    #: ``WatchdogConfig(...).to_env()``)
    env: Dict[str, str] = field(default_factory=dict)
    poll_interval_s: float = 0.1
    #: after a death, how long the survivors may take to dump (their
    #: watchdogs' heartbeat timeout, peer collection and clock probes);
    #: the wait ends as soon as every survivor has dumped
    dump_grace_s: float = 3.0
    #: where each child's stdout/stderr files go (default
    #: ``{out_dir}/logs``)
    log_dir: Optional[str] = None

    def world_for_attempt(self, attempt: int) -> int:
        if not self.resize_schedule:
            return self.n_procs
        i = min(attempt, len(self.resize_schedule) - 1)
        return int(self.resize_schedule[i])

    def device_for_attempt(self, attempt: int) -> Optional[str]:
        if not self.device_schedule:
            return self.device
        i = min(attempt, len(self.device_schedule) - 1)
        return self.device_schedule[i]


class Supervisor:
    """Launch / monitor / manifest / relaunch loop over one worker
    program (a ``python -c`` source string: workers bootstrap from the
    environment contract and print a ``RESULT {json}`` line).

    ``on_incident(manifest_doc)`` / ``on_recovered(attempt)`` hooks let a
    serving harness drain a lost replica's sessions from its router while
    the world is down and re-admit them once the relaunch is up."""

    def __init__(self, worker_src: str, config: SupervisorConfig,
                 on_incident: Optional[Callable[[dict], None]] = None,
                 on_recovered: Optional[Callable[[int], None]] = None):
        self.worker_src = worker_src
        self.cfg = config
        self.on_incident = on_incident
        self.on_recovered = on_recovered
        self.manifests: List[str] = []
        self.incidents: List[dict] = []
        self.attempts: List[dict] = []
        self._procs = []

    # ---- child lifecycle ---------------------------------------------------
    def _log_dir(self) -> str:
        return self.cfg.log_dir or os.path.join(self.cfg.out_dir or ".",
                                                "logs")

    def _launch(self, attempt: int):
        cfg = self.cfg
        env = dict(cfg.env)
        env.update({"CHAINERMN_TPU_FLIGHT_DIR": cfg.dump_dir,
                    "CHAINERMN_TPU_ELASTIC_ATTEMPT": str(attempt)})
        # a fresh port pair per attempt: the previous attempt's (possibly
        # dead) store cannot be rebound reliably
        return launch_world(self.worker_src, cfg.world_for_attempt(attempt),
                            self._log_dir(), cfg.device_for_attempt(attempt),
                            cfg.repo, env, tag=f"attempt{attempt}.")

    def _kill_survivors(self):
        """SIGKILL every rank still running and reap it: a rank's cards
        are free once its process is gone."""
        kill_world(self._procs)

    def _clear_dumps(self):
        """Drop harvested flight dumps so the next attempt's evidence
        window starts clean (they live on, embedded in the manifest)."""
        for f in glob.glob(os.path.join(self.cfg.dump_dir,
                                        "flight_*.json")):
            try:
                os.remove(f)
            except OSError:
                pass

    # ---- the loop ----------------------------------------------------------
    def run(self) -> dict:
        """Supervise until an attempt completes cleanly or the restart
        budget is exhausted.  Returns ``{"results", "attempts",
        "manifests", "incidents"}``; raises ``RuntimeError`` after
        ``max_restarts`` failed attempts (with every manifest already
        on disk), or when a clean attempt's ranks did not all report."""
        attempt = 0
        incident = 0
        while True:
            world = self.cfg.world_for_attempt(attempt)
            resume_gen = scan_latest_generation(
                self.cfg.ckpt_path, self.cfg.ckpt_name, n_ranks=world) \
                if self.cfg.ckpt_path else None
            started = time.time()
            self._procs = self._launch(attempt)
            failure = self._watch()
            record = {"attempt": attempt, "world": world,
                      "device": self.cfg.device_for_attempt(attempt),
                      "resume_generation": resume_gen,
                      "duration_s": time.time() - started,
                      "failure": failure}
            self.attempts.append(record)
            if failure is None:
                results = self._collect_results()
                if self.on_recovered is not None and attempt > 0:
                    self.on_recovered(attempt)
                return {"results": results, "attempts": self.attempts,
                        "manifests": self.manifests,
                        "incidents": self.incidents}
            # incident: the survivors are already dead (killed by
            # _watch); manifest the evidence, then decide on a relaunch
            next_world = self.cfg.world_for_attempt(attempt + 1)
            next_gen = scan_latest_generation(
                self.cfg.ckpt_path, self.cfg.ckpt_name,
                n_ranks=next_world) \
                if self.cfg.ckpt_path else None
            doc = build_restart_manifest(
                incident=incident, reason=failure["reason"],
                dump_dir=self.cfg.dump_dir,
                exit_codes=failure["exit_codes"],
                resume_generation=next_gen,
                attempt=attempt,
                world_before=world, world_after=next_world,
                watchdog_config=self._watchdog_env_view(),
                extra={"stderr_tails": failure["stderr_tails"]})
            path = write_restart_manifest(doc, self.cfg.out_dir)
            self.manifests.append(path)
            self.incidents.append({"incident": incident,
                                   "reason": failure["reason"],
                                   "manifest": path})
            if self.on_incident is not None:
                self.on_incident(doc)
            self._clear_dumps()
            incident += 1
            attempt += 1
            if incident > self.cfg.max_restarts:
                raise RuntimeError(
                    f"elastic supervisor: gave up after {incident} "
                    f"incidents (max_restarts={self.cfg.max_restarts}); "
                    f"manifests: {self.manifests}")

    def _watchdog_env_view(self) -> Optional[dict]:
        wd = {k: v for k, v in self.cfg.env.items()
              if k.startswith("CHAINERMN_TPU_WATCHDOG")}
        return wd or None

    def _watch(self) -> Optional[dict]:
        """Poll the children until all exit cleanly (None) or a failure
        is detected (dict with reason / exit codes / stderr tails; every
        survivor killed before returning)."""
        deadline = time.monotonic() + self.cfg.attempt_timeout_s
        while True:
            states = [p.poll() for p in self._procs]
            bad = [(r, st) for r, st in enumerate(states)
                   if st is not None and st != 0]
            if bad:
                r0, st0 = bad[0]
                reason = (f"rank {r0} exited rc={st0}"
                          + (" (killed)" if st0 < 0 else ""))
                # give the surviving watchdogs a moment to notice the
                # heartbeat loss and dump before they are taken down
                self._await_survivor_dumps(self.cfg.dump_grace_s)
                return self._failure(reason)
            if all(st is not None for st in states):
                return None
            if time.monotonic() > deadline:
                alive = [r for r, st in enumerate(states) if st is None]
                return self._failure(
                    f"attempt timeout after "
                    f"{self.cfg.attempt_timeout_s:.0f}s; rank(s) "
                    f"{alive} still running")
            time.sleep(self.cfg.poll_interval_s)

    def _await_survivor_dumps(self, window_s: float = 3.0):
        """Brief grace window after a death: the surviving ranks'
        watchdogs (heartbeat-loss predicate) or crash handlers may still
        be writing their flight dumps."""
        deadline = time.monotonic() + window_s
        alive = [p for p in self._procs if p.poll() is None]
        if not alive:
            return
        want = len(self._procs)
        while time.monotonic() < deadline:
            have = len(glob.glob(os.path.join(
                self.cfg.dump_dir, "flight_*.json")))
            if have >= want - 1:  # the killed rank leaves none
                return
            if all(p.poll() is not None for p in alive):
                return
            time.sleep(0.1)

    def _failure(self, reason: str) -> dict:
        self._kill_survivors()
        tails = {}
        codes = {}
        for r, p in enumerate(self._procs):
            codes[r] = p.poll()
            err = p.stderr()
            if err:
                tails[str(r)] = err[-2000:]
        return {"reason": reason, "exit_codes": codes,
                "stderr_tails": tails}

    def _collect_results(self) -> Dict[int, dict]:
        results: Dict[int, dict] = {}
        missing = []
        for r, p in enumerate(self._procs):
            res = p.result()
            if res is None:
                missing.append(r)
            else:
                results[r] = res
        if missing:
            raise RuntimeError(
                f"elastic supervisor: rank(s) {missing} exited 0 without a "
                f"RESULT line; stderr of rank {missing[0]}:\n"
                f"{self._procs[missing[0]].stderr()[-2000:]}")
        return results


__all__ = ["Supervisor", "SupervisorConfig", "scan_latest_generation"]
