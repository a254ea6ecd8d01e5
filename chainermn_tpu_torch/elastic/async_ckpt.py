"""Async sharded checkpointing -- persist off the critical path.

Counterpart of ``chainermn_tpu/elastic/async_ckpt.py``.  Wraps a
``_MultiNodeCheckpointer`` (:mod:`chainermn_tpu_torch.extensions.
checkpoint`) so that ``save(state, iteration)`` only pays the
device-to-host snapshot (``_snapshot_arrays``) at the step boundary; the
npz write, the atomic publish and the generation GC (``_persist``) run on
a single background thread.  Ordering guarantees (JAX's):

* **write barrier before GC** -- ``_persist`` collects old generations
  only after ``os.replace`` published the new one, and the persist thread
  handles one snapshot at a time in submission order, so GC never sees a
  half-written generation; ``_persist`` reads only the directory and runs
  no collective, so it is safe on this thread;
* **drain before read** -- ``latest_consistent_generation``, ``resume``
  and ``finalize`` drain the queue first, so a reader never races the
  writer it shares a process with;
* **bounded memory** -- at most :data:`MAX_PENDING` snapshots are held on
  the host; a save cadence faster than the disk turns into backpressure
  (visible as stall) instead of unbounded host memory.

Torch parameters and optimizer state are updated in place, so the
snapshot is a copy: CPU tensors are cloned, CUDA tensors copied into
pinned host memory on the current stream, and ``save`` returns only once
those copies have landed.  A failed write is never hidden: the error is
raised by the next ``save``, ``drain`` or ``finalize``
(:meth:`AsyncCheckpointer._raise_pending`), and the generation is not
published.

Every ``save`` appends its host-blocking time to :attr:`stall_ms` and
records an ``async_ckpt_snapshot`` flight-recorder event carrying
``async_ckpt_stall_ms`` -- the metric the perf gate's ``--elastic`` mode
budgets.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

# Snapshots allowed in flight before save() blocks (the snapshot for a
# large model is a full host copy of the state -- two is already double
# buffering).
MAX_PENDING = 2

_SENTINEL = object()


class AsyncCheckpointer:
    """Background-persist wrapper over the npz checkpointer.

    Same duck-typed interface as ``_MultiNodeCheckpointer`` (``save`` /
    ``latest_consistent_generation`` / ``resume`` / ``finalize``), plus
    :meth:`drain` (the explicit write-barrier) and the
    :attr:`stall_ms` / :attr:`last_stall_ms` stall metric.
    """

    def __init__(self, inner, max_pending: int = MAX_PENDING):
        self._inner = inner
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(max_pending)))
        self._errors: List[BaseException] = []
        self._err_lock = threading.Lock()
        self._closed = False
        self.stall_ms: List[float] = []
        self.persist_ms: List[float] = []
        self._thread = threading.Thread(
            target=self._persist_loop,
            name="chainermn-tpu-async-ckpt", daemon=True)
        self._thread.start()

    # expose the wrapped checkpointer's identity knobs (supervisor and
    # tests read these)
    @property
    def comm(self):
        return self._inner.comm

    @property
    def path(self):
        return self._inner.path

    @property
    def name(self):
        return self._inner.name

    @property
    def last_stall_ms(self) -> Optional[float]:
        return self.stall_ms[-1] if self.stall_ms else None

    # ---- the persist thread ------------------------------------------------
    def _persist_loop(self):
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                arrays, iteration = item
                t0 = time.perf_counter()
                try:
                    # _persist publishes atomically THEN GCs -- the
                    # write-barrier before GC lives inside it
                    self._inner._persist(arrays, iteration)
                except BaseException as e:  # surfaced at the next barrier
                    with self._err_lock:
                        self._errors.append(e)
                else:
                    self.persist_ms.append(
                        (time.perf_counter() - t0) * 1e3)
            finally:
                self._q.task_done()

    def _raise_pending(self):
        with self._err_lock:
            errs, self._errors = self._errors, []
        if errs:
            raise RuntimeError(
                f"async checkpoint persist failed for "
                f"{len(errs)} snapshot(s); first error below -- the "
                f"generations were NOT published") from errs[0]

    # ---- interface ---------------------------------------------------------
    def save(self, state, iteration: int):
        """Snapshot to host and return; the write happens in the
        background.  Blocks only for the device-to-host copy (the copy has
        landed when this returns, so the next in-place optimizer step
        cannot reach the snapshot) plus backpressure if ``max_pending``
        snapshots are already queued -- that blocking time is the recorded
        stall."""
        from chainermn_tpu_torch.observability import flight_recorder as _flight

        if self._closed:
            raise RuntimeError("AsyncCheckpointer used after finalize()")
        self._raise_pending()
        t0 = time.perf_counter()
        arrays = self._inner._snapshot_arrays(state)
        self._q.put((arrays, iteration))
        stall = (time.perf_counter() - t0) * 1e3
        self.stall_ms.append(stall)
        fr = _flight.get_flight_recorder()
        if fr is not None:
            fr.record("checkpoint", op="async_ckpt_snapshot",
                      iteration=iteration, async_ckpt_stall_ms=stall)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued snapshot is published (the explicit
        write barrier).  Returns False on timeout.  Raises if any
        background persist failed."""
        # Queue.join without the unbounded wait: ride the queue's own
        # all_tasks_done condition so "idle" can't race a concurrent put
        endtime = None if timeout is None else time.monotonic() + timeout
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                if endtime is None:
                    self._q.all_tasks_done.wait()
                else:
                    remaining = endtime - time.monotonic()
                    if remaining <= 0:
                        self._raise_pending()
                        return False
                    self._q.all_tasks_done.wait(remaining)
        self._raise_pending()
        return True

    # resume-side reads see all of this process's own writes
    def latest_consistent_generation(self):
        self.drain()
        return self._inner.latest_consistent_generation()

    def resume(self, state):
        self.drain()
        return self._inner.resume(state)

    def finalize(self):
        """Drain, stop the persist thread, surface any background
        errors, then run the inner finalize (cross-rank barrier)."""
        if not self._closed:
            self._closed = True
            self.drain()
            self._q.put(_SENTINEL)
            self._thread.join(timeout=30.0)
        self._raise_pending()
        self._inner.finalize()


__all__ = ["AsyncCheckpointer", "MAX_PENDING"]
