"""Instrumented communicators -- the collective data path, measured.

Counterpart of ``chainermn_tpu/observability/instrument.py``.  Wraps any
:class:`~chainermn_tpu_torch.communicators.communicator_base.
CommunicatorBase` so every collective and object-plane call records

* call count                      (``comm_collective_calls`` /
                                   ``comm_object_calls`` counters),
* payload bytes + wire dtype      (``comm_collective_bytes``,
                                   labeled ``dtype=...``),
* host-side latency               (``comm_collective_seconds`` /
                                   ``comm_object_seconds`` histograms),

and runs under a ``torch.profiler.record_function`` range named
``chainermn_tpu.<op>`` (JAX's ``TraceAnnotation`` names), so a profiler
capture lines up with the metrics.

Semantics note: the port's collectives are eager, so every call is one
executed collective.  ``comm_collective_seconds`` is still a host-side
latency: an NCCL collective returns once it is enqueued on the stream, so
on the card the histogram holds the launch (and any host synchronization
the call makes), not the wire time -- that shows in the trainer's
``device_block`` phase and in a profiler capture.  Names, labels, call
counts and bytes are JAX's (its dtype labels are numpy names:
``float32``, ``float16``, ``bfloat16``).
"""

from __future__ import annotations

import time
from typing import Optional

from chainermn_tpu_torch.observability import registry as _registry


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):  # jax.tree.leaves' key order
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "parameters") and callable(tree.parameters):
        yield from tree.parameters()  # a module: its parameters
    elif tree is not None:
        yield tree


def _dtype_name(dt) -> str:
    s = str(dt)
    return s[len("torch."):] if s.startswith("torch.") else s


def _payload_bytes(tree) -> int:
    """Total bytes of a tree's tensor leaves (shape x itemsize)."""
    total = 0
    for leaf in _leaves(tree):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        n = 1
        for d in shape:
            n *= int(d)
        item = getattr(leaf, "element_size", None)
        total += n * (item() if callable(item) else dtype.itemsize)
    return total


def _leaf_dtype(tree) -> str:
    for leaf in _leaves(tree):
        dt = getattr(leaf, "dtype", None)
        if dt is not None:
            return _dtype_name(dt)
    return "object"


class InstrumentedCommunicator:
    """Transparent recording proxy around a communicator.

    Every attribute not instrumented here delegates to the wrapped
    communicator, so the proxy drops into ``make_train_step``, the
    updaters, and the evaluators unchanged.  ``split``/``split_axes``
    re-wrap their sub-communicators so instrumentation follows the
    topology.
    """

    _COLLECTIVES = ("allreduce", "bcast", "allgather", "alltoall", "gather",
                    "scatter", "reduce_scatter", "ppermute",
                    "allreduce_grad", "multi_node_mean_grad", "bcast_data")
    _OBJECT_OPS = ("send_obj", "recv_obj", "bcast_obj", "gather_obj",
                   "allgather_obj", "scatter_obj", "allreduce_obj", "barrier")

    def __init__(self, comm, registry: Optional[_registry.MetricsRegistry] = None):
        from chainermn_tpu_torch.observability import flight_recorder as _flight

        self._comm = comm
        self._registry = registry or _registry.get_registry()
        self._comm_label = type(comm).__name__
        # Flight-recorder seam, bound once here (None when observability
        # is off -- the proxy only exists when enabled or forced anyway).
        self._flight = _flight.get_flight_recorder()
        r = self._registry
        self._calls = r.counter(
            "comm_collective_calls",
            "collective invocations (one per eager call)")
        self._bytes = r.counter(
            "comm_collective_bytes",
            "payload bytes entering each collective, labeled by wire dtype")
        self._seconds = r.histogram(
            "comm_collective_seconds",
            "host-side collective latency (enqueue time on the card)")
        self._obj_calls = r.counter(
            "comm_object_calls", "control-plane object-op invocations")
        self._obj_seconds = r.histogram(
            "comm_object_seconds", "control-plane object-op host latency")

    # ---- recording core ----------------------------------------------------
    def _span(self, op: str):
        import torch

        return torch.profiler.record_function(f"chainermn_tpu.{op}")

    def _run_collective(self, op: str, payload, fn):
        wire = getattr(self._comm, "allreduce_grad_dtype", None)
        dtype = _dtype_name(wire) if (
            wire is not None and op in ("allreduce_grad",
                                        "multi_node_mean_grad")
        ) else _leaf_dtype(payload)
        nbytes = _payload_bytes(payload)
        self._calls.inc(op=op, comm=self._comm_label)
        self._bytes.inc(nbytes, op=op, comm=self._comm_label, dtype=dtype)
        tok = None
        if self._flight is not None:
            tok = self._flight.span_begin("collective", op,
                                          comm=self._comm_label,
                                          nbytes=nbytes)
        t0 = time.perf_counter()
        try:
            with self._span(op):
                out = fn()
        finally:
            if tok is not None:
                self._flight.span_end(tok)
        self._seconds.observe(time.perf_counter() - t0, op=op,
                              comm=self._comm_label)
        return out

    def _run_object(self, op: str, fn):
        self._obj_calls.inc(op=op, comm=self._comm_label)
        tok = None
        if self._flight is not None:
            tok = self._flight.span_begin("object", op,
                                          comm=self._comm_label)
        t0 = time.perf_counter()
        try:
            with self._span(op):
                out = fn()
        finally:
            if tok is not None:
                self._flight.span_end(tok)
        self._obj_seconds.observe(time.perf_counter() - t0, op=op,
                                  comm=self._comm_label)
        return out

    # ---- gradient entry points (the hot path) ------------------------------
    def allreduce_grad(self, grads, *, compressor=None, state=None):
        return self._run_collective(
            "allreduce_grad", grads,
            lambda: self._comm.allreduce_grad(
                grads, compressor=compressor, state=state))

    multi_node_mean_grad = allreduce_grad

    def _allreduce_grad_start(self, grads):
        """The double-buffered optimizer's seam: the mean is started here
        and finished a step later, so the call counts (and its bytes) as
        one ``allreduce_grad`` and its latency is the start's."""
        return self._run_collective(
            "allreduce_grad", grads,
            lambda: self._comm._allreduce_grad_start(grads))

    def bcast_data(self, params):
        return self._run_collective(
            "bcast_data", params, lambda: self._comm.bcast_data(params))

    # ---- traced array collectives ------------------------------------------
    def allreduce(self, x, op: str = "sum"):
        return self._run_collective(
            "allreduce", x, lambda: self._comm.allreduce(x, op=op))

    def bcast(self, x, root: int = 0):
        return self._run_collective(
            "bcast", x, lambda: self._comm.bcast(x, root=root))

    def allgather(self, x):
        return self._run_collective(
            "allgather", x, lambda: self._comm.allgather(x))

    def alltoall(self, xs):
        return self._run_collective(
            "alltoall", xs, lambda: self._comm.alltoall(xs))

    def gather(self, x, root: int = 0):
        return self._run_collective(
            "gather", x, lambda: self._comm.gather(x, root=root))

    def scatter(self, x, root: int = 0):
        return self._run_collective(
            "scatter", x, lambda: self._comm.scatter(x, root=root))

    def reduce_scatter(self, x):
        return self._run_collective(
            "reduce_scatter", x, lambda: self._comm.reduce_scatter(x))

    def ppermute(self, x, perm):
        return self._run_collective(
            "ppermute", x, lambda: self._comm.ppermute(x, perm))

    # ---- object plane ------------------------------------------------------
    def send_obj(self, obj, dest, tag=0):
        return self._run_object(
            "send_obj", lambda: self._comm.send_obj(obj, dest, tag=tag))

    def recv_obj(self, source, tag=0):
        return self._run_object(
            "recv_obj", lambda: self._comm.recv_obj(source, tag=tag))

    # The wrapper must mirror the FULL wrapped signature, tag included —
    # gather_telemetry rides tag=TELEMETRY_TAG through gather_obj, and
    # dropping ``tag=`` here TypeErrored every instrumented telemetry
    # gather (the wrapper-surface-drift protocol rule now guards this).
    def bcast_obj(self, obj, root=0, tag=0):
        return self._run_object(
            "bcast_obj",
            lambda: self._comm.bcast_obj(obj, root=root, tag=tag))

    def gather_obj(self, obj, root=0, tag=0):
        return self._run_object(
            "gather_obj",
            lambda: self._comm.gather_obj(obj, root=root, tag=tag))

    def allgather_obj(self, obj, tag=0):
        return self._run_object(
            "allgather_obj", lambda: self._comm.allgather_obj(obj, tag=tag))

    def scatter_obj(self, objs, root=0, tag=0):
        return self._run_object(
            "scatter_obj",
            lambda: self._comm.scatter_obj(objs, root=root, tag=tag))

    def allreduce_obj(self, obj, op="sum", tag=0):
        return self._run_object(
            "allreduce_obj",
            lambda: self._comm.allreduce_obj(obj, op=op, tag=tag))

    def barrier(self, tag=900):
        return self._run_object("barrier", lambda: self._comm.barrier(tag=tag))

    # ---- sub-communicators stay instrumented -------------------------------
    def split(self, color: int, key: int):
        return InstrumentedCommunicator(
            self._comm.split(color, key), registry=self._registry)

    def split_axes(self, axes):
        return InstrumentedCommunicator(
            self._comm.split_axes(axes), registry=self._registry)

    # ---- transparent delegation --------------------------------------------
    @property
    def wrapped(self):
        """The underlying (uninstrumented) communicator."""
        return self._comm

    def __getattr__(self, name):
        # only called for names not defined above: topology properties,
        # the process groups, plan(), compression state, ...
        return getattr(self._comm, name)

    def __repr__(self):
        return f"InstrumentedCommunicator({self._comm!r})"


def instrument_communicator(comm, registry=None, force: bool = False):
    """Wrap ``comm`` with metric recording when observability is enabled
    (or ``force=True``); otherwise return ``comm`` unchanged, so call
    sites can wrap unconditionally at zero disabled-path cost.  Idempotent:
    an already-instrumented communicator is returned as-is."""
    if isinstance(comm, InstrumentedCommunicator):
        return comm
    if not (force or _registry.enabled()):
        return comm
    return InstrumentedCommunicator(comm, registry=registry)
