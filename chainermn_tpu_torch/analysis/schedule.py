"""``CollectiveSchedule`` -- the canonical ordered collective list.

Counterpart of ``chainermn_tpu/analysis/schedule.py``.  A communicator
flavor *is* its collective decomposition, so the unit the static analyzer
reasons about is the ordered list of collectives a program issues.  JAX
reads it from a traced jaxpr; an eager PyTorch step has no trace, so the
port reads it from one run of the step:

* :func:`extract_schedule` runs ``fn`` once under a
  :class:`ScheduleRecorder`, a ``TorchDispatchMode`` that sees every
  ``c10d.*`` op the step dispatches (``allreduce_``, ``broadcast_``,
  ``_allgather_base_``, ``_reduce_scatter_base_``, ``alltoall_base_``,
  ``send``/``recv_``, ...) with its tensors: kind, dtype, element count,
  process group and async flag.  Given ``rank=`` and ``world=`` it runs
  **dry**: inside :func:`dry_world`, a fake process group of that size
  (``torch.testing._internal.distributed.fake_pg``) whose collectives
  return at once, so one process runs any rank of any world and records
  each collective without issuing it.  The same recorder collects the
  storages each aten op reads and writes (``captured-constant`` and
  ``donation-alias`` read those, :mod:`.captured`), and the work handles
  the step waits on (``async-pair``).  It does not see the kernels the
  port launches through ctypes or Triton, and it does not need to: they
  move no data between ranks.
* :func:`schedule_from_hlo` reads a compiled TPU program's HLO text
  (the committed census artifacts) through :mod:`.hlo`.

The recorder only watches: every op runs as it would bare, so a recorded
step is bit-equal to the same step run without it.

A recorded op's ``dtype`` is the HLO token (``f32``, ``bf16``, ``s8``...)
so recorded and HLO schedules compare alike; its ``axes`` is the name of
the communicator group it ran on (``intra``, ``inter``, ``world``,
``obj``) where the recorder was told the communicator, its ``groups`` the
group's global ranks.  Schedules canonicalize
(:meth:`CollectiveSchedule.canonical`) so per-rank / per-config schedules
compare for the static version of the flight recorder's
``identify_desync``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from chainermn_tpu_torch.analysis.hlo import HloParse, parse_hlo_collectives

#: ``c10d`` op name -> collective kind (the recorder's own kinds; HLO's
#: spelling where the two share an op)
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "broadcast_": "broadcast",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "send",
    "recv_": "recv",
    "recv_any_source_": "recv",
    "reduce_": "reduce",
    "gather_": "gather",
    "scatter_": "scatter",
    "barrier": "barrier",
    "monitored_barrier_": "barrier",
}

#: torch dtype name -> HLO shape dtype token
TORCH_TO_HLO_DTYPE = {
    "float64": "f64", "float32": "f32", "float16": "f16",
    "bfloat16": "bf16", "float8_e4m3fn": "f8e4m3fn",
    "float8_e5m2": "f8e5m2", "int64": "s64", "int32": "s32",
    "int16": "s16", "int8": "s8", "uint8": "u8", "bool": "pred",
}

#: schema argument names that carry a collective's payload
_PAYLOAD_ARGS = ("tensors", "input_tensor", "input", "input_tensors",
                 "inputs", "input_list")


def hlo_dtype(dtype) -> str:
    """HLO token of a torch dtype (``torch.float32`` -> ``"f32"``)."""
    name = str(dtype).replace("torch.", "")
    return TORCH_TO_HLO_DTYPE.get(name, name)


@dataclass(frozen=True)
class CollectiveOp:
    """One collective, from either extractor.  ``axes`` is the recorded
    op's communicator group name (None for HLO ops and unnamed groups);
    ``groups`` the group's global ranks (recorded) or the HLO
    replica_groups text.  ``stage`` is ``(op, lowering, wire)`` of the
    plan stage the executor was running when the op was issued."""
    kind: str
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int
    axes: Optional[Tuple[str, ...]] = None
    groups: Optional[str] = None
    path: Tuple[str, ...] = ()
    source: Optional[str] = None
    async_op: bool = False
    stage: Optional[Tuple[str, str, str]] = None
    reduce: Optional[str] = None

    @property
    def key(self) -> tuple:
        """Order-sensitive identity used for schedule comparison: kind,
        where it communicates (axes or groups), and what it moves (a
        recorded reduction also by its op: JAX's psum and pmax are two
        primitives)."""
        key = (self.kind, self.axes or self.groups, self.dtype,
               self.nbytes)
        return key + (self.reduce,) if self.reduce else key

    def describe(self) -> str:
        where = ("axes=" + ",".join(self.axes) if self.axes
                 else f"groups={self.groups}" if self.groups else "?")
        kind = f"{self.kind}({self.reduce})" if self.reduce else self.kind
        return (f"{kind}[{self.dtype}, {self.nbytes}B, {where}]"
                + (f" @ {'/'.join(self.path)}" if self.path else ""))


@dataclass
class CollectiveSchedule:
    """Ordered collectives of one recorded/compiled program."""
    ops: List[CollectiveOp] = field(default_factory=list)
    origin: str = "recorded"         # "recorded" | "census" | "hlo"
    label: str = ""                  # e.g. "rank0", "flavor=xla"
    problems: List[dict] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self) -> Iterator[CollectiveOp]:
        return iter(self.ops)

    def canonical(self) -> Tuple[tuple, ...]:
        return tuple(op.key for op in self.ops)

    def kinds(self) -> Tuple[str, ...]:
        return tuple(op.kind for op in self.ops)

    def count_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0) + 1
        return out

    def counts_by_axes(self, kind: str) -> Dict[tuple, int]:
        out: Dict[tuple, int] = {}
        for op in self.ops:
            if op.kind == kind:
                k = op.axes or (op.groups,)
                out[k] = out.get(k, 0) + 1
        return out

    def diff(self, other: "CollectiveSchedule") -> Optional[dict]:
        """First structural divergence against ``other`` (None when the
        canonical schedules agree) -- op index, and each side's op (or
        None past the shorter schedule's end)."""
        a, b = self.canonical(), other.canonical()
        if a == b:
            return None
        for i in range(max(len(a), len(b))):
            if i >= len(a) or i >= len(b) or a[i] != b[i]:
                return {
                    "index": i,
                    "left": self.ops[i].describe() if i < len(a) else None,
                    "right": other.ops[i].describe() if i < len(b) else None,
                    "left_label": self.label,
                    "right_label": other.label,
                }
        return None  # pragma: no cover -- unreachable given a != b


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _work_classes():
    import torch._C._distributed_c10d as c10d
    return [c for c in vars(c10d).values()
            if isinstance(c, type) and issubclass(c, c10d.Work)
            and "wait" in vars(c)]


def _storage_key(t: torch.Tensor) -> Optional[Tuple[str, int, int]]:
    """``(device, data_ptr, nbytes)`` of a tensor's storage (None for an
    empty or storage-less tensor)."""
    try:
        st = t.untyped_storage()
        nbytes = st.nbytes()
        ptr = st.data_ptr()
    except (RuntimeError, NotImplementedError):
        return None
    if not nbytes or not ptr:
        return None
    return (str(t.device), ptr, nbytes)


def _tensors(value) -> List[torch.Tensor]:
    return [x for x in tree_flatten(value)[0] if isinstance(x, torch.Tensor)]


def _reduce_name(op) -> Optional[str]:
    """``"sum"``, ``"max"``... of a c10d ``ReduceOp`` argument."""
    if not isinstance(op, torch.ScriptObject):
        return None
    names = {int(v): k.lower()
             for k, v in dist.ReduceOp.RedOpType.__members__.items()}
    return names.get(int(op.op()))


def _stage_now() -> Optional[Tuple[str, str, str]]:
    """``(op, lowering, wire)`` of the plan stage the executor runs."""
    from chainermn_tpu_torch.planner import compiler
    st = compiler._STAGE
    if st is None:
        return None
    wire = ""
    if st.compression is not None:
        wire = compiler._wire_of(st.compressor())
    elif st.wire_dtype is not None:
        wire = str(st.wire_dtype)
    return (st.op, st.lowering or "default", wire)


class ScheduleRecorder(TorchDispatchMode):
    """Records, in dispatch order, every ``c10d`` collective and the
    storages each aten op reads and writes.

    ``group_names`` (set once the run is over: groups a dry run builds
    do not exist before it) maps process-group objects to names (see
    :func:`group_names`); ``known`` holds the storage keys of the step's
    arguments (:func:`.captured.reachable_tensors`); ``dry`` (default: the
    default group is :func:`dry_world`'s) zeroes what each collective
    receives.  After the
    block:

    * ``ops`` -- the :class:`CollectiveOp` list;
    * ``works`` -- ``(index into ops, work)`` of every op, and
      ``waited`` -- ids of the work handles whose ``wait()`` ran inside
      the block (``wait`` is wrapped on every ``Work`` class while the
      recorder is open); ``foreign_waits`` -- op count at each wait of a
      handle no recorded op returned (a coalesced batch of p2p ops);
    * ``captured`` -- storage key -> ``{"shape", "dtype", "nbytes",
      "op"}`` of storages an op read that neither the arguments hold nor
      an earlier op of the block created;
    * ``written`` -- storage keys an op wrote in place.
    """

    def __init__(self, known=(), dry: Optional[bool] = None):
        super().__init__()
        self.dry = is_dry() if dry is None else dry
        self.group_names: Dict[int, str] = {}
        self.known = set(known)
        self.created: set = set()
        self.captured: Dict[tuple, dict] = {}
        self.written: set = set()
        self.dtypes: Dict[tuple, torch.dtype] = {}
        self.ops: List[CollectiveOp] = []
        self.op_groups: list = []
        self.works: List[Tuple[int, Any]] = []
        self.waited: set = set()
        self.foreign_waits: List[int] = []
        self._patched: List[Tuple[type, Callable]] = []

    # -- wait() tracking ----------------------------------------------------

    def __enter__(self):
        for cls in _work_classes():
            orig = vars(cls)["wait"]

            def wait(work, *a, _orig=orig, **k):
                if any(w is work for _, w in self.works):
                    self.waited.add(id(work))
                else:
                    self.foreign_waits.append(len(self.ops))
                return _orig(work, *a, **k)
            setattr(cls, "wait", wait)
            self._patched.append((cls, orig))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for cls, orig in self._patched:
                setattr(cls, "wait", orig)
            self._patched = []

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            op = self._collective(func, args, kwargs)
            out = func(*args, **kwargs)
            if op is not None and self.dry:
                self._fill_received(func, args, kwargs)
            if op is not None:
                self.ops.append(op)
                work = out[-1] if isinstance(out, tuple) else out
                if isinstance(work, torch.ScriptObject):
                    import torch._C._distributed_c10d as c10d
                    try:
                        self.works.append((len(self.ops) - 1,
                                           c10d.Work.unbox(work)))
                    except RuntimeError:
                        pass
            return out
        self._reads(func, args, kwargs)
        out = func(*args, **kwargs)
        ins = {_storage_key(t) for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            key = _storage_key(t)
            if key is None:
                continue
            if key not in self.known:
                self.created.add(key)
            if key not in ins:  # a new buffer (not a view or in-place)
                self.dtypes[key] = t.dtype
        return out

    def _fill_received(self, func, args, kwargs) -> None:
        """Zero the buffers a collective receives into apart from its
        input (a recv's tensors, a gather's or an exchange's output): the
        fake group leaves them as allocated, and a dry step that indexes
        with received tokens must read defined values.  In-place
        reductions and broadcasts keep this rank's own values."""
        name = func.__name__.split(".")[0]
        for i, a in enumerate(func._schema.arguments):
            if not (a.name.startswith("output")
                    or (name.startswith("recv") and a.name == "tensors")):
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            with torch.no_grad():
                for t in _tensors(v):
                    t.zero_()

    def _reads(self, func, args, kwargs) -> None:
        schema = func._schema.arguments
        for i, a in enumerate(schema):
            value = args[i] if i < len(args) else kwargs.get(a.name)
            if value is None:
                continue
            ts = _tensors(value)
            write = a.alias_info is not None and a.alias_info.is_write
            for t in ts:
                key = _storage_key(t)
                if key is None:
                    continue
                if write:
                    self.written.add(key)
                if key in self.known or key in self.created:
                    continue
                if write and a.name == "out":
                    self.created.add(key)
                    continue
                prev = self.captured.get(key)
                if prev is None:
                    self.captured[key] = {
                        "shape": tuple(int(d) for d in t.shape),
                        "dtype": str(t.dtype).replace("torch.", ""),
                        "nbytes": key[2], "device": key[0],
                        "op": str(func)}

    def _collective(self, func, args, kwargs) -> Optional[CollectiveOp]:
        name = func.__name__.split(".")[0]
        kind = COLLECTIVE_KINDS.get(name)
        if kind is None:
            return None
        schema = func._schema.arguments
        names = [a.name for a in schema]

        def arg(n):
            if n not in names:
                return None
            i = names.index(n)
            if i < len(args):
                return args[i]
            return kwargs.get(n, schema[i].default_value)

        payload: List[torch.Tensor] = []
        for n in _PAYLOAD_ARGS:
            payload = _tensors(arg(n))
            if payload:
                break
        first = payload[0] if payload else None
        dtype = first.dtype if first is not None else None
        if dtype in (torch.uint8, torch.int8):
            # the bytes of another dtype's buffer moved as a view: the
            # wire carries what the buffer was made as
            dtype = self.dtypes.get(_storage_key(first), dtype)
        pg = arg("process_group")
        group, groups = None, None
        if isinstance(pg, torch.ScriptObject):
            import torch._C._distributed_c10d as c10d
            try:
                group = c10d.ProcessGroup.unbox(pg)
                groups = str(dist.get_process_group_ranks(group))
            except (RuntimeError, ValueError):
                pass
        self.op_groups.append(group)
        return CollectiveOp(
            kind=kind,
            dtype=hlo_dtype(dtype) if dtype is not None else "?",
            shape=tuple(int(d) for d in first.shape) if first is not None
            else (),
            nbytes=sum(t.numel() * t.element_size() for t in payload),
            groups=groups, source=str(func),
            # a p2p op is always started apart from its wait (``dist.send``
            # waits inside its call; ``isend`` hands the handle back)
            async_op=bool(arg("async_op")) or kind in ("send", "recv"),
            stage=_stage_now(), reduce=_reduce_name(arg("reduce_op")))

    # -- results ------------------------------------------------------------

    def schedule(self, label: str = "") -> CollectiveSchedule:
        """The recorded ops, each named by its group (``group_names``)."""
        ops = []
        for op, group in zip(self.ops, self.op_groups):
            name = self.group_names.get(id(group)) if group is not None \
                else None
            ops.append(dataclasses.replace(op, axes=(name,))
                       if name else op)
        return CollectiveSchedule(ops=ops, origin="recorded", label=label,
                                  problems=self.unwaited())

    def unwaited(self) -> List[dict]:
        """``async-pair`` problems: an op issued with ``async_op=True`` whose
        work handle no ``wait()`` reached (a blocking op completes inside
        its call).  A send/recv followed by a wait on a handle no recorded
        op returned (the coalesced work of ``batch_isend_irecv``) counts
        as waited through it."""
        out = []
        for idx, work in self.works:
            op = self.ops[idx]
            if not op.async_op or id(work) in self.waited:
                continue
            if op.kind in ("send", "recv") and any(
                    n > idx for n in self.foreign_waits):
                continue
            out.append({"kind": "unmatched-async-start", "op": op.kind,
                        "name": f"{op.source}#{idx}", "line": idx})
        return out


def group_names(comms=()) -> Dict[int, str]:
    """``{id(process group): name}`` for the default group (``world``)
    and each communicator's ``intra``/``inter``/``obj`` groups and world
    group (``world``)."""
    out: Dict[int, str] = {}
    if dist.is_initialized():
        out[id(dist.distributed_c10d._get_default_group())] = "world"
    for comm in comms:
        if comm is None:
            continue
        groups = getattr(comm, "_groups", None) or {}
        for name in ("obj", "inter", "intra"):
            g = groups.get(name)
            if g is not None:
                out[id(g)] = name
        g = getattr(comm, "_group", None)
        if g is not None:
            out[id(g)] = "world"
    return out


# ---------------------------------------------------------------------------
# dry runs on the fake process group
# ---------------------------------------------------------------------------

def is_dry() -> bool:
    """True inside :func:`dry_world` (the default group is the fake
    one)."""
    return dist.is_initialized() and dist.get_backend() == "fake"


@contextlib.contextmanager
def dry_world(rank: int, world: int):
    """A fake default process group: this process is ``rank`` of
    ``world``, and every collective returns at once without moving data
    (nothing is issued).  Refuses to run inside a live process group."""
    if dist.is_initialized():
        raise RuntimeError(
            "a dry run needs a process without a process group (this one "
            f"has a {dist.get_backend()!r} world of {dist.get_world_size()})"
            ": run it in a fresh process")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=int(rank), world_size=int(world),
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclass
class Recording:
    """One recorded run: its schedule, its result and the recorder."""
    schedule: CollectiveSchedule
    result: Any
    recorder: ScheduleRecorder


def record(fn: Callable, *args, rank: Optional[int] = None,
           world: Optional[int] = None, label: str = "", comms=(),
           known=(), finalize: Optional[Callable] = None,
           **kwargs) -> Recording:
    """Run ``fn(*args, **kwargs)`` once under a :class:`ScheduleRecorder`
    (on the fake group of ``world`` as ``rank`` when both are given),
    then ``finalize()`` when given (a double-buffered step's drain), and
    return the :class:`Recording`.  ``comms`` (communicators) name the
    groups; ``known`` are the argument storage keys."""
    ctx = dry_world(rank, world) if (rank is not None
                                     and world is not None) \
        else contextlib.nullcontext()
    with ctx:
        rec = ScheduleRecorder(known=known)
        with rec:
            result = fn(*args, **kwargs)
            if finalize is not None:
                finalize()
        rec.group_names = group_names(comms)
        sched = rec.schedule(label)
    return Recording(sched, result, rec)


def extract_schedule(fn, *args, rank: Optional[int] = None,
                     world: Optional[int] = None, label: str = "",
                     comms=(), **kwargs) -> CollectiveSchedule:
    """Recorded schedule of one run of ``fn(*args, **kwargs)``.  With
    ``rank`` and ``world`` the run is dry, on the fake process group: a
    rank-branching step records each rank's schedule before anything is
    issued."""
    return record(fn, *args, rank=rank, world=world, label=label,
                  comms=comms, **kwargs).schedule


# ---------------------------------------------------------------------------
# the census view: JAX's HLO kinds of what the planner executor issued
# ---------------------------------------------------------------------------

def census_schedule(sched: CollectiveSchedule,
                    label: str = "") -> CollectiveSchedule:
    """``sched`` in JAX's HLO census kinds (what ``plan_census_kinds``
    counts), as :func:`~chainermn_tpu_torch.planner.compiler.
    census_of_record` maps the executor's calls: a default all-gather and
    a multicast broadcast are ``all-reduce`` (masked psums there), a
    send/recv pair of a ring hop one ``collective-permute``, and a float8
    stage's all-to-all plus all-gather its one code ``all-reduce`` (at
    the stage's wire dtype: the codes travel as int8 views).  A barrier
    is not a collective of the program."""
    out: List[CollectiveOp] = []
    ops = [op for op in sched.ops if op.kind != "barrier"]
    skip = set()
    for i, op in enumerate(ops):
        if i in skip:
            continue
        st = op.stage
        kind, dtype = op.kind, op.dtype
        if kind == "all-gather":
            # JAX's default all-gather is a masked psum; only a native
            # lowering stays an all-gather (census_of_record's rule)
            kind = "all-gather" if st is not None and st[1] == "native" \
                else "all-reduce"
        elif kind == "broadcast":
            kind = "all-reduce"
        elif kind in ("send", "recv"):
            kind = "collective-permute"
            other = "recv" if op.kind == "send" else "send"
            if i + 1 < len(ops) and ops[i + 1].kind == other:
                skip.add(i + 1)
        elif kind == "all-to-all" and st is not None and \
                st[0] == "all-reduce":
            kind = "all-reduce"
            if st[2]:
                dtype = TORCH_TO_HLO_DTYPE.get(st[2], st[2])
            if i + 1 < len(ops) and ops[i + 1].kind == "all-gather":
                skip.add(i + 1)
        out.append(CollectiveOp(
            kind=kind, dtype=dtype, shape=op.shape, nbytes=op.nbytes,
            axes=op.axes, groups=op.groups, source=op.source,
            async_op=op.async_op, stage=st, reduce=op.reduce))
    return CollectiveSchedule(ops=out, origin="census",
                              label=label or sched.label,
                              problems=list(sched.problems))


def schedule_from_hlo(hlo_text_or_parse, label: str = "") \
        -> CollectiveSchedule:
    """Compiled-view schedule from optimized HLO text (or a pre-built
    :class:`~chainermn_tpu_torch.analysis.hlo.HloParse`).  Parse problems
    (unmatched async halves) ride along in ``problems`` for the
    ``async-pair`` rule."""
    parse = hlo_text_or_parse
    if not isinstance(parse, HloParse):
        parse = parse_hlo_collectives(parse)
    sched = CollectiveSchedule(origin="hlo", label=label,
                               problems=list(parse.problems))
    for o in parse.ops:
        sched.ops.append(CollectiveOp(
            kind=o.op, dtype=o.dtype or "?", shape=(), nbytes=o.nbytes,
            groups=o.groups, source=o.name or None))
    return sched


__all__ = ["COLLECTIVE_KINDS", "CollectiveOp", "CollectiveSchedule",
           "Recording", "ScheduleRecorder", "TORCH_TO_HLO_DTYPE",
           "census_schedule", "dry_world", "extract_schedule",
           "group_names", "hlo_dtype", "is_dry", "record",
           "schedule_from_hlo"]
