"""Stage IR for collective plans: the decomposition as data.

Counterpart of ``chainermn_tpu/planner/ir.py``, with the same validation and
the same JSON, so a plan or table the JAX package writes loads here and
writes back the same dict.  A :class:`Plan` is an ordered tuple of
:class:`Stage` records over a declared :class:`PlanTopology`; ONE executor
(:mod:`chainermn_tpu_torch.planner.compiler`) runs any plan over the
communicator's process groups.  The seven flavors are fixed plans
(:mod:`~chainermn_tpu_torch.planner.plans`); the autotuner
(:mod:`~chainermn_tpu_torch.planner.autotune`) selects plans per message
size from ``bench_allreduce --sweep`` rows.

A topology's last axis is the intra (NVLink) axis: the ranks of one node;
the leading axes are inter-node.  A communicator's ``plan_topology()`` is
``(("inter", inter_size), ("intra", intra_size))``, so table keys read
``"inter:2,intra:2"`` as the JAX package's do.

Stage vocabulary:

``all-reduce``
    sum over the scope's ranks; works on full buffers and on shards.
``reduce-scatter``
    sum, then this rank's shard, over ONE scope axis; the buffer is padded
    to a multiple of the scope size first (``_packing.pad_to_multiple``).
``all-gather``
    inverse of the innermost live reduce-scatter.  The JAX package lowers
    its default as a masked psum and ``lowering: "native"`` as
    ``lax.all_gather``; here both gather natively (same values).
``multicast``
    broadcast from ``root`` (a rank index within the scope).
``p2p``
    one ring hop (+1) over the scope.
``all-to-all``
    block exchange over the scope's ranks (MoE dispatch / combine): block
    ``d`` of rank ``r``'s ``[P, ...]`` buffer ships to rank ``d``.
    Shape-preserving, so it stacks into the hierarchical two-hop form
    (``intra`` then ``inter``), and a per-stage ``wire_dtype`` is legal.
    Exchange chains run through
    :func:`~chainermn_tpu_torch.planner.compiler.execute_alltoall` and
    must be homogeneous.

Wire dtypes are numpy-spelled names (``"bfloat16"``, ``"float8_e4m3fn"``);
:func:`dtype_name` reads them without ml_dtypes (torch knows the names
numpy lacks).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

def dtype_name(dtype) -> str:
    """numpy's spelling of a dtype given as a name, a numpy dtype or a torch
    dtype (``torch.bfloat16`` -> ``"bfloat16"``).  numpy reads the names it
    knows; the rest (``bfloat16``, ``float8_e4m3fn``) are torch's.
    ``TypeError`` for anything else."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    try:
        return np.dtype(dtype).name
    except TypeError:
        pass
    found = getattr(torch, str(getattr(dtype, "name", dtype)), None)
    if isinstance(found, torch.dtype):
        return str(found).replace("torch.", "")
    raise TypeError(f"data type {dtype!r} not understood")


def dtype_itemsize(dtype) -> int:
    """Bytes per element of a dtype (any form :func:`dtype_name` reads)."""
    found = getattr(torch, dtype_name(dtype), None)
    if isinstance(found, torch.dtype):
        return found.itemsize
    return np.dtype(dtype_name(dtype)).itemsize


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a dtype name (numpy's spelling)."""
    return getattr(torch, dtype_name(dtype))


#: stage op kinds (the plan vocabulary)
STAGE_OPS = ("all-reduce", "reduce-scatter", "all-gather", "multicast",
             "p2p", "all-to-all")

#: symbolic axis scopes a stage communicates over.  "intra" is the last
#: (NVLink) data axis, "inter" the leading (inter-node) axes, "all" every data
#: axis — resolved against a PlanTopology at compile time.
SCOPES = ("intra", "inter", "all")


class PlanError(ValueError):
    """A structurally invalid plan (unknown op/scope, unbalanced
    reduce-scatter/all-gather nesting, plan ends sharded, ...)."""


@dataclass(frozen=True)
class PlanTopology:
    """Serializable NVLink x inter-node topology a plan runs against.

    ``axes`` is the ordered ``(name, size)`` tuple of the communicator's
    data axes, LAST axis = the intra/NVLink axis (the mesh convention every
    communicator already uses).  Mesh communicators export theirs via
    ``comm.plan_topology()`` — the one source of truth for group sizes
    that ``expected_kinds``, the compiler, and the plan table all share.
    """

    axes: Tuple[Tuple[str, int], ...]

    def __post_init__(self):
        if not self.axes:
            raise PlanError("topology needs at least one axis")
        norm = tuple((str(n), int(s)) for n, s in self.axes)
        object.__setattr__(self, "axes", norm)
        for name, size in norm:
            if size < 1:
                raise PlanError(f"axis {name!r} has size {size} < 1")

    @property
    def size(self) -> int:
        out = 1
        for _, s in self.axes:
            out *= s
        return out

    @property
    def intra_size(self) -> int:
        return self.axes[-1][1]

    @property
    def inter_size(self) -> int:
        return self.size // self.intra_size

    def scope_axes(self, scope: str) -> Tuple[str, ...]:
        """Axis names a symbolic scope resolves to (may be empty — e.g.
        "inter" on a single-axis sub-world; the compiler skips such
        stages, matching the legacy ``if inter_axes:`` guards)."""
        if scope == "all":
            return tuple(n for n, _ in self.axes)
        if scope == "intra":
            return (self.axes[-1][0],)
        if scope == "inter":
            return tuple(n for n, _ in self.axes[:-1])
        raise PlanError(f"unknown scope {scope!r}; one of {SCOPES}")

    def scope_size(self, scope: str) -> int:
        sizes = dict(self.axes)
        out = 1
        for name in self.scope_axes(scope):
            out *= sizes[name]
        return out

    def key(self) -> str:
        """Canonical string key for plan tables / sweep rows, e.g.
        ``"inter:2,intra:4"``."""
        return ",".join(f"{n}:{s}" for n, s in self.axes)

    def to_dict(self) -> dict:
        return {"axes": [[n, s] for n, s in self.axes]}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanTopology":
        return cls(axes=tuple((n, s) for n, s in d["axes"]))

    @classmethod
    def from_key(cls, key: str) -> "PlanTopology":
        axes = []
        for part in key.split(","):
            name, _, size = part.partition(":")
            axes.append((name, int(size)))
        return cls(axes=tuple(axes))


@dataclass(frozen=True)
class Stage:
    """One collective stage of a plan."""

    op: str
    scope: str = "all"
    #: numpy dtype name the wire carries for THIS stage (cast in before,
    #: cast back after — the per-hop seam); None inherits the buffer's
    #: dtype.
    wire_dtype: Optional[str] = None
    #: alternative lowering; "" = the stage's default
    lowering: str = ""
    #: multicast root rank on the scope axes
    root: int = 0
    #: per-hop compressor config for THIS stage (DynamiQ direction): a
    #: ``resolve_compressor``-style dict like ``{"name": "int8",
    #: "chunk_size": 1024}``.  The stage quantizes into the compressor's
    #: wire dtype, sums IN the wire over the scope, and dequantizes at
    #: the stage boundary; error feedback is per stage, keyed by stage
    #: index (see ``execute_plan``).  Only legal on all-reduce stages —
    #: in-wire summation is only defined for the sum all-reduce — and
    #: mutually exclusive with ``wire_dtype`` (the compressor owns the
    #: wire).
    compression: Optional[Dict] = None

    def __post_init__(self):
        if self.op not in STAGE_OPS:
            raise PlanError(
                f"unknown stage op {self.op!r}; one of {STAGE_OPS}")
        if self.scope not in SCOPES:
            raise PlanError(
                f"unknown scope {self.scope!r}; one of {SCOPES}")
        if self.lowering and self.op != "all-gather":
            raise PlanError(
                f"lowering={self.lowering!r} only applies to all-gather")
        if self.lowering not in ("", "masked-psum", "native"):
            raise PlanError(f"unknown lowering {self.lowering!r}")
        if self.wire_dtype is not None:
            try:
                dtype_name(self.wire_dtype)
            except TypeError as e:
                raise PlanError(
                    f"bad wire_dtype {self.wire_dtype!r}: {e}") from None
        if self.compression is not None:
            if not isinstance(self.compression, dict) or \
                    not self.compression.get("name"):
                raise PlanError(
                    f"stage compression must be a config dict with a "
                    f"'name' key, got {self.compression!r}")
            if self.op != "all-reduce":
                raise PlanError(
                    f"compression only applies to all-reduce stages "
                    f"(in-wire summation), not {self.op!r}")
            if self.wire_dtype is not None:
                raise PlanError(
                    "a compressed stage's wire dtype is the compressor's "
                    "wire; drop the stage wire_dtype")
            object.__setattr__(self, "compression", dict(self.compression))
            try:
                self.compressor()
            except PlanError:
                raise
            except Exception as e:
                raise PlanError(
                    f"bad stage compression {self.compression!r}: "
                    f"{e}") from None

    def compressor(self):
        """The resolved :class:`~chainermn_tpu_torch.compression.Compressor`
        this stage quantizes with (None when uncompressed)."""
        if self.compression is None:
            return None
        from chainermn_tpu_torch.compression import resolve_compressor
        return resolve_compressor(dict(self.compression))

    def to_dict(self) -> dict:
        d = {"op": self.op, "scope": self.scope}
        if self.wire_dtype is not None:
            d["wire_dtype"] = self.wire_dtype
        if self.lowering:
            d["lowering"] = self.lowering
        if self.root:
            d["root"] = self.root
        if self.compression is not None:
            d["compression"] = dict(self.compression)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Stage":
        return cls(op=d["op"], scope=d.get("scope", "all"),
                   wire_dtype=d.get("wire_dtype"),
                   lowering=d.get("lowering", ""),
                   root=int(d.get("root", 0)),
                   compression=d.get("compression"))


@dataclass(frozen=True)
class StageGroup:
    """One concurrent stripe of a striped plan (FlexLink direction).

    A group owns an ordered stage chain and a ``ratio`` — the fraction
    of the packed flat buffer its chain runs over.  Groups of one plan
    are data-independent (each works its own slice), so their chains
    interleave: the NVLink-heavy stripe's hops overlap the
    inter-node stripe's slow hop with no host joins.  Ratios across a plan's
    groups must sum to 1.
    """

    stages: Tuple[Stage, ...]
    ratio: float
    #: optional tag for spans / debug output; defaults to "g{index}"
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))
        object.__setattr__(self, "ratio", float(self.ratio))
        if not self.stages:
            raise PlanError("stage group has no stages")
        for i, st in enumerate(self.stages):
            if not isinstance(st, Stage):
                raise PlanError(
                    f"group stage {i} is not a Stage: {st!r}")
        if not (0.0 < self.ratio <= 1.0):
            raise PlanError(
                f"group split ratio must be in (0, 1], got {self.ratio}")

    def to_dict(self) -> dict:
        d = {"ratio": self.ratio,
             "stages": [s.to_dict() for s in self.stages]}
        if self.name:
            d["name"] = self.name
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StageGroup":
        return cls(stages=tuple(Stage.from_dict(s) for s in d["stages"]),
                   ratio=float(d["ratio"]), name=d.get("name", ""))


def _validate_chain(plan_name: str, stages: Sequence[Stage],
                    packing: str, where: str = "") -> None:
    """Shard-stack validation of one stage chain (a plain plan's stages
    or one concurrent group's)."""
    at = f" in {where}" if where else ""
    for i, st in enumerate(stages):
        if not isinstance(st, Stage):
            raise PlanError(f"stage {i}{at} is not a Stage: {st!r}")
    ops = {st.op for st in stages}
    if "all-to-all" in ops:
        # exchange chains are homogeneous: interleaving a reduction with
        # the block exchange has no defined block layout, and the
        # exchange executor (compiler.execute_alltoall) runs over
        # [P, ...] block buffers, which only exist under flat packing
        if ops != {"all-to-all"}:
            raise PlanError(
                f"plan {plan_name!r}{at}: an all-to-all chain must be "
                f"all-to-all stages only, got ops {sorted(ops)}")
        if packing != "flat":
            raise PlanError(
                f"plan {plan_name!r}{at}: all-to-all requires flat "
                "packing — the exchange runs over a [P, ...] block "
                "buffer")
        return
    shard_stack = []
    for i, st in enumerate(stages):
        if st.op == "reduce-scatter":
            if packing != "flat":
                raise PlanError(
                    f"plan {plan_name!r}: reduce-scatter (stage {i}{at}) "
                    "requires flat packing")
            shard_stack.append(st.scope)
        elif st.op == "all-gather":
            if not shard_stack:
                raise PlanError(
                    f"plan {plan_name!r}: all-gather (stage {i}{at}) "
                    "without a live reduce-scatter")
            top = shard_stack.pop()
            if top != st.scope:
                raise PlanError(
                    f"plan {plan_name!r}: all-gather (stage {i}{at}) over "
                    f"scope {st.scope!r} does not match the innermost "
                    f"reduce-scatter scope {top!r}")
    if shard_stack:
        raise PlanError(
            f"plan {plan_name!r}{at} ends sharded over {shard_stack} — "
            "every reduce-scatter needs a matching all-gather (or "
            "the consumer must be a sharded-state engine like FSDP, "
            "which has its own scheduler)")


#: tolerance on sum(group ratios) == 1 — ratios are user-facing floats
#: ("0.7" + "0.3"), not exact binary fractions
RATIO_TOL = 1e-6


@dataclass(frozen=True)
class Plan:
    """An ordered collective decomposition — the communicator spec.

    ``packing`` selects the buffer convention the stages run over:

    * ``"flat"`` — gradients pack into flat per-dtype buffers
      (``_packing.pack``), stages run per buffer, the 1/size mean fuses
      into unpack.  The flat/xla/two_dimensional convention.
    * ``"leaf"`` — stages run per gradient leaf (no packing), mean
      applied per leaf.  The naive/hierarchical/single_node convention.
      Only all-reduce/multicast/p2p stages are legal (a reduce-scatter
      shard of an arbitrary-shaped leaf has no defined layout).

    ``wire_dtype`` is the packed-buffer communication dtype (the legacy
    ``allreduce_grad_dtype`` knob as plan data; flat packing only).

    ``groups`` makes the plan *striped*: instead of one ``stages``
    chain, the plan holds concurrent :class:`StageGroup` chains, each
    running over its declared split ratio of the packed flat buffer
    (ratios sum to 1).  ``groups`` and ``stages`` are mutually
    exclusive, and striping requires flat packing — the split is a
    slice of the packed buffer.
    """

    name: str
    stages: Tuple[Stage, ...] = ()
    packing: str = "flat"
    wire_dtype: Optional[str] = None
    groups: Optional[Tuple[StageGroup, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))
        if self.groups is not None:
            object.__setattr__(self, "groups", tuple(self.groups))
        self.validate()

    @property
    def is_striped(self) -> bool:
        return self.groups is not None

    def stage_groups(self) -> Tuple[StageGroup, ...]:
        """The plan as concurrent groups: a striped plan's ``groups``
        verbatim; a plain plan normalized to ONE ratio-1.0 group.  The
        uniform view the cost model and lint rules walk."""
        if self.groups is not None:
            return self.groups
        return (StageGroup(stages=self.stages, ratio=1.0),)

    def validate(self) -> "Plan":
        if self.packing not in ("flat", "leaf"):
            raise PlanError(f"unknown packing {self.packing!r}")
        if self.groups is not None:
            if self.stages:
                raise PlanError(
                    f"plan {self.name!r} has both stages and groups — "
                    "a striped plan's chains live in its groups")
            if self.packing != "flat":
                raise PlanError(
                    f"plan {self.name!r}: concurrent stage groups "
                    "require flat packing — split ratios partition the "
                    "packed flat buffer")
            for g, grp in enumerate(self.groups):
                if not isinstance(grp, StageGroup):
                    raise PlanError(
                        f"plan {self.name!r}: group {g} is not a "
                        f"StageGroup: {grp!r}")
                _validate_chain(self.name, grp.stages, self.packing,
                                where=f"group {g}")
            total = sum(grp.ratio for grp in self.groups)
            if abs(total - 1.0) > RATIO_TOL:
                raise PlanError(
                    f"plan {self.name!r}: group split ratios "
                    f"{[grp.ratio for grp in self.groups]} sum to "
                    f"{total!r}, expected 1.0")
            return self
        if not self.stages:
            raise PlanError(f"plan {self.name!r} has no stages")
        if self.wire_dtype is not None and self.packing != "flat":
            raise PlanError("wire_dtype requires flat packing")
        if self.packing != "flat" and any(
                st.compression is not None for st in self.stages
                if isinstance(st, Stage)):
            raise PlanError(
                f"plan {self.name!r}: per-hop compression requires flat "
                "packing — the EF state is sized to the packed buffer")
        _validate_chain(self.name, self.stages, self.packing)
        return self

    def to_dict(self) -> dict:
        d = {"name": self.name, "packing": self.packing}
        if self.groups is not None:
            d["groups"] = [g.to_dict() for g in self.groups]
        else:
            d["stages"] = [s.to_dict() for s in self.stages]
        if self.wire_dtype is not None:
            d["wire_dtype"] = self.wire_dtype
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        groups = d.get("groups")
        return cls(name=d["name"],
                   stages=tuple(Stage.from_dict(s)
                                for s in d.get("stages", ())),
                   packing=d.get("packing", "flat"),
                   wire_dtype=d.get("wire_dtype"),
                   groups=(tuple(StageGroup.from_dict(g) for g in groups)
                           if groups is not None else None))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Plan":
        with open(path) as f:
            return cls.from_json(f.read())

    def with_name(self, name: str) -> "Plan":
        return dataclasses.replace(self, name=name)


def load_plan(path_or_dict) -> Plan:
    """Coerce a plan file path / dict / Plan into a :class:`Plan`."""
    if isinstance(path_or_dict, Plan):
        return path_or_dict
    if isinstance(path_or_dict, dict):
        return Plan.from_dict(path_or_dict)
    return Plan.load(path_or_dict)


__all__ = ["Plan", "PlanError", "PlanTopology", "RATIO_TOL", "SCOPES",
           "STAGE_OPS", "Stage", "StageGroup", "dtype_itemsize", "dtype_name",
           "load_plan", "torch_dtype"]
