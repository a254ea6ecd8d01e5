"""Compressor protocol and registry: the pluggable gradient-wire codecs.

Counterpart of ``chainermn_tpu/compression/base.py`` (a beyond-reference
extension there too).  The anaruse fork's reduced-precision gradient wire
(``allreduce_grad_dtype='float16'``: cast in, all-reduce in the wire
dtype, cast back) becomes a ``Compressor``, so that the three exchange
seams -- ``allreduce_grad``, ``create_multi_node_optimizer`` and the
bucketed FSDP reduce-scatter -- can ride anything from a plain dtype cast
(:class:`NoCompression`, which runs the exact ``allreduce_grad_dtype``
program) to int8/fp8 quantization with error feedback
(:mod:`.quantize`, :mod:`.error_feedback`).

A compressor is identified by its **spec**, a canonical JSON string of its
name and config: what bucket layouts, checkpoint sidecars and the resume
guard compare.  :func:`resolve_compressor` builds one from a registry name
(``"int8"``), a spec string or dict, a bare wire dtype (``"bfloat16"``)
or an instance.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Type

import torch


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a dtype or its name (``"bfloat16"``,
    ``"float8_e4m3fn"``); ``TypeError`` for anything else."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(getattr(name, "name", name)), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"not a dtype: {name!r}")
    return dt


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy's spelling)."""
    return str(dtype).replace("torch.", "")


class Compressor:
    """Protocol for a gradient wire codec.

    ``compress(buf, state) -> (wire, state)`` encodes one flat float
    buffer into its wire form; ``decompress(wire, state) -> (buf, state)``
    decodes the *summed* wire buffer (the collective between the two sums
    wire values in wire arithmetic, so codecs must be closed under
    summation: int8 codes clip to ``max_code // world_size`` for that
    reason).  Stateful codecs carry a
    :class:`~chainermn_tpu_torch.compression.CompressionState` (EF
    residual, delayed scales, step counter) through both calls.

    Identity: ``name`` (the registry key), ``config()`` (JSON-serializable
    keyword arguments that rebuild it) and ``spec`` (the canonical JSON
    identity string).
    """

    name: str = "?"
    stateful: bool = False

    # -- identity ------------------------------------------------------------
    def config(self) -> Dict[str, Any]:
        return {}

    @property
    def spec(self) -> str:
        return json.dumps({"name": self.name, **self.config()},
                          sort_keys=True)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.config()})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Compressor) and self.spec == other.spec

    def __hash__(self) -> int:
        return hash(self.spec)

    # -- wire ----------------------------------------------------------------
    def wire_dtype_for(self, dtype) -> torch.dtype:
        """Dtype the collective runs in for a buffer of ``dtype``."""
        return torch_dtype(dtype)

    def compress(self, buf, state=None, rank=None):
        raise NotImplementedError

    def decompress(self, wire, state=None):
        raise NotImplementedError


class NoCompression(Compressor):
    """The identity codec: the wire-dtype cast, as a Compressor.

    ``NoCompression(wire_dtype="bfloat16")`` IS ``allreduce_grad_dtype=
    "bfloat16"``: every seam runs the program of the bare dtype knob (pack,
    cast, all-reduce in the wire dtype, cast back, scale), bit for bit.
    ``NoCompression()`` without a wire dtype is the do-nothing default.
    """

    name = "none"
    stateful = False

    def __init__(self, wire_dtype=None):
        if wire_dtype is not None:
            wire = torch_dtype(wire_dtype)
            if not wire.is_floating_point:
                raise ValueError(
                    f"NoCompression wire_dtype must be floating, got "
                    f"{dtype_name(wire)} -- integer wires need a quantizer "
                    f"('int8')")
            wire_dtype = dtype_name(wire)
        self.wire_dtype = wire_dtype

    def config(self):
        return {"wire_dtype": self.wire_dtype}

    @property
    def wire(self) -> Optional[torch.dtype]:
        return torch_dtype(self.wire_dtype) if self.wire_dtype else None

    def wire_dtype_for(self, dtype):
        dtype = torch_dtype(dtype)
        if self.wire_dtype is not None and dtype.is_floating_point:
            return self.wire
        return dtype

    def compress(self, buf, state=None, rank=None):
        return buf.to(self.wire_dtype_for(buf.dtype)), state

    def decompress(self, wire, state=None):
        return wire, state


# ---- registry ---------------------------------------------------------------

_REGISTRY: Dict[str, Type[Compressor]] = {}


def register_compressor(name: str, cls: Type[Compressor]) -> None:
    _REGISTRY[name] = cls


def available_compressors():
    return sorted(_REGISTRY)


register_compressor(NoCompression.name, NoCompression)


def resolve_compressor(value) -> Optional[Compressor]:
    """Any accepted compression designation as a Compressor.

    Accepts ``None`` (no compression), a :class:`Compressor` instance, a
    registry name (``"int8"``), a plain wire dtype (``"bfloat16"`` or a
    torch dtype: ``NoCompression(wire_dtype=...)``), a spec JSON string, or
    a config dict (``{"name": "int8", "chunk_size": 512}``).
    """
    if value is None or isinstance(value, Compressor):
        return value
    cfg = None
    if isinstance(value, torch.dtype):
        cfg = {"name": "none", "wire_dtype": dtype_name(value)}
    elif isinstance(value, dict):
        cfg = dict(value)
    elif isinstance(value, str):
        s = value.strip()
        if s.startswith("{"):
            cfg = json.loads(s)
        elif s in _REGISTRY:
            cfg = {"name": s}
        else:
            # a bare dtype string is the legacy wire knob's spelling
            try:
                torch_dtype(s)
            except TypeError:
                raise ValueError(
                    f"unknown compressor {value!r}; available: "
                    f"{available_compressors()} (or a wire dtype like "
                    f"'bfloat16', or a spec dict/JSON)") from None
            cfg = {"name": "none", "wire_dtype": s}
    else:
        raise TypeError(
            f"cannot resolve a compressor from {type(value).__name__}; "
            f"pass a name, spec dict/JSON, dtype string, or Compressor")
    name = cfg.pop("name", None)
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown compressor {name!r}; available: "
            f"{available_compressors()}")
    return _REGISTRY[name](**cfg)


__all__ = ["Compressor", "NoCompression", "available_compressors",
           "register_compressor", "resolve_compressor"]
