"""Closure-captured tensor audit -- the ``captured-constant`` rule core.

Counterpart of ``chainermn_tpu/analysis/captured.py``.  In JAX every
array a traced function closes over becomes a *constant* of its jaxpr,
serialized into the compile request and duplicated per executable.  An
eager PyTorch step has no trace, but the same bug has a torch shape: a
large tensor the step reads that is none of its inputs -- a batch, a mask
or a table held by a closure or a module global instead of being passed
(or registered as a buffer).  It is invisible to everything that walks
the step's state: checkpoints, ``bcast_data``, FSDP's sharding, the
device placement of the state it reaches, and the memory accounting of
the step's arguments.

A **captured constant** is a tensor the step reads (an input of an aten
op, seen by the :class:`~.schedule.ScheduleRecorder`) that

* is larger than ``max_bytes``;
* is not reachable from the step's arguments (:func:`reachable_tensors`:
  tensors, modules' parameters and buffers, optimizers' state and
  parameter groups, containers, and the attributes and closures of the
  objects they hold);
* was not created inside the step (the output of an earlier op of the
  same run).

The fix is always the same: pass the tensor to the step (or make it a
buffer of a module the step's arguments hold).  Scalars and small tables
are fine; only storages above ``max_bytes`` are reported.
"""

from __future__ import annotations

import types
from typing import Any, Dict, List, Tuple

import torch

# One 32x32 f32 tile, JAX's threshold.
DEFAULT_MAX_BYTES = 4096


class CapturedConstantError(ValueError):
    """A step read tensors above the size threshold that none of its
    arguments hold (see the module docstring for why that is a bug)."""


_SKIP = (types.ModuleType, type, str, bytes, int, float, bool, complex,
         torch.dtype, torch.device)


def reachable_tensors(*roots, with_paths: bool = False,
                      max_depth: int = 12) -> list:
    """Every tensor reachable from ``roots``: tensors (and their
    ``.grad``), modules (parameters, buffers and attributes), optimizers
    (``state`` and ``param_groups``), dicts / lists / tuples / sets, the
    cells of functions' closures and ``functools.partial`` arguments, and
    the ``__dict__`` of other objects, to ``max_depth`` levels.
    ``with_paths=True`` returns ``(path, tensor)`` pairs."""
    out: List[Tuple[str, torch.Tensor]] = []
    seen = set()

    def walk(x, path: str, depth: int) -> None:
        if x is None or isinstance(x, _SKIP) or depth > max_depth:
            return
        if id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            out.append((path, x))
            if x.is_leaf and x.grad is not None:
                walk(x.grad, path + ".grad", depth + 1)
            return
        if isinstance(x, torch.nn.Module):
            for name, t in x.named_parameters(recurse=True):
                walk(t, f"{path}.{name}", depth + 1)
            for name, t in x.named_buffers(recurse=True):
                walk(t, f"{path}.{name}", depth + 1)
        if isinstance(x, torch.optim.Optimizer):
            for i, st in enumerate(x.state.values()):
                walk(st, f"{path}.state[{i}]", depth + 1)
            walk(x.param_groups, f"{path}.param_groups", depth + 1)
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}[{k!r}]", depth + 1)
            return
        if isinstance(x, (list, tuple, set, frozenset)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]", depth + 1)
            return
        if isinstance(x, types.FunctionType):
            for i, cell in enumerate(x.__closure__ or ()):
                try:
                    walk(cell.cell_contents, f"{path}.<cell{i}>", depth + 1)
                except ValueError:  # an empty cell
                    pass
            return
        if isinstance(x, types.MethodType):
            walk(x.__self__, path, depth + 1)
            return
        func = getattr(x, "func", None)
        if callable(func) and hasattr(x, "args"):  # functools.partial
            walk(x.args, f"{path}.args", depth + 1)
            walk(getattr(x, "keywords", None), f"{path}.keywords",
                 depth + 1)
        attrs = getattr(x, "__dict__", None)
        if isinstance(attrs, dict):
            for k, v in attrs.items():
                walk(v, f"{path}.{k}", depth + 1)
        for name in getattr(type(x), "__slots__", ()) or ():
            walk(getattr(x, name, None), f"{path}.{name}", depth + 1)

    for i, root in enumerate(roots):
        walk(root, "" if len(roots) == 1 else f"[{i}]", 0)
    return out if with_paths else [t for _, t in out]


def storage_keys(*roots) -> set:
    """Storage keys (:func:`~.schedule._storage_key`) of every tensor
    reachable from ``roots``."""
    from chainermn_tpu_torch.analysis.schedule import _storage_key
    keys = set()
    for t in reachable_tensors(*roots):
        key = _storage_key(t)
        if key is not None:
            keys.add(key)
    return keys


def constants_in_recording(recording, max_bytes: int = DEFAULT_MAX_BYTES
                           ) -> List[Dict[str, Any]]:
    """Captured-constant records of a :class:`~.schedule.Recording`
    (``{"shape", "dtype", "nbytes", "device", "op"}``, largest first):
    the shared core of :func:`find_captured_constants` and the lint rule
    (which records once and runs every rule on the same run)."""
    found = [dict(rec) for rec in recording.recorder.captured.values()
             if rec["nbytes"] > max_bytes]
    found.sort(key=lambda f: -f["nbytes"])
    return found


def find_captured_constants(fn, *args, max_bytes: int = DEFAULT_MAX_BYTES,
                            **kwargs) -> List[Dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` once under the recorder and return one
    record per captured storage larger than ``max_bytes``, largest first.
    Anything reachable from the arguments (the modules and optimizer a
    step is given among them) is an input.  Empty list means every big
    operand is an input."""
    from chainermn_tpu_torch.analysis.schedule import record
    rec = record(fn, *args, known=storage_keys(args, kwargs), **kwargs)
    return constants_in_recording(rec, max_bytes=max_bytes)


def captured_constant_message(found: List[Dict[str, Any]], label: str,
                              max_bytes: int) -> str:
    lines = "\n".join(
        f"  - {f['dtype']}{list(f['shape'])} ({f['nbytes']} bytes"
        + (f", read by {f['op']}" if f.get("op") else "") + ")"
        for f in found)
    return (
        f"{label} closes over {len(found)} array constant(s) larger than "
        f"{max_bytes} bytes:\n{lines}\n"
        "A tensor the step reads that none of its arguments hold is "
        "invisible to everything that walks the step's state "
        "(checkpoints, bcast_data, FSDP sharding, device placement).  "
        "Pass it to the step as an explicit argument (or register it as "
        "a buffer of a module the step holds) instead of capturing it.")


def assert_no_captured_constants(fn, *args,
                                 max_bytes: int = DEFAULT_MAX_BYTES,
                                 name: str = None,
                                 **kwargs) -> None:
    """Raise :class:`CapturedConstantError` if running ``fn`` reads
    tensors above ``max_bytes`` that none of its arguments hold."""
    found = find_captured_constants(fn, *args, max_bytes=max_bytes,
                                    **kwargs)
    if not found:
        return
    label = name or getattr(fn, "__name__", repr(fn))
    raise CapturedConstantError(
        captured_constant_message(found, label, max_bytes))


__all__ = ["CapturedConstantError", "DEFAULT_MAX_BYTES",
           "assert_no_captured_constants", "captured_constant_message",
           "constants_in_recording", "find_captured_constants",
           "reachable_tensors", "storage_keys"]
