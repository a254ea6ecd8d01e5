"""Device time from a ``torch.profiler`` capture, by kernel.

Counterpart of ``chainermn_tpu/utils/trace.py``:

* :func:`device_op_times` reads an exported Chrome trace and sums the
  durations of the work the card ran -- kernels, copies and fills (the
  categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``) -- by name;
* :func:`device_time` times a callable by those durations instead of by a
  clock on the host, which would also count the host's launch path.

A capture without any device event raises, as the JAX version's
``_detect_device_track`` does for a trace without a device track: a
profiler that saw nothing must not read as a time of 0.  The durations are
summed whether or not they overlapped (kernels on one stream do not).
Kernels launched from the port's ctypes libraries are traced like
PyTorch's own: CUPTI sees every launch of the context.

A capture can also lose kernels.  On an H100 machine with torch 2.11, a
capture opened in a process that had run for a while held only the later
kernels of its window (the first milliseconds' worth were missing, more
the older the process), and a capture with a warm-up step first sometimes
lost its last kernels.  The trace's clock falls behind the host clock
that bounds the profiler's window by up to milliseconds now and then (3.7
ms seen), and kernels near either edge then fall outside it: 11 of 220
unpadded captures lost kernels, none of 220 with 50 ms pads
(:mod:`..benchmarks.bench_device_time` on an NVIDIA H100 80GB HBM3 at
700 W).  So :func:`device_time` captures ``steps``
calls after a warm-up step of as many, leaves :data:`PAD_S` seconds of
host time at both edges of the timed window, brackets the timed calls
with two marker kernels, and sums a capture only if it is
:func:`complete`; else it captures again, up to :data:`TRIES` times, and
then raises.  :data:`captures` counts the captures taken and the ones
that were not complete.  :func:`kernel_category` names the kernel-name
groups of the profile breakdowns.

Usage::

    from chainermn_tpu_torch.utils.trace import device_time, top_ops

    ms = device_time(step, (batch,), steps=10, trace_dir="prof")
    table = top_ops("prof", n=20)   # [(name, ms, count), ...]
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import shutil
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

_CATEGORY_RE = re.compile(r"\.\d+$")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_NAME = "trace.json"
MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
MARKER_CYCLES = 1000    # a marker kernel: about a microsecond
TRIES = 4               # captures before device_time gives up
PAD_S = 0.05            # host seconds at each edge of the timed window
# captures device_time took, and those that were not complete
captures = collections.Counter()

OTHER_CATEGORY = "other (elementwise, pad, pool, loss, optimizer)"
# kernel-name fragments -> category of the profile breakdowns (first match
# wins, so the CUDA statistics kernel, whose name holds "stats_kernel",
# comes before the Triton fragments, and the optimizers' foreach kernels,
# "multi_tensor_apply_kernel", before "apply_kernel"; the rest is "other")
KERNEL_CATEGORIES = (
    ("fused_norm stats (CUDA)", ("bn_stats",)),
    ("fused_norm reduce (CUDA)", ("bn_bwd_reduce",)),
    (OTHER_CATEGORY, ("multi_tensor_apply",)),
    ("fused_norm (Triton)", ("stats_kernel", "apply_kernel",
                             "bwd_dx_kernel", "finalize_kernel")),
    ("cast_scale (CUDA)", ("cast_scale",)),
    ("nccl", ("nccl",)),
    ("memcpy / memset", ("memcpy", "memset")),
    ("conv / gemm", ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90_",
                     "wgrad", "dgrad")),
)


def kernel_category(kernel: str, categories=KERNEL_CATEGORIES) -> str:
    """The category of a kernel's name: the first of ``categories``
    (``(name, name fragments)`` pairs) with a fragment in it."""
    low = kernel.lower()
    for cat, keys in categories:
        if any(k in low for k in keys):
            return cat
    return OTHER_CATEGORY


def _trace_file(trace: str) -> str:
    """``trace`` itself, or the newest Chrome trace in the directory."""
    if os.path.isdir(trace):
        paths = sorted(glob.glob(os.path.join(trace, "*.json"))
                       + glob.glob(os.path.join(trace, "*.json.gz")),
                       key=os.path.getmtime)
        if paths:
            return paths[-1]
    elif os.path.isfile(trace):
        return trace
    raise FileNotFoundError(f"no trace at {trace!r} (expected a Chrome trace "
                            "file or a directory holding *.json[.gz])")


def _load(trace: str) -> dict:
    path = _trace_file(trace)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _device_events(trace: str) -> List[Tuple[str, str, float]]:
    """``[(name, category, ms), ...]`` of the device events of a capture."""
    return [(e["name"], e["cat"], e["dur"] / 1e3)
            for e in _load(trace).get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATEGORIES]


def _by_name(events) -> Dict[str, Tuple[float, int]]:
    acc: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for name, _, ms in events:
        a = acc[name]
        a[0] += ms
        a[1] += 1
    return {k: (v[0], v[1]) for k, v in acc.items()}


def device_op_times(trace: str) -> Dict[str, Tuple[float, int]]:
    """``{name: (total_ms, count)}`` of the device events of a capture
    (a Chrome trace file, or a directory: its newest one)."""
    acc = _by_name(_device_events(trace))
    if not acc:
        raise ValueError(
            f"no CUDA kernel events in {trace!r} (no event of categories "
            f"{DEVICE_CATEGORIES}): the profiler did not trace the card")
    return acc


def top_ops(trace: str, n: int = 20,
            by_category: bool = False) -> List[Tuple[str, float, int]]:
    """Top-``n`` device ops (or name categories, with a trailing ``.N``
    stripped) by total time: ``[(name, total_ms, count), ...]``
    descending."""
    times = device_op_times(trace)
    if by_category:
        cat: Dict[str, List[float]] = collections.defaultdict(
            lambda: [0.0, 0])
        for name, (ms, c) in times.items():
            a = cat[_CATEGORY_RE.sub("", name)]
            a[0] += ms
            a[1] += c
        times = {k: (v[0], v[1]) for k, v in cat.items()}
    rows = [(k, ms, c) for k, (ms, c) in times.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:n]


def _first_tensor(out):
    import torch
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (list, tuple)) else ()
    for x in items:
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def fence(out) -> None:
    """Read one value of ``out`` back to the host and wait for the device,
    so every call before it has run."""
    import torch
    leaf = _first_tensor(out)
    if leaf is not None and leaf.numel():
        leaf.reshape(-1)[:1].cpu()
    torch.cuda.synchronize()


def complete(events: List[Tuple[str, str, float]], steps: int) -> bool:
    """Whether a capture of ``steps`` calls between two marker kernels
    holds all its kernels: both markers, and every other kernel a multiple
    of ``steps`` times (each call launches the same ones)."""
    markers = sum(1 for n, _, _ in events if MARKER in n)
    counts = collections.Counter(n for n, cat, _ in events
                                 if cat == "kernel" and MARKER not in n)
    return markers == 2 and all(c % steps == 0 for c in counts.values())


def capture(fn: Callable, args: tuple, steps: int, path: str,
            pad_s: float = PAD_S):
    """One capture of ``steps`` calls of ``fn(*args)`` after a profiler
    warm-up step of as many, written to ``path``: ``(events, out)``, the
    device events (:func:`_device_events`) and the last call's output.
    The timed calls lie between two marker kernels, with ``pad_s`` host
    seconds between them and each edge of the profiler's window."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    if os.path.exists(path):
        os.remove(path)  # the capture must write its own
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(steps):  # the warm-up step, not kept
            out = fn(*args)
        torch.cuda.synchronize()
        time.sleep(pad_s)
        prof.step()
        time.sleep(pad_s)
        torch.cuda._sleep(MARKER_CYCLES)
        for _ in range(steps):
            out = fn(*args)
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        time.sleep(pad_s)
        prof.step()
    return _device_events(path), out


def device_time(fn: Callable, args: tuple, steps: int = 5, warmup: int = 2,
                trace_dir: Optional[str] = None) -> float:
    """Device milliseconds per call of ``fn(*args)``: the sum of the device
    events of ``steps`` calls under ``torch.profiler`` (CUDA activity),
    over ``steps``, after ``warmup`` calls outside the capture, from the
    first :func:`capture` that holds all its kernels (:func:`complete`;
    the module's docstring says why a capture may not).  The calls are
    fenced by a device-to-host value read of the last one's output, after
    the capture so that its copy is not counted.  ``trace_dir`` keeps the
    capture there as ``trace.json``; without it a temporary directory is
    used and removed."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("device_time times the card, and there is no "
                           "CUDA device")
    out = None
    for _ in range(warmup):
        out = fn(*args)
    fence(out)
    tmp = trace_dir or tempfile.mkdtemp(prefix="chainermn_tpu_torch_trace_")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, TRACE_NAME)
    seen = []
    try:
        for _ in range(TRIES):
            events, out = capture(fn, args, steps, path)
            fence(out)  # the value read stays out of the capture
            captures["taken"] += 1
            if complete(events, steps):
                return sum(ms for n, _, ms in events
                           if MARKER not in n) / steps
            captures["incomplete"] += 1
            seen.append(len(events))
    finally:
        if trace_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    raise ValueError(
        f"no complete capture of {steps} calls in {TRIES} tries (device "
        f"events seen: {seen}; two markers and a multiple of {steps} of "
        "each kernel expected): the profiler lost kernels")


__all__ = ["DEVICE_CATEGORIES", "KERNEL_CATEGORIES", "capture", "captures",
           "complete", "device_op_times", "device_time", "fence",
           "kernel_category", "top_ops"]
