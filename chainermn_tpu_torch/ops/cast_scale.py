"""Fused cast + scale of a flat buffer, as a CUDA kernel.

Counterpart of ``chainermn_tpu/ops/cast_scale.py`` (``cast_scale``, whose
Pallas ``_kernel`` computes ``(x.astype(f32) * scale).astype(dst)``).  It is
the cast around the gradient all-reduce of the ``xla`` (``pure_nccl``)
communicator with a wire dtype: float32 gradients into the float16 wire
buffer with scale 1, and the summed wire buffer back to float32 with scale
1/size -- on a GPU once more the CUDA kernel it was in the reference.

The kernel is ``chainermn_tpu_torch/csrc/cast_scale.cu`` (design and bound
in its header), built with ``nvcc`` into ``build/cuda/`` on the first launch
and bound with ``ctypes`` (:mod:`chainermn_tpu_torch.ops._build`).  It is
bound by device memory: its least time is (source + destination bytes) over
the card's memory rate.

:func:`cast_scale` takes :func:`cast_scale_plain` (the same arithmetic in
PyTorch ops) only for a tensor that lies on the CPU; for a CUDA tensor it
launches the kernel or raises.  ``cast_scale.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from chainermn_tpu_torch.ops import _build

__all__ = ["cast_scale", "cast_scale_plain", "cast_scale_bytes", "KERNELS",
           "launch_counts", "reset_launch_counts"]

# dtype codes of csrc/cast_scale.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if dtype not in _CODES:
        raise ValueError(f"cast_scale: dtype {dtype} is not one of "
                         f"{tuple(_CODES)}")
    return dtype


def cast_scale_plain(x: torch.Tensor, target_dtype, scale: float):
    """Plain version of the kernel: ``(x.to(float32) * float32(scale))
    .to(target_dtype)``; ``target_dtype=None`` keeps ``x.dtype``."""
    dst = x.dtype if target_dtype is None else _dtype(target_dtype)
    s = torch.tensor(scale, dtype=torch.float32)  # rounded as the kernel's
    return (x.to(torch.float32) * s).to(dst)


def _kernel():
    lib = _build.load_library("cast_scale")
    fn = lib.cmn_cast_scale
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cast_scale(x: torch.Tensor, target_dtype: Optional[torch.dtype],
               scale: float) -> torch.Tensor:
    """``(x * scale)`` cast to ``target_dtype`` (None keeps ``x.dtype``),
    computed in float32, as one pass.

    ``x`` may have any shape and is processed as a flat buffer; it must be
    contiguous and float32, bfloat16 or float16, and so must the target
    type.  ``scale`` is a host float.  Returns a new tensor of ``x``'s
    shape.
    """
    src = _dtype(x.dtype)
    dst = src if target_dtype is None else _dtype(target_dtype)
    if not x.is_contiguous():
        raise ValueError("cast_scale: the input must be contiguous")
    if x.device.type == "cpu":
        return cast_scale_plain(x, dst, scale)
    if x.device.type != "cuda":
        raise ValueError(f"cast_scale: tensors on {x.device} are not "
                         "supported")
    y = torch.empty(x.shape, dtype=dst, device=x.device)
    if x.numel() == 0:
        return y
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), x.numel(), float(scale),
                 _CODES[src], _CODES[dst], x.device.index, stream)
    if err:
        raise RuntimeError(f"cast_scale: kernel launch failed with CUDA "
                           f"error {err}")
    cast_scale.launches += 1
    return y


def cast_scale_bytes(n: int, src: torch.dtype, dst: torch.dtype) -> int:
    """Bytes one call must move: ``n`` source elements read once and ``n``
    destination elements written once."""
    return n * (torch.empty((), dtype=src).element_size()
                + torch.empty((), dtype=dst).element_size())


KERNELS = (cast_scale,)
cast_scale.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {w.__name__: w.launches for w in KERNELS}


def reset_launch_counts() -> None:
    for w in KERNELS:
        w.launches = 0
