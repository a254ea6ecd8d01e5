"""Fused BatchNorm(+ReLU) at the normalization boundary, as GPU kernels.

Counterpart of ``chainermn_tpu/ops/fused_norm.py``.  The activation is
viewed as ``[R, C]`` (rows = every non-feature element, channels last), and
each direction makes the fewest full passes over it that a batch-global
normalization allows:

  forward  (train): stats pass (read x)  +  apply pass (read x, write y)
  forward  (eval):  apply pass only
  backward:         reduce pass (read x, g)  +  dx pass (read x, g, write dx)

Four kernels do those passes on the GPU: the two elementwise passes in
Triton and the two reductions in CUDA C++.  Each is bound by device memory:
it does at most ~12 float32 operations per element, while an H100 can do
~20 float32 operations (67 TFLOP/s outside the tensor cores) in the time it
moves one byte (3.35 TB/s).  Its least time is therefore the bytes
:func:`fused_norm_traffic_bytes` prices for its pass, over 3.35 TB/s.

===============  ===============================  =========================
wrapper          replaces (chainermn_tpu/ops/     bytes of its pass
                 fused_norm.py)
===============  ===============================  =========================
stats_call       ``_stats_kernel``                x once + 2 C-vectors
apply_call       ``_apply_kernel``                x and y once + 4 vectors
bwd_reduce_call  ``_bwd_reduce_kernel``           x and g once + 6 vectors
bwd_dx_call      ``_bwd_dx_kernel``               x, g, dx once + 6 vectors
===============  ===============================  =========================

Design, against that bound:

* A Triton program (apply, dx) works on a ``BLOCK_R x BLOCK_C`` tile whose
  rows are runs of ``BLOCK_C`` neighbouring channels, so every load is a
  coalesced run of the channels-last layout (the whole tile is one
  contiguous run when ``C <= BLOCK_C``).  The per-channel vectors are a few
  KiB and stay in L2.
* The TPU kernels carry their sums across a sequential grid in scratch
  memory.  GPU blocks run in parallel and in no order, so the two
  reductions (``chainermn_tpu_torch/csrc/fused_norm.cu``, design in its
  header) take their sums in a fixed order from float32 partials, with no
  atomics on the sums: a rerun gives the same bits.  Each is one launch
  that gathers its partials itself.  The statistics: one cooperative
  launch of at most one block an SM; a block copies a span of whole rows
  through a ring of 1-D bulk asynchronous copies (the TMA engine) into
  shared memory, writes a ``[2, C]`` partial, and after a grid-wide
  barrier every block adds the partials of its slice of the channels.  The
  backward reduction: blocks stream x and g through a ``cp.async`` ring,
  write their partials, and the last block of each channel tile to finish
  (a ticket counter, zeroed by a memset on the call's stream) adds them.
  Both replaced Triton designs whose finalize was one 4-warp program per
  128 channels walking ~500 chunks serially, a latency-bound tail on every
  boundary; Triton expresses neither the in-kernel finalize nor the copy
  ring.
* All arithmetic is float32 whatever the activation dtype; the variance is
  the fast form ``mean(x^2) - mean^2`` clamped at 0, as flax computes it.
* Ragged edges are masked, so any ``R`` and ``C`` work (the TPU kernels
  need the row tile to divide ``R``).

Beside each kernel is its plain PyTorch version with the kernel's op order
(``*_plain``).  A wrapper takes the plain version only for a tensor that
lies on the CPU; for a CUDA tensor it launches its kernel or raises.  Each
wrapper counts its launches in its ``launches`` attribute.

Triton is imported, and its kernels built, on the first launch, with
Triton's cache under ``build/triton`` of the checkout unless
``TRITON_CACHE_DIR`` says otherwise; the CUDA source is built with ``nvcc``
into ``build/cuda`` on the first launch of either reduction
(:mod:`chainermn_tpu_torch.ops._build`).  The module itself imports
without either.
"""

from __future__ import annotations

import collections
import ctypes
import os
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from chainermn_tpu_torch.ops import _build

__all__ = [
    "fused_norm",
    "fused_norm_reference",
    "FusedBatchNormAct",
    "ReferenceBatchNormAct",
    "fused_norm_traffic_bytes",
    "resnet_bn_traffic_bytes",
    "stats_call",
    "apply_call",
    "bwd_reduce_call",
    "bwd_dx_call",
    "stats_geometry",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]

# Bound by _kernels() on the first launch (the kernels read them as module
# globals, which is how Triton resolves names inside a @triton.jit body).
triton = None
tl = None

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_TILE = 4096            # elements per program tile
_MAX_BLOCK_C = 128      # channels per tile row (256 B of bf16)
_BUILD = Path(__file__).resolve().parents[2] / "build" / "triton"
_K: dict = {}
# the CUDA reductions (csrc/fused_norm.cu): dtype codes, block size, the
# statistics' ring stages (kStatsStages of kStageBytes), and the per-device
# state (entry points, SM count)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256
_STATS_STAGES = 6
_STAGE_BYTES = 16384
_CUDA: dict = {}


def _kernels() -> dict:
    """Import Triton and define its kernels (once per process)."""
    if _K:
        return _K
    global triton, tl
    os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD / "cache"))
    os.environ.setdefault("TRITON_HOME", str(_BUILD))
    import triton as _triton
    import triton.language as _tl
    triton, tl = _triton, _tl

    @triton.jit
    def apply_kernel(x_ptr, mean_ptr, invstd_ptr, scale_ptr, bias_ptr, y_ptr,
                     R, C, RELU: tl.constexpr, BLOCK_R: tl.constexpr,
                     BLOCK_C: tl.constexpr):
        # y = relu?((x - mean) * (invstd * scale) + bias)
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        m = (rows < R)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        mul = (tl.load(invstd_ptr + cols, mask=cmask, other=0.0)
               * tl.load(scale_ptr + cols, mask=cmask, other=0.0))
        bias = tl.load(bias_ptr + cols, mask=cmask, other=0.0)
        y = (x - mean[None, :]) * mul[None, :] + bias[None, :]
        if RELU:
            y = tl.maximum(y, 0.0)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def bwd_dx_kernel(x_ptr, g_ptr, mean_ptr, invstd_ptr, scale_ptr, bias_ptr,
                      dbeta_ptr, dgamma_ptr, dx_ptr, R, C, inv_rows,
                      RELU: tl.constexpr, TRAIN: tl.constexpr,
                      BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        # train: dx = γ·invstd·(dz − dβ/R − x̂·dγ/R); eval: γ·invstd·dz
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        m = (rows < R)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        dz = tl.load(g_ptr + offs, mask=m, other=0.0).to(tl.float32)
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        invstd = tl.load(invstd_ptr + cols, mask=cmask, other=0.0)
        scale = tl.load(scale_ptr + cols, mask=cmask, other=0.0)
        xhat = (x - mean[None, :]) * invstd[None, :]
        if RELU:
            bias = tl.load(bias_ptr + cols, mask=cmask, other=0.0)
            z = xhat * scale[None, :] + bias[None, :]
            dz = tl.where(z > 0.0, dz, 0.0)
        k = scale * invstd
        if TRAIN:
            dbeta = tl.load(dbeta_ptr + cols, mask=cmask, other=0.0)
            dgamma = tl.load(dgamma_ptr + cols, mask=cmask, other=0.0)
            dx = k[None, :] * (dz - (dbeta * inv_rows)[None, :]
                               - xhat * (dgamma * inv_rows)[None, :])
        else:
            dx = k[None, :] * dz
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=m)

    _K.update(apply=apply_kernel, bwd_dx=bwd_dx_kernel)
    return _K


# ---------------------------------------------------------------------------
# launch geometry and argument checks
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile(c: int):
    """(BLOCK_R, BLOCK_C): BLOCK_C channels per tile row, _TILE elements."""
    bc = min(_MAX_BLOCK_C, 1 << max(0, (c - 1).bit_length()))
    return _TILE // bc, bc


def _on_gpu(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for CUDA (kernel)."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{name}: tensors on {x.device} are not supported")


def _check_rows(name: str, *ts: torch.Tensor) -> None:
    shape = ts[0].shape
    for t in ts:
        if t.dim() != 2 or t.shape != shape:
            raise ValueError(f"{name}: expected [R, C] tensors of one shape, "
                             f"got {tuple(t.shape)} and {tuple(shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of "
                             f"{_DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: [R, C] tensor must be contiguous")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{ts[0].device}")


def _check_vecs(name: str, x2: torch.Tensor, *vs: torch.Tensor) -> None:
    c = x2.shape[1]
    for v in vs:
        if v.shape != (c,) or v.dtype != torch.float32 \
                or not v.is_contiguous() or v.device != x2.device:
            raise ValueError(
                f"{name}: per-channel vectors must be contiguous float32 "
                f"[{c}] on {x2.device}, got {v.dtype} {tuple(v.shape)} on "
                f"{v.device}")


# ---------------------------------------------------------------------------
# the four wrappers and their plain versions
# ---------------------------------------------------------------------------


def stats_plain(x2):
    """Plain version of the stats kernel: per-channel mean and fast
    variance of ``x2`` [R, C], in float32."""
    r = x2.shape[0]
    x = x2.float()
    mean = x.sum(0) / r
    var = torch.clamp_min((x * x).sum(0) / r - mean * mean, 0.0)
    return mean, var


StatsGeometry = collections.namedtuple(
    "StatsGeometry", "vec gpr rpi tile_c tiles tile_blocks spans span_rows "
    "stage_rows smem_bytes")


def stats_geometry(r: int, c: int, itemsize: int, vec: bool,
                   sms: int) -> StatsGeometry:
    """How ``cmn_bn_stats`` cuts an ``[R, C]`` activation of ``itemsize``
    bytes an element: ``gpr`` threads a row of a channel tile of ``tile_c``
    channels (8 a thread on the vector path, up to 2048 a tile; 1 a thread
    and 256 a tile on the scalar path), ``rpi`` rows a step; ``tiles``
    tiles over ``tile_blocks`` blocks times ``spans`` spans of
    ``span_rows`` rows (a multiple of rpi), at most ``sms`` blocks in all
    (one an SM, all resident at once); ring stages of ``stage_rows`` rows
    (whole row steps within ``_STAGE_BYTES``); ``smem_bytes`` of dynamic
    shared memory a block (the kernel's ``StatsSmem``)."""
    epc = 8 if vec else 1
    gpr = min(_cdiv(c, epc), _THREADS)
    rpi = _THREADS // gpr
    tile_c = gpr * epc
    tiles = _cdiv(c, tile_c)
    tile_blocks = min(tiles, sms)
    spans = max(1, min(sms // tile_blocks, _cdiv(r, rpi)))
    span_rows = _cdiv(_cdiv(r, spans), rpi) * rpi
    spans = _cdiv(r, span_rows)
    if vec:
        stage_rows = max(rpi, _STAGE_BYTES // (tile_c * itemsize) // rpi
                         * rpi)
        ring = _STATS_STAGES * (_STAGE_BYTES + 8)
    else:
        stage_rows, ring = rpi, 0
    return StatsGeometry(vec, gpr, rpi, tile_c, tiles, tile_blocks, spans,
                         span_rows, stage_rows,
                         ring + 2 * 8 * _THREADS * 4)


def stats_call(x2):
    """Batch mean and variance ([C] float32 each) of ``x2`` [R, C].  On the
    card: one cooperative launch of the CUDA ``cmn_bn_stats``
    (``csrc/fused_norm.cu``), which writes its partials into the call's own
    workspace and adds them after a grid-wide barrier."""
    _check_rows("stats_call", x2)
    if not _on_gpu("stats_call", x2):
        return stats_plain(x2)
    r, c = x2.shape
    dev = x2.device
    lib, sms = _cuda_state(dev)
    geo = stats_geometry(r, c, x2.element_size(),
                         c % 8 == 0 and x2.data_ptr() % 16 == 0, sms)
    ws = torch.empty((geo.spans, 2, c), dtype=torch.float32, device=dev)
    mean = torch.empty((c,), dtype=torch.float32, device=dev)
    var = torch.empty_like(mean)
    err = lib.cmn_bn_stats(
        x2.data_ptr(), mean.data_ptr(), var.data_ptr(), ws.data_ptr(), r, c,
        geo.span_rows, geo.gpr, geo.rpi, geo.stage_rows, geo.tile_blocks,
        int(geo.vec), _CODES[x2.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"stats_call: kernel launch failed with CUDA "
                           f"error {err}")
    stats_call.launches += 1
    return mean, var


def apply_plain(x2, mean, invstd, scale, bias, relu):
    """Plain version of the apply kernel."""
    mul = invstd * scale
    y = (x2.float() - mean) * mul + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2.dtype)


def apply_call(x2, mean, invstd, scale, bias, relu):
    """``relu?((x2 - mean) * (invstd * scale) + bias)`` in x2's dtype."""
    _check_rows("apply_call", x2)
    _check_vecs("apply_call", x2, mean, invstd, scale, bias)
    if not _on_gpu("apply_call", x2):
        return apply_plain(x2, mean, invstd, scale, bias, relu)
    k = _kernels()
    r, c = x2.shape
    br, bc = _tile(c)
    y2 = torch.empty_like(x2)
    k["apply"][(_cdiv(r, br), _cdiv(c, bc))](
        x2, mean, invstd, scale, bias, y2, r, c, RELU=bool(relu),
        BLOCK_R=br, BLOCK_C=bc, num_warps=8)
    apply_call.launches += 1
    return y2


def _dz_xhat(x2, g2, mean, invstd, scale, bias, relu):
    """Shared prologue of the plain backward versions: x̂ and masked dz."""
    xhat = (x2.float() - mean) * invstd
    g = g2.float()
    if relu:
        z = xhat * scale + bias
        g = torch.where(z > 0.0, g, torch.zeros_like(g))
    return g, xhat


def bwd_reduce_plain(x2, g2, mean, invstd, scale, bias, relu):
    """Plain version of the backward reduce kernel: (dβ, dγ)."""
    dz, xhat = _dz_xhat(x2, g2, mean, invstd, scale, bias, relu)
    return dz.sum(0), (dz * xhat).sum(0)


def _reduce_geometry(r: int, c: int, vec: bool, sms: int):
    """(threads a row, rows a step, rows a block) of the CUDA reduction:
    8 channels a thread on the vector path, 1 on the scalar path, in tiles
    of up to 128 channels (narrow tiles give wide layers more blocks and
    each tile's finalize fewer partials to add); about one block an SM in
    all, each walking at least 8 row steps."""
    epc, groups = (8, 16) if vec else (1, 128)
    tpr = min(_cdiv(c, epc), groups)
    rpi = _THREADS // tpr
    tiles = _cdiv(c, tpr * epc)
    want = max(1, _cdiv(sms, tiles))
    n_chunks = max(1, min(want, r // (8 * rpi)))
    rows = _cdiv(_cdiv(r, n_chunks), rpi) * rpi
    return tpr, rpi, rows


def declare_entries(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of the two C entry points of a
    library built from ``csrc/fused_norm.cu``; returns it."""
    lib.cmn_bn_bwd_reduce.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    lib.cmn_bn_stats.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 7
        + [ctypes.c_void_p])
    lib.cmn_bn_bwd_reduce.restype = lib.cmn_bn_stats.restype = ctypes.c_int
    return lib


def _cuda_state(dev: torch.device):
    """``(library, SM count)`` of the CUDA reductions on ``dev``, made at
    the first call there."""
    st = _CUDA.get(dev)
    if st is None:
        st = _CUDA[dev] = (
            declare_entries(_build.load_library("fused_norm")),
            torch.cuda.get_device_properties(dev).multi_processor_count)
    return st


def bwd_reduce_call(x2, g2, mean, invstd, scale, bias, relu):
    """dβ = Σdz and dγ = Σdz·x̂ ([C] float32 each), dz the upstream
    gradient ``g2`` masked by the recomputed ReLU.  On the card: one launch
    of the CUDA ``cmn_bn_bwd_reduce`` (``csrc/fused_norm.cu``), after a
    memset of its tile counters, which sit at the end of the call's own
    workspace; ``x2`` and ``g2`` must have one dtype there."""
    _check_rows("bwd_reduce_call", x2, g2)
    _check_vecs("bwd_reduce_call", x2, mean, invstd, scale, bias)
    if not _on_gpu("bwd_reduce_call", x2):
        return bwd_reduce_plain(x2, g2, mean, invstd, scale, bias, relu)
    if g2.dtype != x2.dtype:
        raise ValueError(f"bwd_reduce_call: x2 {x2.dtype} and g2 "
                         f"{g2.dtype} must have one dtype on the card")
    r, c = x2.shape
    dev = x2.device
    lib, sms = _cuda_state(dev)
    vec = (c % 8 == 0 and x2.data_ptr() % 16 == 0
           and g2.data_ptr() % 16 == 0)
    tpr, rpi, rows = _reduce_geometry(r, c, vec, sms)
    # [n_chunks, 2, C] float32 partials, then one int32 counter a tile
    partials = _cdiv(r, rows) * 2 * c
    ws = torch.empty((partials + _cdiv(c, tpr * (8 if vec else 1)),),
                     dtype=torch.float32, device=dev)
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    vecs = (ctypes.c_void_p * 4)(mean.data_ptr(), invstd.data_ptr(),
                                 scale.data_ptr(), bias.data_ptr())
    err = lib.cmn_bn_bwd_reduce(
        x2.data_ptr(), g2.data_ptr(), vecs, out.data_ptr(), ws.data_ptr(),
        ws.data_ptr() + 4 * partials, r, c, rows, tpr, rpi, int(vec),
        int(bool(relu)), _CODES[x2.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"bwd_reduce_call: kernel launch failed with "
                           f"CUDA error {err}")
    dbeta, dgamma = out
    bwd_reduce_call.launches += 1
    return dbeta, dgamma


def bwd_dx_plain(x2, g2, mean, invstd, scale, bias, dbeta, dgamma, relu,
                 train):
    """Plain version of the dx kernel."""
    dz, xhat = _dz_xhat(x2, g2, mean, invstd, scale, bias, relu)
    k = scale * invstd
    if train:
        inv_rows = 1.0 / x2.shape[0]
        dx = k * (dz - dbeta * inv_rows - xhat * (dgamma * inv_rows))
    else:
        dx = k * dz
    return dx.to(x2.dtype)


def bwd_dx_call(x2, g2, mean, invstd, scale, bias, dbeta, dgamma, relu,
                train):
    """dx in x2's dtype; in train mode it carries the batch-statistics
    terms (dβ, dγ from :func:`bwd_reduce_call`)."""
    _check_rows("bwd_dx_call", x2, g2)
    _check_vecs("bwd_dx_call", x2, mean, invstd, scale, bias, dbeta, dgamma)
    if not _on_gpu("bwd_dx_call", x2):
        return bwd_dx_plain(x2, g2, mean, invstd, scale, bias, dbeta, dgamma,
                            relu, train)
    k = _kernels()
    r, c = x2.shape
    br, bc = _tile(c)
    dx2 = torch.empty_like(x2)
    k["bwd_dx"][(_cdiv(r, br), _cdiv(c, bc))](
        x2, g2, mean, invstd, scale, bias, dbeta, dgamma, dx2, r, c,
        1.0 / r, RELU=bool(relu), TRAIN=bool(train), BLOCK_R=br,
        BLOCK_C=bc, num_warps=8)
    bwd_dx_call.launches += 1
    return dx2


KERNELS = (stats_call, apply_call, bwd_reduce_call, bwd_dx_call)
for _w in KERNELS:
    _w.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {w.__name__: w.launches for w in KERNELS}


def reset_launch_counts() -> None:
    for w in KERNELS:
        w.launches = 0


# ---------------------------------------------------------------------------
# autograd core over the flattened [R, C] view
# ---------------------------------------------------------------------------


class _FusedCore(torch.autograd.Function):
    """The ``_fused_core`` custom VJP: forward = stats (train) + apply,
    backward = reduce + dx.  The cotangents of the returned batch
    mean/var are dropped, so gradients w.r.t. running stats are zero."""

    @staticmethod
    def forward(ctx, x2, scale, bias, mean_in, var_in, train, eps, relu):
        if train:
            mean, var = stats_call(x2)
        else:
            mean, var = mean_in, var_in
        invstd = torch.rsqrt(var + eps)
        y2 = apply_call(x2, mean, invstd, scale, bias, relu)
        ctx.save_for_backward(x2, scale, bias, mean, invstd)
        ctx.train, ctx.relu = train, relu
        ctx.mark_non_differentiable(mean, var)
        return y2, mean, var

    @staticmethod
    def backward(ctx, gy2, _gmean, _gvar):
        x2, scale, bias, mean, invstd = ctx.saved_tensors
        gy2 = gy2.contiguous()
        dbeta, dgamma = bwd_reduce_call(x2, gy2, mean, invstd, scale, bias,
                                        ctx.relu)
        dx2 = bwd_dx_call(x2, gy2, mean, invstd, scale, bias, dbeta, dgamma,
                          ctx.relu, ctx.train)
        return dx2, dgamma, dbeta, None, None, None, None, None


def _vec(v, c, name):
    v = torch.as_tensor(v)
    if v.numel() != c:
        raise ValueError(f"fused_norm: {name} has {v.numel()} values for "
                         f"{c} channels")
    return v.reshape(c).to(torch.float32).contiguous()


def fused_norm(x, scale, bias, mean=None, var=None, *,
               use_running_average=False, epsilon=1e-5, relu=True):
    """Fused BatchNorm(+ReLU) over the last axis of ``x``.

    Returns ``(y, mean, var)``: ``y`` in ``x``'s dtype and the per-channel
    statistics used (the batch's in train mode, the given running stats in
    eval mode).  Differentiable; the backward is the reduce + dx kernels.

    Args:
      x: activations ``[..., C]`` (features last; a channels-last NCHW
        tensor permuted to NHWC is a free view).
      scale, bias: ``[C]`` affine parameters (γ, β).
      mean, var: running statistics ``[C]``, needed when
        ``use_running_average=True`` and ignored otherwise.
      use_running_average: eval mode.
      epsilon: added to the variance before the rsqrt.
      relu: apply ``max(y, 0)`` in the same pass.
    """
    c = x.shape[-1]
    r = x.numel() // c if c else 0
    if r == 0:
        raise ValueError(f"fused_norm: empty activation batch for "
                         f"{tuple(x.shape)}")
    x2 = x.reshape(r, c).contiguous()
    s2 = _vec(scale, c, "scale")
    b2 = _vec(bias, c, "bias")
    if use_running_average:
        if mean is None or var is None:
            raise ValueError(
                "fused_norm(use_running_average=True) needs mean= and var=")
        m2, v2 = _vec(mean, c, "mean"), _vec(var, c, "var")
    else:
        m2 = v2 = None
    y2, m, v = _FusedCore.apply(x2, s2, b2, m2, v2, not use_running_average,
                                float(epsilon), bool(relu))
    return y2.reshape(x.shape), m, v


def fused_norm_reference(x, scale, bias, mean=None, var=None, *,
                         use_running_average=False, epsilon=1e-5, relu=True):
    """Plain differentiable oracle with the kernels' math (float32, fast
    variance, flax op order); autograd gives its gradient."""
    c = x.shape[-1]
    x2 = x.reshape(-1, c).float()
    if use_running_average:
        m, v = mean.float(), var.float()
    else:
        m = x2.mean(0)
        v = torch.clamp_min((x2 * x2).mean(0) - m * m, 0.0)
    mul = torch.rsqrt(v + epsilon) * scale.float()
    y = (x2 - m) * mul + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.reshape(x.shape).to(x.dtype), m, v


# ---------------------------------------------------------------------------
# module: the norm_cls of models.resnet
# ---------------------------------------------------------------------------


class FusedBatchNormAct(nn.Module):
    """BatchNorm(+ReLU) module backed by the fused kernels.

    The counterpart of the flax ``FusedBatchNormAct``: float32 ``weight``
    (γ, flax ``scale``) and ``bias``, float32 ``running_mean`` /
    ``running_var`` buffers updated as ``m * running + (1 - m) * batch``
    with the biased batch variance (flax's rule; ``nn.BatchNorm2d`` would
    use the unbiased one).  Train or eval mode follows ``self.training``.
    Takes ``[N, C, H, W]`` (best in ``torch.channels_last`` memory, where
    the ``[R, C]`` view is free) or ``[N, C]``; the output is in ``dtype``
    (default: the promotion of the input's dtype with float32).
    ``update_stats`` False leaves the running buffers alone in train mode:
    for a forward that a checkpoint recomputes in the backward pass, whose
    statistics the first forward already folded in (flax's ``nn.remat``
    drops the recomputed state).
    """

    supports_fused_relu = True  # read by models.resnet._norm_relu
    _norm = staticmethod(fused_norm)

    def __init__(self, num_features: int, *, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 scale_init: float = 1.0, fuse_relu: bool = False,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.fuse_relu = fuse_relu
        self.update_stats = True
        f32 = {"dtype": torch.float32, "device": device}
        self.weight = nn.Parameter(torch.full((num_features,), scale_init,
                                              **f32))
        self.bias = nn.Parameter(torch.zeros((num_features,), **f32))
        self.register_buffer("running_mean", torch.zeros((num_features,),
                                                         **f32))
        self.register_buffer("running_var", torch.ones((num_features,),
                                                       **f32))

    def forward(self, x):
        odt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        xl = x.permute(0, 2, 3, 1) if x.dim() == 4 else x
        y, mean, var = self._norm(
            xl.to(odt), self.weight, self.bias, self.running_mean,
            self.running_var, use_running_average=not self.training,
            epsilon=self.epsilon, relu=self.fuse_relu)
        if self.training and self.update_stats:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        return y.permute(0, 3, 1, 2) if x.dim() == 4 else y


class ReferenceBatchNormAct(FusedBatchNormAct):
    """The same module over :func:`fused_norm_reference` (plain PyTorch
    ops and autograd): the yardstick a model with kernels is held to."""

    _norm = staticmethod(fused_norm_reference)


# ---------------------------------------------------------------------------
# traffic model (plain arithmetic, identical to the JAX package's)
# ---------------------------------------------------------------------------


def _dtype_info(dtype: torch.dtype):
    """(name, itemsize) of a torch dtype."""
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"expected a torch dtype, got {dtype!r}")
    return str(dtype).replace("torch.", ""), dtype.itemsize


def fused_norm_traffic_bytes(shape, dtype=torch.bfloat16, *, train=True,
                             relu=True, backward=True):
    """Modeled device-memory bytes for one BN(+ReLU) boundary, fused vs
    unfused: full-activation traversals at ``dtype`` width plus the float32
    per-channel vectors each pass touches.  The fused side prices exactly
    the passes of the kernels in this module:

      unfused fwd: mean 1R · var 1R · normalize 1R+1W · scale/shift
                   1R+1W · relu 1R+1W                       = 8 acts
      unfused bwd: relu-bwd 2R+1W · dβ 1R · dγ 2R · dx 2R+1W = 9 acts
      fused   fwd: stats 1R · apply 1R+1W                    = 3 acts
      fused   bwd: reduce 2R · dx 2R+1W                      = 5 acts
    """
    shape = tuple(int(s) for s in shape)
    c = shape[-1]
    n = 1
    for s in shape:
        n *= s
    name, itemsize = _dtype_info(dtype)
    act = n * itemsize
    vec = c * 4  # per-channel f32 vectors

    def _table(passes):
        total = sum(b for _, b in passes)
        return {"passes": [[p, int(b)] for p, b in passes],
                "total_bytes": int(total)}

    fused = []
    if train:
        fused.append(("fwd_stats", act + 2 * vec))
    fused.append(("fwd_apply", 2 * act + 4 * vec))
    if backward:
        fused.append(("bwd_reduce", 2 * act + 6 * vec))
        fused.append(("bwd_dx", 3 * act + 6 * vec))

    unfused = []
    if train:
        unfused.append(("fwd_mean", act + vec))
        unfused.append(("fwd_var", act + vec))
    unfused.append(("fwd_normalize", 2 * act + 2 * vec))
    unfused.append(("fwd_scale_shift", 2 * act + 2 * vec))
    if relu:
        unfused.append(("fwd_relu", 2 * act))
    if backward:
        if relu:
            unfused.append(("bwd_relu", 3 * act))
        unfused.append(("bwd_dbeta", act + vec))
        unfused.append(("bwd_dgamma", 2 * act + vec))
        unfused.append(("bwd_dx", 3 * act + 4 * vec))

    f, u = _table(fused), _table(unfused)
    return {
        "shape": list(shape),
        "dtype": name,
        "train": bool(train),
        "relu": bool(relu),
        "backward": bool(backward),
        "activation_bytes": int(act),
        "fused": f,
        "unfused": u,
        "ratio": u["total_bytes"] / f["total_bytes"],
    }


def resnet_bn_boundaries(batch, *, image=224, stage_sizes=(3, 4, 6, 3),
                         num_filters=64):
    """``(name, NHWC shape, relu)`` of every BN boundary of a bottleneck
    ResNet, in the order the forward pass meets them."""
    boundaries = []
    s = image // 2  # stem conv 7x7 stride 2
    boundaries.append(("stem/bn_init", (batch, s, s, num_filters), True))
    s = s // 2  # 3x3 maxpool stride 2
    for i, blocks in enumerate(stage_sizes):
        f = num_filters * (2 ** i)
        for j in range(blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            s_in, s_out = s, s // stride
            tag = f"stage{i + 1}/block{j + 1}"
            boundaries.append((f"{tag}/norm1", (batch, s_in, s_in, f), True))
            boundaries.append((f"{tag}/norm2", (batch, s_out, s_out, f),
                               True))
            boundaries.append((f"{tag}/norm3",
                               (batch, s_out, s_out, 4 * f), False))
            if j == 0:  # channel (and possibly spatial) change: projection
                boundaries.append((f"{tag}/norm_proj",
                                   (batch, s_out, s_out, 4 * f), False))
            s = s_out
    return boundaries


def resnet_bn_traffic_bytes(batch, *, image=224, stage_sizes=(3, 4, 6, 3),
                            num_filters=64, dtype=torch.bfloat16, train=True):
    """Sum :func:`fused_norm_traffic_bytes` over every BN boundary of a
    bottleneck ResNet (the 53 boundaries of ResNet-50)."""
    rows, fused_total, unfused_total = [], 0, 0
    for name, shape, relu in resnet_bn_boundaries(
            batch, image=image, stage_sizes=stage_sizes,
            num_filters=num_filters):
        t = fused_norm_traffic_bytes(shape, dtype, train=train, relu=relu)
        fused_total += t["fused"]["total_bytes"]
        unfused_total += t["unfused"]["total_bytes"]
        rows.append({"name": name, "shape": list(shape), "relu": relu,
                     "fused_bytes": t["fused"]["total_bytes"],
                     "unfused_bytes": t["unfused"]["total_bytes"]})
    return {
        "batch": int(batch),
        "image": int(image),
        "stage_sizes": list(stage_sizes),
        "dtype": _dtype_info(dtype)[0],
        "train": bool(train),
        "num_boundaries": len(rows),
        "fused_total_bytes": int(fused_total),
        "unfused_total_bytes": int(unfused_total),
        "ratio": unfused_total / fused_total,
        "boundaries": rows,
    }
