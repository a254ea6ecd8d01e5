"""The stage-1 gradient products of ResNet-50 as CUDA kernels, for the probe.

Counterpart of the two Pallas kernels of
``benchmarks/bench_pallas_conv_probe.py``, which time the matrix products of
ResNet-50's first stage (M = 256 * 56 * 56 rows) against the library's:

* :func:`wgrad` (``make_wgrad_pallas``, :51): ``C[256, 64] f32 =
  A[256, M] @ B[M, 64]``, bf16 in, the reduction over M taken in float32;
* :func:`rowblock` (``make_rowblock_pallas``, :82): ``C[M, n] bf16 =
  A[M, k] @ B[k, n]`` summed in float32 and rounded once, for
  ``(k, n) = (64, 256)`` (dgrad) and ``(256, 64)`` (the forward 1x1 conv).

The kernels are ``chainermn_tpu_torch/csrc/probe_matmul.cu`` (design and
bound in its header): persistent blocks fed by TMA through an mbarrier ring,
``wgmma`` products, and (rowblock) a TMA-store epilogue.  They are built
with ``nvcc`` into ``build/cuda/`` on the first launch and bound with
``ctypes`` (:mod:`chainermn_tpu_torch.ops._build`).  Both cut M into 64-row
tiles and the tiles into :data:`SPANS` spans balanced within one tile, one
block each (:func:`probe_geometry`, computed here and checked by the
kernels' entry points): wgrad's blocks take contiguous spans, rowblock's
every :data:`SPANS`-th tile, so that the blocks write neighbouring rows.
wgrad writes one float32 partial per span into a workspace of
:func:`wgrad_workspace_bytes` and a second kernel adds the partials in a
fixed order.  ``bm`` keeps the probe's meaning (rows of M a grid step on
the TPU) in the API, its checks and the plain versions, where it sets the
chunk order; the kernels do not use it: every ``bm`` gives them the same
launch and the same bits.

Each wrapper takes its plain version (:func:`wgrad_plain`,
:func:`rowblock_plain`: the same function in PyTorch ops, chunk by chunk)
only for tensors that lie on the CPU; for CUDA tensors it launches its
kernel or raises.  ``wgrad.launches`` and ``rowblock.launches`` count the
launches (a wgrad launch is its two kernels).
"""

from __future__ import annotations

import ctypes

import torch

from chainermn_tpu_torch.ops import _build

__all__ = ["wgrad", "wgrad_plain", "rowblock", "rowblock_plain",
           "agreement", "probe_flops", "probe_bytes", "bound_ms",
           "wgrad_workspace_bytes", "ROWBLOCK_EQUAL", "ROWBLOCK_SHAPES",
           "SPANS", "STEP_ROWS", "WGRAD_RTOL", "KERNELS", "launch_counts",
           "probe_geometry", "reset_launch_counts", "span_tiles",
           "strided_tiles"]

# (k, n) of the rowblock kernel: dgrad and the forward 1x1 conv
ROWBLOCK_SHAPES = ((64, 256), (256, 64))
WGRAD_SHAPE = (256, 64)  # wgrad's output
STEP_ROWS = 64           # rows of M a kernel tile takes: bm is a multiple
SPANS = 132              # the kernels' spans of M (blocks): a constant, so
                         # the bits do not depend on the card's SM count
WGRAD_RTOL = 2e-5        # relative L2 error of wgrad against its plain sum
ROWBLOCK_EQUAL = 0.99    # share of rowblock's bf16 outputs equal bit for bit


def _check_split(m: int, bm: int, what: str) -> None:
    if bm <= 0 or m % bm:
        raise ValueError(f"{what}: bm {bm} does not divide M {m}")
    if bm % STEP_ROWS:
        raise ValueError(f"{what}: bm {bm} is not a multiple of "
                         f"{STEP_ROWS} (the kernel's step)")


def _check(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    for name, x in (("a", a), ("b", b)):
        if x.dim() != 2 or x.dtype != torch.bfloat16 or \
                not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a 2-D contiguous "
                             f"bfloat16 tensor, got {x.dtype} "
                             f"{tuple(x.shape)} strides {x.stride()}")
    if a.device != b.device:
        raise ValueError(f"{what}: a on {a.device}, b on {b.device}")


def _check_wgrad(a, b, bm) -> int:
    _check(a, b, "wgrad")
    m = a.shape[1]
    if a.shape[0] != WGRAD_SHAPE[0] or tuple(b.shape) != (m, WGRAD_SHAPE[1]):
        raise ValueError(f"wgrad: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}, expected [256, M] @ [M, 64]")
    _check_split(m, bm, "wgrad")
    return m


def _check_rowblock(a, b, bm) -> int:
    _check(a, b, "rowblock")
    m, k = a.shape
    if tuple(b.shape) not in ROWBLOCK_SHAPES or b.shape[0] != k:
        raise ValueError(f"rowblock: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}, expected [M, k] @ [k, n] with "
                         f"(k, n) one of {ROWBLOCK_SHAPES}")
    _check_split(m, bm, "rowblock")
    return m


def wgrad_plain(a: torch.Tensor, b: torch.Tensor, bm: int) -> torch.Tensor:
    """Plain version of :func:`wgrad`: the sum over chunks of ``bm`` rows of
    M, in order, of ``a[:, chunk].float() @ b[chunk].float()``."""
    m = _check_wgrad(a, b, bm)
    out = torch.zeros(WGRAD_SHAPE, dtype=torch.float32, device=a.device)
    for k0 in range(0, m, bm):
        out += a[:, k0:k0 + bm].float() @ b[k0:k0 + bm].float()
    return out


def rowblock_plain(a: torch.Tensor, b: torch.Tensor, bm: int) -> torch.Tensor:
    """Plain version of :func:`rowblock`: per block of ``bm`` rows,
    ``(a_blk.float() @ b.float()).to(bfloat16)``."""
    m = _check_rowblock(a, b, bm)
    bf = b.float()
    return torch.cat([(a[r:r + bm].float() @ bf).to(torch.bfloat16)
                      for r in range(0, m, bm)])


def probe_geometry(m: int) -> tuple:
    """``(spans, base, extra)``: the kernels' split of M's ``m // 64``
    tiles into :data:`SPANS` spans, balanced within one tile -- span ``s``
    holds ``base + 1`` tiles if ``s < extra``, else ``base``; block ``s``
    of wgrad takes them contiguous (:func:`span_tiles`), block ``s`` of
    rowblock every ``SPANS``-th tile from tile ``s`` (:func:`strided_tiles`).
    The same for every bm."""
    tiles = m // STEP_ROWS
    return SPANS, tiles // SPANS, tiles % SPANS


def span_tiles(geometry: tuple, s: int) -> range:
    """The tiles wgrad's block ``s`` reduces, in order: span ``s`` of
    ``geometry``, contiguous (the kernels' ``Share::span``)."""
    _, base, extra = geometry
    first = s * base + min(s, extra)
    return range(first, first + base + (s < extra))


def strided_tiles(geometry: tuple, s: int) -> range:
    """The tiles rowblock's block ``s`` computes, in order: every
    ``spans``-th tile from tile ``s`` (``Share::strided``), as many as span
    ``s`` holds."""
    spans, base, extra = geometry
    return range(s, spans * base + extra, spans)


def _library():
    lib = _build.load_library("probe_matmul")
    split = [ctypes.c_int, ctypes.c_int64, ctypes.c_int]  # probe_geometry
    lib.cmn_probe_wgrad.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, *split, ctypes.c_int, ctypes.c_void_p]
    lib.cmn_probe_rowblock.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, *split, ctypes.c_int, ctypes.c_void_p]
    lib.cmn_probe_wgrad.restype = lib.cmn_probe_rowblock.restype = ctypes.c_int
    return lib


def _kernel_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` when the kernels can read it (TMA needs a 16-byte aligned
    base), else an aligned copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {x.device} are not supported")
    return True


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")


def wgrad(a: torch.Tensor, b: torch.Tensor, bm: int) -> torch.Tensor:
    """``C[256, 64] float32 = a[256, M] @ b[M, 64]`` (bfloat16, contiguous),
    the reduction over M taken in float32 (``bm`` a multiple of 64 dividing
    M).  The kernel sums :data:`SPANS` float32 partials in a fixed order;
    the plain version sums chunks of ``bm`` rows in order."""
    m = _check_wgrad(a, b, bm)
    if not _on_cuda(a, "wgrad"):
        return wgrad_plain(a, b, bm)
    a, b = _kernel_input(a), _kernel_input(b)
    out = torch.empty(WGRAD_SHAPE, dtype=torch.float32, device=a.device)
    work = torch.empty((SPANS,) + WGRAD_SHAPE, dtype=torch.float32,
                       device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.cmn_probe_wgrad(a.data_ptr(), b.data_ptr(),
                                  work.data_ptr(), out.data_ptr(), m,
                                  *probe_geometry(m), a.device.index, stream)
    _raise_on(err, "wgrad")
    wgrad.launches += 1
    return out


def rowblock(a: torch.Tensor, b: torch.Tensor, bm: int) -> torch.Tensor:
    """``C[M, n] bfloat16 = a[M, k] @ b[k, n]`` (bfloat16, contiguous; (k,
    n) one of :data:`ROWBLOCK_SHAPES`), summed in float32 and rounded once
    (``bm`` a multiple of 64 dividing M; the plain version's row blocks)."""
    m = _check_rowblock(a, b, bm)
    if not _on_cuda(a, "rowblock"):
        return rowblock_plain(a, b, bm)
    a, b = _kernel_input(a), _kernel_input(b)
    k, n = b.shape
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.cmn_probe_rowblock(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), m, k, n,
                                     *probe_geometry(m), a.device.index,
                                     stream)
    _raise_on(err, "rowblock")
    rowblock.launches += 1
    return out


def probe_flops(m: int, k: int, n: int) -> int:
    """Operations of ``[m, k] @ [k, n]``: a multiply and an add each."""
    return 2 * m * k * n


def probe_bytes(m: int, k: int, n: int, out_bytes: int) -> int:
    """Bytes of ``[m, k] @ [k, n]`` in bf16: each input read once, the
    output written once (``out_bytes`` an element: 4 for wgrad's float32,
    2 for rowblock's bf16)."""
    return 2 * (m * k + k * n) + out_bytes * m * n


def bound_ms(flops: int, nbytes: int, card) -> tuple:
    """``(ms, "bytes" or "operations")``: the least time ``card`` (a
    :class:`~chainermn_tpu_torch.utils.gpu_info.Card`) could take, the
    larger of the bytes over its memory rate and the operations over its
    bf16 tensor-core peak."""
    bytes_ms = nbytes / card.hbm_bytes_per_s * 1e3
    ops_ms = flops / (card.peak_tflops * 1e12) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                            "operations")


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns as integers in the order of the values (+0 and -0
    both 0), so that neighbouring values differ by 1."""
    i = x.view(torch.int16).int()
    return torch.where(i >= 0, i, -(i & 0x7FFF))


def agreement(kind: str, a: torch.Tensor, b: torch.Tensor,
              got: torch.Tensor, want: torch.Tensor) -> dict:
    """Hold a kernel's output ``got`` on inputs ``a``, ``b`` to its plain
    version's ``want``; returns the figures and raises ``AssertionError``
    where they are off.

    * ``"wgrad"``: relative L2 error within :data:`WGRAD_RTOL`.  bf16
      products are exact in float32; only the order of the float32 sums
      differs, and its rounding grows with M.
    * ``"rowblock"``: at least :data:`ROWBLOCK_EQUAL` of the elements equal
      bit for bit, and every element within one bf16 unit in the last place
      plus the rounding bound of two float32 sums of k terms,
      ``k * 2**-22 * (|a| @ |b|)`` (the float32 sums may differ by that
      before they are rounded to bf16; it matters only where a sum cancels
      to far below its terms, where the bf16 unit is smaller than it).
    """
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{kind}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    out = {"max_abs_err": float(diff.max())}
    if kind == "wgrad":
        out["rel_l2"] = float((got - want).norm()
                              / want.norm().clamp_min(1e-30))
        if not out["rel_l2"] <= WGRAD_RTOL:
            raise AssertionError(f"wgrad: relative L2 error "
                                 f"{out['rel_l2']:.3g} over {WGRAD_RTOL}")
        return out
    ulps = (_ordered_bits(got) - _ordered_bits(want)).abs()
    out["equal_share"] = float((ulps == 0).float().mean())
    mag = torch.maximum(got.float().abs(), want.float().abs())
    _, e = torch.frexp(mag.clamp_min(2.0 ** -126))
    slack = a.shape[1] * 2.0 ** -22 * (a.float().abs() @ b.float().abs())
    over = diff > torch.ldexp(torch.ones_like(mag), e - 8) + slack
    out["beyond_one_ulp"] = int((ulps > 1).sum())
    if bool(over.any()) or out["equal_share"] < ROWBLOCK_EQUAL:
        raise AssertionError(
            f"rowblock: {int(over.sum())} elements beyond one bf16 ulp plus "
            f"the float32 sums' rounding bound, {out['equal_share']:.4f} of "
            f"them equal bit for bit (limit {ROWBLOCK_EQUAL})")
    return out


def wgrad_workspace_bytes(m: int, bm: int) -> int:
    """The float32 partials wgrad writes and sums again: one ``[256, 64]``
    a span, :data:`SPANS` of them whatever ``m`` and ``bm``."""
    return SPANS * WGRAD_SHAPE[0] * WGRAD_SHAPE[1] * 4


KERNELS = (wgrad, rowblock)
for _w in KERNELS:
    _w.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {w.__name__: w.launches for w in KERNELS}


def reset_launch_counts() -> None:
    for w in KERNELS:
        w.launches = 0
