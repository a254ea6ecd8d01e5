"""Fused softmax attention, forward and backward, as CUDA kernels.

Counterpart of ``chainermn_tpu/ops/flash_attention.py``: the same public
:func:`flash_attention` (layout q ``[B, Tq, H, D]``, k/v ``[B, Tkv, Hkv,
D]``, the same checks and ``ValueError``s, causal / segment / dropout /
offset masks, grouped-query heads, a differentiable ``[B, H, Tq]``
logsumexp), with its three Pallas kernels written again by hand for Hopper
in ``chainermn_tpu_torch/csrc/flash_attention.cu`` (design and bounds in
its header):

==============  ======================================  =====================
wrapper         replaces (chainermn_tpu/ops/            bound (H100)
                flash_attention.py)
==============  ======================================  =====================
flash_fwd       ``_fwd_kernel`` (:136) via              FLOPs / 989 T (bf16,
                ``_forward``                            fp16), / 66.9 T
                                                        (float32)
flash_bwd_dkv   ``_dkv_kernel`` (:307) via              the same
                ``_pallas_backward``
flash_bwd_dq    ``_dq_kernel`` (:393) via               the same
                ``_pallas_backward``
==============  ======================================  =====================

bf16 and fp16 run on the tensor cores (``wgmma`` at head dims 64 and 128,
``mma.sync`` at 16 and 32); float32 runs on the CUDA cores in float32,
never TF32 (the forward and dK/dV register-blocked, dQ over shared-memory
tiles).

The kernels are built with ``nvcc`` into ``build/cuda/`` at their first
launch and bound with ``ctypes`` (:mod:`chainermn_tpu_torch.ops._build`).
:func:`flash_attention_flops` and :func:`flash_attention_bytes` give the
work each one must do, for its least time on the card.

Beside them, in this module:

* :func:`_keep_mask`, the dropout hash, bit for bit the JAX one;
* :func:`flash_forward_plain`, masked softmax with the kernels'
  conventions (scale after the product, masked scores -1e30 and masked
  probabilities zeroed, dropout on the normalised weights with inverted
  scaling and the denominator from the undropped weights, P cast to v's
  dtype before the PV product, empty rows give 0 and lse 1e30);
* :func:`flash_backward_plain`, a port of JAX's ``_blockwise_backward``
  (a loop over K/V tiles) -- the gradient oracle.

A wrapper takes its plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its launches
in its ``launches`` attribute.  ``delta = rowsum(dO * O)`` stays plain
PyTorch, as JAX computes it outside any kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from chainermn_tpu_torch.ops import _build

__all__ = ["flash_attention", "flash_forward_plain", "flash_backward_plain",
           "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_attention_flops", "flash_attention_bytes", "KERNELS",
           "launch_counts", "reset_launch_counts"]

_BLOCK_Q = 1024  # JAX's default tiles: they set the plain backward's K/V
_BLOCK_K = 1024  # tile and are validated as in JAX; the kernels pick theirs
_NEG_INF = -1e30
_LSE_SENTINEL = 1e30
_M32 = 0xFFFFFFFF
# dtype codes and head dims of csrc/flash_attention.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128)


# ---------------------------------------------------------------------------
# dropout hash
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, in two 16-bit
    halves of ``c`` so that no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _keep_mask(seed, bh_idx, q_pos, k_pos, rate: float) -> torch.Tensor:
    """Dropout keep-mask from the counter-based hash of JAX's
    ``_keep_mask``, bit for bit: uint32 arithmetic on int64 tensors.
    ``q_pos``/``k_pos``/``bh_idx`` broadcast against each other."""
    u = lambda a: torch.as_tensor(a, dtype=torch.int64) & _M32  # noqa: E731
    x = (_mul32(u(q_pos), 0x9E3779B1) ^ _mul32(u(k_pos), 0x85EBCA77)
         ^ _mul32(u(bh_idx), 0xC2B2AE35) ^ u(seed))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= _threshold(rate)


def _threshold(rate: float) -> int:
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scale(sm_scale, d: int) -> float:
    return sm_scale if sm_scale is not None else d ** -0.5


def _pos(t: int, off: Optional[torch.Tensor], col: int, device):
    """Global positions ``off + arange(t)``, shaped to broadcast over
    ``[B, H, Tq, Tk]``: along axis 2 (``col=0``, q) or 3 (``col=1``, k)."""
    ar = torch.arange(t, device=device)
    shape = (1, 1, t, 1) if col == 0 else (1, 1, 1, t)
    if off is None:
        return ar.view(shape)
    return off[:, col].long().view(-1, 1, 1, 1) + ar.view(shape)


def _mask(causal, q_pos, k_pos, qseg, kseg):
    """``[B|1, 1, Tq, Tk]`` allow-mask, or None when nothing masks."""
    mask = None
    if causal:
        mask = q_pos >= k_pos
    if qseg is not None:
        m2 = qseg[:, None, :, None] == kseg[:, None, None, :]
        mask = m2 if mask is None else (mask & m2)
    return mask


def _heads(b: int, h: int, device):
    """Program index ``b * H + h`` of every (batch, q head): the dropout
    hash's ``bh_idx``, ``[B, H, 1, 1]``."""
    return torch.arange(b * h, device=device).view(b, h, 1, 1)


def _bhtd(x: torch.Tensor, grp: int = 1) -> torch.Tensor:
    """``[B, T, H, D]`` -> float32 ``[B, H, T, D]``, each kv head repeated
    for its ``grp`` q heads."""
    x = x.permute(0, 2, 1, 3).float()
    return x.repeat_interleave(grp, dim=1) if grp > 1 else x


def flash_forward_plain(q, k, v, causal=False, sm_scale=None, *, qseg=None,
                        kseg=None, offs=None, seed=0, rate=0.0):
    """Plain version of the forward kernel: ``(out [B, Tq, H, D] in q's
    dtype, lse [B, H, Tq] float32)`` from the whole ``[Tq, Tkv]`` score
    matrix in float32.  ``qseg``/``kseg`` are ``[B, T]`` ids, ``offs`` a
    ``[B, 2]`` (q, kv) offset tensor, ``seed`` a host int.  Differentiable
    by autograd (out of place where q, k or v requires grad)."""
    b, tq, h, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    grp = h // hk
    dev = q.device
    # in place unless autograd records the call (the same values either way)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    s = torch.matmul(_bhtd(q), _bhtd(k, grp).transpose(-1, -2))
    scale = _scale(sm_scale, d)
    s = s * scale if grad else s.mul_(scale)
    q_pos, k_pos = _pos(tq, offs, 0, dev), _pos(tk, offs, 1, dev)
    mask = _mask(causal, q_pos, k_pos, qseg, kseg)
    if mask is not None:
        s = (s.masked_fill(~mask, _NEG_INF) if grad
             else s.masked_fill_(~mask, _NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = (s - m).exp() if grad else s.sub_(m).exp_()
    if mask is not None:
        # a row masked everywhere has s - m == 0: zero it explicitly
        p = p.masked_fill(~mask, 0.0) if grad else p.masked_fill_(~mask, 0.0)
    l = p.sum(-1, keepdim=True)
    if rate > 0.0:
        keep = _keep_mask(seed, _heads(b, h, dev), q_pos, k_pos, rate)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    acc = torch.matmul(p.to(v.dtype).float(), _bhtd(v, grp))
    empty = l == 0.0
    out = (acc / torch.where(empty, 1.0, l)).to(q.dtype)
    lse = torch.where(empty, _LSE_SENTINEL,
                      m + torch.log(torch.where(empty, 1.0, l)))
    return out.permute(0, 2, 1, 3), lse.squeeze(-1)


def flash_backward_plain(q, k, v, g, lse, delta, glse=None, causal=False,
                         sm_scale=None, *, qseg=None, kseg=None, offs=None,
                         seed=0, rate=0.0, block_k=None):
    """Plain version of the two backward kernels, a port of JAX's
    ``_blockwise_backward``: a loop over K/V tiles of ``block_k`` keys in
    float32, from the saved lse ``[B, H, Tq]`` and ``delta = rowsum(dO *
    O)`` ``[B, H, Tq]``; ``glse`` is the lse's cotangent or None.  Returns
    ``(dq, dk, dv)`` in the inputs' dtypes; each kv head's gradient is the
    sum over its q-head group, in float32."""
    b, tq, h, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    grp = h // hk
    dev = q.device
    scale = _scale(sm_scale, d)
    bk = min(block_k or tk, tk) if tk else 1
    qT, gT, kT, vT = _bhtd(q), _bhtd(g), _bhtd(k, grp), _bhtd(v, grp)
    lse4, delta4 = lse[..., None], delta[..., None]
    glse4 = None if glse is None else glse.float()[..., None]
    q_pos = _pos(tq, offs, 0, dev)
    k_pos = _pos(tk, offs, 1, dev)
    bh_idx = _heads(b, h, dev)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    dq = torch.zeros_like(qT)
    dk_tiles, dv_tiles = [], []
    for j in range(0, tk, bk):
        kb, vb = kT[:, :, j:j + bk], vT[:, :, j:j + bk]
        kp = k_pos[..., j:j + bk]
        s = torch.matmul(qT, kb.transpose(-1, -2)) * scale
        a = torch.exp(s - lse4)
        mask = _mask(causal, q_pos, kp, qseg,
                     None if kseg is None else kseg[:, j:j + bk])
        if mask is not None:
            a = torch.where(mask, a, 0.0)
        dp = torch.matmul(gT, vb.transpose(-1, -2))
        if rate > 0.0:
            keep = _keep_mask(seed, bh_idx, q_pos, kp, rate)
            a_drop = torch.where(keep, a * inv, 0.0)
            da = torch.where(keep, dp * inv, 0.0)
        else:
            a_drop, da = a, dp
        dv_tiles.append(torch.matmul(a_drop.transpose(-1, -2), gT))
        ds = a * (da - delta4) * scale
        if glse4 is not None:
            ds = ds + a * glse4 * scale
        dq = dq + torch.matmul(ds, kb)
        dk_tiles.append(torch.matmul(ds.transpose(-1, -2), qT))
    empty = qT.new_zeros((b, h, 0, d))
    dk = torch.cat(dk_tiles, dim=2) if dk_tiles else empty
    dv = torch.cat(dv_tiles, dim=2) if dv_tiles else empty
    if grp > 1:  # sum each kv head's gradient over its q-head group
        dk = dk.reshape(b, hk, grp, tk, d).sum(2)
        dv = dv.reshape(b, hk, grp, tk, d).sum(2)
    back = lambda x, ref: x.permute(0, 2, 1, 3).to(ref.dtype)  # noqa: E731
    return back(dq, q), back(dk, k), back(dv, v)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

# csrc/flash_attention.cu's `Args`: every field 8 bytes, in this order
_PTRS = ("q", "k", "v", "g", "lse_in", "delta", "glse", "qseg", "kseg",
         "offs", "out", "lse", "dq", "dk", "dv")
_INTS = ("B", "Tq", "Tk", "H", "Hk", "q_sb", "q_st", "q_sh", "k_sb", "k_st",
         "k_sh", "v_sb", "v_st", "v_sh", "g_sb", "g_st", "g_sh", "causal",
         "seed", "thresh", "dropout")


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int64) for n in _INTS]
                + [("scale", ctypes.c_double), ("inv_keep", ctypes.c_double)])


def _kernel(entry: str):
    lib = _build.load_library("flash_attention")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it, else a contiguous copy.
    They read a view as a TMA tensor map does (the wgmma kernels) or by
    16-byte vectors (the others): unit stride along D, a 16-byte aligned
    base, strides that are multiples of 16 bytes, and no zero stride along a
    dimension longer than 1 (a broadcast view)."""
    e = x.element_size()
    if (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all((s * e) % 16 == 0 and (s or n == 1)
                    for s, n in zip(x.stride()[:3], x.shape[:3]))):
        return x
    # a clone, not .contiguous(): a contiguous view off the 16-byte grid
    # must move too
    return x.clone(memory_format=torch.contiguous_format)


def _args(q, k, v, causal, sm_scale, qseg, kseg, offs, seed, rate):
    """Check the inputs for the kernels and fill the ``Args`` they share;
    returns ``(args, q, k, v)`` (views the kernels can read)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels: tensors on {q.device} "
                         "are not supported")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _CODES:
        raise ValueError(f"flash attention kernels: q/k/v dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype} must be one of "
                         f"{tuple(_CODES)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels: head dim {q.shape[3]} "
                         f"is not one of {HEAD_DIMS}")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    b, tq, h, _ = q.shape
    a = _Args()
    a.q, a.k, a.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    a.B, a.Tq, a.Tk, a.H, a.Hk = b, tq, k.shape[1], h, k.shape[2]
    a.q_sb, a.q_st, a.q_sh = q.stride()[:3]
    a.k_sb, a.k_st, a.k_sh = k.stride()[:3]
    a.v_sb, a.v_st, a.v_sh = v.stride()[:3]
    if qseg is not None:
        a.qseg = qseg.data_ptr()
        a.kseg = kseg.data_ptr()
    if offs is not None:
        a.offs = offs.data_ptr()
    a.causal = int(bool(causal))
    a.scale = _scale(sm_scale, q.shape[3])
    a.dropout = int(rate > 0.0)
    if rate > 0.0:
        a.seed = int(seed) & _M32
        a.thresh = _threshold(rate)
        a.inv_keep = 1.0 / (1.0 - rate)
    return a, q, k, v


def _launch(entry: str, a: _Args, x: torch.Tensor) -> None:
    fn = _kernel(entry)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ctypes.byref(a), _CODES[x.dtype], x.shape[3],
                 x.device.index, stream)
    if err:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error "
                           f"{err}")


def _ids(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.to(torch.int32).contiguous()


def flash_fwd(q, k, v, causal=False, sm_scale=None, *, qseg=None, kseg=None,
              offs=None, seed=0, rate=0.0):
    """Forward kernel: ``(out [B, Tq, H, D] in q's dtype, lse [B, H, Tq]
    float32)``.  Arguments as :func:`flash_forward_plain`."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, sm_scale, qseg=qseg,
                                   kseg=kseg, offs=offs, seed=seed, rate=rate)
    qseg, kseg, offs = _ids(qseg), _ids(kseg), _ids(offs)
    a, q, k, v = _args(q, k, v, causal, sm_scale, qseg, kseg, offs, seed,
                       rate)
    b, tq, h, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.fill_(_LSE_SENTINEL)
    a.out, a.lse = out.data_ptr(), lse.data_ptr()
    _launch("cmn_flash_fwd", a, q)
    flash_fwd.launches += 1
    return out, lse


def _bwd_args(q, k, v, g, lse, delta, glse, causal, sm_scale, qseg, kseg,
              offs, seed, rate):
    a, q, k, v = _args(q, k, v, causal, sm_scale, qseg, kseg, offs, seed,
                       rate)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"flash attention kernels: dO {g.dtype}"
                         f"{tuple(g.shape)} must match q {q.dtype}"
                         f"{tuple(q.shape)}")
    g = _kernel_view(g)
    a.g = g.data_ptr()
    a.g_sb, a.g_st, a.g_sh = g.stride()[:3]
    vecs = [lse.float().contiguous(), delta.float().contiguous()]
    a.lse_in, a.delta = vecs[0].data_ptr(), vecs[1].data_ptr()
    if glse is not None:
        vecs.append(glse.float().contiguous())
        a.glse = vecs[2].data_ptr()
    return a, (q, k, v, g, vecs)


def flash_bwd_dkv(q, k, v, g, lse, delta, glse=None, causal=False,
                  sm_scale=None, *, qseg=None, kseg=None, offs=None, seed=0,
                  rate=0.0):
    """dK/dV kernel: ``(dk, dv)`` ``[B, Tkv, Hkv, D]`` in k's dtype, each
    kv head's sum over its q-head group taken in float32 inside the
    kernel.  ``g`` is dO, ``lse``/``delta``/``glse`` are ``[B, H, Tq]``."""
    if q.device.type == "cpu":
        return flash_backward_plain(
            q, k, v, g, lse, delta, glse, causal, sm_scale, qseg=qseg,
            kseg=kseg, offs=offs, seed=seed, rate=rate)[1:]
    qseg, kseg, offs = _ids(qseg), _ids(kseg), _ids(offs)
    a, keep = _bwd_args(q, k, v, g, lse, delta, glse, causal, sm_scale, qseg,
                        kseg, offs, seed, rate)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    if q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    a.dk, a.dv = dk.data_ptr(), dv.data_ptr()
    _launch("cmn_flash_bwd_dkv", a, keep[0])
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, g, lse, delta, glse=None, causal=False,
                 sm_scale=None, *, qseg=None, kseg=None, offs=None, seed=0,
                 rate=0.0):
    """dQ kernel: ``dq`` ``[B, Tq, H, D]`` in q's dtype (no atomics: one
    block owns each dQ tile, so a rerun gives the same bits)."""
    if q.device.type == "cpu":
        return flash_backward_plain(
            q, k, v, g, lse, delta, glse, causal, sm_scale, qseg=qseg,
            kseg=kseg, offs=offs, seed=seed, rate=rate)[0]
    qseg, kseg, offs = _ids(qseg), _ids(kseg), _ids(offs)
    a, keep = _bwd_args(q, k, v, g, lse, delta, glse, causal, sm_scale, qseg,
                        kseg, offs, seed, rate)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    if k.shape[1] == 0:  # no key: every row is empty (no tensor map of K)
        return dq.zero_()
    a.dq = dq.data_ptr()
    _launch("cmn_flash_bwd_dq", a, keep[0])
    flash_bwd_dq.launches += 1
    return dq


KERNELS = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)
for _w in KERNELS:
    _w.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {w.__name__: w.launches for w in KERNELS}


def reset_launch_counts() -> None:
    for w in KERNELS:
        w.launches = 0


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """``(out, lse)``; the backward runs the dK/dV and dQ kernels on CUDA
    tensors and the plain backward on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, offs, seed, rate, causal, sm_scale,
                block_k):
        ctx.set_materialize_grads(False)
        out, lse = flash_fwd(q, k, v, causal, sm_scale, qseg=qseg, kseg=kseg,
                             offs=offs, seed=seed, rate=rate)
        ctx.save_for_backward(q, k, v, out, lse, qseg, kseg, offs)
        ctx.conf = (seed, rate, causal, sm_scale, block_k)
        return out, lse

    @staticmethod
    def backward(ctx, g, glse):
        q, k, v, out, lse, qseg, kseg, offs = ctx.saved_tensors
        seed, rate, causal, sm_scale, block_k = ctx.conf
        if g is None:
            g = torch.zeros_like(out)
        # delta = rowsum(dO * O) in float32: plain torch, as JAX keeps it
        # outside the kernels
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
        kw = dict(qseg=qseg, kseg=kseg, offs=offs, seed=seed, rate=rate)
        if q.device.type == "cpu":
            dq, dk, dv = flash_backward_plain(
                q, k, v, g, lse, delta, glse, causal, sm_scale,
                block_k=block_k, **kw)
        else:
            dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, glse, causal,
                                   sm_scale, **kw)
            dq = flash_bwd_dq(q, k, v, g, lse, delta, glse, causal, sm_scale,
                              **kw)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def _fit_block(t: int, requested: Optional[int], default: int) -> int:
    """Resolve a block size as JAX does: explicit sizes must divide T; the
    default halves until it does."""
    if requested is not None:
        b = min(int(requested), t)
        if t % b:
            raise ValueError(
                f"flash_attention needs seq len ({t}) divisible by its "
                f"tiles ({b}); pad the sequence or pass smaller block "
                f"sizes")
        return b
    b = min(default, t)
    while b > 1 and t % b:
        b //= 2
    if t % b:
        raise ValueError(
            f"flash_attention cannot tile seq len {t}; pass block_q/"
            f"block_k that divide it (or pad the sequence)")
    return b


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    *, q_segment_ids=None, kv_segment_ids=None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    q_offset=None, kv_offset=None,
                    return_lse: bool = False,
                    bwd_impl: str = "pallas"):
    """Fused softmax attention: q ``[B, Tq, H, D]``, k/v ``[B, Tkv, Hkv,
    D]`` -> ``[B, Tq, H, D]``, differentiable in q, k, v (and in the lse
    with ``return_lse``).  The JAX signature and semantics:

    * ``causal`` compares GLOBAL positions: row ``q_offset + i`` sees column
      ``kv_offset + j`` iff ``i + q_offset >= j + kv_offset``;
    * ``Hkv`` may divide ``H`` (grouped-query attention): q head ``h`` reads
      kv head ``h // (H / Hkv)``;
    * ``q_segment_ids``/``kv_segment_ids`` (``[B, T]`` ints) allow a pair
      only where the ids match; passing either defaults the other to zeros;
      a row that matches nothing gives output 0 and lse 1e30;
    * ``dropout_rate`` + ``dropout_seed`` (a host int or a scalar tensor):
      dropout on the normalised weights, the mask a hash of (seed, b * H +
      h, q position, k position);
    * ``q_offset``/``kv_offset``: scalars shared by the batch or ``[B]``
      vectors;
    * ``return_lse``: also return the ``[B, H, Tq]`` float32 logsumexp;
    * ``block_q``/``block_k`` are checked as in JAX (explicit values must
      divide the sequence length) and set the plain backward's K/V tile;
      the CUDA kernels pick their own tiles, so a result depends on them
      only within float rounding;
    * ``bwd_impl``: "pallas" (the backward kernels on CUDA tensors, the
      plain backward on CPU tensors) or "blockwise" (the plain backward,
      which the port keeps for CPU tensors only).
    """
    dev = q.device
    if (q_segment_ids is not None) or (kv_segment_ids is not None):
        if q_segment_ids is None:
            q_segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32)
        if kv_segment_ids is None:
            kv_segment_ids = torch.zeros(k.shape[:2], dtype=torch.int32)
        q_segment_ids = torch.as_tensor(q_segment_ids).to(dev, torch.int32)
        kv_segment_ids = torch.as_tensor(kv_segment_ids).to(dev, torch.int32)
    dropout_rate = float(dropout_rate)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        dropout_seed = int(dropout_seed) & _M32
    else:
        dropout_seed = 0
    if (q_offset is not None) or (kv_offset is not None):
        b = q.shape[0]

        def _off_vec(o, label):
            o = torch.as_tensor(0 if o is None else o).to(dev, torch.int32)
            if o.ndim == 0:
                return o.expand(b)
            if tuple(o.shape) != (b,):
                raise ValueError(
                    f"{label} must be a scalar or a [batch] vector; got "
                    f"shape {tuple(o.shape)} for batch {b}")
            return o

        offs = torch.stack([_off_vec(q_offset, "q_offset"),
                            _off_vec(kv_offset, "kv_offset")], dim=1)
    else:
        offs = None
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if (q.shape[0], q.shape[3]) != (k.shape[0], k.shape[3]):
        raise ValueError(
            f"q and k/v must share batch/dim: {tuple(q.shape)} vs "
            f"{tuple(k.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q head count ({q.shape[2]}) must be a multiple of the kv "
            f"head count ({k.shape[2]}) for grouped-query attention")
    if max(a.element_size() for a in (q, k, v)) >= 4:
        dq_def, dk_def = min(_BLOCK_Q, 512), min(_BLOCK_K, 512)
    else:
        dq_def, dk_def = _BLOCK_Q, _BLOCK_K
    _fit_block(q.shape[1], block_q, dq_def)
    bk = _fit_block(k.shape[1], block_k, dk_def)
    if bwd_impl not in ("pallas", "blockwise"):
        raise ValueError(f"unknown bwd_impl {bwd_impl!r} "
                         "(expected 'pallas' or 'blockwise')")
    if bwd_impl == "blockwise" and dev.type != "cpu":
        raise ValueError("bwd_impl='blockwise' is the plain backward, kept "
                         "for CPU tensors; CUDA tensors take the kernels "
                         "('pallas')")
    out, lse = _Flash.apply(q, k, v, q_segment_ids, kv_segment_ids, offs,
                            dropout_seed, dropout_rate, bool(causal),
                            sm_scale, bk)
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# work of one call, for the bounds
# ---------------------------------------------------------------------------

_MATMULS = {"fwd": 2, "bwd_dkv": 4, "bwd_dq": 3}


def _pairs(tq: int, tk: int, causal: bool, q_offset: int = 0,
           kv_offset: int = 0) -> int:
    """(q, k) position pairs a causal (or full) mask allows."""
    if not causal:
        return tq * tk
    shift = q_offset - kv_offset
    return sum(min(max(i + shift + 1, 0), tk) for i in range(tq))


def flash_attention_flops(b: int, tq: int, tk: int, h: int, d: int,
                          causal: bool = False, kind: str = "fwd",
                          q_offset: int = 0, kv_offset: int = 0) -> int:
    """Matrix-product operations one kernel must do: ``2 * d`` per allowed
    (q, k) pair and product -- 2 products forward (QK^T, PV), 4 for dK/dV
    (QK^T, dO V^T, P^T dO, dS^T Q), 3 for dQ (QK^T, dO V^T, dS K)."""
    return (2 * d * _MATMULS[kind] * b * h
            * _pairs(tq, tk, causal, q_offset, kv_offset))


def flash_attention_bytes(b: int, tq: int, tk: int, h: int, hk: int, d: int,
                          dtype=torch.bfloat16, kind: str = "fwd") -> int:
    """Bytes one kernel must move, each input read once and each output
    written once: forward q, k, v in, out and the float32 lse out; dK/dV q,
    dO, k, v, lse, delta in, dk, dv out; dQ q, dO, k, v, lse, delta in, dq
    out."""
    e = torch.empty((), dtype=dtype).element_size()
    qb, kb, vec = b * tq * h * d * e, b * tk * hk * d * e, b * h * tq * 4
    return {"fwd": 2 * qb + 2 * kb + vec,
            "bwd_dkv": 2 * qb + 4 * kb + 2 * vec,
            "bwd_dq": 3 * qb + 2 * kb + 2 * vec}[kind]
