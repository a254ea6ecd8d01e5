"""Sequence parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``chainermn_tpu/parallel/sequence.py``.  The sequence is
sharded over the ranks of a communicator (the world, or a ``split_axes``
sub-communicator; JAX names a mesh axis instead): each rank holds the
local block ``[B, T/P, H, D]`` of q, k and v, in rank order.

* :func:`ring_attention` keeps q resident and rotates the k/v blocks
  around the ring (:func:`~chainermn_tpu_torch.functions.spmd_send_recv`
  to the next rank), folding each visiting block into a running (max,
  denominator, accumulator) triple: the online softmax, so the result is
  the single-shard softmax up to float associativity.  With ``attn_fn``
  (``ring_flash``: :func:`~chainermn_tpu_torch.ops.flash_attention`) each
  block goes through the fused kernel with its global offsets and lse
  (:func:`ring_flash_block`), and the running ``(out, lse)`` pairs merge
  by logsumexp; the lse's cotangent reaches the backward kernels.
* :func:`ulysses_attention` trades the sequence shard for a head shard
  with one all-to-all, attends over the whole sequence for H/P heads, and
  trades back.

The fold's arithmetic is rematerialised in the backward pass
(``torch.utils.checkpoint``), as JAX checkpoints its fold, so no
``[T/P, T/P]`` tile is kept per step; the rotation is not inside the
checkpoint, so the backward issues each reversed permute once and never
re-issues a forward one.  Each block starts on to the next rank before
its fold is queued and is waited for after it, so the transfer overlaps
the fold (in the backward pass the reversed transfer overlaps the fold's
backward).  The last block is not rotated on (JAX's scan rotates it back
to its owner and drops it).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from chainermn_tpu_torch import functions

# the flash kernels give a row that attends nothing an lse of 1e30; such a
# row takes merge weight 0
SENTINEL = 1e29


def attention(q, k, v, *, causal: bool = False,
              sm_scale: Optional[float] = None, q_offset=0, k_offset=0):
    """Plain softmax attention in float32: q ``[B, Tq, H, D]``, k/v ``[B,
    Tk, H, D]`` -> ``[B, Tq, H, D]`` in q's dtype.  The products take their
    operands in float32 (exact for bf16/fp16 inputs, as JAX's
    ``preferred_element_type=float32``), the causal mask compares global
    positions (``q_offset``/``k_offset`` are those of the first rows) with
    ``-inf``, and the probabilities are cast to v's dtype before the PV
    product."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _rotate(k_blk, v_blk, comm, step: int):
    """Start shipping the held k/v block to the next rank (one batch for
    both), unless ``step`` is the last: the fold of this block runs while
    they travel."""
    if step == comm.size - 1:
        return None
    pairs = [(i, (i + 1) % comm.size) for i in range(comm.size)]
    return functions.spmd_send_recv_async((k_blk, v_blk), comm, pairs)


def _fold(qf, k_blk, v_blk, acc, m, l, *, scale, causal, q_offset,
          k_offset):
    """One visiting k/v block folded into the running ``acc`` ``[B, H, T,
    D]``, max ``m`` and denominator ``l`` ``[B, H, T]`` (float32)."""
    scores = torch.einsum("bthd,bshd->bhts", qf, k_blk.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(qf.shape[1], device=qf.device)
        k_pos = k_offset + torch.arange(k_blk.shape[1], device=qf.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
    new_m = torch.maximum(m, scores.amax(-1))
    finite = torch.isfinite(new_m)
    safe_m = torch.where(finite, new_m, 0.0)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(finite[..., None], p, 0.0)  # fully masked rows
    alpha = torch.where(finite, torch.exp(m - safe_m), 1.0)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bhts,bshd->bhtd", p,
                                                v_blk.float())
    return acc, new_m, l


def ring_attention(q, k, v, comm, *, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   attn_fn: Optional[Callable] = None):
    """Exact attention over a sequence sharded on the ranks of ``comm``.

    ``q``/``k``/``v``: this rank's block ``[B, T/P, H, D]`` (rank r holds
    positions ``r T/P`` onward).  Returns this rank's ``[B, T/P, H, D]`` in
    q's dtype.  ``attn_fn``: a fused kernel with the extended signature of
    :func:`~chainermn_tpu_torch.ops.flash_attention` (``q_offset``/
    ``kv_offset``/``return_lse``), which then reads grouped k/v heads as
    they are; see :func:`ring_flash_block`.
    """
    if attn_fn is not None:
        return _ring_attention_kernel(q, k, v, comm, causal=causal,
                                      sm_scale=sm_scale, attn_fn=attn_fn)
    size, me = comm.size, comm.rank
    b, t_local, h, d = q.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qf = q.float()
    acc = q.new_zeros((b, h, t_local, d), dtype=torch.float32)
    m = q.new_full((b, h, t_local), float("-inf"), dtype=torch.float32)
    l = q.new_zeros((b, h, t_local), dtype=torch.float32)
    k_blk, v_blk = k, v
    for step in range(size):
        src = (me - step) % size  # the block held arrived from rank src
        nxt = _rotate(k_blk, v_blk, comm, step)
        acc, m, l = checkpoint(
            _fold, qf, k_blk, v_blk, acc, m, l, scale=scale, causal=causal,
            q_offset=me * t_local, k_offset=src * t_local,
            use_reentrant=False, preserve_rng_state=False)
        if nxt is not None:
            k_blk, v_blk = nxt.wait()
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ring_flash_block(q, k_blk, v_blk, o_run, lse_run, *, causal: bool,
                     sm_scale: Optional[float], attn_fn: Callable,
                     q_offset: int = 0, kv_offset: int = 0):
    """One step of the ``ring_flash`` fold: the visiting block through
    ``attn_fn(..., return_lse=True)`` (with the blocks' global offsets when
    causal), merged into the running ``o_run`` ``[B, T, H, D]`` and
    ``lse_run`` ``[B, H, T]`` (float32) by logsumexp.  A row whose block
    lse is the kernel's empty-row mark (``>= SENTINEL``) takes weight 0;
    the weights ``[B, H, T]`` are laid onto ``[B, T, H, D]``.  Returns the
    new ``(o_run, lse_run)``."""
    offsets = dict(q_offset=q_offset, kv_offset=kv_offset) if causal else {}
    o_blk, lse_blk = attn_fn(q, k_blk, v_blk, causal=causal,
                             sm_scale=sm_scale, return_lse=True, **offsets)
    lse_b = torch.where(lse_blk >= SENTINEL, float("-inf"), lse_blk)
    m = torch.maximum(lse_run, lse_b)
    finite = torch.isfinite(m)
    safe_m = torch.where(finite, m, 0.0)
    w_run = torch.where(finite, torch.exp(lse_run - safe_m), 0.0)
    w_blk = torch.where(finite, torch.exp(lse_b - safe_m), 0.0)
    denom = w_run + w_blk
    safe_denom = torch.where(denom == 0.0, 1.0, denom)

    def tr(w):
        return w.transpose(1, 2)[..., None]

    o_new = (o_run * tr(w_run) + o_blk.float() * tr(w_blk)) / tr(safe_denom)
    lse_new = torch.where(finite, safe_m + torch.log(safe_denom),
                          float("-inf"))
    return o_new, lse_new


def _ring_attention_kernel(q, k, v, comm, *, causal, sm_scale, attn_fn):
    """Ring attention with a fused kernel per block (see ring_attention)."""
    size, me = comm.size, comm.rank
    b, t_local, h, d = q.shape
    o_run = q.new_zeros((b, t_local, h, d), dtype=torch.float32)
    lse_run = q.new_full((b, h, t_local), float("-inf"),
                         dtype=torch.float32)
    k_blk, v_blk = k, v
    for step in range(size):
        src = (me - step) % size
        nxt = _rotate(k_blk, v_blk, comm, step)
        o_run, lse_run = checkpoint(
            ring_flash_block, q, k_blk, v_blk, o_run, lse_run,
            causal=causal, sm_scale=sm_scale, attn_fn=attn_fn,
            q_offset=me * t_local, kv_offset=src * t_local,
            use_reentrant=False, preserve_rng_state=False)
        if nxt is not None:
            k_blk, v_blk = nxt.wait()
    return o_run.to(q.dtype)


def _heads_to_sequence(comm, x):
    """``[B, T/P, H, D]`` -> ``[B, T, H/P, D]``: this rank's head group
    over the whole sequence (JAX's tiled ``all_to_all``, split heads,
    concatenate the sequence)."""
    b, t, h, d = x.shape
    p = comm.size
    slots = x.reshape(b, t, p, h // p, d).permute(2, 0, 1, 3, 4)
    got = functions.alltoall(comm, slots)  # [P (sequence block), B, T/P, ..]
    return got.permute(1, 0, 2, 3, 4).reshape(b, p * t, h // p, d)


def _sequence_to_heads(comm, x):
    """The inverse: ``[B, T, H/P, D]`` -> ``[B, T/P, H, D]``."""
    b, t, h, d = x.shape
    p = comm.size
    slots = x.reshape(b, p, t // p, h, d).permute(1, 0, 2, 3, 4)
    got = functions.alltoall(comm, slots)  # [P (head group), B, T/P, ..]
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // p, p * h, d)


def ulysses_attention(q, k, v, comm, *, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism: in and out
    ``[B, T/P, H, D]`` on the ranks of ``comm``; needs ``H % P == 0``.
    ``attn_fn(q, k, v, causal=..., sm_scale=...)`` defaults to the plain
    :func:`attention`."""
    size = comm.size
    h = q.shape[2]
    if h % size != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({h}) divisible by the axis "
            f"size ({size}); use ring_attention for odd head counts")
    qg, kg, vg = (_heads_to_sequence(comm, x) for x in (q, k, v))
    fn = attn_fn if attn_fn is not None else attention
    out = fn(qg, kg, vg, causal=causal, sm_scale=sm_scale)
    return _sequence_to_heads(comm, out)


__all__ = ["attention", "ring_attention", "ring_flash_block",
           "ulysses_attention"]
