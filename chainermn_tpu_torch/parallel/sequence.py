"""Attention over the sequence of one shard.

Counterpart of ``chainermn_tpu/parallel/sequence.py``.  Only
:func:`attention` (``:50``), the plain single-shard softmax behind
``TransformerLM(attention_impl="xla")``, is ported.  The sequence-parallel
strategies -- ring attention (also with the flash kernel inside, the JAX
``ring_flash``) and Ulysses all-to-all -- raise: they wait for ROADMAP.md
Queue A9.
"""

from __future__ import annotations

from typing import Optional

import torch


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


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (sequence parallelism) is not ported yet; see "
            "ROADMAP.md Queue A9")
    fn.__name__ = name
    return fn


ring_attention = _not_ported("ring_attention")
ulysses_attention = _not_ported("ulysses_attention")

__all__ = ["attention", "ring_attention", "ulysses_attention"]
