"""Decoder-only Transformer LM.

Counterpart of ``chainermn_tpu/models/transformer.py``: pre-LN blocks,
learned positional embeddings, a GELU MLP, float32 parameters computed in
``dtype``, attention through ``attention_impl``:

* ``"flash"`` -- :func:`chainermn_tpu_torch.ops.flash_attention` (the CUDA
  kernels on the card), which reads grouped kv heads natively;
* ``"ring"`` -- :func:`chainermn_tpu_torch.parallel.ring_attention` over
  the ranks of ``comm``, for a sequence sharded across GPUs; ``"ring_flash"``
  runs each visiting block through the flash kernels (logsumexp-merged) and
  rotates the grouped kv heads as they are (1/group of the bytes);
* ``"ulysses"`` -- :func:`chainermn_tpu_torch.parallel.ulysses_attention`,
  the all-to-all head/sequence exchange over ``comm``;
* ``"xla"`` -- the plain softmax of
  :func:`chainermn_tpu_torch.parallel.sequence.attention`.

Every impl but ``flash`` and ``ring_flash`` sees the kv heads repeated for
GQA.  The sequence-parallel impls take a communicator where the JAX model
takes ``axis_name``: each rank runs the model on its block of the sequence
with ``pos_offset = rank * T/P``.

What is kept from flax, which ``torch.nn``'s defaults would change:

* ``nn.gelu`` is the tanh approximation;
* ``LayerNorm``: epsilon 1e-6, the fast variance ``E[x^2] - E[x]^2``
  clamped at 0, statistics and normalisation in float32 even for bf16
  inputs, the result cast to ``dtype``;
* ``Dense`` in ``dtype`` casts the input and the float32 kernel to
  ``dtype`` and adds the bias in ``dtype`` (after the product's rounding);
* ``Embed`` casts its table to ``dtype`` before the lookup;
* the qkv projection splits q | k | v with widths ``d_model, d_kv, d_kv``;
* the logits are float32; ``pos_offset`` is a scalar or a ``[B]`` vector.

The JAX model's other extensions are not ported: ``moe_experts > 0``,
``tp_size > 1`` and ``attend=`` raise with their ROADMAP.md queue.  Weights
come from a flax model with :mod:`chainermn_tpu_torch.weights`;
initialisation otherwise draws from an explicit ``torch.Generator`` with
flax's initialisers (lecun-normal dense kernels and embeddings, zero biases,
unit scales).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models.resnet import Dense as _Dense, _lecun_normal_
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.parallel.sequence import (
    attention, ring_attention, ulysses_attention)
from chainermn_tpu_torch.parallel.topology import resolve_device

IMPLS = ("flash", "ring", "ring_flash", "ulysses", "xla")
SEQUENCE_PARALLEL = ("ring", "ring_flash", "ulysses")


def _check_impl(impl: str, comm) -> None:
    if impl not in IMPLS:
        raise ValueError(
            f"attention_impl must be flash|ring|ring_flash|ulysses|xla, "
            f"got {impl!r}")
    if impl in SEQUENCE_PARALLEL and comm is None:
        raise ValueError(
            f"attention_impl={impl!r} shards the sequence over the ranks "
            "of a communicator: pass comm=")


def _attend(impl: str, comm, q, k, v, causal: bool):
    if impl == "flash":
        return flash_attention(q, k, v, causal)
    if impl == "ring":
        return ring_attention(q, k, v, comm, causal=causal)
    if impl == "ring_flash":
        return ring_attention(q, k, v, comm, causal=causal,
                              attn_fn=flash_attention)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, comm, causal=causal)
    return attention(q, k, v, causal=causal)


class Dense(_Dense):
    """flax ``nn.Dense(dtype=...)``: ``(x @ W^T)`` in ``dtype``, then
    ``+ b`` in ``dtype``."""

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (see the module note)."""

    def __init__(self, features: int, *, dtype=torch.float32, device=None,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(features, dtype=torch.float32,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mu * mu, 0.0)
        y = (x - mu) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed(dtype=...)``: the float32 table cast to ``dtype``,
    then looked up."""

    def __init__(self, num: int, features: int, *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((num, features),
                                               dtype=torch.float32,
                                               device=device))
        _lecun_normal_(self.weight, features, generator)

    def forward(self, idx):
        return F.embedding(idx, self.weight.to(self.dtype))


class Block(nn.Module):
    """Pre-LN transformer block: ``x + proj(attn(ln_attn(x)))``, then
    ``x + down(gelu(up(ln_mlp(x))))``, causal."""

    def __init__(self, d_model: int, n_heads: int,
                 attention_impl: str = "xla", dtype=torch.float32,
                 n_kv_heads: Optional[int] = None, moe_experts: int = 0,
                 tp_size: int = 1, comm=None, *, device=None,
                 generator=None):
        super().__init__()
        n_kv = n_kv_heads or n_heads
        if n_heads % tp_size or n_kv % tp_size:
            raise ValueError(
                f"tp_size ({tp_size}) must divide n_heads "
                f"({n_heads}) and n_kv_heads ({n_kv})")
        if tp_size > 1:
            raise NotImplementedError(
                "tp_size > 1 (tensor-parallel serving) is not ported yet; "
                "see ROADMAP.md Queue A12")
        if moe_experts:
            raise NotImplementedError(
                "moe_experts > 0 (expert-parallel MLP) is not ported yet; "
                "see ROADMAP.md Queue A9")
        _check_impl(attention_impl, comm)
        self.n_heads, self.n_kv, self.impl = n_heads, n_kv, attention_impl
        self.comm = comm
        self.head_dim = d_model // n_heads
        self.d_kv = n_kv * self.head_dim
        dense = lambda i, o: Dense(i, o, dtype=dtype, device=device,  # noqa
                                   generator=generator)
        ln = lambda: LayerNorm(d_model, dtype=dtype, device=device)  # noqa
        self.ln_attn = ln()
        self.qkv = dense(d_model, d_model + 2 * self.d_kv)
        self.proj = dense(d_model, d_model)
        self.ln_mlp = ln()
        self.up = dense(d_model, 4 * d_model)
        self.down = dense(4 * d_model, d_model)

    def forward(self, x, attend=None):
        if attend is not None:
            raise NotImplementedError(
                "attend= (serving's per-layer attention) is not ported yet; "
                "see ROADMAP.md Queue A12")
        d_model = x.shape[-1]
        lead = x.shape[:-1]
        qkv = self.qkv(self.ln_attn(x))
        q = qkv[..., :d_model].reshape(lead + (self.n_heads, self.head_dim))
        k = qkv[..., d_model:d_model + self.d_kv].reshape(
            lead + (self.n_kv, self.head_dim))
        v = qkv[..., d_model + self.d_kv:].reshape(
            lead + (self.n_kv, self.head_dim))
        if self.n_kv != self.n_heads and self.impl not in (
                "flash", "ring_flash"):
            # the fused kernels read grouped kv natively (and under
            # ring_flash the grouped blocks rotate the ring, 1/group of the
            # bytes); the other impls see the heads repeated
            grp = self.n_heads // self.n_kv
            k = k.repeat_interleave(grp, dim=-2)
            v = v.repeat_interleave(grp, dim=-2)
        out = _attend(self.impl, self.comm, q, k, v, causal=True)
        x = x + self.proj(out.reshape(lead + (d_model,)))
        h = F.gelu(self.up(self.ln_mlp(x)), approximate="tanh")
        return x + self.down(h)


class TransformerLM(nn.Module):
    """``model(tokens [B, T]) -> logits [B, T, vocab]`` (float32, causal).

    The JAX constructor's fields, with ``comm`` (the communicator whose
    ranks shard the sequence) for ``axis_name``; with a sequence-parallel
    ``attention_impl`` each rank passes its ``[B, T/P]`` block and
    ``pos_offset=rank * T/P``.  Of the extensions, ``moe_experts`` and
    ``tp_size`` are taken only to refuse them.
    """

    def __init__(self, vocab: int, d_model: int = 256, n_layers: int = 4,
                 n_heads: int = 8, max_len: int = 8192,
                 attention_impl: str = "xla", *,
                 dtype: torch.dtype = torch.float32,
                 n_kv_heads: Optional[int] = None, moe_experts: int = 0,
                 tp_size: int = 1, comm=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(
                f"n_heads ({n_heads}) must divide d_model ({d_model})")
        if n_kv_heads is not None and (
                n_kv_heads < 1 or n_heads % n_kv_heads):
            raise ValueError(
                f"n_kv_heads ({n_kv_heads}) must be >= 1 and divide "
                f"n_heads ({n_heads})")
        device = resolve_device(device)
        self.vocab, self.d_model, self.dtype = vocab, d_model, dtype
        self.tok_emb = Embed(vocab, d_model, dtype=dtype, device=device,
                             generator=generator)
        self.pos_emb = Embed(max_len, d_model, dtype=dtype, device=device,
                             generator=generator)
        self.blocks = nn.ModuleList([
            Block(d_model, n_heads, attention_impl, dtype, n_kv_heads,
                  moe_experts, tp_size, comm, device=device,
                  generator=generator)
            for _ in range(n_layers)])
        self.ln_f = LayerNorm(d_model, dtype=dtype, device=device)
        self.head = Dense(d_model, vocab, dtype=dtype, device=device,
                          generator=generator)

    def forward(self, tokens, pos_offset=0, attend=None):
        if attend is not None:
            raise NotImplementedError(
                "attend= (serving's per-layer attention) is not ported yet; "
                "see ROADMAP.md Queue A12")
        x = self.tok_emb(tokens)
        off = torch.as_tensor(pos_offset, dtype=torch.int64,
                              device=tokens.device)
        ar = torch.arange(tokens.shape[-1], device=tokens.device)
        positions = off + ar if off.ndim == 0 else off[:, None] + ar[None, :]
        x = x + self.pos_emb(positions)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.ln_f(x)).float()


__all__ = ["Block", "Embed", "LayerNorm", "TransformerLM"]
