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

Serving's hooks are JAX's: ``pos_offset`` may be a ``[B]`` vector (each
sequence at its own global position) and ``attend=`` installs a per-layer
callback ``attend(layer, q, k, v)`` that sees the unrepeated grouped kv
heads and owns masking and the cache (:mod:`chainermn_tpu_torch.serving`).

The JAX model's two parallel extensions take communicators where JAX takes
mesh axis names:

* ``moe_experts > 0`` replaces every block's MLP by an
  :class:`~chainermn_tpu_torch.parallel.expert.ExpertParallelMLP` (top
  ``moe_top_k``, ``moe_capacity``) over the ranks of ``moe_comm`` (JAX's
  ``moe_axis``; None is a world of one), each rank holding its own experts.
  Each block keeps its last forward's statistics in ``moe_stats``, JAX's
  sown ``"moe_stats"`` keys (``aux_loss``, ``overflow_fraction``,
  ``expert_load``); :func:`collect_moe_stats` gathers them by block;
* ``tp_size > 1`` shards every block Megatron-style: ``n_heads / tp``
  local heads and ``n_kv_heads / tp`` kv heads from column slices of
  ``qkv``, ``up`` at ``4 d_model / tp``, and ``proj``/``down`` row slices
  whose outputs (biases included, pre-divided by ``tp`` in
  :func:`~chainermn_tpu_torch.serving.weights.shard_params_tp`) are summed
  over ``tp_comm`` (JAX's ``tp_axis``; None sums nothing, as JAX without
  an axis).  Embeddings, layer norms, the router and the head stay whole.

Weights come from a flax model with :mod:`chainermn_tpu_torch.weights`;
initialisation otherwise draws from an explicit ``torch.Generator`` with
flax's initialisers (lecun-normal dense kernels and embeddings, zero biases,
unit scales).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch import functions
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
    ``x + down(gelu(up(ln_mlp(x))))`` or ``x + moe(ln_mlp(x))``, causal
    (see the module note for the MoE and tensor-parallel branches)."""

    def __init__(self, d_model: int, n_heads: int,
                 attention_impl: str = "xla", dtype=torch.float32,
                 n_kv_heads: Optional[int] = None, moe_experts: int = 0,
                 tp_size: int = 1, comm=None, *, moe_top_k: int = 1,
                 moe_capacity: Optional[int] = None, moe_comm=None,
                 moe_plan=None, tp_comm=None, device=None, generator=None):
        super().__init__()
        n_kv = n_kv_heads or n_heads
        if n_heads % tp_size or n_kv % tp_size:
            raise ValueError(
                f"tp_size ({tp_size}) must divide n_heads "
                f"({n_heads}) and n_kv_heads ({n_kv})")
        if tp_comm is not None and tp_comm.size != tp_size:
            raise ValueError(f"tp_comm has {tp_comm.size} ranks, tp_size is "
                             f"{tp_size}")
        _check_impl(attention_impl, comm)
        self.n_heads, self.impl = n_heads // tp_size, attention_impl
        self.n_kv = n_kv // tp_size
        self.comm, self.tp_comm = comm, tp_comm if tp_size > 1 else None
        self.head_dim = d_model // n_heads
        self.d_local = self.n_heads * self.head_dim
        self.d_kv = self.n_kv * self.head_dim
        dense = lambda i, o: Dense(i, o, dtype=dtype, device=device,  # noqa
                                   generator=generator)
        ln = lambda: LayerNorm(d_model, dtype=dtype, device=device)  # noqa
        self.ln_attn = ln()
        self.qkv = dense(d_model, self.d_local + 2 * self.d_kv)
        self.proj = dense(self.d_local, d_model)
        self.ln_mlp = ln()
        self.moe_stats = None
        if moe_experts:
            from chainermn_tpu_torch.parallel.expert import ExpertParallelMLP
            self.moe = ExpertParallelMLP(
                d_model, 4 * d_model, moe_comm, num_experts=moe_experts,
                top_k=moe_top_k, capacity=moe_capacity, dtype=dtype,
                with_stats=True, plan=moe_plan, device=device,
                generator=generator)
        else:
            self.up = dense(d_model, 4 * d_model // tp_size)
            self.down = dense(4 * d_model // tp_size, d_model)

    def _row_sum(self, y):
        """The row-parallel outputs summed over the tensor-parallel ranks."""
        return y if self.tp_comm is None else functions.allreduce(
            self.tp_comm, y)

    def forward(self, x, attend=None):
        lead = x.shape[:-1]
        qkv = self.qkv(self.ln_attn(x))
        dl, dkv = self.d_local, self.d_kv
        q = qkv[..., :dl].reshape(lead + (self.n_heads, self.head_dim))
        k = qkv[..., dl:dl + dkv].reshape(lead + (self.n_kv, self.head_dim))
        v = qkv[..., dl + dkv:].reshape(lead + (self.n_kv, self.head_dim))
        if attend is not None:
            return self._rest(x, attend(q, k, v), lead)
        if self.n_kv != self.n_heads and self.impl not in (
                "flash", "ring_flash"):
            # the fused kernels read grouped kv natively (and under
            # ring_flash the grouped blocks rotate the ring, 1/group of the
            # bytes); the other impls see the heads repeated
            grp = self.n_heads // self.n_kv
            k = k.repeat_interleave(grp, dim=-2)
            v = v.repeat_interleave(grp, dim=-2)
        out = _attend(self.impl, self.comm, q, k, v, causal=True)
        return self._rest(x, out, lead)

    def _rest(self, x, out, lead):
        x = x + self._row_sum(self.proj(out.reshape(lead + (self.d_local,))))
        h = self.ln_mlp(x)
        if hasattr(self, "moe"):
            y, self.moe_stats = self.moe(h)
            return x + y
        h = F.gelu(self.up(h), approximate="tanh")
        return x + self._row_sum(self.down(h))


def collect_moe_stats(model) -> dict:
    """The last forward's MoE statistics of every block, ``{"block_i":
    {"aux_loss", "overflow_fraction", "expert_load"}}`` (JAX's
    ``"moe_stats"`` collection, one value a key)."""
    return {f"block_{i}": blk.moe_stats
            for i, blk in enumerate(model.blocks)
            if blk.moe_stats is not None}


class TransformerLM(nn.Module):
    """``model(tokens [B, T]) -> logits [B, T, vocab]`` (float32, causal).

    The JAX constructor's fields, with ``comm`` (the communicator whose
    ranks shard the sequence) for ``axis_name``; with a sequence-parallel
    ``attention_impl`` each rank passes its ``[B, T/P]`` block and
    ``pos_offset=rank * T/P``.  Decode mode (serving): ``pos_offset`` a
    ``[B]`` vector and ``attend(layer, q, k, v)`` per layer.
    ``moe_experts``/``moe_top_k``/``moe_capacity`` with ``moe_comm`` (the
    expert-parallel ranks) and ``tp_size`` with ``tp_comm`` (the
    tensor-parallel ranks) are the module note's extensions; ``moe_plan``
    (a planner all-to-all plan) runs the MoE exchanges through it.
    """

    def __init__(self, vocab: int, d_model: int = 256, n_layers: int = 4,
                 n_heads: int = 8, max_len: int = 8192,
                 attention_impl: str = "xla", *,
                 dtype: torch.dtype = torch.float32,
                 n_kv_heads: Optional[int] = None, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity: Optional[int] = None,
                 moe_comm=None, moe_plan=None, tp_size: int = 1,
                 tp_comm=None, comm=None, device=None,
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
        self.n_layers, self.n_heads, self.max_len = n_layers, n_heads, max_len
        self.n_kv_heads = n_kv_heads
        self.attention_impl = attention_impl
        self.moe_experts, self.moe_top_k = moe_experts, moe_top_k
        self.moe_capacity, self.tp_size = moe_capacity, tp_size
        self.tok_emb = Embed(vocab, d_model, dtype=dtype, device=device,
                             generator=generator)
        self.pos_emb = Embed(max_len, d_model, dtype=dtype, device=device,
                             generator=generator)
        self.blocks = nn.ModuleList([
            Block(d_model, n_heads, attention_impl, dtype, n_kv_heads,
                  moe_experts, tp_size, comm, moe_top_k=moe_top_k,
                  moe_capacity=moe_capacity, moe_comm=moe_comm,
                  moe_plan=moe_plan, tp_comm=tp_comm, device=device,
                  generator=generator)
            for _ in range(n_layers)])
        self.ln_f = LayerNorm(d_model, dtype=dtype, device=device)
        self.head = Dense(d_model, vocab, dtype=dtype, device=device,
                          generator=generator)

    def forward(self, tokens, pos_offset=0, attend=None):
        x = self.tok_emb(tokens)
        off = torch.as_tensor(pos_offset, dtype=torch.int64,
                              device=tokens.device)
        ar = torch.arange(tokens.shape[-1], device=tokens.device)
        positions = off + ar if off.ndim == 0 else off[:, None] + ar[None, :]
        x = x + self.pos_emb(positions)
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if attend is None
                    else functools.partial(attend, i))
        return self.head(self.ln_f(x)).float()


__all__ = ["Block", "Embed", "LayerNorm", "TransformerLM", "collect_moe_stats"]
