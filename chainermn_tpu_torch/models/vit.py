"""Vision Transformer: the image classifier made of large products.

Counterpart of ``chainermn_tpu/models/vit.py`` (a beyond-reference
extension there too): patchify with a stride-``patch`` convolution, prepend
a learned [CLS] token (or mean-pool with ``pooling="gap"``), add learned
position embeddings, run pre-LN encoder blocks (non-causal self-attention
and a GELU MLP), and classify from the final LayerNorm'd [CLS] row.  The
modules take NCHW images like the port's other image models.

What is kept from flax, which ``torch.nn``'s defaults would change (the
pieces are :mod:`.transformer`'s): ``nn.gelu`` is the tanh approximation,
``nn.LayerNorm``'s epsilon is 1e-6 with float32 statistics, ``Dense`` and
the patch convolution compute in ``dtype`` from float32 parameters, and the
logits are float32.  The patch convolution is "VALID" with a bias, the
[CLS] token starts at zero, the position embeddings from a normal of
stddev 0.02; the dense kernels and the patch kernel from flax's
``lecun_normal``, every bias at zero.

``attention_impl``: ``"xla"`` (the default) is the plain softmax of
:func:`chainermn_tpu_torch.parallel.sequence.attention`; ``"flash"`` is
:func:`chainermn_tpu_torch.ops.flash_attention` with ``causal=False``, the
CUDA kernels on the card (q, k and v are views of the one qkv
projection).  Dropout draws its masks from the model's
``dropout_generator`` (:mod:`.layers`).  Weights of a flax ViT come over
with :mod:`..weights`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models.layers import Dropout
from chainermn_tpu_torch.models.resnet import Conv
from chainermn_tpu_torch.models.transformer import Dense, LayerNorm
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.parallel.sequence import attention
from chainermn_tpu_torch.parallel.topology import resolve_device


def _encoder_attention(impl: str, q, k, v):
    if impl == "flash":
        return flash_attention(q, k, v, causal=False)
    if impl == "xla":
        return attention(q, k, v, causal=False)
    raise ValueError(f"attention_impl must be xla|flash, got {impl!r}")


class EncoderBlock(nn.Module):
    """Pre-LN non-causal encoder block: ``x + drop(proj(attn(ln_attn(x))))``,
    then ``x + drop(down(drop(gelu(up(ln_mlp(x))))))``."""

    def __init__(self, d_model: int, n_heads: int, mlp_ratio: int = 4,
                 attention_impl: str = "xla", dropout: float = 0.0,
                 dtype=torch.float32, *, device=None, generator=None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if attention_impl not in ("xla", "flash"):
            raise ValueError(
                f"attention_impl must be xla|flash, got {attention_impl!r}")
        self.n_heads, self.impl = n_heads, attention_impl
        dense = lambda i, o: Dense(i, o, dtype=dtype, device=device,  # noqa
                                   generator=generator)
        self.ln_attn = LayerNorm(d_model, dtype=dtype, device=device)
        self.qkv = dense(d_model, 3 * d_model)
        self.proj = dense(d_model, d_model)
        self.ln_mlp = LayerNorm(d_model, dtype=dtype, device=device)
        self.up = dense(d_model, mlp_ratio * d_model)
        self.down = dense(mlp_ratio * d_model, d_model)
        self.drop = Dropout(dropout, dropout_generator)

    def forward(self, x):
        d_model = x.shape[-1]
        h = self.ln_attn(x)
        q, k, v = self.qkv(h).split(d_model, dim=-1)
        shape = h.shape[:-1] + (self.n_heads, d_model // self.n_heads)
        out = _encoder_attention(self.impl, q.reshape(shape),
                                 k.reshape(shape), v.reshape(shape))
        x = x + self.drop(self.proj(out.reshape(h.shape)))
        h = F.gelu(self.up(self.ln_mlp(x)), approximate="tanh")
        return x + self.drop(self.down(self.drop(h)))


class ViT(nn.Module):
    """``model(images[B, 3, H, W]) -> logits[B, num_classes]`` (float32);
    train or eval mode (dropout) follows ``self.training``.  No BatchNorm
    state: LayerNorm throughout.  ``image_size`` sizes the position
    embeddings (flax takes it from the first input)."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 d_model: int = 768, n_layers: int = 12, n_heads: int = 12,
                 mlp_ratio: int = 4, pooling: str = "cls",
                 attention_impl: str = "xla", dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, image_size: int = 224,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(
                f"n_heads ({n_heads}) must divide d_model ({d_model})")
        self._check_image(image_size, image_size, patch)
        if pooling not in ("cls", "gap"):
            raise ValueError(f"pooling must be cls|gap, got {pooling!r}")
        device = resolve_device(device)
        self.patch, self.d_model, self.pooling = patch, d_model, pooling
        self.dtype = dtype
        self.dropout_generator = torch.Generator(device=device)
        self.patch_embed = Conv(3, d_model, patch, patch, bias=True,
                                dtype=dtype, device=device,
                                generator=generator)
        tokens = (image_size // patch) ** 2
        if pooling == "cls":
            self.cls_token = nn.Parameter(torch.zeros(
                (1, 1, d_model), dtype=torch.float32, device=device))
            tokens += 1
        self.pos_embed = nn.Parameter(torch.empty(
            (1, tokens, d_model), dtype=torch.float32, device=device))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.drop = Dropout(dropout, self.dropout_generator)
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, n_heads, mlp_ratio, attention_impl, dropout,
                         dtype, device=device, generator=generator,
                         dropout_generator=self.dropout_generator)
            for _ in range(n_layers))
        self.ln_f = LayerNorm(d_model, dtype=dtype, device=device)
        self.head = Dense(d_model, num_classes, dtype=dtype, device=device,
                          generator=generator)

    @staticmethod
    def _check_image(h: int, w: int, patch: int) -> None:
        if h % patch or w % patch:
            raise ValueError(
                f"image size {h}x{w} must be a multiple of the patch size "
                f"({patch})")

    def forward(self, x):
        self._check_image(x.shape[2], x.shape[3], self.patch)
        # patchify: one stride-`patch` conv == a linear map of each patch;
        # tokens in flax's (row, column) order
        x = self.patch_embed(x.to(self.dtype))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)
        if self.pooling == "cls":
            cls = self.cls_token.expand(b, 1, self.d_model).to(self.dtype)
            x = torch.cat([cls, x], dim=1)
        x = self.drop(x + self.pos_embed.to(self.dtype))
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        x = x[:, 0] if self.pooling == "cls" else x.mean(dim=1)
        return self.head(x).float()


def ViT_S16(**kw) -> ViT:
    """ViT-Small/16: 384 wide, 12 layers, 6 heads (~22M parameters)."""
    kw.setdefault("d_model", 384)
    kw.setdefault("n_layers", 12)
    kw.setdefault("n_heads", 6)
    return ViT(**kw)


def ViT_B16(**kw) -> ViT:
    """ViT-Base/16: 768 wide, 12 layers, 12 heads (~86M parameters)."""
    return ViT(**kw)


__all__ = ["EncoderBlock", "ViT", "ViT_B16", "ViT_S16"]
