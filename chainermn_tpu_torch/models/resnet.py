"""ResNet family over the fused BatchNorm(+ReLU) normalization boundary.

Counterpart of ``chainermn_tpu/models/resnet.py``.  The modules take NCHW
tensors and run them in ``torch.channels_last`` memory, so that every
BatchNorm sees a free ``[R, C]`` view.  What is kept from the JAX model:

* flax's ``"SAME"`` padding: ``total // 2`` before and the rest after.  At
  stride 2 on an even input that is asymmetric (stem 7x7/s2 on 224 pads
  (2, 3); each 3x3/s2 pads (0, 1); the 3x3/s2 max pool pads (0, 1) with
  -inf), which ``nn.Conv2d(padding=k // 2)`` would shift;
* ``dtype``: parameters stay float32 and are cast for the conv and the
  dense layer; the norm outputs ``dtype`` with float32 math inside;
* the norm layers: momentum 0.9, epsilon 1e-5, the last BN of each block
  zero-initialised and without ReLU, the projection BN without ReLU, and
  every other BN with its ReLU fused when ``norm_cls`` supports it.

Initialisation draws from an explicit ``torch.Generator``: conv and dense
weights from flax's ``lecun_normal`` (truncated normal, fan-in), dense bias
zero.  Weights of a flax model come over with :mod:`..weights`.

``stem="s2d"`` is JAX's space-to-depth stem: :func:`space_to_depth` in
JAX's channel order ``(bh, bw, c)``, then a 4x4/s1 "SAME" conv over 12
channels (padded (1, 2), as XLA pads it), so a flax ``conv_init`` kernel
``[4, 4, 12, C]`` maps as any other conv.  ``remat_policy`` is JAX's
(:data:`REMAT_POLICIES`): ``"block"`` recomputes each residual block in
the backward pass (``torch.utils.checkpoint``), ``"norm"`` keeps the
block's convolution outputs and recomputes only the norm/ReLU tail (a
selective checkpoint whose policy saves the convolutions).  A recomputed
forward leaves the BatchNorm running buffers alone, as flax's ``nn.remat``
drops the recomputed state: they move once a step under every policy.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as tcp
from torch import nn

from chainermn_tpu_torch.ops.fused_norm import FusedBatchNormAct
from chainermn_tpu_torch.parallel.topology import resolve_device

#: the remat policies, as JAX's ``models.resnet.REMAT_POLICIES``
REMAT_POLICIES = ("none", "block", "norm")
STEMS = ("conv7", "s2d")
# what the "norm" policy keeps: the convolutions' outputs (the norms'
# inputs, JAX's ``checkpoint_name(x, "norm_in")``)
_CONV_OPS = (torch.ops.aten.convolution.default,
             torch.ops.aten._convolution.default)

# stddev of a standard normal truncated to [-2, 2] (flax's lecun_normal
# divides by it so the truncated draw keeps variance 1 / fan_in)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def _same_pads(n: int, k: int, s: int):
    """flax/XLA "SAME" padding of one spatial axis: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution with flax "SAME" padding, computed in ``dtype`` from
    float32 weights (OIHW); bias-free unless ``bias`` (flax's ``use_bias``,
    zero-initialised)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 *, bias: bool = False, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(
            (out_ch, in_ch, kernel, kernel), dtype=torch.float32,
            device=device))
        _lecun_normal_(self.weight, in_ch * kernel * kernel, generator)
        self.bias = nn.Parameter(torch.zeros(
            (out_ch,), dtype=torch.float32, device=device)) if bias else None

    def forward(self, x):
        k, s = self.kernel, self.stride
        ph = _same_pads(x.shape[2], k, s)
        pw = _same_pads(x.shape[3], k, s)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        stride=s, padding=pad)


def space_to_depth(x, block: int = 2):
    """JAX's ``space_to_depth`` on an NCHW tensor: ``[N, C, H, W]`` ->
    ``[N, b * b * C, H / b, W / b]`` with channel ``(bh * b + bw) * C + c``
    (JAX's NHWC order ``(bh, bw, c)``; ``F.pixel_unshuffle`` would give
    ``(c, bh, bw)``)."""
    n, c, h, w = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {block}")
    x = x.reshape(n, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, block * block * c, h // block, w // block)


def _save_convs(ctx, op, *args, **kwargs):
    return (tcp.CheckpointPolicy.MUST_SAVE if op in _CONV_OPS
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def _recompute_frozen(block):
    """``block`` for a checkpoint: its first call (the forward) runs as it
    is, every later one (the recompute in the backward pass) with its
    norms' ``update_stats`` off."""
    norms = [m for m in block.modules() if getattr(m, "update_stats", False)]
    calls = [0]

    def run(x):
        calls[0] += 1
        if calls[0] == 1:
            return block(x)
        for m in norms:
            m.update_stats = False
        try:
            return block(x)
        finally:
            for m in norms:
                m.update_stats = True

    return run


def remat(block, x, policy: str):
    """``block(x)`` under ``policy`` (see the module note)."""
    if policy == "none" or not torch.is_grad_enabled():
        return block(x)
    kw = {}
    if policy == "norm":
        kw["context_fn"] = partial(tcp.create_selective_checkpoint_contexts,
                                   _save_convs)
    return tcp.checkpoint(_recompute_frozen(block), x, use_reentrant=False,
                          **kw)


def flatten_nhwc(x):
    """``[N, C, H, W]`` -> ``[N, H * W * C]`` in flax's (NHWC) order, so
    the first dense layer after it takes flax's kernel rows as they are."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def max_pool_same(x, k: int = 3, s: int = 2):
    """flax ``max_pool(x, (k, k), (s, s), padding="SAME")``: -inf padding."""
    ph = _same_pads(x.shape[2], k, s)
    pw = _same_pads(x.shape[3], k, s)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def _norm_relu(norm, features: int, **kwargs):
    """A norm layer followed by ReLU, fused into it when the norm class
    supports it (``supports_fused_relu``); otherwise norm then ReLU."""
    cls = norm.func if isinstance(norm, partial) else norm
    if getattr(cls, "supports_fused_relu", False):
        return norm(features, fuse_relu=True, **kwargs)
    return nn.Sequential(norm(features, **kwargs), nn.ReLU())


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with projection shortcut on shape
    change (the stride sits on the 3x3 conv)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, conv, norm, stride: int = 1):
        super().__init__()
        out_ch = filters * 4
        self.conv0 = conv(in_ch, filters, 1)
        self.norm0 = _norm_relu(norm, filters)
        self.conv1 = conv(filters, filters, 3, stride)
        self.norm1 = _norm_relu(norm, filters)
        self.conv2 = conv(filters, out_ch, 1)
        # zero-init γ: each block starts as identity; ReLU after the add
        self.norm2 = norm(out_ch, scale_init=0.0)
        self.proj = in_ch != out_ch or stride != 1
        if self.proj:
            self.conv_proj = conv(in_ch, out_ch, 1, stride)
            self.norm_proj = norm(out_ch)

    def forward(self, x):
        y = self.norm0(self.conv0(x))
        y = self.norm1(self.conv1(y))
        y = self.norm2(self.conv2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, conv, norm, stride: int = 1):
        super().__init__()
        self.conv0 = conv(in_ch, filters, 3, stride)
        self.norm0 = _norm_relu(norm, filters)
        self.conv1 = conv(filters, filters, 3)
        self.norm1 = norm(filters, scale_init=0.0)
        self.proj = in_ch != filters or stride != 1
        if self.proj:
            self.conv_proj = conv(in_ch, filters, 1, stride)
            self.norm_proj = norm(filters)

    def forward(self, x):
        y = self.norm0(self.conv0(x))
        y = self.norm1(self.conv1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(residual + y)


class Dense(nn.Module):
    """``x @ weight.T + bias`` computed in ``dtype`` from float32
    parameters (weight ``[out, in]``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            (out_features, in_features), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            (out_features,), dtype=torch.float32, device=device))
        _lecun_normal_(self.weight, in_features, generator)

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ResNet(nn.Module):
    """Generic ResNet over NCHW inputs (``torch.channels_last`` inside).

    Train or eval mode follows ``self.training``: in train mode every
    BatchNorm normalizes with this rank's batch statistics and updates its
    running buffers, which stay rank-local (the reference's local BN).
    ``norm_cls`` defaults to :class:`FusedBatchNormAct`; any class taking
    ``(features, *, momentum, epsilon, dtype, scale_init, device)`` fits.
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls=BottleneckBlock,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32, momentum: float = 0.9,
                 norm_cls=None, stem: str = "conv7",
                 remat_policy: str = "none", in_channels: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(
                f"unknown stem {stem!r}: expected 'conv7' or 's2d'")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {remat_policy!r}: "
                f"expected one of {REMAT_POLICIES}")
        device = resolve_device(device)
        self.dtype, self.stem, self.remat_policy = dtype, stem, remat_policy
        conv = partial(Conv, dtype=dtype, device=device, generator=generator)
        norm = partial(norm_cls or FusedBatchNormAct, momentum=momentum,
                       epsilon=1e-5, dtype=dtype, device=device)
        # s2d: the 7x7/s2 stem as a 4x4/s1 conv over the (H/2, W/2, 12) view
        self.conv_init = (conv(4 * in_channels, num_filters, 4)
                          if stem == "s2d" else
                          conv(in_channels, num_filters, 7, 2))
        self.bn_init = _norm_relu(norm, num_filters)
        blocks, ch = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                blocks.append(block_cls(ch, filters, conv, norm, stride))
                ch = filters * block_cls.expansion
        self.blocks = nn.Sequential(*blocks)
        self.dense = Dense(ch, num_classes, dtype=dtype, device=device,
                           generator=generator)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.bn_init(self.conv_init(x))
        x = max_pool_same(x)
        for block in self.blocks:
            x = remat(block, x, self.remat_policy)
        return self.dense(x.mean(dim=(2, 3))).float()


ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock)
