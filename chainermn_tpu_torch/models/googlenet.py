"""GoogLeNet (Inception v1) and its BatchNorm variant.

Counterpart of ``chainermn_tpu/models/googlenet.py``: a 7x7/2 stem (flax
``"SAME"``: pads (2, 3) on 224 pixels), 1x1 and 3x3 convolutions, 3x3/2
``"SAME"`` max pools (pads (0, 1) with -inf), nine inception blocks whose
towers are concatenated in the order 1x1, 3x3, 5x5, pool projection, the
global mean, dropout and the classifier.  ``GoogLeNetBN`` puts BatchNorm
(momentum 0.9, epsilon 1e-5) and ReLU after every convolution, drops the
conv biases and factorizes the 5x5 tower into two 3x3 convolutions: 3 + 9
x 7 = 66 BatchNorm+ReLU boundaries, which run on
:class:`FusedBatchNormAct` with the ReLU fused by default.

With ``aux_heads=True`` the auxiliary classifiers after 4a and 4d are
built, and in training the model returns ``(logits, (aux4a, aux4d))``
(the reference recipe trains ``loss3 + 0.3 loss1 + 0.3 loss2``).  An aux
head is a 5x5/3 VALID average pool (window clamped to the map), a 1x1
convolution to 128 channels with bias and ReLU, dense 1024 with ReLU,
dropout 0.7 and the classifier; flax infers its dense width at init,
here ``image_size`` gives it.

NCHW inputs in ``torch.channels_last`` memory; parameters float32,
computed in ``dtype``.  flax names (:mod:`..weights`): the stem's
``Conv_j``/``BatchNorm_j`` are ``convs.j``/``norms.j``, block
``inc{name}``'s are ``blocks.inc{name}.convs.j``/``.norms.j``, the heads'
``aux{name}`` ``Conv_0``/``Dense_0``/``Dense_1`` are
``aux.aux{name}.conv``/``.fc``/``.classifier``, and ``Dense_0`` is
``classifier``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models.layers import Dropout
from chainermn_tpu_torch.models.resnet import (
    Conv, Dense, _norm_relu, flatten_nhwc, max_pool_same)
from chainermn_tpu_torch.ops.fused_norm import FusedBatchNormAct
from chainermn_tpu_torch.parallel.topology import resolve_device

# (c1, c3r, c3, c5r, c5, cp) per inception block, Szegedy et al. table 1
BLOCKS = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}
AUX_AFTER = ("4a", "4d")


class _Units(nn.Module):
    """Convolutions, each followed by BatchNorm+ReLU (``norm`` given) or
    by ReLU; ``unit(j, x)`` runs the j-th."""

    def __init__(self, specs, conv, norm):
        super().__init__()
        self.convs = nn.ModuleList([conv(i, o, k, s, bias=norm is None)
                                    for i, o, k, s in specs])
        self.norms = None if norm is None else nn.ModuleList(
            [_norm_relu(norm, o) for _, o, _, _ in specs])

    def unit(self, j: int, x):
        x = self.convs[j](x)
        return F.relu(x) if self.norms is None else self.norms[j](x)


class InceptionBlock(_Units):
    """Parallel 1x1 / 3x3 / 5x5 / pool-projection towers, concatenated
    along the channels."""

    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, cp, conv, norm=None):
        t5 = ([(in_ch, c5r, 1, 1), (c5r, c5, 3, 1), (c5, c5, 3, 1)]
              if norm is not None else [(in_ch, c5r, 1, 1), (c5r, c5, 5, 1)])
        super().__init__([(in_ch, c1, 1, 1), (in_ch, c3r, 1, 1),
                          (c3r, c3, 3, 1)] + t5 + [(in_ch, cp, 1, 1)],
                         conv, norm)
        self.out_channels = c1 + c3 + c5 + cp

    def forward(self, x):
        u, n = self.unit, len(self.convs)
        t1 = u(0, x)
        t3 = u(2, u(1, x))
        t5 = u(3, x)
        for j in range(4, n - 1):
            t5 = u(j, t5)
        tp = u(n - 1, max_pool_same(x, 3, 1))
        return torch.cat([t1, t3, t5, tp], dim=1)


def aux_features(size: int) -> int:
    """Flattened width of an aux head's 1x1 convolution on a ``size``
    square map: the 5x5/3 VALID pool, its window clamped to the map."""
    out = (size - min(5, size)) // 3 + 1
    return out * out * 128


class AuxHead(nn.Module):
    """Auxiliary classifier (Szegedy et al. section 5) on a ``size``
    square map of ``in_ch`` channels."""

    def __init__(self, in_ch: int, num_classes: int, size: int, *, dtype,
                 device, generator, dropout_generator):
        super().__init__()
        self.conv = Conv(in_ch, 128, 1, bias=True, dtype=dtype,
                         device=device, generator=generator)
        dense = partial(Dense, dtype=dtype, device=device, generator=generator)
        self.fc = dense(aux_features(size), 1024)
        self.dropout = Dropout(0.7, dropout_generator)
        self.classifier = dense(1024, num_classes)

    def forward(self, x):
        x = F.avg_pool2d(x, (min(5, x.shape[2]), min(5, x.shape[3])), 3)
        x = flatten_nhwc(F.relu(self.conv(x)))
        x = self.dropout(F.relu(self.fc(x)))
        return self.classifier(x).float()


class GoogLeNet(_Units):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, use_bn: bool = False,
                 dropout_rate: float = 0.4, aux_heads: bool = False,
                 momentum: float = 0.9, norm_cls=None,
                 image_size: int = 224, in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        conv = partial(Conv, dtype=dtype, device=device, generator=generator)
        norm = partial(norm_cls or FusedBatchNormAct, momentum=momentum,
                       epsilon=1e-5, dtype=dtype, device=device) \
            if use_bn else None
        super().__init__([(in_channels, 64, 7, 2), (64, 64, 1, 1),
                          (64, 192, 3, 1)], conv, norm)
        self.dtype = dtype
        self.aux_heads = aux_heads
        self.dropout_generator = torch.Generator(device=device)
        blocks, ch = {}, 192
        for name, spec in BLOCKS.items():
            blocks[f"inc{name}"] = InceptionBlock(ch, *spec, conv, norm)
            ch = blocks[f"inc{name}"].out_channels
        self.blocks = nn.ModuleDict(blocks)
        if aux_heads:
            size = -(-image_size // 16)  # the stem's stride 2, three pools
            self.aux = nn.ModuleDict({
                f"aux{name}": AuxHead(
                    self.blocks[f"inc{name}"].out_channels, num_classes,
                    size, dtype=dtype, device=device, generator=generator,
                    dropout_generator=self.dropout_generator)
                for name in AUX_AFTER})
        self.dropout = Dropout(dropout_rate, self.dropout_generator)
        self.classifier = Dense(ch, num_classes, dtype=dtype, device=device,
                                generator=generator)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = max_pool_same(self.unit(0, x))
        x = max_pool_same(self.unit(2, self.unit(1, x)))
        aux = []
        for name, block in self.blocks.items():
            if name in ("inc4a", "inc5a"):
                x = max_pool_same(x)
            x = block(x)
            if self.aux_heads and self.training and \
                    name[3:] in AUX_AFTER:
                aux.append(self.aux[f"aux{name[3:]}"](x))
        x = self.dropout(x.mean(dim=(2, 3)))
        logits = self.classifier(x).float()
        return (logits, tuple(aux)) if aux else logits


GoogLeNetBN = partial(GoogLeNet, use_bn=True)
