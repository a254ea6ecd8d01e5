"""VGG-16, the reference's CIFAR-scale convnet.

Counterpart of ``chainermn_tpu/models/vgg.py`` (BASELINE config
"VGG-16 / CIFAR-10 with double-buffered allreduce optimizer"): 3x3
bias-free convolutions with flax ``"SAME"`` padding, each followed by
BatchNorm (momentum 0.9, epsilon 1e-5) and ReLU, 2x2/2 max pools at the
``"M"`` marks, then a ``hidden`` dense layer, ReLU, dropout and the
classifier.  NCHW inputs in ``torch.channels_last`` memory, as
:mod:`.resnet`.

The JAX model computes ``relu(BatchNorm(x))``, which is the fused
kernels' function: ``norm_cls`` defaults to :class:`FusedBatchNormAct`
with the ReLU fused, so the 13 boundaries of VGG-16 run the BatchNorm
kernels on a card (``ReferenceBatchNormAct`` is the plain yardstick).
flax infers the first dense layer's width at init; here ``image_size``
gives it, and the features are flattened in flax's NHWC order.  Weights
of a flax model come over with :mod:`..weights` (``Conv_i`` ->
``convs.i``, ``BatchNorm_i`` -> ``norms.i``, ``Dense_0`` -> ``fc``,
``Dense_1`` -> ``classifier``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models.layers import Dropout
from chainermn_tpu_torch.models.resnet import (
    Conv, Dense, _norm_relu, flatten_nhwc)
from chainermn_tpu_torch.ops.fused_norm import FusedBatchNormAct
from chainermn_tpu_torch.parallel.topology import resolve_device

# the standard VGG-16 plan ("D"); "M" = 2x2/2 max pool
CFG_16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")


class VGG(nn.Module):
    """VGG over NCHW inputs of ``image_size`` pixels (train or eval mode
    follows ``self.training``; BatchNorm statistics stay rank-local)."""

    def __init__(self, cfg: Sequence = CFG_16, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, hidden: int = 512,
                 dropout_rate: float = 0.5, momentum: float = 0.9,
                 norm_cls=None, image_size: int = 32, in_channels: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.cfg = tuple(cfg)
        conv = partial(Conv, dtype=dtype, device=device, generator=generator)
        norm = partial(norm_cls or FusedBatchNormAct, momentum=momentum,
                       epsilon=1e-5, dtype=dtype, device=device)
        convs, norms = [], []
        ch, size = in_channels, image_size
        for c in self.cfg:
            if c == "M":
                size //= 2
            else:
                convs.append(conv(ch, c, 3))
                norms.append(_norm_relu(norm, c))
                ch = c
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        dense = partial(Dense, dtype=dtype, device=device, generator=generator)
        self.fc = dense(size * size * ch, hidden)
        self.dropout_generator = torch.Generator(device=device)
        self.dropout = Dropout(dropout_rate, self.dropout_generator)
        self.classifier = dense(hidden, num_classes)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        layers = iter(zip(self.convs, self.norms))
        for c in self.cfg:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                conv, norm = next(layers)
                x = norm(conv(x))
        x = F.relu(self.fc(flatten_nhwc(x)))
        return self.classifier(self.dropout(x)).float()


VGG16 = VGG
