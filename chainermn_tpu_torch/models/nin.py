"""Network-in-Network, one of the reference ImageNet example's
architectures.

Counterpart of ``chainermn_tpu/models/nin.py``: four "mlpconv" stacks (a
spatial convolution, then two 1x1 convolutions, all with bias, ReLU and
flax ``"SAME"`` padding), 3x3/2 VALID max pools between them, dropout
before the last stack and the global mean over ``num_classes`` maps in
place of a dense head.  No BatchNorm.  NCHW inputs in
``torch.channels_last`` memory; flax ``Conv_i`` is ``convs.i``
(:mod:`..weights`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models.layers import Dropout
from chainermn_tpu_torch.models.resnet import Conv
from chainermn_tpu_torch.parallel.topology import resolve_device


class NIN(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.5, in_channels: int = 3,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        conv = partial(Conv, bias=True, dtype=dtype, device=device,
                       generator=generator)
        convs, ch = [], in_channels
        for f, k, s in ((96, 11, 4), (256, 5, 1), (384, 3, 1),
                        (num_classes, 3, 1)):
            convs += [conv(ch, f, k, s), conv(f, f, 1), conv(f, f, 1)]
            ch = f
        self.convs = nn.ModuleList(convs)
        self.dropout_generator = torch.Generator(device=device)
        self.dropout = Dropout(dropout_rate, self.dropout_generator)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        # the stride-4 stem and three stride-2 valid pools leave no map
        # below 48 pixels: fail as the JAX model does
        if min(x.shape[2], x.shape[3]) < 48:
            raise ValueError(
                f"NIN needs inputs of at least 48x48 (got "
                f"{x.shape[2]}x{x.shape[3]}); smaller images collapse to "
                "an empty feature map under its stride-4 stem + three "
                "pools and the global average becomes NaN")
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        for i in range(4):
            if i == 3:
                x = self.dropout(x)
            for conv in self.convs[3 * i:3 * i + 3]:
                x = F.relu(conv(x))
            if i < 3:
                x = F.max_pool2d(x, 3, 2)
        return x.mean(dim=(2, 3)).float()
