"""AlexNet, one of the reference ImageNet example's architectures.

Counterpart of ``chainermn_tpu/models/alexnet.py``: five convolutions with
bias and flax ``"SAME"`` padding (the 11x11/4 stem pads (3, 4) on 224
pixels), local response normalization after the first two, 3x3/2 VALID
max pools, and three dense layers with dropout between them.  No
BatchNorm.  NCHW inputs in ``torch.channels_last`` memory; parameters
float32, computed in ``dtype``.

flax infers the first dense layer's width at init (6 x 6 x 256 = 9216 at
224 pixels); here ``image_size`` gives it, and the features are flattened
in flax's NHWC order.  flax ``Conv_i`` is ``convs.i`` and ``Dense_i``
``dense.i`` (:mod:`..weights`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models.layers import Dropout
from chainermn_tpu_torch.models.resnet import Conv, Dense, flatten_nhwc
from chainermn_tpu_torch.parallel.topology import resolve_device


def local_response_normalization(x, n: int = 5, k: float = 2.0,
                                 alpha: float = 1e-4, beta: float = 0.75):
    """Krizhevsky's LRN over the channels of ``[N, C, H, W]``, as the JAX
    package computes it: float32, ``x / (k + alpha * sum of the n
    neighbouring squares) ** beta`` (a sum, where
    ``F.local_response_norm`` averages), cast back to ``x``'s dtype."""
    x32 = x.float()
    sq = x32 * x32
    c, half = x.shape[1], n // 2
    pad = F.pad(sq, (0, 0, 0, 0, half, half))
    window = sum(pad[:, i:i + c] for i in range(n))
    return (x32 / (k + alpha * window) ** beta).to(x.dtype)


def _valid_pool(n: int, k: int = 3, s: int = 2) -> int:
    return (n - k) // s + 1


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.5, image_size: int = 224,
                 in_channels: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        conv = partial(Conv, bias=True, dtype=dtype, device=device,
                       generator=generator)
        self.convs = nn.ModuleList([
            conv(in_channels, 96, 11, 4), conv(96, 256, 5),
            conv(256, 384, 3), conv(384, 384, 3), conv(384, 256, 3)])
        s = -(-image_size // 4)
        for _ in range(3):
            s = _valid_pool(s)
        dense = partial(Dense, dtype=dtype, device=device, generator=generator)
        self.dense = nn.ModuleList([dense(s * s * 256, 4096),
                                    dense(4096, 4096),
                                    dense(4096, num_classes)])
        self.dropout_generator = torch.Generator(device=device)
        self.dropout = Dropout(dropout_rate, self.dropout_generator)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        c = self.convs
        x = F.max_pool2d(local_response_normalization(F.relu(c[0](x))), 3, 2)
        x = F.max_pool2d(local_response_normalization(F.relu(c[1](x))), 3, 2)
        x = F.relu(c[4](F.relu(c[3](F.relu(c[2](x))))))
        x = flatten_nhwc(F.max_pool2d(x, 3, 2))
        x = self.dropout(F.relu(self.dense[0](x)))
        x = self.dropout(F.relu(self.dense[1](x)))
        return self.dense[2](x).float()
