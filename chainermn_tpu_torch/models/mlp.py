"""MLP — the reference MNIST example's model.

Counterpart of ``chainermn_tpu/models/mlp.py`` (the reference's
784-1000-1000-10 ReLU MLP of ``examples/mnist/train_mnist.py``): three
dense layers ``l1``, ``l2``, ``l3`` (flax's ``Dense_0``, ``Dense_1``,
``Dense_2``; ``weights.py`` maps one onto the other), weights drawn as
flax's default ``lecun_normal`` with zero biases.  flax infers the input
width at init; here it is ``n_in``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models.resnet import Dense
from chainermn_tpu_torch.parallel.topology import resolve_device


class MLP(nn.Module):
    def __init__(self, n_units: int = 1000, n_out: int = 10, n_in: int = 784,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        dense = lambda i, o: Dense(i, o, device=device,  # noqa: E731
                                   generator=generator)
        self.l1 = dense(n_in, n_units)
        self.l2 = dense(n_units, n_units)
        self.l3 = dense(n_units, n_out)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).float()
        x = F.relu(self.l1(x))
        x = F.relu(self.l2(x))
        return self.l3(x)
