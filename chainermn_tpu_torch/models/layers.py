"""Dropout with masks from an explicit generator.

flax's ``nn.Dropout`` draws its mask from the ``dropout`` RNG stream that
the caller passes to ``apply``; the JAX examples fold the step and the
device index into it.  ``F.dropout`` takes no generator, so the models of
this package that drop units hold one ``torch.Generator`` on their device
(``model.dropout_generator``), shared by their :class:`Dropout` layers, and
the examples reseed it before every step with :func:`dropout_seed` of
(seed, iteration, rank).  The masks are not JAX's: parity with the flax
models holds with the rate at 0, or in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn


def dropout_seed(seed: int, iteration: int, rank: int) -> int:
    """The generator seed of one step on one rank: every (seed, iteration,
    rank) its own masks, and a resumed run the uninterrupted one's."""
    return ((seed * 1_000_003 + iteration) * 1_009 + rank) % (1 << 63)


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training, each element is kept with
    probability ``1 - rate`` and the kept ones are divided by it; identity
    in eval mode or at rate 0.  Masks come from ``generator``."""

    def __init__(self, rate: float, generator: torch.Generator):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = torch.empty(x.shape, device=x.device).bernoulli_(
            keep, generator=self.generator)
        return torch.where(mask.bool(), x / keep, x.new_zeros(()))


__all__ = ["Dropout", "dropout_seed"]
