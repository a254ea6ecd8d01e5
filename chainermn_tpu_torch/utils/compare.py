"""The float32 training-step comparison the on-card checks share.

Two runs of one step (or of a few) from the same weights and data agree
when every loss is within ``LOSS_RTOL`` relative of the reference's and
every gradient tensor within a relative L2 error of ``GRAD_RTOL``.  Float32
with TF32 off: the two runs differ only by the order of their sums.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|`` in float32 (``want`` 0: over 1e-30)."""
    got, want = got.float(), want.to(got.device).float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def step_errors(losses: Sequence[float], want_losses: Sequence[float],
                grads: Dict[str, torch.Tensor],
                want_grads: Dict[str, torch.Tensor]
                ) -> Tuple[float, float, str]:
    """``(loss_rel, grad_rel, worst)``: the largest relative error over the
    losses, the largest relative L2 error over the gradient tensors of
    ``want_grads`` and that tensor's name."""
    if len(losses) != len(want_losses) or set(grads) != set(want_grads):
        raise ValueError("the runs differ in their steps or parameters")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    grad_rel, worst = max((rel_l2(grads[k], g), k)
                          for k, g in want_grads.items())
    return loss_rel, grad_rel, worst


def step_agrees(loss_rel: float, grad_rel: float) -> bool:
    """Both errors within their limits (a NaN never is)."""
    return loss_rel <= LOSS_RTOL and grad_rel <= GRAD_RTOL


__all__ = ["GRAD_RTOL", "LOSS_RTOL", "rel_l2", "step_agrees", "step_errors"]
