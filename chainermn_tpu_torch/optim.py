"""The optax rules the ImageNet example uses that ``torch.optim`` lacks, and
the optimizer-state helpers of checkpoint/resume.

* :class:`LARS` follows ``optax.lars(lr, momentum=0.9)`` step for step:
  decayed weights (``g + wd * p``), the layer-wise trust ratio
  ``tc * |p| / (|u| + eps)`` (1 where either norm is 0), the scale by
  ``-lr``, then the momentum trace ``t = u + momentum * t`` and ``p += t``.
  The trace holds lr-scaled updates, so a changing lr acts as optax's does
  (unlike ``torch.optim.SGD``, whose buffer holds gradients).
* :func:`warmup_cosine_decay_schedule` is optax's, evaluated in float32 as
  optax evaluates it.  The example sets each ``param_group["lr"]`` to
  ``schedule(updates so far)`` before each step, as optax's
  ``scale_by_schedule`` reads its update count.
* :func:`optimizer_state_tree`, :func:`load_optimizer_state_tree` and
  :func:`init_optimizer_state`: a ``torch.optim`` state as a tree of
  tensors for the multi-node checkpointer.  A torch optimizer creates its
  state at its first step, where optax creates it at ``init``; a resume
  target needs it, so :func:`init_optimizer_state` takes one step with zero
  gradients and lr 0 before restoring (what ``torch.distributed.checkpoint``
  does), which the restore then overwrites.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


class LARS(torch.optim.Optimizer):
    """``optax.lars`` as a ``torch.optim`` optimizer (its defaults:
    ``weight_decay`` 0, ``trust_coefficient`` 0.001, ``eps`` 0,
    ``momentum`` 0.9; optax's Nesterov variant is not ported)."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 trust_coefficient: float = 0.001, eps: float = 0.0,
                 momentum: float = 0.9):
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay,
            trust_coefficient=trust_coefficient, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("LARS.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad + group["weight_decay"] * p
                pn = torch.linalg.vector_norm(p)
                un = torch.linalg.vector_norm(u)
                ratio = group["trust_coefficient"] * pn / (un + group["eps"])
                ratio = torch.where((pn == 0) | (un == 0),
                                    torch.ones_like(ratio), ratio)
                u = u * ratio * -group["lr"]
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                t = state["trace"]
                t.copy_(u + group["momentum"] * t)
                p.add_(t)
        return None


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps`` updates, then cosine decay to
    ``end_value`` at ``decay_steps`` (which counts the warmup).  Returns
    ``schedule(count) -> float``, computed in float32 with optax's order of
    operations."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def warm(count):
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count):
        c = f32(min(float(count), cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c
                                            / f32(cos_steps)))
        decayed = f32(1 - alpha) * decay ** f32(exponent) + f32(alpha)
        return f32(peak_value) * decayed

    def schedule(count: int) -> float:
        out = warm(count) if count < warmup_steps else \
            cosine(count - warmup_steps)
        return float(out)

    return schedule


def optimizer_state_tree(optimizer) -> dict:
    """``{"<param index>": {"<state key>": tensor}}`` of a ``torch.optim``
    optimizer's state (a scalar such as SGD's absent momentum buffer is
    left out; python numbers become 0-d tensors)."""
    out = {}
    for i, st in optimizer.state_dict()["state"].items():
        leaves = {k: v if torch.is_tensor(v) else torch.tensor(v)
                  for k, v in st.items() if v is not None}
        if leaves:
            out[str(i)] = leaves
    return out


def load_optimizer_state_tree(optimizer, tree: dict) -> None:
    """Restore :func:`optimizer_state_tree` output (the hyperparameters
    stay the live optimizer's)."""
    sd = optimizer.state_dict()
    sd["state"] = {int(i): dict(st) for i, st in tree.items()}
    optimizer.load_state_dict(sd)


def init_optimizer_state(optimizer) -> None:
    """Create the state a first step would create, changing no parameter:
    one step with zero gradients at lr 0 (gradients and lr restored)."""
    saved = []
    for g in optimizer.param_groups:
        saved.append(g["lr"])
        g["lr"] = 0.0
    grads = {}
    for g in optimizer.param_groups:
        for p in g["params"]:
            grads[p] = p.grad
            p.grad = torch.zeros_like(p)
    try:
        optimizer.step()
    finally:
        for g, lr in zip(optimizer.param_groups, saved):
            g["lr"] = lr
        for p, gr in grads.items():
            p.grad = gr


__all__ = ["LARS", "init_optimizer_state", "load_optimizer_state_tree",
           "optimizer_state_tree", "warmup_cosine_decay_schedule"]
