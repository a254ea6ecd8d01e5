"""Gradient accumulation over equal microbatches of the local batch.

Counterpart of ``chainermn_tpu/utils/accum.py``: where JAX scans one
microbatch's forward/backward K times, this runs it K times in a loop.
The gradients sum in each parameter's ``.grad`` (the first backward stores
``g1``, each later one adds its own, as JAX's ``0 + g1 + g2 ...``), then are
divided by K once; the loss and aux sum in float32 and are divided by K
once too.  Modules with state (the BatchNorm running buffers) update after
each microbatch in turn: JAX's ghost-batch semantics.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _slice(batch, i: int, n: int):
    if isinstance(batch, torch.Tensor):
        return batch[i * n:(i + 1) * n]
    return type(batch)(_slice(v, i, n) for v in batch)


def split_microbatches(batch, accum_steps: int) -> list:
    """``batch`` (a tensor, or a tuple or list of them, one leading axis)
    as ``accum_steps`` equal microbatches of consecutive rows, as JAX's
    ``reshape((K, b / K) + ...)``; raises ``ValueError`` when K does not
    divide the batch."""
    first = batch
    while not isinstance(first, torch.Tensor):
        first = first[0]
    b = first.shape[0]
    if b % accum_steps:
        raise ValueError(
            f"accum_steps ({accum_steps}) must divide the per-device batch "
            f"({b})")
    n = b // accum_steps
    return [_slice(batch, i, n) for i in range(accum_steps)]


def accumulate_microbatches(loss_fn: Callable, batch, accum_steps: int,
                            has_aux: bool, params,
                            after_backward: Optional[Callable] = None):
    """Run ``loss_fn`` forward and backward on each microbatch of
    ``batch``; leaves the MEAN gradient in each of ``params``' ``.grad``
    and returns ``(loss, aux)``, both averaged over the microbatches (aux
    None without ``has_aux``).  The gradients must be clear on entry.
    ``after_backward()``, if given, runs after each microbatch's backward
    (FSDP adds the microbatch's reduce-scattered gradients there)."""
    loss_sum = aux_sum = None
    for mb in split_microbatches(batch, accum_steps):
        out = loss_fn(mb)
        loss, aux = out if has_aux else (out, None)
        try:
            loss.backward()
        finally:
            if after_backward is not None:
                after_backward()
        part = loss.detach().float()
        loss_sum = part if loss_sum is None else loss_sum + part
        if has_aux:
            aux = {k: v.detach() for k, v in aux.items()}
            aux_sum = aux if aux_sum is None else {
                k: aux_sum[k] + v for k, v in aux.items()}
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.div_(accum_steps)
    if has_aux:
        aux_sum = {k: v / accum_steps for k, v in aux_sum.items()}
    return loss_sum / accum_steps, aux_sum


__all__ = ["accumulate_microbatches", "split_microbatches"]
