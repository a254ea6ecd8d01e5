"""Micro-batch pipeline parallelism: GPipe and 1F1B over homogeneous stages.

Counterpart of ``chainermn_tpu/parallel/pipeline.py`` (a beyond-reference
extension there too).  The batch is split into M micro-batches that flow
through S stages; stage s runs on rank s of a communicator (one process a
stage, where JAX runs one device a stage of a ``shard_map``), holds stage
s's parameters (JAX holds slice ``[s]`` of a stacked ``[S, ...]`` tree) and
gets back its own stage's gradients.  ``stage_fn(params, a) -> a`` is one
stage in JAX's functional form (``params`` a dict of tensors; for an
``nn.Module`` stage, :func:`module_stage_fn` wraps
``torch.func.functional_call``); every stage runs the same function and
must keep the activation's shape and dtype (JAX's homogeneous stages), or
the schedule raises.

* :func:`pipeline_apply` is GPipe: stage s runs micro-batch i at tick
  ``s + i`` (S + M - 1 ticks) and ships its output one hop forward with
  :func:`~chainermn_tpu_torch.functions.spmd_send_recv`, so the backward
  is autograd through that chain (each transfer's backward ships the
  cotangent one hop back).  ``collect="all_gather"`` gives every rank the
  last stage's outputs; its backward hands the last stage ONE copy of the
  cotangent (its own rank's), as JAX's replicated ``out_specs`` does, and
  the other ranks' copies only start their transfers' backward.
  ``collect="last"``: the outputs on the last stage, zeros elsewhere.
* :func:`pipeline_1f1b` is the 1F1B schedule over M + 2S - 1 ticks
  without autograd across ranks: at tick t stage s runs the forward of
  micro-batch ``i = t - s`` without a graph, keeping the stage INPUT in a
  ring of 2S slots, and the backward of ``j = t - S - (S - 1 - s)``: it
  recomputes the stage from the kept input under ``torch.enable_grad()``,
  folds ``loss_fn(y, target_j)`` into the same pull on the last stage (the
  cotangent received from stage s + 1 elsewhere), accumulates the
  parameter gradients and ships d(input) one hop back.  Its stored state
  is O(S) micro-batches, independent of M.  The tick's two transfers go
  opposite ways (activations to s + 1, cotangents to s - 1) and go out as
  one ``batch_isend_irecv``, so no issue order can deadlock.  The mean loss
  over micro-batches is summed over the ranks (JAX's scalar ``psum``), and
  the gradients are divided by M.

Differences from JAX: each rank knows the schedule, so bubble ticks are
skipped -- the stage's work and the transfers on both ends -- where JAX's
lockstep program computes them and masks them out; outputs and gradients
are the same.  A communicator takes the place of the mesh and axis name.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.functions import spmd_send_recv


def module_stage_fn(module: torch.nn.Module) -> Callable:
    """``stage_fn(params, a)`` running ``module`` with ``params`` (a dict
    of its parameters by name) in place of its own
    (``torch.func.functional_call``)."""
    def stage_fn(params, a):
        return torch.func.functional_call(module, params, (a,))
    return stage_fn


def _run_stage(stage_fn, params, a):
    y = stage_fn(params, a)
    if y.shape != a.shape or y.dtype != a.dtype:
        raise ValueError(
            f"a pipeline stage must keep the activation's shape and dtype "
            f"(homogeneous stages): got {tuple(y.shape)} {y.dtype} from "
            f"{tuple(a.shape)} {a.dtype}")
    return y


class _Collect(torch.autograd.Function):
    """GPipe's collect.  Forward: the last stage's stacked outputs (its
    inputs on that rank), to every rank (``all_gather``) or kept there
    (``last``, zeros elsewhere).  Backward: the last stage takes its own
    cotangent, one copy; on the other ranks each input is a tie -- the
    zeros its forward transfers returned -- and gets a zero cotangent,
    which starts those transfers' backward (receiving the cotangents
    stage s + 1 sends)."""

    @staticmethod
    def forward(ctx, comm, broadcast, shape, dtype, *xs):
        last = comm.rank == comm.size - 1
        ctx.last, ctx.n = last, len(xs)
        if last:
            out = torch.stack(xs)
        elif broadcast:
            out = torch.empty(shape, dtype=dtype, device=xs[0].device)
        else:
            out = torch.zeros(shape, dtype=dtype, device=xs[0].device)
        if broadcast and comm.size > 1:
            dist.broadcast(out, src=comm._global_rank(comm.size - 1),
                           group=comm.group)
        ctx.tie_shape = None if last else xs[0].shape
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.last:
            grads = tuple(g.unbind(0))
        else:
            z = g.new_zeros(ctx.tie_shape)
            grads = (z,) * ctx.n
        return (None, None, None, None) + grads


def pipeline_apply(stage_fn: Callable, stage_params, x, comm, *,
                   collect: str = "all_gather"):
    """GPipe over the ranks of ``comm`` (rank s runs stage s).

    ``stage_params``: this rank's stage parameters; ``x``: the micro-batch
    stack ``[M, mb, ...]``, the same on every rank (only stage 0 reads
    it); ``stage_fn(params, activation) -> activation``.  Returns the last
    stage's outputs ``[M, mb, ...]`` on every rank (``collect=
    "all_gather"``) or on the last rank with zeros elsewhere
    (``"last"``).  Differentiable: a loss on the result, backward on every
    rank, gives each rank its stage's parameter gradients.  Every rank of
    ``comm`` must call it."""
    if collect not in ("all_gather", "last"):
        raise ValueError(f"collect must be 'all_gather' or 'last', "
                         f"got {collect!r}")
    s, n = comm.rank, comm.size
    m = int(x.shape[0])
    shape, dtype, dev = tuple(x.shape[1:]), x.dtype, x.device
    # the receiving end's placeholder: a leaf that requires grad, so the
    # received activation carries the transfer's backward
    ph = torch.zeros((), dtype=dtype, device=dev, requires_grad=True)
    outs, ties = [], []
    for i in range(m):  # stage s runs micro-batch i at tick s + i
        if s == 0:
            a = x[i]
        else:
            a = spmd_send_recv(ph.expand(shape), comm, [(s - 1, s)])
        y = _run_stage(stage_fn, stage_params, a)
        if s < n - 1:
            ties.append(spmd_send_recv(y, comm, [(s, s + 1)]))
        else:
            outs.append(y)
    return _Collect.apply(comm, collect == "all_gather", (m,) + shape,
                          dtype, *(outs if s == n - 1 else ties))


def _exchange(comm, sends, recvs):
    """One ``batch_isend_irecv`` of ``sends`` ``[(tensor, peer)]`` and
    ``recvs`` ``[(buffer, peer)]`` (peers are ranks of ``comm``),
    waited for."""
    ops = [dist.P2POp(dist.isend, t, comm._global_rank(p), group=comm.group)
           for t, p in sends]
    ops += [dist.P2POp(dist.irecv, t, comm._global_rank(p), group=comm.group)
            for t, p in recvs]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()


def pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, stage_params, x,
                  targets, comm):
    """The 1F1B schedule (see the module note): ``(mean_loss,
    stage_grads)``.

    ``stage_params``: this rank's stage parameters (a dict, list or
    tuple of tensors); ``x``: ``[M, mb, ...]`` and ``targets``: ``[M,
    ...]``, the same on every rank; ``loss_fn(y, target) -> scalar``, the
    per-micro-batch loss, on the last stage.  Returns the mean loss over
    the micro-batches on every rank and this rank's gradients of it, in
    ``stage_params``' structure.  Every rank of ``comm`` must call it."""
    s, n = comm.rank, comm.size
    m = int(x.shape[0])
    if int(targets.shape[0]) != m:
        raise ValueError(f"targets leading dim {targets.shape[0]} != "
                         f"microbatch count {m}")
    leaves, treedef = _packing.tree_flatten(stage_params)
    # the recompute differentiates with respect to these (views of the
    # caller's tensors, whether or not they require grad)
    leaves = [p.detach().requires_grad_() for p in leaves]
    gacc = [torch.zeros_like(p) for p in leaves]
    lacc = torch.zeros((), dtype=torch.float32, device=x.device)
    buf = 2 * n  # the in-flight bound of the schedule
    ring: dict = {}
    shape = tuple(x.shape[1:])
    fwd_act = bwd_cot = None
    last = s == n - 1

    def f_valid(t, stage):
        return 0 <= t - stage < m

    def b_valid(t, stage):
        return 0 <= t - n - (n - 1 - stage) < m

    for t in range(m + 2 * n - 1):
        sends = []
        # ---- forward slot: micro-batch i = t - s ----
        if f_valid(t, s):
            i = t - s
            inp = x[i] if s == 0 else fwd_act
            with torch.no_grad():
                y = _run_stage(stage_fn, stage_params, inp)
            ring[i % buf] = inp
            if not last:
                sends.append((y, s + 1))
        # ---- backward slot: micro-batch j, S ticks behind the forward
        # wave, reflected through the last stage ----
        if b_valid(t, s):
            j = t - n - (n - 1 - s)
            a = ring.pop(j % buf).detach().requires_grad_()
            with torch.enable_grad():
                y = _run_stage(stage_fn,
                               _packing.tree_unflatten(treedef, leaves), a)
                if last:
                    lj = loss_fn(y, targets[j]).to(torch.float32)
                    grads = torch.autograd.grad(lj, leaves + [a],
                                                allow_unused=True)
                    lacc = lacc + lj.detach()
                else:
                    grads = torch.autograd.grad(y, leaves + [a],
                                                grad_outputs=bwd_cot,
                                                allow_unused=True)
            for acc, g in zip(gacc, grads[:-1]):
                if g is not None:
                    acc += g
            if s > 0:
                sends.append((grads[-1], s - 1))
        # ---- the tick's transfers, both ways in one batch ----
        recvs = []
        fwd_act = bwd_cot = None
        if s > 0 and f_valid(t, s - 1):
            fwd_act = torch.empty(shape, dtype=x.dtype, device=x.device)
            recvs.append((fwd_act, s - 1))
        if not last and b_valid(t, s + 1):
            bwd_cot = torch.empty(shape, dtype=x.dtype, device=x.device)
            recvs.append((bwd_cot, s + 1))
        _exchange(comm, [(t_.contiguous(), p) for t_, p in sends], recvs)
    grads = _packing.tree_unflatten(treedef, [g / m for g in gacc])
    # the loss lives on the last stage, zeros elsewhere: JAX's scalar psum
    loss = comm.allreduce(lacc / m, "sum") if n > 1 else lacc / m
    return loss, grads


def _split(batch, m: int):
    if batch.shape[0] % m:
        raise ValueError(f"batch of {batch.shape[0]} is not divisible by "
                         f"n_microbatches={m}")
    return batch.reshape((m, -1) + tuple(batch.shape[1:]))


def make_pipeline_train_fn(stage_fn: Callable, loss_fn: Callable, comm, *,
                           n_microbatches: int):
    """The 1F1B training step: ``fn(stage_params, batch, targets) ->
    (loss, stage_grads)``, ``batch``/``targets`` ``[B, ...]`` global
    arrays (the same on every rank) with B divisible by
    ``n_microbatches``; the gradients are this rank's stage's, ready for
    its optimizer."""
    def fn(stage_params, batch, targets):
        return pipeline_1f1b(stage_fn, loss_fn, stage_params,
                             _split(batch, n_microbatches),
                             _split(targets, n_microbatches), comm)
    return fn


def make_pipeline_fn(stage_fn: Callable, comm, *, n_microbatches: int):
    """GPipe as a function: ``fn(stage_params, batch) -> out``, ``batch``
    ``[B, ...]`` (B divisible by ``n_microbatches``, the same on every
    rank), ``out`` the last stage's result ``[B, ...]`` on every rank
    (the all-gather collect); differentiable."""
    def fn(stage_params, batch):
        out = pipeline_apply(stage_fn, stage_params,
                             _split(batch, n_microbatches), comm)
        return out.reshape((-1,) + tuple(out.shape[2:]))
    return fn


__all__ = ["make_pipeline_fn", "make_pipeline_train_fn", "module_stage_fn",
           "pipeline_1f1b", "pipeline_apply"]
