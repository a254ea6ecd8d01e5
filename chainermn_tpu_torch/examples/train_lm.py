"""Long-context LM training with sequence parallelism.

Counterpart of ``examples/long_context/train_lm.py``: a decoder-only
:class:`~chainermn_tpu_torch.models.TransformerLM` learns the synthetic
"repeated motif" task (each sequence repeats a short motif with 2% noise,
so a causal LM learns long-range next-token prediction quickly) with Adam.
The model is float32, as the JAX example's.

``--attention ring`` (the default), ``ring_flash`` or ``ulysses`` shard the
sequence over every rank of the world, one rank per GPU under
``torchrun``: rank r holds positions ``r T/P`` onward, each shard also
predicts the next shard's first token (one
:func:`~chainermn_tpu_torch.functions.spmd_send_recv`), the last global
position is masked, and the loss is ``allreduce(sum ce * mask) /
allreduce(sum mask)``, the single-shard objective.  After ``backward()``
each rank holds its share of the gradient, and the shares are summed over
the ranks before the Adam step.  ``--attention flash`` (the CUDA flash
kernels) and ``xla`` (the plain softmax) keep the whole sequence on each
rank and communicate nothing.

    torchrun --nproc_per_node 4 -m chainermn_tpu_torch.examples.train_lm \\
        --attention ring_flash --seq-len 8192
    python -m chainermn_tpu_torch.examples.train_lm --attention flash

``--fsdp`` (with a sequence-parallel attention) adds ZeRO-3 over the same
ranks (:mod:`chainermn_tpu_torch.parallel.fsdp`): the parameters and
Adam's state live as 1/P flat shards, the step gathers them, runs
:func:`sp_loss` on this rank's block, and the reduce-scatter of the
gradients sums the ranks' shares (``global_loss``: no
:func:`sum_gradients`).  At the end the module holds the trained
parameters, gathered.

The flags are the JAX example's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch import functions
from chainermn_tpu_torch.communicators import _packing, create_communicator
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.models.transformer import SEQUENCE_PARALLEL
from chainermn_tpu_torch.parallel.fsdp import (
    fsdp_full_params, fsdp_init, load_module_params, make_fsdp_train_step)


def make_motif_task(n, seq_len, vocab, motif_len=16, seed=0):
    """``[n, seq_len]`` int32 tokens, the JAX example's from the same
    ``RandomState``."""
    rng = np.random.RandomState(seed)
    motifs = (rng.rand(n, motif_len) * vocab).astype(np.int32)
    reps = -(-seq_len // motif_len)
    seqs = np.tile(motifs, (1, reps))[:, :seq_len]
    noise = rng.rand(n, seq_len) < 0.02
    seqs = np.where(noise, (rng.rand(n, seq_len) * vocab).astype(np.int32),
                    seqs)
    return torch.from_numpy(np.ascontiguousarray(seqs))


def lm_loss(model, toks):
    """Mean next-token cross entropy over every position but the last."""
    logits = model(toks)
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           toks[:, 1:].reshape(-1).long())


def sp_loss(model, toks, comm):
    """The JAX example's ``sp_body`` on this rank's block ``toks`` ``[B,
    T/P]`` of a sequence sharded over ``comm``: the global next-token
    objective, which each rank's backward differentiates into its share."""
    n, me = comm.size, comm.rank
    t_local = toks.shape[1]
    logits = model(toks, pos_offset=me * t_local)
    nxt = functions.spmd_send_recv(toks[:, :1], comm,
                                   [(i, (i - 1) % n) for i in range(n)])
    targets = torch.cat([toks[:, 1:], nxt], dim=1)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         targets.reshape(-1).long(),
                         reduction="none").view(targets.shape)
    mask = torch.ones_like(ce)
    if me == n - 1:
        mask[:, -1] = 0.0
    total = functions.allreduce(comm, (ce * mask).sum())
    count = functions.allreduce(comm, mask.sum())
    return total / count


def sum_gradients(model, comm) -> None:
    """Replace each parameter's gradient by its sum over ``comm`` (one
    all-reduce per dtype): the ranks' shares make the one gradient."""
    params = list(model.parameters())
    bufs, meta = _packing.pack([p.grad if p.grad is not None
                                else torch.zeros_like(p) for p in params])
    summed = _packing.unpack([comm.allreduce(b, op="sum") for b in bufs],
                             meta)
    for p, g in zip(params, summed):
        p.grad = g


def train_steps(model, toks, steps: int, lr: float, comm=None,
                on_grads=None, fsdp: bool = False):
    """``steps`` Adam steps (optax's defaults: betas 0.9/0.999, eps 1e-8) on
    the fixed batch ``toks``; yields each step's ``(loss, seconds)`` (a
    step ends in its loss read).  With ``comm`` the sequence is sharded
    over its ranks: ``toks`` is this rank's block, the loss is
    :func:`sp_loss` and the gradients are summed over the ranks.
    ``on_grads(i, model)``, if given, sees step i's gradients before the
    update.  ``fsdp`` (with ``comm``) shards the parameters and Adam's
    state over the ranks (:func:`fsdp_steps`)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    if fsdp:
        yield from fsdp_steps(model, opt, toks, steps, comm, on_grads)
        return
    for i in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model, toks) if comm is None \
            else sp_loss(model, toks, comm)
        loss.backward()
        if comm is not None:
            sum_gradients(model, comm)
        if on_grads is not None:
            on_grads(i, model)
        opt.step()
        loss = float(loss.detach())
        yield loss, time.perf_counter() - t0


def fsdp_steps(model, opt, toks, steps: int, comm, on_grads=None):
    """:func:`train_steps` under ZeRO-3 over ``comm``: ``opt``'s class and
    hyperparameters step the shards, the reduce-scatter sums the ranks'
    shares of the gradient (``global_loss``), and after the last step the
    module holds the gathered parameters (JAX's ``fsdp_full_params``)."""
    if on_grads is not None:
        raise ValueError("on_grads reads the parameters' gradients, which "
                         "--fsdp keeps as reduce-scattered shards")
    state, meta = fsdp_init(comm, model, opt)
    step = make_fsdp_train_step(comm, lambda t: sp_loss(model, t, comm),
                                state, meta, global_loss=True)
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = float(step(toks))
        yield loss, time.perf_counter() - t0
    load_module_params(model, fsdp_full_params(state, meta, comm))


def _log_step(log, i, steps, loss):
    if log and (i % 10 == 0 or i == steps - 1):
        log(f"step {i}: loss {loss:.4f}")


def train(model, toks, steps: int, lr: float, log=print) -> list:
    """:func:`train_steps` on one shard; returns the losses."""
    losses = []
    for i, (loss, _) in enumerate(train_steps(model, toks, steps, lr)):
        losses.append(loss)
        _log_step(log, i, steps, loss)
    return losses


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_tpu_torch long-context "
                                "LM")
    p.add_argument("--attention", default="ring",
                   choices=["ring", "ring_flash", "ulysses", "flash", "xla"])
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batchsize", "-b", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=None,
                   help="GQA/MQA: kv head count (must divide --heads; "
                        "flash/ring_flash read grouped kv natively)")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3 over the sequence-parallel ranks: "
                        "parameters and Adam state sharded, gathered "
                        "inside the step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    args = p.parse_args(argv)
    if args.kv_heads is not None and (
            args.kv_heads < 1 or args.heads % args.kv_heads):
        p.error(f"--kv-heads ({args.kv_heads}) must be >= 1 and divide "
                f"--heads ({args.heads})")
    if args.fsdp and args.attention not in SEQUENCE_PARALLEL:
        p.error("--fsdp composes with the sequence-parallel attentions "
                "(ring/ring_flash/ulysses); single-shard runs have no "
                "axis to shard over")
    return args


def main(argv=None, on_grads=None) -> dict:
    """Train; returns ``{"losses", "seconds", "step_seconds",
    "tokens_per_sec", "world", "peak_memory_gb", "state_memory_gb",
    "model"}``: tokens/sec of the whole sequence over every step, the first
    included (with sequence parallelism, over the ``world`` ranks
    together); each step's seconds; this process's peak device memory and
    its allocation after the last step (None on the CPU); the trained
    module.  ``on_grads`` as in :func:`train_steps`.  Initializes the
    default process group if it is not yet, and then destroys it at the
    end."""
    args = parse_args(argv)
    created = not dist.is_initialized()
    comm = create_communicator("xla", device=args.device)
    try:
        return _run(args, comm, on_grads)
    finally:
        if created:
            dist.destroy_process_group()


def _run(args, comm, on_grads) -> dict:
    device = comm.device
    seq_parallel = args.attention in SEQUENCE_PARALLEL
    n_sp = comm.size if seq_parallel else 1
    if args.seq_len % n_sp:
        raise ValueError(f"--seq-len ({args.seq_len}) must be divisible by "
                         f"{n_sp} ranks")
    t_local = args.seq_len // n_sp
    model = TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_layers=args.layers,
        n_heads=args.heads, n_kv_heads=args.kv_heads, max_len=args.seq_len,
        attention_impl=args.attention, comm=comm if seq_parallel else None,
        device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed))
    toks = make_motif_task(args.batchsize, args.seq_len, args.vocab,
                           seed=args.seed).to(device)
    if seq_parallel:
        comm.bcast_data(model)
        toks = toks[:, comm.rank * t_local:(comm.rank + 1) * t_local]
    if comm.rank == 0:
        print(f"attention={args.attention} devices={n_sp} "
              f"seq={args.seq_len} (local {t_local}) fsdp={args.fsdp} "
              f"device={device}",
              flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log = (lambda m: print(m, flush=True)) if comm.rank == 0 else None
    losses, step_seconds = [], []
    state_gb = None
    t0 = time.perf_counter()
    for i, (loss, sec) in enumerate(train_steps(
            model, toks, args.steps, args.lr,
            comm=comm if seq_parallel else None, on_grads=on_grads,
            fsdp=args.fsdp)):
        losses.append(loss)
        step_seconds.append(sec)
        _log_step(log, i, args.steps, loss)
        if i == args.steps - 1 and device.type == "cuda":
            # what training keeps between steps (under --fsdp, before the
            # module gets the gathered parameters back)
            state_gb = torch.cuda.memory_allocated(device) / 1e9
    seconds = time.perf_counter() - t0  # each step ends in a loss read
    if comm.rank == 0:
        print(f"done in {seconds:.1f}s; final loss {losses[-1]:.4f}",
              flush=True)
    return {"losses": losses, "seconds": seconds,
            "step_seconds": step_seconds,
            "tokens_per_sec": args.batchsize * args.seq_len * args.steps
            / seconds, "world": n_sp,
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None,
            "state_memory_gb": state_gb, "model": model}


if __name__ == "__main__":
    main()
