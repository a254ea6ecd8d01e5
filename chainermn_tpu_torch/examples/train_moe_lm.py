"""Mixture-of-experts LM training with expert parallelism.

Counterpart of ``examples/moe_lm/train_moe_lm.py``: a decoder-only
:class:`~chainermn_tpu_torch.models.TransformerLM` whose MLPs are top-k
routed :class:`~chainermn_tpu_torch.parallel.expert.ExpertParallelMLP`
layers spread over the expert-parallel ranks (tokens travel by all-to-all,
experts stay put), learning the repeated-motif task with Adam.  The loss
adds the load-balancing auxiliary loss, and each step prints the global
expert load and overflow fraction, so a collapsing router shows.

The EP world is ``min(world size, --experts)`` ranks, one a GPU under
``torchrun``; the batch is split over them.  Each rank holds its
``experts / P`` experts; :func:`train_step` sums the gradients of the
replicated parameters over the ranks (each rank's backward gives its
share of the global objective, the JAX example's ``pmean``-ed cross
entropy plus ``aux_weight`` times the summed per-block ``aux_loss``),
while an expert's gradient arrives whole on its owner through the
all-to-all's backward.

    torchrun --nproc_per_node 4 -m chainermn_tpu_torch.examples.train_moe_lm
    python -m chainermn_tpu_torch.examples.train_moe_lm --experts 8 --top-k 2

The flags are the JAX example's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from chainermn_tpu_torch import functions
from chainermn_tpu_torch.communicators import _packing, create_communicator
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.models.transformer import collect_moe_stats
from chainermn_tpu_torch.parallel.expert import expert_parameter_names


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


def parser():
    p = argparse.ArgumentParser(description="chainermn_tpu_torch MoE LM")
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--top-k", type=int, default=2)
    p.add_argument("--aux-weight", type=float, default=1e-2)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--batchsize", "-b", type=int, default=8)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (the default, one card a rank) or cpu")
    return p


def sum_replicated_gradients(model, comm) -> None:
    """Sum the gradients of every parameter but the rank-local experts
    over ``comm`` (one all-reduce a dtype): the ranks' shares make the
    replicated parameters' gradient."""
    local = expert_parameter_names(model)
    params = [p for n, p in model.named_parameters() if n not in local]
    bufs, meta = _packing.pack([p.grad if p.grad is not None
                                else torch.zeros_like(p) for p in params])
    summed = _packing.unpack([comm.allreduce(b, op="sum") for b in bufs],
                             meta)
    for p, g in zip(params, summed):
        p.grad = g


def moe_loss(model, toks, aux_weight: float, comm=None):
    """The JAX example's objective on this rank's tokens: ``(loss, ce,
    aux, overflow, load)``; ``ce`` is the mean over the EP ranks (its
    backward gives this rank's share), ``aux`` the blocks' summed
    ``aux_loss``, ``overflow`` and ``load`` the blocks' means."""
    logits = model(toks)
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                         toks[:, 1:].reshape(-1).long())
    if comm is not None and comm.size > 1:
        ce = functions.allreduce(comm, ce, op="mean")
    stats = collect_moe_stats(model).values()
    aux = sum(s["aux_loss"] for s in stats)
    over = sum(s["overflow_fraction"] for s in stats) / len(stats)
    load = sum(s["expert_load"] for s in stats) / len(stats)
    return ce + aux_weight * aux, ce, aux, over, load


def train_step(model, opt, toks, aux_weight: float, comm=None):
    """One Adam step of :func:`moe_loss` on this rank's ``toks``: backward,
    the replicated parameters' gradients summed over ``comm``, the update.
    Returns the detached ``(loss, ce, aux, overflow, load)``."""
    opt.zero_grad(set_to_none=True)
    out = moe_loss(model, toks, aux_weight, comm)
    out[0].backward()
    if comm is not None and comm.size > 1:
        sum_replicated_gradients(model, comm)
    opt.step()
    return tuple(t.detach() for t in out)


def build(args, comm=None, device=None, attention_impl="xla",
          dtype=torch.float32, capacity=None):
    """The example's model (JAX's configuration; ``attention_impl``,
    ``dtype`` and the experts' ``capacity`` for other callers of
    :func:`train_step`) and its Adam."""
    model = TransformerLM(
        args.vocab, args.d_model, args.layers, args.heads, args.seq_len,
        attention_impl, dtype=dtype, moe_experts=args.experts,
        moe_top_k=args.top_k, moe_capacity=capacity, moe_comm=comm,
        device=device,
        generator=torch.Generator(device).manual_seed(args.seed))
    return model, torch.optim.Adam(model.parameters(), lr=args.lr)


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    import torch.distributed as dist
    from chainermn_tpu_torch.runtime.bootstrap import init_distributed
    created = not dist.is_initialized()
    topo = init_distributed(device=args.device)
    n_ep = min(topo.size, args.experts)
    if args.experts % n_ep:
        p.error(f"--experts must be a multiple of {n_ep} devices")
    if args.batchsize % n_ep:
        p.error(f"--batchsize must be divisible by {n_ep} devices")
    if topo.size > n_ep:
        p.error(f"{topo.size} ranks for {args.experts} experts: run at most "
                f"--experts ranks")
    comm = create_communicator("naive", device=args.device) \
        if n_ep > 1 else None
    device = topo.device
    model, opt = build(args, comm, device)
    toks = make_motif_task(args.batchsize, args.seq_len, args.vocab,
                           seed=args.seed)
    per = args.batchsize // n_ep
    mine = toks[topo.rank * per:(topo.rank + 1) * per].to(device)
    if topo.rank == 0:
        print(f"experts={args.experts} top_k={args.top_k} devices={n_ep} "
              f"backend={device.type}", flush=True)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        _, ce, aux, over, load = train_step(model, opt, mine,
                                            args.aux_weight, comm)
        losses.append(float(ce))
        if topo.rank == 0:
            lo = load.float().cpu().numpy()
            print(f"step {i}: loss {float(ce):.4f} aux {float(aux):.3f} "
                  f"overflow {float(over):.3f} "
                  f"load[min/max] {lo.min():.3f}/{lo.max():.3f}", flush=True)
    if topo.rank == 0:
        print(f"done in {time.time() - t0:.1f}s; final loss {losses[-1]:.4f}",
              flush=True)
    res = {"losses": losses, "model": model, "world": n_ep}
    if created:
        dist.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
