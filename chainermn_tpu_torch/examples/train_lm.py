"""Long-context LM training on one GPU (one shard of the sequence).

Counterpart of ``examples/long_context/train_lm.py``'s single-shard path: a
decoder-only :class:`~chainermn_tpu_torch.models.TransformerLM` learns the
synthetic "repeated motif" task (each sequence repeats a short motif with
2% noise, so a causal LM learns long-range next-token prediction quickly)
with Adam, attention through the CUDA flash kernels (``--attention
flash``) or the plain softmax (``--attention xla``).  The model is float32,
as the JAX example's.

    python -m chainermn_tpu_torch.examples.train_lm --attention flash

The flags are the JAX example's, plus ``--device``.  The sequence-parallel
attentions (``ring``, ``ring_flash``, ``ulysses``) and ``--fsdp`` are not
ported (ROADMAP.md Queue A9) and raise; the default ``--attention`` is
therefore ``flash`` (the JAX example's is ``ring``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.parallel.topology import resolve_device


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


def train(model, toks, steps: int, lr: float, log=print) -> list:
    """``steps`` Adam steps (optax's defaults: betas 0.9/0.999, eps 1e-8) on
    the fixed batch ``toks``; returns the losses."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model, toks)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if log and (i % 10 == 0 or i == steps - 1):
            log(f"step {i}: loss {losses[-1]:.4f}")
    return losses


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_tpu_torch long-context "
                                "LM (single shard)")
    p.add_argument("--attention", default="flash",
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
                        "flash reads grouped kv natively)")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--fsdp", action="store_true",
                   help="not ported yet (ROADMAP.md Queue A9)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    args = p.parse_args(argv)
    if args.kv_heads is not None and (
            args.kv_heads < 1 or args.heads % args.kv_heads):
        p.error(f"--kv-heads ({args.kv_heads}) must be >= 1 and divide "
                f"--heads ({args.heads})")
    if args.fsdp and args.attention not in ("ring", "ring_flash",
                                            "ulysses"):
        p.error("--fsdp composes with the sequence-parallel attentions "
                "(ring/ring_flash/ulysses); single-shard runs have no "
                "axis to shard over")
    return args


def main(argv=None) -> dict:
    """Train; returns ``{"losses": [...], "seconds": s,
    "tokens_per_sec": rate}`` (over every step, the first included)."""
    args = parse_args(argv)
    if args.attention in ("ring", "ring_flash", "ulysses") or args.fsdp:
        raise NotImplementedError(
            f"--attention {args.attention}"
            f"{' --fsdp' if args.fsdp else ''} (sequence parallelism) is not "
            "ported yet; see ROADMAP.md Queue A9")
    device = resolve_device(args.device)
    model = TransformerLM(
        vocab=args.vocab, d_model=args.d_model, n_layers=args.layers,
        n_heads=args.heads, n_kv_heads=args.kv_heads, max_len=args.seq_len,
        attention_impl=args.attention, device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed))
    toks = make_motif_task(args.batchsize, args.seq_len, args.vocab,
                           seed=args.seed).to(device)
    print(f"attention={args.attention} devices=1 seq={args.seq_len} "
          f"device={device}", flush=True)
    t0 = time.perf_counter()
    losses = train(model, toks, args.steps, args.lr,
                   log=lambda m: print(m, flush=True))
    seconds = time.perf_counter() - t0  # each step ends in a loss read
    print(f"done in {seconds:.1f}s; final loss {losses[-1]:.4f}", flush=True)
    return {"losses": losses, "seconds": seconds,
            "tokens_per_sec": args.batchsize * args.seq_len * args.steps
            / seconds}


if __name__ == "__main__":
    main()
