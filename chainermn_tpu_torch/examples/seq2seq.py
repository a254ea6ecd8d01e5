"""Model-parallel seq2seq NMT training.

Counterpart of ``examples/seq2seq/seq2seq.py`` (the reference's seq2seq
example, BASELINE config "seq2seq NMT model-parallel"): the encoder is
stage 0 and the decoder stage 1 of a
:class:`~chainermn_tpu_torch.links.MultiNodeChainList`; the LSTM carry
crosses the boundary and one backward a process spans both stages.  On one
GPU both stages run in one process (the in-process channel); under
``torchrun`` on two or more, the encoder runs on rank 0 and the decoder on
rank 1, the carry goes forward over NCCL and its cotangent comes back.
Ragged sentences become padded length buckets with explicit lengths and a
masked loss; the held-out pass reports masked token accuracy and greedy
BLEU.

    # synthetic copy-reverse corpus (the default; no download)
    python -m chainermn_tpu_torch.examples.seq2seq --epoch 5
    torchrun --nproc_per_node 2 -m chainermn_tpu_torch.examples.seq2seq
    python -m chainermn_tpu_torch.examples.seq2seq --device cpu --epoch 1
    # a real corpus: one whitespace-tokenized sentence per line
    python -m chainermn_tpu_torch.examples.seq2seq --src train.src \\
        --tgt train.tgt --val-src dev.src --val-tgt dev.tgt

The flags are the JAX example's, plus ``--device``.  The model is float32
with Adam 2e-3 through the per-stage optimizer, as in JAX; the stages'
weights come from CPU generators seeded ``1000 seed + stage``, so a run on
one GPU and one on two start from the same weights.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.datasets.nmt import (
    BOS_ID, Vocab, bleu, bucket_batches, encode_pairs, load_corpus)
from chainermn_tpu_torch.links import MultiNodeChainList, pseudo_loss
from chainermn_tpu_torch.models.seq2seq import Seq2SeqDecoder, Seq2SeqEncoder
from chainermn_tpu_torch.optimizers import create_per_stage_optimizer

# Object-plane tag of the held-out carry transfer: above the tags that
# cross-process chain lists pack (32 instances << 15).
CARRY_TAG = 33 << 15


def synthetic_pairs(n, max_len, vocab, seed=0):
    """Copy-reverse pairs as token sentences of varying lengths (the JAX
    example's, from the same ``RandomState``)."""
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        length = rng.randint(4, max_len + 1)
        toks = [f"w{rng.randint(vocab)}" for _ in range(length)]
        pairs.append((toks, toks[::-1]))
    return pairs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_tpu_torch seq2seq "
                                "example")
    p.add_argument("--src", default=None, help="train source corpus "
                   "(one whitespace-tokenized sentence per line)")
    p.add_argument("--tgt", default=None, help="train target corpus")
    p.add_argument("--val-src", default=None, help="held-out source")
    p.add_argument("--val-tgt", default=None, help="held-out target")
    p.add_argument("--val-frac", type=float, default=0.05,
                   help="held-out split when no --val-src given")
    p.add_argument("--max-vocab", type=int, default=40000)
    p.add_argument("--max-len", type=int, default=48,
                   help="skip training pairs longer than this")
    p.add_argument("--bucket-step", type=int, default=4,
                   help="length-bucket granularity")
    p.add_argument("--batchsize", "-b", type=int, default=128)
    p.add_argument("--epoch", "-e", type=int, default=5)
    p.add_argument("--vocab", type=int, default=32,
                   help="symbol count for the synthetic default task")
    p.add_argument("--seq-len", type=int, default=12,
                   help="max length for the synthetic default task")
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--n-train", type=int, default=4096,
                   help="pair count for the synthetic default task")
    p.add_argument("--communicator", default="xla")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    args = p.parse_args(argv)
    if args.epoch < 1:
        p.error("--epoch must be >= 1")
    if (args.src is None) != (args.tgt is None):
        p.error("--src and --tgt must be given together")
    if (args.val_src is None) != (args.val_tgt is None):
        p.error("--val-src and --val-tgt must be given together")
    return args


def load_data(args):
    """``(train, val, src_vocab, tgt_vocab)``: encoded pairs and the
    vocabularies built from the training side."""
    if args.src is not None:
        train_pairs = load_corpus(args.src, args.tgt, max_len=args.max_len)
        if args.val_src is not None:
            val_pairs = load_corpus(args.val_src, args.val_tgt,
                                    max_len=args.max_len)
        else:
            n_val = max(1, int(len(train_pairs) * args.val_frac))
            val_pairs, train_pairs = (train_pairs[:n_val],
                                      train_pairs[n_val:])
    else:
        pairs = synthetic_pairs(args.n_train, args.seq_len, args.vocab,
                                seed=args.seed)
        n_val = max(1, int(len(pairs) * args.val_frac))
        val_pairs, train_pairs = pairs[:n_val], pairs[n_val:]
    src_vocab = Vocab.build((s for s, _ in train_pairs), args.max_vocab)
    tgt_vocab = Vocab.build((t for _, t in train_pairs), args.max_vocab)
    return (encode_pairs(train_pairs, src_vocab, tgt_vocab),
            encode_pairs(val_pairs, src_vocab, tgt_vocab), src_vocab,
            tgt_vocab)


def build_model(comm, n_src: int, n_tgt: int, embed_dim: int, hidden: int,
                seed: int = 0) -> MultiNodeChainList:
    """The two-stage chain; each stage built (on its rank only) from a CPU
    generator seeded ``1000 seed + stage``, then moved to the device."""
    def stage(cls, vocab, s):
        gen = torch.Generator().manual_seed(1000 * seed + s)
        return cls(vocab, embed_dim, hidden, generator=gen).to(comm.device)

    model = MultiNodeChainList(comm)
    # the encoder's carry (at each sentence's last real token) goes to
    # stage 1
    model.add_link(functools.partial(stage, Seq2SeqEncoder, n_src, 0),
                   rank_in=None, rank_out=1)
    model.add_link(functools.partial(stage, Seq2SeqDecoder, n_tgt, 1),
                   rank_in=0, rank_out=None)
    return model


def batch_tensors(batch, device) -> dict:
    """A batch's arrays as tensors on ``device``; ``src_len`` stays on the
    CPU (the encoder's packing reads it there)."""
    out = {k: torch.from_numpy(batch[k]).to(device).long()
           for k in ("src", "tgt_in", "tgt_out")}
    out["mask"] = torch.from_numpy(batch["mask"]).to(device)
    out["src_len"] = torch.from_numpy(batch["src_len"]).long()
    return out


def masked_loss(logits, tb):
    """``(loss, token accuracy)`` of the decoder's ``logits``, both masked
    means over the real target tokens (the JAX example's ``loss_fn``)."""
    mask, tgt = tb["mask"], tb["tgt_out"]
    ce = F.cross_entropy(logits.flatten(0, 1), tgt.flatten(),
                         reduction="none").view_as(mask)
    denom = mask.sum().clamp_min(1.0)
    loss = (ce * mask).sum() / denom
    acc = ((logits.argmax(-1) == tgt) * mask).sum() / denom
    return loss, acc


def loss_fn(model, tb):
    """:func:`masked_loss` of the chain's output; ``(pseudo_loss, None)``
    on a rank without the exit stage."""
    out = model(tb["src"], stage_inputs={0: (tb["src_len"],),
                                         1: (tb["tgt_in"],)})
    if not model.owns_output:
        return pseudo_loss(out), None
    return masked_loss(out, tb)


def train_steps(model, optimizer, batches):
    """One optimizer step a batch; yields ``{"loss", "acc", "tokens",
    "seconds"}`` of each (a step ends in its loss read; ``loss`` and
    ``acc`` are 0.0 on a rank without the exit stage; ``tokens`` are the
    batch's real target tokens)."""
    for batch in batches:
        t0 = time.perf_counter()
        tb = batch_tensors(batch, model.device)
        optimizer.zero_grad()
        loss, acc = loss_fn(model, tb)
        loss.backward()
        optimizer.step()
        loss = float(loss.detach())
        yield {"loss": loss, "acc": 0.0 if acc is None else float(acc),
               "tokens": int(batch["mask"].sum()),
               "seconds": time.perf_counter() - t0}


@torch.no_grad()
def evaluate(model, comm, val, args, tgt_vocab) -> dict:
    """Held-out masked loss and token accuracy (forward only) and greedy
    BLEU; the carry reaches the decoder's rank once a batch over the object
    plane under ``CARRY_TAG``.  Real numbers on the exit stage's owner."""
    va_loss = va_acc = 0.0
    nv = 0
    hyps, refs = [], []
    enc_owner, dec_owner = model.stage_owner(0), model.stage_owner(1)
    for batch in bucket_batches(val, args.batchsize, step=args.bucket_step,
                                shuffle=False, drop_remainder=False):
        tb = batch_tensors(batch, model.device)
        loss, acc = loss_fn(model, tb)
        if model.owns_output:
            va_loss += float(loss)
            va_acc += float(acc)
            nv += 1
        carry = None
        if model.is_local_stage(0):
            carry = model.stage(0)(tb["src"], tb["src_len"])
            if dec_owner != enc_owner:
                comm.send_obj([t.cpu() for t in carry], dec_owner,
                              tag=CARRY_TAG)
        if model.is_local_stage(1):
            if dec_owner != enc_owner:
                carry = comm.recv_obj(enc_owner, tag=CARRY_TAG)
            carry = model.place_activation(tuple(carry), 1)
            toks = model.stage(1).decode(carry, batch["tgt_out"].shape[1],
                                         bos_id=BOS_ID)
            toks = toks.cpu().numpy()[:batch["n_real"]]
            for h_ids, r_ids in zip(toks,
                                    batch["tgt_out"][:batch["n_real"]]):
                hyps.append(tgt_vocab.decode(h_ids))
                refs.append(tgt_vocab.decode(r_ids))
    if dec_owner != enc_owner:
        # the encoder's rank returns once every carry sent has arrived (a
        # send still in flight is lost when its process tears down)
        comm.barrier()
    result = {"val_loss": round(va_loss / max(nv, 1), 4),
              "val_token_accuracy": round(va_acc / max(nv, 1), 4)}
    if hyps:
        result["val_bleu"] = round(bleu(hyps, refs), 4)
    return result


def main(argv=None) -> dict:
    """Train and evaluate; returns ``{"losses", "accs", "step_seconds",
    "log", "final", "tokens_per_sec", "steady_tokens_per_sec",
    "peak_memory_gb", "world", "owns_output"}``: every step's loss and
    accuracy (0.0 on a rank without the exit stage), one record an epoch,
    the held-out result (None on a rank without the exit stage), real
    target tokens a second over every step and over the steps after the
    first (which pays the first transfers' set-up), and this process's peak
    device memory (None on the CPU).  Initializes the default process
    group if it is not yet, and then destroys it at the end."""
    args = parse_args(argv)
    created = not dist.is_initialized()
    comm = create_communicator(args.communicator, device=args.device)
    try:
        return _run(args, comm)
    finally:
        if created:
            dist.destroy_process_group()


def _run(args, comm) -> dict:
    train, val, src_vocab, tgt_vocab = load_data(args)
    if next(bucket_batches(train, args.batchsize, step=args.bucket_step,
                           shuffle=False), None) is None:
        raise SystemExit(
            "no length bucket holds a full batch: lower --batchsize, "
            "raise --bucket-step, or add data")
    model = build_model(comm, len(src_vocab), len(tgt_vocab), args.embed_dim,
                        args.hidden, args.seed)
    if comm.rank == 0:
        print(f"corpus: {len(train)} train / {len(val)} val pairs, "
              f"vocab {len(src_vocab)} src / {len(tgt_vocab)} tgt; "
              f"ranks: {comm.size}, stage owners "
              f"{[model.stage_owner(s) for s in range(2)]}, device "
              f"{comm.device}", flush=True)
    opt = create_per_stage_optimizer(
        functools.partial(torch.optim.Adam, lr=2e-3))
    opt.init(model)
    device = comm.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    steps, log = [], []
    for epoch in range(args.epoch):
        t0 = time.perf_counter()
        ep = list(train_steps(model, opt, bucket_batches(
            train, args.batchsize, step=args.bucket_step, shuffle=True,
            seed=args.seed + epoch)))
        dt = time.perf_counter() - t0
        steps += ep
        rec = {"epoch": epoch + 1,
               "loss": sum(s["loss"] for s in ep) / len(ep),
               "token_accuracy": sum(s["acc"] for s in ep) / len(ep),
               "tokens_per_sec": sum(s["tokens"] for s in ep) / dt,
               "seconds": dt}
        log.append(rec)
        if model.owns_output:
            print(f"epoch {epoch + 1}: loss {rec['loss']:.4f} token-acc "
                  f"{rec['token_accuracy']:.4f} "
                  f"({rec['tokens_per_sec']:.0f} tok/s, {dt:.1f}s)",
                  flush=True)
    result = evaluate(model, comm, val, args, tgt_vocab)
    if model.owns_output:
        print(f"final: {result}", flush=True)
    secs = [s["seconds"] for s in steps]
    toks = [s["tokens"] for s in steps]
    return {"losses": [s["loss"] for s in steps],
            "accs": [s["acc"] for s in steps], "step_seconds": secs,
            "log": log, "final": result if model.owns_output else None,
            "tokens_per_sec": sum(toks) / sum(secs),
            "steady_tokens_per_sec": (sum(toks[1:]) / sum(secs[1:])
                                      if len(secs) > 1 else None),
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None,
            "world": comm.size, "owns_output": model.owns_output}


if __name__ == "__main__":
    main()
