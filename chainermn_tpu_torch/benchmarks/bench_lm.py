"""Transformer-LM training throughput: tokens/s through the whole stack.

Counterpart of ``benchmarks/bench_lm.py``.  Beside :mod:`.bench`
(ResNet-50) and :mod:`.bench_vit` (ViT-B/16) this one times the LM family
the long-context machinery exists for: ``TransformerLM`` with the CUDA
flash kernels, bf16 compute, the bf16 gradient wire (the cast kernel),
the double-buffered optimizer; the same ``create_communicator("xla")`` ->
``create_multi_node_optimizer`` (SGD 1e-3, momentum 0.9) ->
``make_train_step`` path as JAX's.

Prints ONE JSON line with JAX's keys (``metric``, ``value`` in tokens/s
per GPU, ``unit``, ``seq_len``, ``d_model``, ``layers``, ``n_params_m``,
``train_gflop_per_token``), stamped ``bench_lm/v1``.  On the card: JAX's
TPU configuration (T 8192, width 2048, 8 layers, 16 heads, vocabulary
32768, batch 1 a GPU: 553.9 M parameters, flash attention), 10 steps
timed after 3 of warm-up; the line adds the MFU against the card's bf16
peak (:mod:`..utils.gpu_info`; ``peak_assumed`` for a card not in its
table), ``step_ms``, ``device_ms_per_step`` (profiler kernel sums of 3 more
steps, :func:`..utils.trace.device_time`), ``device_busy_share`` (their
ratio), the first and last loss and ``step_calls`` (every call of the step,
for exact launch checks).  ``--device cpu`` runs JAX's CPU smoke (T 256,
width 64, 2 layers, 4 heads, vocabulary 512, batch 2, 3 steps after 1,
``xla`` attention) and marks the line ``smoke: true``.

FLOP accounting (:func:`lm_train_gflop_per_token`, JAX's, copied): each
matrix product 2*M*N*K (qkv, output projection, MLP up and down, the head)
plus causal attention (scores and values over the T^2/2 half), times 3
for training.

    python -m chainermn_tpu_torch.benchmarks.bench_lm
    python -m chainermn_tpu_torch.benchmarks.bench_lm --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

# (T, width, layers, heads, vocabulary, batch, timed steps, warm-up, attention)
CPU_SMOKE = (256, 64, 2, 4, 512, 2, 3, 1, "xla")
GPU_HEADS, GPU_VOCAB, GPU_STEPS, GPU_WARMUP = 16, 32768, 10, 3
DEVICE_TIME_STEPS, DEVICE_TIME_WARMUP = 3, 1


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def lm_train_gflop_per_token(seq_len, d, layers, vocab, n_heads,
                             n_kv_heads=None):
    """Exact matmul FLOPs of one forward TOKEN at sequence length T,
    x3 for training.  Attention counts the causal half (T^2/2) for both
    the score and value matmuls; GQA reduces only the kv projection."""
    t = seq_len
    n_kv = n_kv_heads or n_heads
    head_dim = d // n_heads
    d_kv = n_kv * head_dim
    per_layer_tokens = (
        2 * t * d * (d + 2 * d_kv)      # qkv projection
        + 2 * t * d * d                 # output projection
        + 2 * t * d * 4 * d * 2         # mlp up + down
    )
    attn = 2 * 2 * (t * t / 2) * d      # scores + values, causal half
    f = layers * (per_layer_tokens + attn)
    f += 2 * t * d * vocab              # head (tok_emb lookup is gatherless)
    return 3 * f / t / 1e9


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seq-len", type=int, default=8192)
    p.add_argument("--d-model", type=int, default=2048)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--batch", type=int, default=1,
                   help="per-GPU batch (the card's configuration)")
    p.add_argument("--attempts", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU "
                        "smoke)")
    return p.parse_args(argv)


def config(args, on_gpu: bool) -> dict:
    """The run's shape: the card's from ``args``, else JAX's CPU smoke."""
    if on_gpu:
        return dict(seq=args.seq_len, d=args.d_model, layers=args.layers,
                    heads=GPU_HEADS, vocab=GPU_VOCAB, batch=args.batch,
                    steps=GPU_STEPS, warmup=GPU_WARMUP, attention="flash")
    keys = ("seq", "d", "layers", "heads", "vocab", "batch", "steps",
            "warmup", "attention")
    return dict(zip(keys, CPU_SMOKE))


def run(args) -> dict:
    """One benchmark attempt; returns the JSON-line dict."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.examples.train_lm import lm_loss
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel.topology import env_int, resolve_device
    from chainermn_tpu_torch.utils.gpu_info import peak_tflops_info
    from chainermn_tpu_torch.utils.trace import device_time, fence
    dev = resolve_device(args.device, env_int("LOCAL_RANK") or 0)
    on_gpu = dev.type == "cuda"
    c = config(args, on_gpu)
    seq, vocab, batch = c["seq"], c["vocab"], c["batch"]
    model = TransformerLM(
        vocab=vocab, d_model=c["d"], n_layers=c["layers"],
        n_heads=c["heads"], max_len=seq, attention_impl=c["attention"],
        dtype=torch.bfloat16, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    gflop_tok = lm_train_gflop_per_token(seq, c["d"], c["layers"], vocab,
                                         c["heads"])
    comm = cmn.create_communicator(
        "xla", allreduce_grad_dtype="bfloat16" if on_gpu else None,
        device=dev)
    log(f"bench_lm: device={dev} world={comm.size} T={seq} d={c['d']} "
        f"L={c['layers']} vocab={vocab} b={batch}/GPU "
        f"attn={c['attention']} train GFLOP/token={gflop_tok:.3f}")
    comm.bcast_data(model)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"bench_lm: {n_params / 1e6:.1f}M params")
    optimizer = cmn.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9), comm,
        double_buffering=True)
    train_step = cmn.make_train_step(comm, lambda b: lm_loss(model, b),
                                     optimizer)
    calls = [0]

    def step(b):
        calls[0] += 1
        return train_step(b)

    # JAX's tokens: RandomState(0), [batch * size, T]; this rank's rows
    rng = np.random.RandomState(0)
    toks = (rng.rand(batch * comm.size, seq) * vocab).astype(np.int32)
    toks = torch.from_numpy(
        toks[comm.rank * batch:(comm.rank + 1) * batch]).to(dev)
    model.train()
    for _ in range(c["warmup"]):
        loss = step(toks)
    first_loss = float(loss)  # a value read: the warm-up has run
    log(f"bench_lm: warmup done, loss={first_loss:.3f}")
    t0 = time.perf_counter()
    for _ in range(c["steps"]):
        loss = step(toks)
    final_loss = float(loss)
    dt = time.perf_counter() - t0
    log(f"bench_lm: final loss {final_loss:.3f}")
    tok_per_sec = batch * seq * c["steps"] / dt  # per GPU
    out = {
        "metric": "transformer_lm_train_throughput"
                  if on_gpu else "tiny_lm_cpu_smoke_train_throughput",
        "value": tok_per_sec,
        "unit": "tokens/sec/GPU" if on_gpu else "tokens/sec/process",
        "seq_len": seq, "d_model": c["d"], "layers": c["layers"],
        "n_params_m": round(n_params / 1e6, 1),
        "train_gflop_per_token": round(gflop_tok, 4),
        "attention": c["attention"],
        "first_loss": first_loss, "final_loss": final_loss,
    }
    if on_gpu:
        peak, matched = peak_tflops_info(dev)
        out.update(mfu=tok_per_sec * gflop_tok / 1e3 / peak,
                   device_kind=torch.cuda.get_device_name(dev),
                   peak_tflops=peak, peak_assumed=matched is None,
                   step_ms=dt / c["steps"] * 1e3)
        with tempfile.TemporaryDirectory() as tmp:
            out["device_ms_per_step"] = device_time(
                step, (toks,), steps=DEVICE_TIME_STEPS,
                warmup=DEVICE_TIME_WARMUP, trace_dir=tmp)
        out["device_busy_share"] = out["device_ms_per_step"] / out["step_ms"]
        fence(loss)
        log(f"bench_lm: MFU {out['mfu']:.1%} (peak {peak} TFLOP/s bf16)")
    else:
        out["smoke"] = True
    train_step.finalize()  # no gradient mean left in flight
    out["step_calls"] = calls[0]
    return out


def main(argv=None) -> dict:
    """Run the bench (with retries); prints the stamped JSON line and
    returns it."""
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    from chainermn_tpu_torch.utils.retry import retry_transient
    args = parse_args(argv)
    out = retry_transient(lambda: run(args), attempts=args.attempts,
                          label="bench_lm")
    stamp_envelope(out, "bench_lm/v1")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
