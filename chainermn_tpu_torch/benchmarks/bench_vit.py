"""ViT training throughput: the data-parallel step on a model of large
products.

Counterpart of ``benchmarks/bench_vit.py``.  The headline bench
(:mod:`.bench`) keeps the reference's ResNet-50; this one runs the SAME
training machinery (``create_communicator`` -> ``create_multi_node_optimizer``
-> ``make_train_step``, bf16 compute, the bf16 gradient wire, double
buffering) on ViT-B/16, which is almost all large matrix products
(197-token attention and 4x GELU MLPs at width 768).

Prints ONE JSON line: ``{"metric": "vit_b16_synthetic_imagenet_train_
throughput", "value": images/sec/GPU, "unit": ..., "attention": ...,
"train_gflop_per_image": ..., "mfu": ...}``.  On the card: ViT-B/16 at
224 pixels, 256 a GPU, SGD 3e-3 with momentum 0.9 (a larger rate diverges
on an unwarmed ViT within the timed steps), 20 steps timed after 5 of
warm-up; the line adds the MFU against the card's bf16 peak
(:mod:`..utils.gpu_info`; ``peak_assumed`` for a card not in its table),
``step_ms``, ``device_ms_per_step`` (profiler kernel sums of 3 more steps,
:func:`..utils.trace.device_time`), ``device_busy_share`` (their ratio),
``device_ms_by_category`` (:data:`CATEGORIES`), the first and last loss,
and ``step_calls`` (every call of the step this run made, for exact
kernel-launch checks).
``--attention flash`` runs the encoder's attention through the CUDA flash
kernels (non-causal, D 64, T 197), ``xla`` (the default, as in JAX) through
the plain softmax.  ``--device cpu`` runs the JAX bench's tiny CPU smoke
(image 32, patch 8, width 32, 2 layers, 4 heads, 10 classes, batch 8, 5
steps after 2, no wire dtype) and marks the line ``smoke: true``.

FLOP accounting (:func:`vit_train_gflop_per_image`): the forward's matrix
products counted exactly from the configuration, times 3 for training.

    python -m chainermn_tpu_torch.benchmarks.bench_vit --attention flash
    python -m chainermn_tpu_torch.benchmarks.bench_vit --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# kernel-name fragments -> category of device_ms_by_category (first match
# wins; the rest is trace.OTHER_CATEGORY)
CATEGORIES = (
    ("flash (CUDA)", ("fwd_wgmma_kernel", "dkv_wgmma_kernel",
                      "dq_wgmma_kernel", "fwd_tc_kernel", "dkv_tc_kernel",
                      "dq_tc_kernel", "_f32_kernel")),
    ("cast_scale (CUDA)", ("cast_scale",)),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("nccl", ("nccl",)),
    ("memcpy / memset", ("memcpy", "memset")),
    ("gemm / conv", ("gemm", "xmma", "cutlass", "sm90_", "nvjet", "conv",
                     "cudnn")),
    ("softmax", ("softmax",)),
    ("reductions (layer norm, mean)", ("reduce_kernel",)),
)
# (classes, image, patch, width, layers, heads, timed steps, warm-up)
GPU_SHAPE = (1000, 224, 16, 768, 12, 12, 20, 5)
CPU_SHAPE = (10, 32, 8, 32, 2, 4, 5, 2)
CPU_BATCH = 8
DEVICE_TIME_STEPS, DEVICE_TIME_WARMUP = 3, 1


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def vit_train_gflop_per_image(image, patch, d, layers, n_classes,
                              mlp_ratio=4, pooling="cls"):
    """Exact matmul FLOPs (2*M*N*K) of one forward image, x3 for training.
    The head count does not change them (the per-head dims multiply back
    out), so it is not a parameter here."""
    t = (image // patch) ** 2 + (1 if pooling == "cls" else 0)
    f = 2 * t * (patch * patch * 3) * d            # patch embed conv
    per_layer = (
        2 * t * d * 3 * d                          # qkv
        + 2 * t * t * d                            # scores (all heads)
        + 2 * t * t * d                            # probs @ v
        + 2 * t * d * d                            # proj
        + 2 * t * d * mlp_ratio * d * 2            # mlp up + down
    )
    f += layers * per_layer
    f += 2 * d * n_classes                         # head (one row)
    return 3 * f / 1e9


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256,
                   help="per-GPU batch (the card's shape)")
    p.add_argument("--attention", choices=["xla", "flash"], default="xla",
                   help="encoder attention: the plain softmax (xla) or the "
                        "flash kernels")
    p.add_argument("--attempts", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU "
                        "smoke)")
    return p.parse_args(argv)


def build(dev, attention: str, batch: int):
    """``(step, batch, comm, shape, gflop)``: the bench's train step on
    ``dev`` over this rank's rows of the seeded data."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import ViT
    on_gpu = dev.type == "cuda"
    shape = GPU_SHAPE if on_gpu else CPU_SHAPE
    n_classes, image, patch, d, layers, heads = shape[:6]
    per_gpu = batch if on_gpu else CPU_BATCH
    gen = torch.Generator(device=dev).manual_seed(0)
    model = ViT(num_classes=n_classes, patch=patch, d_model=d,
                n_layers=layers, n_heads=heads, dtype=torch.bfloat16,
                attention_impl=attention, image_size=image, device=dev,
                generator=gen)
    comm = cmn.create_communicator(
        "xla", allreduce_grad_dtype="bfloat16" if on_gpu else None,
        device=dev)
    comm.bcast_data(model)
    optimizer = cmn.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=3e-3, momentum=0.9), comm,
        double_buffering=True)
    step = cmn.make_train_step(
        comm, lambda b: F.cross_entropy(model(b[0]), b[1]), optimizer)
    model.train()
    rng = np.random.RandomState(0)
    n = per_gpu * comm.size
    x = rng.randn(n, image, image, 3).astype(np.float32)
    y = (rng.rand(n) * n_classes).astype(np.int64)
    rows = slice(comm.rank * per_gpu, (comm.rank + 1) * per_gpu)
    data = (torch.from_numpy(x[rows]).permute(0, 3, 1, 2).contiguous()
            .to(dev), torch.from_numpy(y[rows]).to(dev))
    gflop = vit_train_gflop_per_image(image, patch, d, layers, n_classes)
    return step, data, comm, (per_gpu,) + shape[6:], gflop


def run(args) -> dict:
    """One benchmark attempt; returns the JSON-line dict."""
    from chainermn_tpu_torch.parallel.topology import env_int, resolve_device
    from chainermn_tpu_torch.utils.gpu_info import peak_tflops_info
    from chainermn_tpu_torch.utils.trace import (
        MARKER, device_op_times, device_time, fence, kernel_category)
    dev = resolve_device(args.device, env_int("LOCAL_RANK") or 0)
    on_gpu = dev.type == "cuda"
    train_step, batch, comm, (per_gpu, steps, warmup), gflop = build(
        dev, args.attention, args.batch)
    calls = [0]

    def step(b):
        calls[0] += 1
        return train_step(b)

    log(f"bench_vit: device={dev} world={comm.size} batch/GPU={per_gpu} "
        f"attention={args.attention} train GFLOP/img={gflop:.2f}")
    for _ in range(warmup):
        loss = step(batch)
    first_loss = float(loss)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(batch)
    final_loss = float(loss)  # a value read: every step has run
    dt = time.perf_counter() - t0
    log(f"bench_vit: loss {first_loss:.3f} -> {final_loss:.3f}")
    per_gpu_rate = per_gpu * steps / dt
    out = {
        "metric": "vit_b16_synthetic_imagenet_train_throughput"
                  if on_gpu else "tiny_vit_cpu_smoke_train_throughput",
        "value": per_gpu_rate,
        "unit": "images/sec/GPU" if on_gpu else "images/sec/process",
        "attention": args.attention,
        "train_gflop_per_image": gflop,
        "first_loss": first_loss,
        "final_loss": final_loss,
    }
    if on_gpu:
        peak, matched = peak_tflops_info(dev)
        out.update(mfu=per_gpu_rate * gflop / 1e3 / peak,
                   device_kind=torch.cuda.get_device_name(dev),
                   peak_tflops=peak, peak_assumed=matched is None,
                   step_ms=dt / steps * 1e3)
        with tempfile.TemporaryDirectory() as tmp:
            out["device_ms_per_step"] = device_time(
                step, (batch,), steps=DEVICE_TIME_STEPS,
                warmup=DEVICE_TIME_WARMUP, trace_dir=tmp)
            by_cat: dict = {}
            for name, (ms, _) in device_op_times(tmp).items():
                if MARKER not in name:
                    cat = kernel_category(name, CATEGORIES)
                    by_cat[cat] = (by_cat.get(cat, 0.0)
                                   + ms / DEVICE_TIME_STEPS)
        out["device_ms_by_category"] = by_cat
        out["device_busy_share"] = out["device_ms_per_step"] / out["step_ms"]
        fence(loss)
        log(f"bench_vit: MFU {out['mfu']:.1%} (peak {peak} TFLOP/s bf16)")
    else:
        out["smoke"] = True
    train_step.finalize()  # no gradient mean left in flight
    out["step_calls"] = calls[0]
    return out


def main(argv=None) -> dict:
    """Run the bench (with retries); prints the JSON line and returns it."""
    from chainermn_tpu_torch.utils.retry import retry_transient
    args = parse_args(argv)
    out = retry_transient(lambda: run(args), attempts=args.attempts,
                          label="bench_vit")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
