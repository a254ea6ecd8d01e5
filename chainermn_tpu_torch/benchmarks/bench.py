"""Headline benchmark: ResNet-50 synthetic-ImageNet training throughput.

Counterpart of the root ``bench.py``.  Prints exactly ONE JSON line to
stdout:
    {"metric": ..., "value": N, "unit": "images/sec/GPU", "vs_baseline": N,
     ...}

Baseline: the reference's flagship published result -- ResNet-50/ImageNet
on 1024 P100s in 15 minutes (Akiba et al., arXiv:1711.04325; BASELINE.md):
90 epochs x 1.28M images / 900 s / 1024 GPUs ~= 125 images/sec per GPU,
with the fork's fp16 allreduce and double-buffered optimizer.  The
configuration is the JAX bench's: ResNet-50 at 224x224, batch 256 per GPU,
bf16 compute, the ``xla`` communicator with the bfloat16 wire, SGD momentum
0.9 through the double-buffered multi-node optimizer, the full train step
(forward, backward, all-reduce, update) per iteration, 20 steps timed after
5 of warm-up, random weights from seed 0 and ``RandomState(0)`` data.  The
norm is the port's fused BatchNorm(+ReLU) kernels (``"norm": "fused"``;
the JAX bench uses flax ``nn.BatchNorm``).

On the card the line also carries the MFU against the card's bf16 peak
(:mod:`..utils.gpu_info`; ``peak_assumed`` when the card is not in its
table), ``step_ms``, ``device_ms_per_step`` (the kernels' durations in a
profiler capture of 3 more steps, :func:`..utils.trace.device_time`; a
failure there raises) and ``device_ms_by_category`` (the same split by
:func:`..utils.trace.kernel_category`).  ``--device cpu`` runs the JAX
bench's CPU smoke shape (a two-stage ResNet of 8 filters at 32x32, batch
8, float32, no wire dtype, 5 steps after 2) and marks the line ``smoke:
true``.  ``--stem s2d`` swaps the 7x7/s2 stem for JAX's space-to-depth
stem (the same 53 BatchNorm boundaries a step).  The whole run
sits in a bounded retry of transient (network) failures.

    python -m chainermn_tpu_torch.benchmarks.bench
    python -m chainermn_tpu_torch.benchmarks.bench --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

BASELINE_IMG_PER_SEC_PER_GPU = 125.0  # P100, arXiv:1711.04325 (BASELINE.md)

# ResNet-50 at 224x224: ~4.1 GFLOP forward per image; a train step is ~3x
# the forward (forward + backward at twice its cost) ~= 12.3 GFLOP an image
# (the standard accounting, as in the MLPerf reference).  For the MFU only.
TRAIN_GFLOP_PER_IMAGE = 12.3

# (batch per GPU, image, timed steps, warm-up steps)
GPU_SHAPE = (256, 224, 20, 5)
CPU_SHAPE = (8, 32, 5, 2)
DEVICE_TIME_STEPS, DEVICE_TIME_WARMUP = 3, 1


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the timed steps "
                        "into DIR")
    p.add_argument("--attempts", type=int, default=3,
                   help="max benchmark attempts before giving up")
    p.add_argument("--stem", choices=["conv7", "s2d"], default=None,
                   help="ResNet stem: conv7 (the reference's 7x7/s2) or s2d "
                        "(space-to-depth + 4x4/s1 over 12 channels)")
    p.add_argument("--scan", type=int, default=None,
                   help="train steps fused per dispatch (only 1: see "
                        "ROADMAP.md, the captured train step)")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append the result record to this metrics JSONL")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    return p.parse_args(argv)


def build(dev, stem: str = "conv7"):
    """The bench's train step on ``dev``: ``(step, batch, comm, shape)``,
    ``shape`` = (batch per GPU, image, timed steps, warm-up steps) and the
    number of classes.  ResNet-50 at :data:`GPU_SHAPE` on the card, the
    tiny ResNet at :data:`CPU_SHAPE` on the CPU; ``stem`` either way."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import ResNet, ResNet50
    from chainermn_tpu_torch.models.resnet import BasicBlock
    on_gpu = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    if on_gpu:
        n_classes = 1000
        model = ResNet50(num_classes=n_classes, dtype=torch.bfloat16,
                         stem=stem, device=dev, generator=gen)
        shape = GPU_SHAPE
    else:  # CPU smoke path: tiny ResNet so the contract can be exercised
        n_classes = 10
        model = ResNet(stage_sizes=(1, 1), block_cls=BasicBlock,
                       num_filters=8, num_classes=n_classes,
                       dtype=torch.float32, stem=stem, device=dev,
                       generator=gen)
        shape = CPU_SHAPE
    per_gpu_batch, image = shape[:2]

    comm = cmn.create_communicator(
        "xla", allreduce_grad_dtype="bfloat16" if on_gpu else None,
        device=dev)
    comm.bcast_data(model)
    optimizer = cmn.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm,
        double_buffering=True)
    step = cmn.make_train_step(
        comm, lambda b: F.cross_entropy(model(b[0]), b[1]), optimizer)
    model.train()

    # the JAX bench's data: RandomState(0), NHWC, this rank's rows
    global_batch = per_gpu_batch * comm.size
    rng = np.random.RandomState(0)
    x = rng.randn(global_batch, image, image, 3).astype(np.float32)
    y = (rng.rand(global_batch) * n_classes).astype(np.int64)
    rows = slice(comm.rank * per_gpu_batch, (comm.rank + 1) * per_gpu_batch)
    batch = (torch.from_numpy(x[rows]).permute(0, 3, 1, 2).to(dev),
             torch.from_numpy(y[rows]).to(dev))
    return step, batch, comm, shape


def run(args) -> dict:
    """One full benchmark attempt.  Returns the JSON-line dict."""
    from chainermn_tpu_torch.parallel.topology import env_int, resolve_device
    from chainermn_tpu_torch.utils.gpu_info import peak_tflops_info
    from chainermn_tpu_torch.utils.trace import (
        MARKER, captures, device_op_times, device_time, fence,
        kernel_category)

    stem = args.stem or "conv7"
    scan = 1 if args.scan is None else args.scan
    if scan != 1:
        raise NotImplementedError(
            f"--scan {scan}: several train steps a dispatch have no eager "
            "counterpart; their counterpart is the captured train step (one "
            "CUDA graph a step), recorded in ROADMAP.md under work for after "
            "the port")
    dev = resolve_device(args.device, env_int("LOCAL_RANK") or 0)
    on_gpu = dev.type == "cuda"
    step, batch, comm, shape = build(dev, stem)
    per_gpu_batch, image, steps, warmup = shape
    log(f"bench: device={dev} world={comm.size} batch/GPU={per_gpu_batch} "
        f"image={image} stem={stem} scan={scan}")

    def sync(out):
        if on_gpu:
            fence(out)

    for _ in range(warmup):
        loss = step(batch)
    sync(loss)
    log(f"bench: warmup done, loss={float(loss):.3f}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_gpu else [])
        prof_ctx = profile(activities=acts)
    else:
        prof_ctx = contextlib.nullcontext()
    with prof_ctx as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(batch)
        # a value read: every step has run once the last loss is on the host
        final_loss = float(loss)
        dt = time.perf_counter() - t0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        log(f"bench: profile written to {args.profile}")
    log(f"bench: final loss {final_loss:.3f}")

    per_gpu = per_gpu_batch * steps / dt
    out = {
        "metric": "resnet50_synthetic_imagenet_train_throughput"
                  if on_gpu else "tiny_resnet_cpu_smoke_train_throughput",
        "value": per_gpu,
        "unit": "images/sec/GPU" if on_gpu else "images/sec/process",
        "vs_baseline": per_gpu / BASELINE_IMG_PER_SEC_PER_GPU,
        "stem": stem,
        "scan_steps": scan,
        "norm": "fused",
    }
    if on_gpu:
        peak, matched = peak_tflops_info(dev)
        mfu = per_gpu * TRAIN_GFLOP_PER_IMAGE / 1e3 / peak
        out.update(mfu=mfu, device_kind=torch.cuda.get_device_name(dev),
                   peak_tflops=peak, peak_assumed=matched is None,
                   step_ms=dt / steps * 1e3)
        # the device's own time a step (profiler kernel durations): the
        # host's launch path shows as the gap to step_ms
        before = dict(captures)
        with tempfile.TemporaryDirectory() as tmp:
            out["device_ms_per_step"] = device_time(
                step, (batch,), steps=DEVICE_TIME_STEPS,
                warmup=DEVICE_TIME_WARMUP, trace_dir=tmp)
            by_cat: dict = {}
            for name, (ms, _) in device_op_times(tmp).items():
                if MARKER not in name:
                    cat = kernel_category(name)
                    by_cat[cat] = (by_cat.get(cat, 0.0)
                                   + ms / DEVICE_TIME_STEPS)
        out["device_ms_by_category"] = by_cat
        # profiler captures taken for device_ms_per_step, and those that
        # lost kernels and were taken again
        out["device_time_captures"] = {
            k: captures[k] - before.get(k, 0)
            for k in ("taken", "incomplete")}
        log(f"bench: MFU {mfu:.1%} (peak {peak} TFLOP/s bf16, "
            f"{TRAIN_GFLOP_PER_IMAGE} GFLOP/img train)")
    else:
        out["smoke"] = True
    step.finalize()  # no gradient mean left in flight
    return out


def main(argv=None) -> dict:
    """Run the bench (with retries); prints the JSON line and returns it."""
    from chainermn_tpu_torch.observability import append_jsonl
    from chainermn_tpu_torch.utils.retry import retry_transient
    args = parse_args(argv)
    out = retry_transient(lambda: run(args), attempts=args.attempts,
                          label="bench")
    if args.metrics:
        append_jsonl(args.metrics, dict(out, kind="bench", ts=time.time()))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
