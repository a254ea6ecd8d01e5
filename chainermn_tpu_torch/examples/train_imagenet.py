"""Data-parallel ImageNet training on GPUs, ChainerMN style.

Counterpart of ``examples/imagenet/train_imagenet.py``: create a
communicator, scatter the dataset, wrap the optimizer so every step
averages the gradients, and train.  One process drives one GPU; launch
several with ``torchrun`` (or set ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT``/``LOCAL_RANK`` yourself).  This port supports synthetic
ImageNet-shaped data only (class-dependent channel means, so the loss can
fall) and ResNet-50 with the fused BatchNorm(+ReLU) kernels.  The fork's
"ImageNet in 15 minutes" configuration is the float16 wire with double
buffering:

    python -m chainermn_tpu_torch.examples.train_imagenet --arch resnet50 \\
        --communicator xla --batchsize 32 --iterations 20 \\
        --allreduce-grad-dtype float16 --double-buffering
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.datasets import TupleDataset
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import ResNet50
from chainermn_tpu_torch.training import StatefulUpdater, Trainer
from chainermn_tpu_torch.utils.trace import KERNEL_CATEGORIES, kernel_category

ARCHS = {"resnet50": ResNet50}


def make_synthetic_imagenet(n, image, n_classes, seed):
    """NCHW float32 images whose channel means depend on the class."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) * n_classes).astype(np.int64)
    x = rng.randn(n, 3, image, image).astype(np.float32)
    x += (y % 8).reshape(-1, 1, 1, 1) * 0.3
    return TupleDataset(x, y)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_tpu_torch ImageNet "
                                "example (synthetic data)")
    p.add_argument("--arch", "-a", default="resnet50", choices=sorted(ARCHS))
    p.add_argument("--batchsize", "-B", type=int, default=32,
                   help="per-GPU minibatch size")
    p.add_argument("--epoch", "-E", type=int, default=1)
    p.add_argument("--iterations", type=int, default=None,
                   help="stop after this many steps (overrides --epoch)")
    p.add_argument("--communicator", default="xla")
    p.add_argument("--allreduce-grad-dtype", default=None,
                   help="communication dtype (xla communicator only), "
                        "e.g. float16")
    p.add_argument("--double-buffering", action="store_true",
                   help="overlap gradient allreduce with compute "
                        "(1-step-stale gradients)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--n-classes", type=int, default=1000)
    p.add_argument("--train-size", type=int, default=1024,
                   help="synthetic examples in all (scattered over ranks)")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    p.add_argument("--log-interval", type=int, default=10,
                   help="rank 0 prints every N iterations")
    p.add_argument("--warmup-steps", type=int, default=2,
                   help="first steps left out of images/sec")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="after training, run this many more steps under "
                        "torch.profiler and print where the device time "
                        "went")
    return p.parse_args(argv)


def profile_steps(updater, steps: int, device,
                  categories=KERNEL_CATEGORIES) -> dict:
    """Run ``steps`` more steps under ``torch.profiler``; returns wall ms
    per step, device kernel ms per step by category (``(name, kernel-name
    fragments)`` pairs, first match wins), and the device's busy share
    (kernel time over wall time; streams assumed not to overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            updater.update()
        updater.finalize()
        torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_cat: dict = {}
    by_kernel = []
    for e in prof.key_averages():
        # device-side kernels only; a user annotation (such as
        # "Optimizer.step#SGD.step") spans kernels counted on their own
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or "#" in e.key:
            continue
        ms = e.self_device_time_total / 1e3 / steps
        cat = kernel_category(e.key, categories)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        by_kernel.append((ms, e.key[:80]))
    busy = sum(by_cat.values())
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "device_ms_by_category": by_cat,
            "top_kernels": [[k, ms] for ms, k in sorted(by_kernel)[::-1][:10]]}


def main(argv=None) -> dict:
    """Train; returns ``{"losses", "images_per_sec", "iterations",
    "world"}`` (images/sec over the steps after ``--warmup-steps``, summed
    over the world), plus ``"profile"`` with ``--profile-steps``."""
    args = parse_args(argv)
    comm = cmn.create_communicator(
        args.communicator, allreduce_grad_dtype=args.allreduce_grad_dtype,
        device=args.device)
    device = comm.device
    if comm.rank == 0:
        print(f"==========================================\n"
              f"Num processes (GPUs): {comm.size} (intra {comm.intra_size})\n"
              f"Using {args.communicator} communicator, arch {args.arch}\n"
              f"Minibatch/GPU: {args.batchsize}, dtype: {args.dtype}, "
              f"device: {device}\n"
              f"==========================================", flush=True)

    train = make_synthetic_imagenet(args.train_size, args.image_size,
                                    args.n_classes, args.seed)
    train = cmn.scatter_dataset(train, comm, shuffle=True, seed=args.seed)
    train_iter = SerialIterator(train, args.batchsize, shuffle=True,
                                seed=args.seed)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = ARCHS[args.arch](num_classes=args.n_classes,
                             dtype=getattr(torch, args.dtype), device=device,
                             generator=gen)
    comm.bcast_data(model)
    optimizer = cmn.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9), comm,
        double_buffering=args.double_buffering)

    def loss_fn(batch):
        x, y = batch
        logits = model(x)
        acc = (logits.argmax(-1) == y).float().mean()
        return F.cross_entropy(logits, y), {"accuracy": acc}

    step = cmn.make_train_step(comm, loss_fn, optimizer, has_aux=True)
    model.train()
    updater = StatefulUpdater(train_iter, step, model, comm)
    stop = ((args.iterations, "iteration") if args.iterations
            else (args.epoch, "epoch"))
    trainer = Trainer(updater, stop,
                      log_trigger=(args.log_interval, "iteration"))
    losses, marks = [], []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def record(tr):
        losses.append(tr.observation["main/loss"])
        sync()
        marks.append(time.perf_counter())

    trainer.extend(record, trigger=(1, "iteration"))
    sync()
    marks.append(time.perf_counter())
    trainer.run()
    losses = [float(v) for v in losses]
    w = args.warmup_steps
    ips = None
    if len(losses) > w:  # marks[i]: after step i (marks[0]: the start)
        ips = (args.batchsize * comm.size * (len(losses) - w)
               / (marks[-1] - marks[w]))
    result = {"losses": losses, "images_per_sec": ips,
              "iterations": updater.iteration, "world": comm.size}
    if comm.rank == 0:
        ips_s = f"{ips:.1f}" if ips is not None else "n/a"
        print(f"final loss {losses[-1]:.4f}; images/sec (all GPUs, steps "
              f"{w + 1}..{len(losses)}): {ips_s}", flush=True)
    if args.profile_steps:
        if device.type != "cuda":
            raise ValueError("--profile-steps profiles the GPU")
        result["profile"] = profile_steps(updater, args.profile_steps,
                                          device)
        if comm.rank == 0:
            print(f"profile: {result['profile']}", flush=True)
    return result


if __name__ == "__main__":
    main()
    torch.distributed.destroy_process_group()
