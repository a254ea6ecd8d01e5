"""Data-parallel CIFAR-10 training with VGG-16 and double buffering.

Counterpart of ``examples/cifar/train_cifar.py`` (BASELINE config
"VGG-16 / CIFAR-10 with double-buffered allreduce optimizer"): the
configuration that validates the fork's double-buffered optimizer, where
the gradient allreduce of step t-1 overlaps the forward and backward of
step t and is applied one step stale.  VGG-16 (13 BatchNorm+ReLU
boundaries on the fused kernels), SGD with momentum 0.9 through
``create_multi_node_optimizer``, ``AllreducePersistent`` on the BatchNorm
buffers at every epoch end.  One process drives one GPU; launch several
with ``torchrun``.

Without ``--data`` the JAX example's synthetic CIFAR-shaped set is used
(the same ``RandomState`` draws, class-dependent means so the loss can
fall), transposed to NCHW; ``--data`` names an npz with ``x_train``
(NHWC) and ``y_train``.

    python -m chainermn_tpu_torch.examples.train_cifar --double-buffering \\
        --communicator xla --allreduce-grad-dtype float16 --iterations 30

The flags and defaults are the JAX example's (``--batchsize`` per GPU),
plus the port's ``--device``, ``--iterations``, ``--log-interval``,
``--warmup-steps`` and ``--profile-steps`` (as in ``train_imagenet``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.datasets import TupleDataset
from chainermn_tpu_torch.examples.train_imagenet import profile_steps
from chainermn_tpu_torch.extensions import AllreducePersistent
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import VGG16
from chainermn_tpu_torch.models.layers import dropout_seed
from chainermn_tpu_torch.training import StatefulUpdater, Trainer, extensions


def make_synthetic_cifar(n, seed):
    """The JAX example's synthetic set (labels, then NHWC images of
    class-dependent mean, from one ``RandomState``), transposed to NCHW
    float32."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) * 10).astype(np.int64)
    x = rng.randn(n, 32, 32, 3).astype(np.float32) * 0.5
    x += y.reshape(-1, 1, 1, 1) * 0.25
    return TupleDataset(np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y)


def load_data(args):
    if args.data:
        with np.load(args.data) as d:
            x = d["x_train"].astype(np.float32)
            return TupleDataset(np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
                                d["y_train"].astype(np.int64))
    return make_synthetic_cifar(args.train_size, args.seed)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_tpu_torch CIFAR "
                                "example (VGG-16, synthetic data by default)")
    p.add_argument("--batchsize", "-b", type=int, default=64,
                   help="per-GPU minibatch size")
    p.add_argument("--epoch", "-e", type=int, default=20)
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
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--out", "-o", default=None,
                   help="directory for rank 0's per-epoch log (default: no "
                        "files)")
    p.add_argument("--data", default=None,
                   help="npz with x_train/y_train arrays (NHWC)")
    p.add_argument("--train-size", type=int, default=8192,
                   help="synthetic examples in all (no --data)")
    p.add_argument("--intra-size", type=int, default=None)
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


def main(argv=None) -> dict:
    """Train; returns ``{"losses", "images_per_sec", "iterations",
    "world", "log", "peak_memory_gb", "model", "optimizer"}`` (images/sec
    over the steps after ``--warmup-steps``, summed over the world; the
    run's peak device memory, None on the CPU), plus ``"profile"``
    with ``--profile-steps``."""
    args = parse_args(argv)
    comm = cmn.create_communicator(
        args.communicator, allreduce_grad_dtype=args.allreduce_grad_dtype,
        intra_size=args.intra_size, device=args.device)
    device = comm.device
    if comm.rank == 0:
        print(f"Num processes (GPUs): {comm.size}; communicator "
              f"{args.communicator} (wire {args.allreduce_grad_dtype}); "
              f"double_buffering={args.double_buffering}; minibatch/GPU "
              f"{args.batchsize}, dtype {args.dtype}, device {device}",
              flush=True)

    train = cmn.scatter_dataset(load_data(args), comm, shuffle=True,
                                seed=args.seed)
    train_iter = SerialIterator(train, args.batchsize, shuffle=True,
                                seed=args.seed)
    model = VGG16(num_classes=10, dtype=getattr(torch, args.dtype),
                  image_size=train[0][0].shape[-1], device=device,
                  generator=torch.Generator(device=device).manual_seed(
                      args.seed))
    comm.bcast_data(model)
    optimizer = cmn.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9), comm,
        double_buffering=args.double_buffering)

    def loss_fn(batch):
        x, y = batch
        logits = model(x)
        acc = (logits.argmax(-1) == y).float().mean()
        return F.cross_entropy(logits, y), {"accuracy": acc}

    train_step = cmn.make_train_step(comm, loss_fn, optimizer, has_aux=True)

    def step(batch):
        model.dropout_generator.manual_seed(
            dropout_seed(args.seed, updater.iteration, comm.rank))
        return train_step(batch)

    step.finalize = train_step.finalize
    model.train()
    updater = StatefulUpdater(train_iter, step, model, comm)
    stop = ((args.iterations, "iteration") if args.iterations
            else (args.epoch, "epoch"))
    trainer = Trainer(updater, stop,
                      log_trigger=(args.log_interval, "iteration"),
                      out=args.out)
    timer = extensions.StepTimer(device)
    trainer.extend(timer)
    trainer.extend(AllreducePersistent(comm, model))
    log = extensions.LogReport(filename="log" if comm.rank == 0 else None)
    trainer.extend(log)
    timer.start()
    trainer.run()
    w = args.warmup_steps
    losses, ips, peak_gb = timer.result(args.batchsize * comm.size, w)
    result = {"losses": losses, "images_per_sec": ips,
              "iterations": updater.iteration, "world": comm.size,
              "log": log.log, "peak_memory_gb": peak_gb, "model": model,
              "optimizer": optimizer}
    if comm.rank == 0:
        ips_s = f"{ips:.1f}" if ips is not None else "n/a"
        final = f"{losses[-1]:.4f}" if losses else "n/a"
        mem = f"{peak_gb:.2f} GB" if peak_gb is not None else "n/a"
        print(f"final loss {final}; images/sec (all GPUs, steps "
              f"{w + 1}..{len(losses)}): {ips_s}; peak device memory of "
              f"rank 0 {mem}; epoch log {log.log[-1] if log.log else {}}",
              flush=True)
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
