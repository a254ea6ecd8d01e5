"""Data-parallel MNIST training on GPUs, ChainerMN style.

Counterpart of ``examples/mnist/train_mnist.py`` (the reference's canonical
ChainerMN example, BASELINE config 0): create a communicator, scatter the
dataset, wrap the optimizer, evaluate on every rank with the multi-node
evaluator, gate the reports to rank 0, train a 784-1000-1000-10 MLP with
Adam.  One process drives one GPU; launch several with ``torchrun``.  The
data is the JAX example's synthetic MNIST-shaped Gaussian blobs (12,000
train, 2,000 test; the MNIST npz of ``--data`` is not in the repository).

    python -m chainermn_tpu_torch.examples.train_mnist --epoch 5
    torchrun --nproc_per_node 4 -m chainermn_tpu_torch.examples.train_mnist \\
        --communicator xla --allreduce-grad-dtype float16 --double-buffering
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.datasets import PrefetchIterator, make_classification
from chainermn_tpu_torch.extensions import (
    create_multi_node_evaluator, make_eval_fn)
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import MLP
from chainermn_tpu_torch.training import StandardUpdater, Trainer, extensions

ENTRIES = ["epoch", "main/loss", "validation/loss", "main/accuracy",
           "validation/accuracy", "elapsed_time"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_tpu_torch MNIST "
                                "example (synthetic data)")
    p.add_argument("--batchsize", "-b", type=int, default=100,
                   help="per-GPU minibatch size")
    p.add_argument("--communicator", type=str, default="hierarchical",
                   help="naive/flat/hierarchical/two_dimensional/"
                        "single_node/non_cuda_aware/xla/pure_nccl")
    p.add_argument("--epoch", "-e", type=int, default=20)
    p.add_argument("--unit", "-u", type=int, default=1000)
    p.add_argument("--out", "-o", default="result")
    p.add_argument("--data", default=None,
                   help="not supported yet (ROADMAP.md Queue A5)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="prefetched training batches (0 disables the "
                        "loader thread)")
    p.add_argument("--double-buffering", action="store_true",
                   help="overlap gradient allreduce with compute "
                        "(1-step-stale gradients)")
    p.add_argument("--allreduce-grad-dtype", default=None,
                   help="communication dtype (xla communicator only), "
                        "e.g. float16")
    p.add_argument("--compression", default=None,
                   help="not supported yet (ROADMAP.md Queue A10)")
    p.add_argument("--intra-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--observability", action="store_true",
                   help="not supported yet (ROADMAP.md Queue A13)")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns ``{"log": [...], "world": size,
    "examples_per_sec_per_gpu": rate}``, ``log`` holding one record per
    epoch with ``main/loss``, ``main/accuracy``, ``validation/loss`` and
    ``validation/accuracy`` (on every rank), ``rate`` over the epochs after
    the first (None for one epoch)."""
    args = parse_args(argv)
    for flag, queue in (("data", "A5 (an MNIST npz in the repository)"),
                        ("compression", "A10"), ("observability", "A13")):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet; see ROADMAP.md Queue {queue}")
    comm = cmn.create_communicator(
        args.communicator, intra_size=args.intra_size,
        allreduce_grad_dtype=args.allreduce_grad_dtype, device=args.device)
    device = comm.device
    if comm.rank == 0:
        print("==========================================")
        print(f"Num processes (GPUs): {comm.size} (inter {comm.inter_size} "
              f"x intra {comm.intra_size}), device: {device}")
        print(f"Using {args.communicator} communicator")
        print(f"Num units: {args.unit}, minibatch/GPU: {args.batchsize}, "
              f"epochs: {args.epoch}")
        if args.double_buffering:
            print("Using double buffering (1-step-stale gradients)")
        print("==========================================", flush=True)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = MLP(args.unit, 10, device=device, generator=gen)
    comm.bcast_data(model)  # identical start everywhere
    optimizer = cmn.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm,
        double_buffering=args.double_buffering)

    def metrics(batch):
        x, y = batch
        logits = model(x)
        y = y.long()
        return {"loss": F.cross_entropy(logits, y),
                "accuracy": (logits.argmax(-1) == y).float().mean()}

    def loss_fn(batch):
        m = metrics(batch)
        return m["loss"], {"accuracy": m["accuracy"]}

    step = cmn.make_train_step(comm, loss_fn, optimizer, has_aux=True)

    train = make_classification(n=12000, dim=784, n_classes=10, noise=4.0,
                                seed=0)
    test = make_classification(n=2000, dim=784, n_classes=10, noise=4.0,
                               seed=1)
    train = cmn.scatter_dataset(train, comm, shuffle=True, seed=args.seed)
    test = cmn.scatter_dataset(test, comm, shuffle=False)
    train_iter = SerialIterator(train, args.batchsize, shuffle=True,
                                seed=args.seed)
    if args.prefetch > 0:
        # batch assembly overlaps the step (the evaluation iterator stays
        # plain: it must rewind every epoch)
        train_iter = PrefetchIterator(train_iter, prefetch=args.prefetch,
                                      workers=2)
    test_iter = SerialIterator(test, args.batchsize, repeat=False,
                               shuffle=False)

    updater = StandardUpdater(train_iter, step, comm)
    trainer = Trainer(updater, (args.epoch, "epoch"), log_trigger=None,
                      out=args.out)
    evaluator = extensions.Evaluator(test_iter, make_eval_fn(comm, metrics),
                                     comm)
    trainer.extend(create_multi_node_evaluator(evaluator, comm),
                   trigger=(1, "epoch"))
    # every rank keeps the per-epoch log (main() returns it); rank 0 alone
    # writes it and prints it, as the reference example does
    log = extensions.LogReport(filename="log" if comm.rank == 0 else None)
    trainer.extend(log)
    if comm.rank == 0:
        trainer.extend(extensions.PrintReport(ENTRIES))
    model.train()
    try:
        trainer.run()
    finally:
        if args.prefetch > 0:
            train_iter.close()
    # training examples/sec per GPU after the first epoch (which holds the
    # start-up); the per-epoch evaluation counts in it
    rate = None
    if len(log.log) > 1:
        first, last = log.log[0], log.log[-1]
        rate = ((last["iteration"] - first["iteration"]) * args.batchsize
                / (last["elapsed_time"] - first["elapsed_time"]))
    if comm.rank == 0:
        print(f"final: {log.log[-1] if log.log else {}}; examples/sec per "
              f"GPU (epochs 2..{len(log.log)}): {rate}", flush=True)
    return {"log": log.log, "world": comm.size,
            "examples_per_sec_per_gpu": rate}


if __name__ == "__main__":
    main()
    torch.distributed.destroy_process_group()
