"""Channel-wise (filter-wise) parallel convolution.

Counterpart of ``examples/parallel_convolution/train_parallel_conv.py``:
the reference's example-level ancestor of tensor parallelism.  Each rank
owns 1/size of every convolution's filters, computes its slice of the
channels, and the ranks allgather activations between the layers with the
differentiable ``functions.allgather`` (stacked ``[size, ...]``, then
concatenated along the channels; its backward sums each rank's slot over
the ranks' cotangents).  Every rank sees the same batch and trains its own
parameters, initialised from its own seed, with its own Adam: there is no
gradient allreduce.  One process per GPU under ``torchrun``:

    torchrun --nproc_per_node 4 -m \\
        chainermn_tpu_torch.examples.train_parallel_conv
    python -m chainermn_tpu_torch.examples.train_parallel_conv --device cpu

The flags are the JAX example's (60 steps of a batch of 32 16x16 images,
Adam 1e-2), plus ``--device``; the run fails unless the loss falls, as the
JAX example's does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.functions import allgather
from chainermn_tpu_torch.models.resnet import Conv, Dense


class ChannelShardedCNN(nn.Module):
    """This rank's ``channels_per_device`` filters of each of two 3x3
    convolutions (bias, flax ``"SAME"``) and its own dense classifier.
    flax's ``Conv_0``, ``Conv_1`` and ``Dense_0`` are ``conv0``, ``conv1``
    and ``dense``."""

    def __init__(self, comm, channels_per_device: int = 8,
                 n_classes: int = 10, in_channels: int = 3,
                 generator=None):
        super().__init__()
        self.comm = comm
        width = channels_per_device * comm.size
        kw = dict(device=comm.device, generator=generator)
        self.conv0 = Conv(in_channels, channels_per_device, 3, bias=True,
                          **kw)
        self.conv1 = Conv(width, channels_per_device, 3, bias=True, **kw)
        self.dense = Dense(width, n_classes, **kw)

    def _gather(self, y):
        # [size, B, C/size, H, W] -> every rank's channels, in rank order
        return torch.cat(list(allgather(self.comm, y)), dim=1)

    def forward(self, x):
        y = self._gather(F.relu(self.conv0(x)))
        y = F.max_pool2d(y, 2, 2)
        y = self._gather(F.relu(self.conv1(y)))
        return self.dense(y.mean(dim=(2, 3)))


def make_batch(batchsize: int, seed: int):
    """The JAX example's batch (labels, then NHWC images of class-dependent
    mean, from one ``RandomState``) as NCHW float32 and int64."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(batchsize) * 10).astype(np.int64)
    x = rng.randn(batchsize, 16, 16, 3).astype(np.float32)
    x += y.reshape(-1, 1, 1, 1) * 0.3
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), \
        torch.from_numpy(y)


def train_steps(model, optimizer, x, y, steps: int):
    """``steps`` Adam steps on the batch; yields this rank's loss of
    each (the loss of its own classifier)."""
    for _ in range(steps):
        optimizer.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        optimizer.step()
        yield float(loss.detach())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_tpu_torch "
                                "channel-parallel convolution example")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batchsize", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns ``{"losses", "world", "model"}``: the world's mean
    loss of each step (every rank holds the same) and this rank's
    model."""
    args = parse_args(argv)
    comm = create_communicator("xla", device=args.device)
    # each rank its own filters: the generator of rank r is seeded r
    model = ChannelShardedCNN(comm, generator=torch.Generator(
        device=comm.device).manual_seed(comm.rank))
    x, y = make_batch(args.batchsize, args.seed)
    x, y = x.to(comm.device), y.to(comm.device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    losses = []
    for i, loss in enumerate(train_steps(model, opt, x, y, args.steps)):
        losses.append(float(comm.allreduce(
            torch.tensor(loss, device=comm.device), "mean")))
        if i % 10 == 0 and comm.rank == 0:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    if comm.rank == 0:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    if not losses[-1] < losses[0]:
        raise RuntimeError("channel-parallel training should reduce the "
                           f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "world": comm.size, "model": model}


if __name__ == "__main__":
    main()
    torch.distributed.destroy_process_group()
