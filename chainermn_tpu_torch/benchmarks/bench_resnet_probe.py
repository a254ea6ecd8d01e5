"""Decompose the ResNet-50 train step's time on one GPU.

Counterpart of ``benchmarks/bench_resnet_probe.py``.  Times variants of
the batch-256 ResNet-50 step that remove one cost at a time, so each
feature's price is a measured subtraction:

  full        -- the bench's step (forward, backward, all-reduce, update;
                 bf16, the bf16 wire, double buffering) with the plain
                 PyTorch BatchNorm (``ReferenceBatchNormAct``: JAX's flax
                 ``nn.BatchNorm``)
  nostats     -- BatchNorm with CONSTANT mean/var (the statistics and their
                 backward vanish; the normalize/scale elementwise math stays)
  nonorm      -- BatchNorm replaced by the identity (all its work vanishes)
  fwdonly     -- the forward pass only (no gradient)
  fwdbwd      -- forward and backward only (no all-reduce, no update)
  s2d         -- the full step with the space-to-depth stem
  remat       -- the full step with every residual block recomputed in the
                 backward pass (``remat_policy="block"``)
  fusednorm   -- the full step with every BatchNorm(+ReLU) boundary on the
                 fused kernels (``FusedBatchNormAct``: the CUDA statistics
                 and backward reduction, the Triton apply and dx)

Each variant reports ms a step (wall clock between value reads, after 4
steps of warm-up) and images/sec; the deltas against ``full`` go to
stderr.  ``--json``/``--out`` also emit a ``resnet_probe/v1`` document:
the variant rows, the card's name and power limit, and the deterministic
``traffic`` section (``ops.resnet_bn_traffic_bytes`` at ``--traffic-batch``,
224 pixels).  ``nostats``/``nonorm`` change the numerics (the loss is
garbage): they price memory traffic and never train.

``--stages`` switches to per-stage isolation: each ResNet-50 stage's
bottleneck blocks run forward and backward alone on a seeded bf16
activation (device ms from :func:`..utils.trace.device_time`, TFLOP/s),
plus ``stage1_pad128``, stage 1 widened from 64 to 128 channels: about
twice stage 1's TFLOP/s means its 64-channel products are bound by their
width; about the same means the stage is bound by memory.

``--device cpu`` runs the same variants on the smoke ResNet (two stages of
basic blocks, 8 filters; batch 8 at 32 pixels unless given) in float32
without a wire dtype, and marks the document ``smoke: true``.

    python -m chainermn_tpu_torch.benchmarks.bench_resnet_probe \\
        --variants full,fusednorm,s2d,remat --json
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VARIANTS = ("full", "nostats", "nonorm", "fwdonly", "fwdbwd", "s2d",
            "remat", "fusednorm")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class ConstStatBN(nn.Module):
    """BatchNorm with mean 0 and var 1 pinned: the same γ/β and the same
    elementwise normalize math and dtype flow, minus the batch statistics
    (and their backward reductions).  Prices the statistics alone."""

    def __init__(self, num_features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=None, scale_init: float = 1.0,
                 device=None):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        f32 = {"dtype": torch.float32, "device": device}
        self.weight = nn.Parameter(torch.full((num_features,), scale_init,
                                              **f32))
        self.bias = nn.Parameter(torch.zeros((num_features,), **f32))

    def forward(self, x):
        shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
        mul = (self.weight / math.sqrt(1.0 + self.epsilon)).to(x.dtype)
        y = x * mul.reshape(shape) + self.bias.to(x.dtype).reshape(shape)
        return y if self.dtype is None else y.to(self.dtype)


class IdentityNorm(nn.Module):
    """The norm boundary removed: the identity, no parameters."""

    def __init__(self, num_features: int, **_):
        super().__init__()

    def forward(self, x):
        return x


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=None,
                   help="per-GPU batch (default 256; 8 on the CPU)")
    p.add_argument("--image", type=int, default=None,
                   help="image size (default 224; 32 on the CPU)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--variants", default="full,nostats,nonorm,fwdonly,fwdbwd")
    p.add_argument("--stages", action="store_true",
                   help="per-stage isolation + the pad128 width probe "
                        "instead of the step variants")
    p.add_argument("--json", action="store_true",
                   help="print the resnet_probe/v1 document on stdout")
    p.add_argument("--out", default=None,
                   help="write the resnet_probe/v1 document to this path "
                        "(implies --json)")
    p.add_argument("--traffic-batch", type=int, default=256,
                   help="batch of the deterministic BN-traffic section")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU "
                        "smoke)")
    args = p.parse_args(argv)
    wanted = args.variants.split(",")
    unknown = set(wanted) - set(VARIANTS)
    if unknown:
        # a typo must not re-measure the full model under the wrong label
        raise SystemExit(f"unknown variant(s) {sorted(unknown)}; "
                         f"available: {sorted(VARIANTS)}")
    args.wanted = wanted
    return args


def _sync(out) -> None:
    """A value read of ``out``: every queued step has run."""
    float(out.detach().float().reshape(-1)[0])


def time_step(step, steps: int, warmup: int) -> float:
    """Seconds a call of ``step()``: ``steps`` calls between value reads,
    after ``warmup``."""
    for _ in range(warmup):
        out = step()
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step()
    _sync(out)
    return (time.perf_counter() - t0) / steps


def build_model(variant: str, dev, on_gpu: bool):
    """The ResNet of ``variant`` on ``dev`` (ResNet-50 bf16 on the card,
    the smoke ResNet in float32 on the CPU)."""
    from chainermn_tpu_torch.models import ResNet, ResNet50
    from chainermn_tpu_torch.models.resnet import BasicBlock
    from chainermn_tpu_torch.ops.fused_norm import (
        FusedBatchNormAct, ReferenceBatchNormAct)
    kw = dict(norm_cls={"nostats": ConstStatBN, "nonorm": IdentityNorm,
                        "fusednorm": FusedBatchNormAct}.get(
                            variant, ReferenceBatchNormAct),
              stem="s2d" if variant == "s2d" else "conv7",
              remat_policy="block" if variant == "remat" else "none",
              device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    if on_gpu:
        return ResNet50(num_classes=1000, dtype=torch.bfloat16, **kw), 1000
    return ResNet(stage_sizes=(1, 1), block_cls=BasicBlock, num_filters=8,
                  num_classes=10, **kw), 10


def run_variants(args, dev) -> dict:
    """``{variant: seconds a step}`` of every asked variant."""
    import chainermn_tpu_torch as cmn
    on_gpu = dev.type == "cuda"
    comm = cmn.create_communicator(
        "xla", allreduce_grad_dtype="bfloat16" if on_gpu else None,
        device=dev)
    results = {}
    for variant in args.wanted:
        model, n_classes = build_model(variant, dev, on_gpu)
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(args.batch, args.image, args.image, 3)
                             .astype(np.float32)).permute(0, 3, 1, 2).to(dev)
        y = torch.from_numpy((rng.rand(args.batch) * n_classes)
                             .astype(np.int64)).to(dev)
        model.train()
        loss_of = lambda: F.cross_entropy(model(x), y)  # noqa: E731
        if variant == "fwdonly":
            def step():
                with torch.no_grad():
                    return loss_of()
        elif variant == "fwdbwd":
            def step():
                model.zero_grad(set_to_none=True)
                loss = loss_of()
                loss.backward()
                return next(model.parameters()).grad.sum()
        else:
            comm.bcast_data(model)
            optimizer = cmn.create_multi_node_optimizer(
                torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
                comm, double_buffering=True)
            train = cmn.make_train_step(comm, lambda b: loss_of(), optimizer)
            step = lambda: train(None)  # noqa: E731
        dt = time_step(step, args.steps, 4)
        if variant not in ("fwdonly", "fwdbwd"):
            train.finalize()
        results[variant] = dt
        log(f"{variant:9s}  {dt * 1e3:7.2f} ms/step   "
            f"{args.batch / dt:8.1f} img/s")
        del model
        if on_gpu:
            torch.cuda.empty_cache()
    if "full" in results:
        base = results["full"]
        for v, dt in results.items():
            if v != "full":
                log(f"delta full-{v:9s} = {1e3 * (base - dt):7.2f} ms")
    return results


def stage_flops_fwd(b, h_in, c_in, f, count, stride) -> int:
    """Forward conv FLOPs of a bottleneck stack (BN/ReLU excluded)."""
    total, c, h = 0, c_in, h_in
    for j in range(count):
        s = stride if j == 0 else 1
        h_out = h // s
        n_out, n_in = b * h_out * h_out, b * h * h
        total += 2 * (n_in * c * f + n_out * f * f * 9 + n_out * f * 4 * f)
        if c != 4 * f or s != 1:
            total += 2 * n_out * c * 4 * f    # projection shortcut
        c, h = 4 * f, h_out
    return total


# (name, spatial in, channels in, filters, blocks, first stride)
STAGES = (("stage1", 56, 64, 64, 3, 1), ("stage1_pad128", 56, 128, 128, 3, 1),
          ("stage2", 56, 256, 128, 4, 2), ("stage3", 28, 512, 256, 6, 2),
          ("stage4", 14, 1024, 512, 3, 2))


def run_stage_isolation(args, dev) -> dict:
    """``{stage: {"ms", "tflops"}}``: each stage's blocks forward and
    backward alone (device ms on the card, wall ms on the CPU)."""
    from functools import partial

    from chainermn_tpu_torch.models.resnet import BottleneckBlock, Conv
    from chainermn_tpu_torch.ops.fused_norm import ReferenceBatchNormAct
    on_gpu = dev.type == "cuda"
    dt = torch.bfloat16 if on_gpu else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    conv = partial(Conv, dtype=dt, device=dev, generator=gen)
    norm = partial(ReferenceBatchNormAct, momentum=0.9, epsilon=1e-5,
                   dtype=dt, device=dev)
    rng = np.random.RandomState(0)
    b, out = args.batch, {}
    for name, hw, c_in, f, count, stride in STAGES:
        blocks, c = [], c_in
        for j in range(count):
            blocks.append(BottleneckBlock(c, f, conv, norm,
                                          stride if j == 0 else 1))
            c = 4 * f
        stack = nn.Sequential(*blocks).to(memory_format=torch.channels_last)
        x = torch.from_numpy(rng.randn(b, c_in, hw, hw).astype(np.float32)) \
            .to(dev, dt).contiguous(memory_format=torch.channels_last)
        x.requires_grad_(True)

        def fwd_bwd(stack=stack, x=x):
            stack.zero_grad(set_to_none=True)
            x.grad = None
            y = stack(x).float().sum()
            y.backward()
            return x.grad

        if on_gpu:
            from chainermn_tpu_torch.utils.trace import device_time
            ms = device_time(fwd_bwd, (), steps=5, warmup=2)
        else:
            ms = time_step(fwd_bwd, 3, 1) * 1e3
        flops = 3 * stage_flops_fwd(b, hw, c_in, f, count, stride)
        out[name] = {"ms": ms, "tflops": flops / (ms / 1e3) / 1e12}
        log(f"{name:14s}  {ms:7.2f} ms  {out[name]['tflops']:6.1f} TFLOP/s "
            f"(fwd+bwd, {count} blocks @ {hw}x{hw}, width {f})")
    return out


def main(argv=None) -> dict:
    """Run the probe; returns the ``resnet_probe/v1`` document (printed
    with ``--json``, written with ``--out``)."""
    from chainermn_tpu_torch.observability import stamp_envelope
    from chainermn_tpu_torch.ops import resnet_bn_traffic_bytes
    from chainermn_tpu_torch.parallel.topology import env_int, resolve_device
    from chainermn_tpu_torch.utils.gpu_info import smi_line
    args = parse_args(argv)
    dev = resolve_device(args.device, env_int("LOCAL_RANK") or 0)
    on_gpu = dev.type == "cuda"
    args.batch = args.batch or (256 if on_gpu else 8)
    args.image = args.image or (224 if on_gpu else 32)
    doc = {"schema": "resnet_probe/v1", "backend": dev.type,
           "smoke": not on_gpu, "batch": args.batch, "image": args.image,
           "steps": args.steps,
           "card": smi_line(dev.index or 0) if on_gpu else None,
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    if args.stages:
        doc["stages"] = run_stage_isolation(args, dev)
    else:
        results = run_variants(args, dev)
        base = results.get("full")
        doc["variants"] = {
            v: {"ms_per_step": dt * 1e3, "img_per_sec": args.batch / dt,
                **({"delta_vs_full_ms": (base - dt) * 1e3}
                   if base is not None and v != "full" else {})}
            for v, dt in results.items()}
    # modeled device-memory bytes of the 53 boundaries at 224 pixels
    doc["traffic"] = resnet_bn_traffic_bytes(args.traffic_batch)
    stamp_envelope(doc)
    if args.json or args.out:
        payload = json.dumps(doc, indent=2)
        if args.out:
            with open(args.out, "w") as f:
                f.write(payload + "\n")
            log(f"wrote {args.out}")
        else:
            print(payload, flush=True)
    return doc


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
