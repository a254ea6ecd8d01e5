"""Probe of ResNet-50's stage-1 gradient products on the card.

Counterpart of ``benchmarks/bench_pallas_conv_probe.py``.  For each of the
three matrix products of ResNet-50's first stage (M = 256 * 56 * 56 =
802,816 rows, the activation of a batch of 256):

  * wgrad:  C[256, 64] (f32) = A[256, M] (bf16) @ B[M, 64] (bf16)
  * dgrad:  C[M, 256] (bf16) = A[M, 64] (bf16)  @ B[64, 256] (bf16)
  * fwd1x1: C[M, 64] (bf16)  = A[M, 256] (bf16) @ B[256, 64] (bf16)

it times one library call (``library``: ``torch.mm`` with the same output
type, cuBLAS on the card) and the port's hand-written CUDA kernel
(:mod:`chainermn_tpu_torch.ops.probe_matmul`) over a sweep of block sizes
``bm`` -- the JAX probe's grid step; the port's persistent kernels split M
their own way and give the same launch and bits at every ``bm``, which
only sets the plain version's chunk order (the sweep's rows should agree
within the timing's noise) -- beside the least time the card could take
(``bound_ms``: the bytes over its memory rate or the operations over its
bf16 peak, whichever is larger, from :mod:`..utils.gpu_info`).  Then the 3x3
64->64 convolution of the same activation, forward and forward+backward, in
cuDNN (``F.conv2d``, channels_last bf16), which the JAX probe timed in XLA.

The document keeps the JAX probe's shape with three renames: ``xla`` ->
``library``, ``pallas_sweep``/``pallas_best`` -> ``kernel_sweep``/
``kernel_best``, schema ``conv_probe_torch/v1``.  Its TPU constants (the
TPU's memory rate and MXU lane ceiling) are replaced by the card's rates.
Two deliberate differences from the JAX probe:

1. A kernel that fails at some block size raises and the run exits
   non-zero; the JAX probe recorded the failure and went on.
2. Before a kernel is timed, its whole output is held to its plain version
   (:func:`~chainermn_tpu_torch.ops.probe_matmul.agreement`: wgrad within a
   relative L2 error of 2e-5; rowblock 99% equal bit for bit and
   every element within one bf16 ulp plus the float32 sums' rounding
   bound); the JAX probe compared the first 256 rows with the library's
   at a loose tolerance.

Times on the card are device time (:func:`..utils.trace.device_time`: the
kernels' durations in a profiler capture, 2 warm-up calls and 5 timed).
With ``--device cpu`` the wrappers take their plain versions and the
document records the host's wall time (``host_ms``) instead; a block size
that does not divide M is skipped, as in the JAX probe.  The convolutions
run on a batch of ``M // 3136`` (at least 1) 56x56 images: 256 at the
default M.

    python -m chainermn_tpu_torch.benchmarks.bench_conv_probe --out p.json
    python -m chainermn_tpu_torch.benchmarks.bench_conv_probe \\
        --device cpu --M 4096 --blocks 1024,2048
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

from chainermn_tpu_torch.observability import stamp_envelope
from chainermn_tpu_torch.ops import probe_matmul as pm
from chainermn_tpu_torch.parallel.topology import env_int, resolve_device
from chainermn_tpu_torch.utils.gpu_info import card_info
from chainermn_tpu_torch.utils.retry import retry_transient
from chainermn_tpu_torch.utils.trace import captures, device_time

SCHEMA = "conv_probe_torch/v1"
STEPS, WARMUP = 5, 2    # timed and warm-up calls of each measurement
IMAGE, CHANNELS = 56, 64  # stage 1 of ResNet-50


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the document to this file")
    ap.add_argument("--M", type=int, default=256 * IMAGE * IMAGE)
    ap.add_argument("--blocks", default="1024,2048,4096,8192",
                    help="block sizes bm of the kernel sweep")
    ap.add_argument("--device", default=None,
                    help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    return ap.parse_args(argv)


def probe_cases(m: int) -> dict:
    """``{name: (A shape, B shape, kernel, output dtype)}`` of the three
    stage-1 products at M = ``m``."""
    return {
        "wgrad": ((256, m), (m, 64), "wgrad", torch.float32),
        "dgrad": ((m, 64), (64, 256), "rowblock", torch.bfloat16),
        "fwd1x1": ((m, 256), (256, 64), "rowblock", torch.bfloat16),
    }


def operands(dev, sa, sb, first_seed=0):
    """bf16 normals of shapes ``sa`` and ``sb`` on ``dev``, from generators
    seeded ``first_seed`` and ``first_seed + 1``."""
    return tuple(torch.randn(shape, generator=torch.Generator(device=dev)
                             .manual_seed(first_seed + i), device=dev,
                             dtype=torch.bfloat16)
                 for i, shape in enumerate((sa, sb)))


def library_product(a, b, out_dtype):
    """One PyTorch call for the same product: ``torch.mm`` with the output
    type (on the card, cuBLAS with float32 accumulation).  The CPU has no
    mixed-type product, so there a float32 output is taken from float32
    copies of the inputs."""
    if out_dtype == a.dtype:
        return torch.mm(a, b)
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=out_dtype)
    return torch.mm(a.to(out_dtype), b.to(out_dtype))


def main(argv=None) -> dict:
    """Run the probe; prints the document as one JSON line and returns
    it."""
    args = parse_args(argv)
    dev = resolve_device(args.device, env_int("LOCAL_RANK") or 0)
    on_gpu = dev.type == "cuda"
    card, matched = card_info(dev if on_gpu else "unknown")
    kind = torch.cuda.get_device_name(dev) if on_gpu else None
    M = args.M
    blocks = [int(b) for b in args.blocks.split(",")]
    doc = {"suite": "conv_probe_torch", "M": M, "backend": dev.type,
           "peak_tflops": card.peak_tflops,
           "hbm_bytes_per_s": card.hbm_bytes_per_s,
           "peak_assumed": matched is None,
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "cases": {}}
    before = dict(captures)

    def measure(fn, flops):
        """Device ms and TFLOP/s of ``fn()`` on the card, the host's wall ms
        on the CPU."""
        if on_gpu:
            ms = device_time(fn, (), steps=STEPS, warmup=WARMUP)
            return {"device_ms": ms, "tflops": flops / ms / 1e9}
        for _ in range(WARMUP):
            fn()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            fn()
        return {"host_ms": (time.perf_counter() - t0) * 1e3 / STEPS}

    def ms_of(row):
        return row["device_ms" if on_gpu else "host_ms"]

    for name, (sa, sb, kern, out_dtype) in probe_cases(M).items():
        a, b = operands(dev, sa, sb)
        flops = pm.probe_flops(sa[0], sa[1], sb[1])
        out_bytes = torch.empty((), dtype=out_dtype).element_size()
        nbytes = pm.probe_bytes(sa[0], sa[1], sb[1], out_bytes)
        bound, bound_by = pm.bound_ms(flops, nbytes, card)
        row = {"flops_g": flops / 1e9, "traffic_mb": nbytes / 1e6,
               "bound_ms": bound, "bound_by": bound_by,
               "roofline_tflops": flops / bound / 1e9}
        row["library"] = retry_transient(
            lambda: measure(lambda: library_product(a, b, out_dtype), flops),
            attempts=3, label=f"{name}-library")
        log(f"{name}: library {row['library']} (bound {bound:.4f} ms)")

        fn, plain = getattr(pm, kern), getattr(pm, f"{kern}_plain")
        best = None
        for bm in blocks:
            if M % bm:
                continue
            # the whole output against the plain version, then the time;
            # a failure of either raises
            check = pm.agreement(kern, a, b, fn(a, b, bm), plain(a, b, bm))
            res = retry_transient(
                lambda: measure(lambda: fn(a, b, bm), flops), attempts=3,
                label=f"{name}-kernel-{bm}")
            res.update(check)
            if kern == "wgrad":
                res["workspace_mb"] = pm.wgrad_workspace_bytes(M, bm) / 1e6
            row.setdefault("kernel_sweep", {})[str(bm)] = res
            log(f"{name}: kernel bm={bm}: {res}")
            if best is None or ms_of(res) < ms_of(best[1]):
                best = (bm, res)
        if best:
            row["kernel_best"] = dict(best[1], bm=best[0])
        doc["cases"][name] = row
        del a, b

    # the 3x3 64->64 convolution of the same activation: cuDNN, as the JAX
    # probe timed XLA's convolution (no kernel of the port contends)
    def conv_case(name, fwd_only):
        batch = max(1, M // (IMAGE * IMAGE))
        x, w = (t.contiguous(memory_format=torch.channels_last)
                for t in operands(dev, (batch, CHANNELS, IMAGE, IMAGE),
                                  (CHANNELS, CHANNELS, 3, 3), first_seed=2))
        flops = 2 * batch * IMAGE * IMAGE * 9 * CHANNELS * CHANNELS
        if fwd_only:
            def fn():
                return F.conv2d(x, w, padding=1)
        else:
            flops *= 3  # forward, dgrad, wgrad
            xg, wg = x.requires_grad_(), w.requires_grad_()

            def fn():
                loss = (F.conv2d(xg, wg, padding=1).float() ** 2).sum()
                return torch.autograd.grad(loss, (xg, wg))
        row = retry_transient(lambda: measure(fn, flops), attempts=3,
                              label=name)
        row["flops_g"] = flops / 1e9
        row["batch"] = batch
        doc["cases"][name] = row
        log(f"{name}: {row}")

    conv_case("conv3x3_fwd", fwd_only=True)
    conv_case("conv3x3_fwd_bwd", fwd_only=False)

    if on_gpu:  # profiler captures taken, and those that lost kernels
        doc["device_time_captures"] = {
            k: captures[k] - before.get(k, 0)
            for k in ("taken", "incomplete")}
    stamp_envelope(doc, SCHEMA, device_kind=kind, n_devices=1,
                   backend=dev.type)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    print(json.dumps(doc), flush=True)
    return doc


if __name__ == "__main__":
    main()
