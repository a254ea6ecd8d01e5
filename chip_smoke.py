#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. environment: the card's name and power limit (nvidia-smi), the torch,
   CUDA and Triton versions;
2. kernels: each Triton kernel of ``chainermn_tpu_torch.ops.fused_norm``
   (built into ``build/triton`` on first use) against its plain PyTorch
   version, at ResNet-50 batch-32 boundary shapes and one ragged row
   count, in bfloat16 and float32, train/eval, ReLU on/off;
3. the slice: ``python -m chainermn_tpu_torch.examples.train_imagenet``'s
   ``main`` -- an NCCL world of one, ``create_communicator("xla")``,
   ResNet-50 at full width (224x224, batch 32, bfloat16, random weights
   from seed 0) on synthetic data, SGD momentum through
   ``create_multi_node_optimizer`` and ``StatefulUpdater`` -- for
   ``STEPS`` steps (images/sec over those after ``WARMUP``), then
   ``PROFILED`` more under ``torch.profiler`` (device time by category);
   every kernel's launch count must be 53 per step;
4. timing: each kernel over the 53 boundaries of one bfloat16 step,
   captured into a CUDA graph and replayed between CUDA events (device
   time; the eager time with the host's launch path is printed too),
   beside its plain version, one PyTorch library call and the least time
   the card could take (bytes over 3.35 TB/s, or float32 operations over
   67 TFLOP/s, whichever is larger);
5. float32 agreement: one step of ResNet-50 with the kernels and one with
   the plain reference norm, from the same ``weights.py``-converted
   weights, TF32 off and cuDNN deterministic; the loss (relative 1e-4) and
   every BatchNorm parameter gradient (relative L2 error 1e-3) must agree;
6. cast kernel: the CUDA ``cast_scale`` of ``chainermn_tpu_torch.ops``
   (built with nvcc into ``build/cuda`` on first use) against
   ``cast_scale_plain``, bit for bit (NaN positions, not payloads), for
   every (source, destination) pair and None, scales 1, 1/2, 1/3, 1/8,
   lengths from 1 to the packed gradient counts of the MLP and of
   ResNet-50 (taken from the models), a view one element in (not 16-byte
   aligned), +-7e4 (float16 overflow), NaN and subnormals;
7. the MNIST slice: ``examples.train_mnist``'s ``main`` for one epoch at
   full width (784-1000-1000-10, batch 100) with ``--communicator xla
   --allreduce-grad-dtype float16 --double-buffering``: 2 cast launches
   per iteration (the float32 group's cast in and cast back), finite
   losses and a validation accuracy; a direct drive of the same pieces
   shows that update 0 leaves every parameter unchanged; then one epoch
   each with the ``hierarchical`` and ``two_dimensional`` communicators;
8. ResNet-50 in the fork's 15-minute configuration (float16 wire, double
   buffering; 224x224, batch 32, bf16, ``STEPS`` steps): images/sec beside
   phase 3's, 2 cast launches per step;
9. cast timing over ResNet-50's packed gradient buffer, float32 -> float16
   at scale 1 and back at scale 1/size: kernel (CUDA graph replay), eager,
   plain, library (``x.to(dst)``) and the bound (source plus destination
   bytes over 3.35 TB/s);
10. summary: a ``{"kernels": [...]}`` line with all five kernels, the
    nvidia-smi line, then ``{"ok": true, "device": {...}}`` as the last
    line.

The cast check (6) runs right after the BatchNorm kernel check (2).
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 10           # trained steps; images/sec over those after WARMUP
WARMUP = 3
PROFILED = 3         # further steps under torch.profiler
BATCH = 32
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SOURCE = "chainermn_tpu_torch/ops/fused_norm.py"
# wrapper -> (JSON name, TPU kernel it replaces, its pass in the traffic
# model, float32 operations per element counted from the kernel body)
KERNELS = {
    "stats_call": ("fused_norm.stats", "chainermn_tpu/ops/fused_norm.py:78",
                   "fwd_stats", 3),
    "apply_call": ("fused_norm.apply", "chainermn_tpu/ops/fused_norm.py:97",
                   "fwd_apply", 4),
    "bwd_reduce_call": ("fused_norm.bwd_reduce",
                        "chainermn_tpu/ops/fused_norm.py:119", "bwd_reduce",
                        9),
    "bwd_dx_call": ("fused_norm.bwd_dx",
                    "chainermn_tpu/ops/fused_norm.py:140", "bwd_dx", 11),
}
LIBRARY = {
    "stats_call": "torch.var_mean(x, 0, correction=0)",
    "apply_call": "F.batch_norm(eval) (no ReLU)",
    "bwd_reduce_call": "aten.native_batch_norm_backward(dgamma, dbeta)",
    "bwd_dx_call": "aten.native_batch_norm_backward(dx, dgamma, dbeta)",
}


def log(msg):
    print(msg, flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def check(name, got, want, rtol, atol, errs):
    """Fail unless |got - want| <= atol + rtol * |want| everywhere; keep
    the largest absolute error per kernel."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} values off (max abs err "
            f"{float(err.max()):.3g}, rtol {rtol}, atol {atol})")
    errs[name] = max(errs.get(name, 0.0), float(err.max()))


def phase_kernels(fn, torch, dev):
    """Every kernel against its plain version; returns max abs errors."""
    shapes = [(401408, 64), (100352, 256), (6272, 1024), (1568, 2048),
              (12547, 512)]  # the last: a ragged row count
    errs = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for r, c in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn((r, c), device=dev, generator=gen) * 1.5
                 + 0.3).to(dt)
            g = torch.randn((r, c), device=dev, generator=gen).to(dt)
            vec = lambda: torch.rand(c, device=dev, generator=gen)  # noqa
            scale, bias = vec() + 0.5, vec() - 0.5
            out_tol = 1e-5 if dt == torch.float32 else 1e-2
            mean, var = fn.stats_plain(x)
            for got, want in zip(fn.stats_call(x), (mean, var)):
                check("stats_call", got, want, 1e-4, 1e-4, errs)
            invstd = torch.rsqrt(var + 1e-5)
            for relu in (True, False):
                check("apply_call",
                      fn.apply_call(x, mean, invstd, scale, bias, relu),
                      fn.apply_plain(x, mean, invstd, scale, bias, relu),
                      out_tol, out_tol, errs)
                db, dg = fn.bwd_reduce_plain(x, g, mean, invstd, scale, bias,
                                             relu)
                for got, want in zip(fn.bwd_reduce_call(
                        x, g, mean, invstd, scale, bias, relu), (db, dg)):
                    # sums of R terms of O(1): absolute slack grows ~sqrt(R)
                    check("bwd_reduce_call", got, want, 1e-4,
                          1e-4 * r ** 0.5, errs)
                for train in (True, False):
                    check("bwd_dx_call",
                          fn.bwd_dx_call(x, g, mean, invstd, scale, bias, db,
                                         dg, relu, train),
                          fn.bwd_dx_plain(x, g, mean, invstd, scale, bias,
                                          db, dg, relu, train),
                          out_tol, out_tol, errs)
            del x, g
        log(f"kernels: [{r}, {c}] bf16+f32 within tolerance")
    torch.cuda.synchronize()
    return errs


def phase_slice(fn):
    import torch.distributed as dist
    from chainermn_tpu_torch import init_distributed
    from chainermn_tpu_torch.examples import train_imagenet
    topo = init_distributed()
    if (dist.get_backend(), topo.size) != ("nccl", 1):
        raise AssertionError(f"expected an NCCL world of one, got "
                             f"{dist.get_backend()} x {topo.size}")
    fn.reset_launch_counts()
    out = train_imagenet.main([
        "--arch", "resnet50", "--communicator", "xla", "--batchsize",
        str(BATCH), "--iterations", str(STEPS), "--dtype", "bfloat16",
        "--train-size", str(BATCH * STEPS), "--seed", "0",
        "--log-interval", "1", "--warmup-steps", str(WARMUP),
        "--profile-steps", str(PROFILED)])
    counts = fn.launch_counts()
    losses = out["losses"]
    if len(losses) != STEPS or not all(map(lambda v: v == v and abs(v) <
                                           float("inf"), losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    steps = STEPS + PROFILED
    for name, n in counts.items():
        if n != 53 * steps:
            raise AssertionError(
                f"{name} launched {n} times in {steps} steps, expected "
                f"{53 * steps} (53 BatchNorm boundaries per step)")
    return out, counts


def _time(torch, fn_, reps, graph):
    """ms per call of ``fn_`` between CUDA events.  With ``graph`` the
    calls are captured once into a CUDA graph and replayed, so the time is
    the device's alone; without, it includes the host's launch path."""
    fn_()  # warm-up (and the first call's build)
    torch.cuda.synchronize()
    run = fn_
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn_()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn_()
        run = g.replay
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(fn, torch, dev):
    """Each kernel over one bf16 step's 53 boundaries: kernel, plain,
    library ms, and the bound."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for name, shape, relu in fn.resnet_bn_boundaries(BATCH):
        n, h, w, c = shape
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        x2, g2 = x.reshape(-1, c), g.reshape(-1, c)
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.rand(c, device=dev, generator=gen) - 0.5
        mean, var = fn.stats_plain(x2)
        invstd = torch.rsqrt(var + 1e-5)
        db, dg = fn.bwd_reduce_plain(x2, g2, mean, invstd, scale, bias, relu)
        cases.append(dict(shape=shape, relu=relu, x2=x2, g2=g2, scale=scale,
                          bias=bias, mean=mean, var=var, invstd=invstd,
                          db=db, dg=dg, x4=x.permute(0, 3, 1, 2),
                          g4=g.permute(0, 3, 1, 2)))
    aten_bwd = torch.ops.aten.native_batch_norm_backward

    def over(call):
        return lambda: [call(k) for k in cases]

    runs = {
        "stats_call": (
            over(lambda k: fn.stats_call(k["x2"])),
            over(lambda k: fn.stats_plain(k["x2"])),
            over(lambda k: torch.var_mean(k["x2"], 0, correction=0))),
        "apply_call": (
            over(lambda k: fn.apply_call(k["x2"], k["mean"], k["invstd"],
                                         k["scale"], k["bias"], k["relu"])),
            over(lambda k: fn.apply_plain(k["x2"], k["mean"], k["invstd"],
                                          k["scale"], k["bias"], k["relu"])),
            over(lambda k: F.batch_norm(k["x4"], k["mean"], k["var"],
                                        k["scale"], k["bias"], False, 0.0,
                                        1e-5))),
        "bwd_reduce_call": (
            over(lambda k: fn.bwd_reduce_call(
                k["x2"], k["g2"], k["mean"], k["invstd"], k["scale"],
                k["bias"], k["relu"])),
            over(lambda k: fn.bwd_reduce_plain(
                k["x2"], k["g2"], k["mean"], k["invstd"], k["scale"],
                k["bias"], k["relu"])),
            over(lambda k: aten_bwd(
                k["g4"], k["x4"], k["scale"], None, None, k["mean"],
                k["invstd"], True, 1e-5, [False, True, True]))),
        "bwd_dx_call": (
            over(lambda k: fn.bwd_dx_call(
                k["x2"], k["g2"], k["mean"], k["invstd"], k["scale"],
                k["bias"], k["db"], k["dg"], k["relu"], True)),
            over(lambda k: fn.bwd_dx_plain(
                k["x2"], k["g2"], k["mean"], k["invstd"], k["scale"],
                k["bias"], k["db"], k["dg"], k["relu"], True)),
            over(lambda k: aten_bwd(
                k["g4"], k["x4"], k["scale"], None, None, k["mean"],
                k["invstd"], True, 1e-5, [True, True, True]))),
    }
    out = {}
    for wrapper, (kern, plain, lib) in runs.items():
        _, _, pass_name, ops_per_el = KERNELS[wrapper]
        nbytes = ops = 0
        for k in cases:
            t = fn.fused_norm_traffic_bytes(k["shape"], torch.bfloat16,
                                            relu=k["relu"])
            nbytes += dict(t["fused"]["passes"])[pass_name]
            ops += ops_per_el * k["x2"].numel()
        ms = _time(torch, kern, 20, graph=True)
        eager_ms = _time(torch, kern, 10, graph=False)
        plain_ms = _time(torch, plain, 5, graph=True)
        library_ms = _time(torch, lib, 20, graph=True)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        out[wrapper] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=max(bytes_ms, ops_ms),
                            bound_by="bytes" if bytes_ms >= ops_ms
                            else "operations", bytes=nbytes, ops=ops)
        log(f"timing: {wrapper} over 53 boundaries (CUDA graph replay): "
            f"kernel {ms:.4f} ms (eager launches: {eager_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, library ({LIBRARY[wrapper]}) "
            f"{library_ms:.4f} ms, bound {out[wrapper]['bound_ms']:.4f} ms "
            f"({out[wrapper]['bound_by']}: {nbytes} B, {ops} ops)")
    return out


def phase_f32(fn, torch, dev, comm):
    """One float32 step with the kernels and one with the plain norm, from
    the same weights.py-converted weights; returns the largest relative
    errors seen."""
    import torch.nn.functional as F
    from chainermn_tpu_torch import create_multi_node_optimizer, \
        make_train_step, weights
    from chainermn_tpu_torch.models import ResNet50
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # fixed conv algorithms: the two steps then differ only where the BN
    # kernels sum in another order than the plain ops
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator(device=dev).manual_seed(3)
    src = ResNet50(dtype=torch.float32, device=dev, generator=gen)
    variables = weights.state_dict_to_flax(src)
    del src
    rng = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((BATCH, 3, 224, 224), device=dev, generator=rng)
    y = torch.randint(0, 1000, (BATCH,), device=dev, generator=rng)
    results = []
    for norm_cls in (fn.FusedBatchNormAct, fn.ReferenceBatchNormAct):
        model = ResNet50(dtype=torch.float32, device=dev, norm_cls=norm_cls)
        weights.load_flax_variables(model, variables)
        model.train()
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)
        step = make_train_step(
            comm, lambda b: F.cross_entropy(model(b[0]), b[1]), opt)
        loss = float(step((x, y)))
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters()
                 if isinstance(model.get_submodule(k.rsplit(".", 1)[0]),
                               fn.FusedBatchNormAct)}
        results.append((loss, grads))
        del model, opt
    torch.backends.cudnn.deterministic = False
    (lk, gk), (lp, gp) = results
    loss_rel = abs(lk - lp) / abs(lp)
    # per tensor ||g_kernels - g_plain|| / ||g_plain||: float32 sums taken
    # in another order drift by ~1e-4 through 53 layers
    grad_rel, worst = max((float((gk[k] - gp[k]).norm())
                           / max(float(gp[k].norm()), 1e-30), k) for k in gp)
    log(f"f32 step: loss kernels {lk:.7f} plain {lp:.7f} (rel {loss_rel:.2e},"
        f" tol 1e-4); BN param grads: worst relative L2 error {grad_rel:.2e}"
        f" ({worst}; tol 1e-3) over {len(gp)} tensors; TF32 off, cuDNN "
        f"deterministic")
    if not (lk == lk and loss_rel <= 1e-4 and grad_rel <= 1e-3):
        raise AssertionError("float32 kernel step disagrees with the plain "
                             "reference step")
    return loss_rel, grad_rel


def _same_bits(torch, got, want, what):
    """Bit-exact but for NaN payloads (NaN positions must agree); returns
    the largest absolute error over the finite values (0.0)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    view = torch.int32 if got.element_size() == 4 else torch.int16
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)) or not torch.equal(
            got.view(view)[~nan], want.view(view)[~nan]):
        raise AssertionError(f"{what}: kernel and plain version differ")
    fin = torch.isfinite(want)
    return float((got[fin].float() - want[fin].float()).abs().max()) \
        if bool(fin.any()) else 0.0


def grad_counts(torch, dev):
    """Packed gradient counts of the MLP and of ResNet-50."""
    from chainermn_tpu_torch.models import MLP, ResNet50
    return {type(m).__name__: sum(p.numel() for p in m.parameters())
            for m in (MLP(device=dev), ResNet50(device=dev))}


def phase_cast(cs, torch, dev, counts):
    """The CUDA cast_scale kernel against cast_scale_plain, bit-exact."""
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    gen = torch.Generator(device=dev).manual_seed(5)
    err, cases = 0.0, 0
    for n in [1, 7, 127, 128, 33000] + sorted(counts.values()):
        base = torch.randn(n + 1, device=dev, generator=gen) * 3e4
        base[::97] = float("nan")
        base[1::89], base[2::83] = 7e4, -7e4          # float16 overflow
        base[3::79], base[4::71] = 1e-41, 3e-8        # subnormals
        for src in dtypes:
            x = base.to(src)
            for view in (x[:n], x[1:]):               # x[1:]: misaligned
                for dst in dtypes + (None,):
                    for scale in (1.0, 0.5, 1.0 / 3.0, 0.125):
                        err = max(err, _same_bits(
                            torch, cs.cast_scale(view, dst, scale),
                            cs.cast_scale_plain(view, dst, scale),
                            f"cast_scale {src}->{dst} n={n} scale={scale} "
                            f"offset={view.storage_offset()}"))
                        cases += 1
    torch.cuda.synchronize()
    return err, cases


def phase_mnist(cs, torch, dev):
    """The MNIST example on the float16 wire with double buffering, then
    update 0 of the same pieces driven directly, then the hierarchical
    and two-dimensional communicators."""
    import torch.nn.functional as F
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     make_train_step)
    from chainermn_tpu_torch.examples import train_mnist
    from chainermn_tpu_torch.models import MLP
    out_dir = os.path.join(HERE, "build", "chip_smoke_mnist")
    flags = ["--epoch", "1", "--unit", "1000", "--batchsize", "100",
             "--out", out_dir]
    cs.reset_launch_counts()
    res = train_mnist.main(flags + ["--communicator", "xla",
                                    "--allreduce-grad-dtype", "float16",
                                    "--double-buffering"])
    launches = cs.cast_scale.launches
    rec = res["log"][-1]
    iters = rec["iteration"]
    if launches != 2 * iters:
        raise AssertionError(f"cast_scale launched {launches} times in "
                             f"{iters} iterations, expected {2 * iters}")
    vals = [rec[k] for k in ("main/loss", "main/accuracy", "validation/loss",
                             "validation/accuracy")]
    if not all(math.isfinite(v) for v in vals) or \
            not 0.1 < rec["validation/accuracy"] <= 1.0:
        raise AssertionError(f"MNIST epoch not sane: {rec}")

    # update 0 of the double buffer applies zeros
    comm = create_communicator("xla", allreduce_grad_dtype="float16")
    model = MLP(1000, 10, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    opt = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm,
        double_buffering=True)
    step = make_train_step(comm, lambda b: F.cross_entropy(model(b[0]),
                                                           b[1]), opt)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = (torch.randn(100, 784, device=dev, generator=gen),
             torch.randint(0, 10, (100,), device=dev, generator=gen))
    before = [p.detach().clone() for p in model.parameters()]
    counts = []  # cast launches by update 0, update 1, the drain
    for run in (lambda: step(batch), lambda: step(batch), step.finalize):
        cs.reset_launch_counts()
        run()
        counts.append(cs.cast_scale.launches)
        if len(counts) == 1 and not all(
                torch.equal(a, p) for a, p in zip(before,
                                                  model.parameters())):
            raise AssertionError("update 0 of the double buffer changed a "
                                 "parameter")
    if all(torch.equal(a, p) for a, p in zip(before, model.parameters())):
        raise AssertionError("update 1 of the double buffer changed nothing")
    if counts != [1, 2, 1]:
        raise AssertionError(f"cast launches by update 0, update 1 and the "
                             f"drain: {counts}, expected [1, 2, 1]")

    others = {}
    for name in ("hierarchical", "two_dimensional"):
        r = train_mnist.main(flags + ["--communicator", name,
                                      "--double-buffering"])["log"][-1]
        if not math.isfinite(r["main/loss"]):
            raise AssertionError(f"{name}: loss {r['main/loss']}")
        others[name] = r
    return res, launches, counts, others


def phase_resnet_fp16(cs, fn):
    """ResNet-50 on the float16 wire with double buffering."""
    from chainermn_tpu_torch.examples import train_imagenet
    cs.reset_launch_counts()
    fn.reset_launch_counts()
    out = train_imagenet.main([
        "--arch", "resnet50", "--communicator", "xla",
        "--allreduce-grad-dtype", "float16", "--double-buffering",
        "--batchsize", str(BATCH), "--iterations", str(STEPS),
        "--dtype", "bfloat16", "--train-size", str(BATCH * STEPS),
        "--seed", "0", "--log-interval", str(STEPS),
        "--warmup-steps", str(WARMUP)])
    launches = cs.cast_scale.launches
    losses = out["losses"]
    if len(losses) != STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"fp16-wire losses not finite: {losses}")
    if launches != 2 * STEPS:
        raise AssertionError(f"cast_scale launched {launches} times in "
                             f"{STEPS} steps, expected {2 * STEPS}")
    for name, n in fn.launch_counts().items():
        if n != 53 * STEPS:
            raise AssertionError(f"{name}: {n} launches in {STEPS} steps")
    return out, launches


def phase_cast_timing(cs, torch, dev, n, size):
    """Both legs of the wire over ResNet-50's packed gradient buffer."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x32 = torch.randn(n, device=dev, generator=gen)
    x16 = x32.half()
    legs = (("f32->f16", x32, torch.float16, 1.0),
            ("f16->f32", x16, torch.float32, 1.0 / size))
    total = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, library_ms=0.0,
                 bound_ms=0.0, bytes=0)
    for name, x, dst, scale in legs:
        t = dict(
            ms=_time(torch, lambda: cs.cast_scale(x, dst, scale), 50, True),
            eager_ms=_time(torch, lambda: cs.cast_scale(x, dst, scale), 50,
                           False),
            plain_ms=_time(torch, lambda: cs.cast_scale_plain(x, dst, scale),
                           20, True),
            library_ms=_time(torch, lambda: x.to(dst), 50, True),
            bytes=cs.cast_scale_bytes(n, x.dtype, dst))
        t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"timing: cast_scale {name} over {n} elements (CUDA graph "
            f"replay): kernel {t['ms']:.4f} ms (eager launch: "
            f"{t['eager_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, library "
            f"(x.to(dst)) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms (bytes: {t['bytes']} B)")
        for k in total:
            total[k] += t[k]
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import importlib
    fn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    import triton

    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton "
        f"{triton.__version__}, python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    errs = phase_kernels(fn, torch, dev)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s, max abs err "
        f"{json.dumps(errs)}")

    t0 = time.perf_counter()
    grads = grad_counts(torch, dev)
    cast_err, cases = phase_cast(cs, torch, dev, grads)
    log(f"phase cast: {time.perf_counter() - t0:.1f} s; {cases} cases "
        f"bit-exact against cast_scale_plain (packed gradient counts "
        f"{json.dumps(grads)})")

    t0 = time.perf_counter()
    out, counts = phase_slice(fn)
    prof = out["profile"]
    if not prof["device_ms_per_step"]:
        prof = "not measured (the profiler saw no device time)"
    log(f"phase slice: {time.perf_counter() - t0:.1f} s; losses "
        f"{out['losses']}; launches {json.dumps(counts)} "
        f"(53 x {STEPS + PROFILED} each); images/sec (steps "
        f"{WARMUP + 1}..{STEPS}) {out['images_per_sec']:.1f} on {gpu}; "
        f"profile of {PROFILED} more steps: {json.dumps(prof)}")

    t0 = time.perf_counter()
    times = phase_timing(fn, torch, dev)
    log(f"phase timing: {time.perf_counter() - t0:.1f} s")

    from chainermn_tpu_torch.communicators import create_communicator
    t0 = time.perf_counter()
    phase_f32(fn, torch, dev, create_communicator("xla"))
    log(f"phase f32: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    mnist, mnist_casts, db_casts, others = phase_mnist(cs, torch, dev)
    rec = mnist["log"][-1]
    log(f"phase mnist: {time.perf_counter() - t0:.1f} s; xla + float16 "
        f"wire + double buffering, 1 epoch of {rec['iteration']} "
        f"iterations: cast_scale launches {mnist_casts} (2 per iteration), "
        f"{json.dumps(rec)}; direct drive: update 0 left every parameter "
        f"unchanged, cast launches by update 0 / update 1 / drain "
        f"{db_casts}; hierarchical {json.dumps(others['hierarchical'])}; "
        f"two_dimensional {json.dumps(others['two_dimensional'])} on {gpu}")

    t0 = time.perf_counter()
    fp16, fp16_casts = phase_resnet_fp16(cs, fn)
    log(f"phase resnet fp16: {time.perf_counter() - t0:.1f} s; losses "
        f"{fp16['losses']}; cast_scale launches {fp16_casts} (2 x {STEPS}); "
        f"images/sec (steps {WARMUP + 1}..{STEPS}): float16 wire + double "
        f"buffering {fp16['images_per_sec']:.1f}, phase 3 (float32 wire) "
        f"{out['images_per_sec']:.1f} on {gpu}")

    import torch.distributed as dist
    t0 = time.perf_counter()
    cast_t = phase_cast_timing(cs, torch, dev, grads["ResNet"],
                               dist.get_world_size())
    log(f"phase cast timing: {time.perf_counter() - t0:.1f} s; both legs: "
        f"{json.dumps(cast_t)}")

    dist.destroy_process_group()
    kernels = []
    for wrapper, (name, replaces, _, _) in KERNELS.items():
        t = times[wrapper]
        kernels.append({
            "name": name, "route": "triton", "source": SOURCE,
            "replaces": replaces, "launches": counts[wrapper],
            "max_abs_err": errs[wrapper], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    kernels.append({
        "name": "cast_scale", "route": "cuda",
        "source": "chainermn_tpu_torch/csrc/cast_scale.cu",
        "replaces": "chainermn_tpu/ops/cast_scale.py:33",
        "launches": mnist_casts, "max_abs_err": cast_err,
        "ms": cast_t["ms"], "plain_ms": cast_t["plain_ms"],
        "bound_ms": cast_t["bound_ms"], "bound_by": "bytes",
        "library_ms": cast_t["library_ms"]})
    log("kernels: " + ", ".join(k["name"] for k in kernels))
    log(json.dumps({"kernels": kernels}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
