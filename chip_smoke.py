#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. environment: the card's name and power limit (nvidia-smi), the torch,
   CUDA and Triton versions, and the card's rates from
   ``chainermn_tpu_torch.utils.gpu_info`` that every bound below uses
   (``peak_assumed=True`` when the card is not in its table);
2. kernels: each kernel of ``chainermn_tpu_torch.ops.fused_norm`` (the
   Triton apply and dx passes, built into ``build/triton`` on first use,
   and the two CUDA reductions -- the statistics ``cmn_bn_stats``, one
   cooperative launch fed by bulk copies with its finalize behind a grid
   barrier, and the backward ``cmn_bn_bwd_reduce`` -- built with nvcc into
   ``build/cuda`` at the start) against its plain PyTorch version, at
   ResNet-50 batch-32 boundary shapes and one ragged row count, in
   bfloat16 and float32, then at the 12 distinct shapes of the bench's 53
   boundaries (batch 256, phase 16: [3211264, 64] down to [12544, 2048])
   in bfloat16; train/eval, ReLU on/off; then the statistics' edges: C 13,
   100, 2050 and 4104 (channel tiles), R 1 and 7, fp16, a view one element
   into its buffer (the scalar path), each within rtol/atol 1e-4 of
   ``stats_plain``, and data of mean 100 and standard deviation 1 against
   a float64 reference (mean within 1e-5 relative; var within 1e-5 of
   mean(x^2), the fast variance's cancellation);
3. the slice: ``python -m chainermn_tpu_torch.examples.train_imagenet``'s
   ``main`` -- an NCCL world of one, ``create_communicator("xla")``,
   ResNet-50 at full width (224x224, batch 32, bfloat16, random weights
   from seed 0) on synthetic data, SGD momentum through
   ``create_multi_node_optimizer`` and ``StatefulUpdater`` -- for
   ``STEPS`` steps (images/sec over those after ``WARMUP``), then
   ``PROFILED`` more under ``torch.profiler`` (device time by category,
   which must hold the CUDA statistics kernel's);
   every kernel's launch count must be 53 per step;
4. timing: each BatchNorm kernel (the CUDA statistics and reduction, the
   Triton apply and dx) over the 53 boundaries of one bfloat16 step, at
   batch 32 (phase 3's) and at the bench's batch 256 (phase 16's),
   captured into a CUDA graph and replayed between CUDA events (device
   time; the eager time with the host's launch path is printed too),
   beside its plain version, one PyTorch library call and the least time
   the card could take (bytes over its memory rate, or float32 operations
   over its float32 peak, whichever is larger: 3.35 TB/s and 66.9 TFLOP/s
   on an H100 SXM);
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
   bytes over the card's memory rate);
10. flash kernels: the three CUDA kernels of
    ``chainermn_tpu_torch.ops.flash_attention`` (built with nvcc into
    ``build/cuda`` at the start, beside the cast kernel, one nvcc each,
    started together) against their plain versions.  Which kernel runs is
    set by dtype and head dim: bf16/fp16 at D 64 and 128 take the wgmma
    kernels fed by TMA (``fwd_wgmma_kernel``, ``dkv_wgmma_kernel``,
    ``dq_wgmma_kernel``), at D 16 and 32 the mma.sync kernels; float32
    takes the CUDA-core kernels.  The build prints ptxas's registers and
    spills of the wgmma kernels (flash and probe), the probe's span sum
    and the two BatchNorm reductions (statistics and backward).
    Cases: bfloat16 at the LM's attention shape (B 1, T 8192, H 16, D 128,
    causal), then GQA (Hkv 4 and 1), non-causal, Tq != Tkv, T 100, segment
    ids with a padding id (empty rows give 0 and lse 1e30), dropout 0.1
    (the kernel's mask read out exactly and held to the plain
    ``_keep_mask``), scalar and [B] offsets with a glse cotangent, fp16 and
    float32, D 16/32/64/128, and the wgmma kernels' edges: T 1000 (no tile
    divides it), a Tq 1 decode row with [B] offsets over Tk 4096, a GQA
    group of 8, q/k/v as views of one qkv projection, fp16 at D 64, and
    the first three of them in float32 (the CUDA-core kernels); relative
    L2 errors within 1e-5 (float32) and 1e-2 (bf16/fp16); then each kernel
    launched twice on the same inputs must give the same bits (bf16 D 128
    GQA, fp16 D 64, bf16 D 32, float32 D 128 GQA and D 32).  The build
    fails the phase if the float32 forward or dK/dV spills at D 128;
11. the LM slice: an NCCL world of one, TransformerLM at full width
    (vocab 32768, d_model 2048, 8 layers, 16 heads, T 8192, batch 1, bf16
    compute over float32 parameters, random weights from seed 0: 553.9 M
    parameters) through ``create_communicator("xla",
    allreduce_grad_dtype=torch.bfloat16)`` ->
    ``create_multi_node_optimizer(SGD momentum, double_buffering=True)`` ->
    ``make_train_step`` for ``LM_STEPS`` steps on ``RandomState(0)``
    tokens: finite losses from about ln 32768, 24 flash launches (3 x 8
    layers) and 2 cast launches a step; tokens/sec over the steps after
    ``LM_WARMUP``; ``LM_PROFILED`` more under ``torch.profiler``; then
    ``examples.train_lm`` at its defaults with ``--attention flash``
    (float32, D 16) for ``EXAMPLE_STEPS`` steps, whose loss must fall;
12. float32 agreement: the LM at full width with 2 layers and T 2048, TF32
    off, one loss and gradient with the kernels and one with
    ``attention_impl="xla"`` from the same weights: loss relative 1e-4,
    every gradient relative L2 1e-3;
13. flash timing at the LM's shape (q/k/v views of one qkv projection):
    each kernel by CUDA-graph replay, eagerly, its plain version, the bound
    (matrix-product FLOPs over the card's bf16 peak, 989.4 TFLOP/s on an
    H100 SXM, or bytes over its memory rate, whichever is larger) and
    PyTorch's ``scaled_dot_product_attention`` (forward; its autograd
    backward beside dK/dV + dQ); each kernel's
    TFLOP/s, and its time against the mma.sync design's
    (``FLASH_MMA_SYNC_MS``: every kernel now runs the wgmma design at the
    LM's shape); then the float32 variant of each kernel (the CUDA-core
    kernels that ``ring_flash`` runs in the float32 long-context example)
    at the same shape with TF32 off: graph replay, its plain version,
    ``scaled_dot_product_attention`` in float32 and the bound at the card's
    float32 peak outside the tensor cores (66.9 TFLOP/s on an H100 SXM),
    each also against its first CUDA-core design's time
    (``FLASH_F32_CUDA_CORE_MS``);
14. probe kernels: the two CUDA kernels of
    ``chainermn_tpu_torch.ops.probe_matmul`` (persistent, TMA-fed wgmma:
    wgrad with its span sum, rowblock with its TMA-store epilogue) against
    their plain versions at the probe's shapes (M = 802,816: wgrad
    [256, M] @ [M, 64], rowblock (k, n) = (64, 256) and (256, 64)) for
    every bm of the sweep, bm = M and bm 256, and at M with fewer 64-row
    tiles than the kernels' 132 spans and with a ragged split: wgrad
    within a relative L2 error of 2e-5, rowblock 99% equal bit for bit and
    every element within one bf16 ulp plus the float32 sums' rounding
    bound; every bm gives the same bits; a bm that does not divide M
    raises; views at storage offsets 8 and 1 give the tensor's own bits;
    two launches give the same bits;
15. the probe: ``python -m chainermn_tpu_torch.benchmarks.bench_conv_probe``'s
    ``main`` at its defaults prints its document (library, kernel sweep,
    bound and TFLOP/s of each case; the two cuDNN convolutions); every
    bm's kernel launched once for the check, twice to warm up and 5 + 5
    times in each profiler capture (its warm-up step and the timed one;
    ``utils.trace.device_time`` captures again when one lost kernels);
16. the bench: ``python -m chainermn_tpu_torch.benchmarks.bench``'s
    ``main`` at its card defaults (ResNet-50, batch 256, the bf16 wire,
    double buffering, 20 steps after 5) prints its line (images/sec per
    GPU, MFU, step and device ms); 53 launches of each BatchNorm kernel
    and 2 casts a step over its 26 steps and 3 + 3 a capture; its peak
    memory;
17. probe timing: each case at every bm by CUDA-graph replay, eagerly, its
    plain version, ``torch.mm`` with the output type (library) and the
    bound, and against the mma.sync design's time at that bm
    (``PROBE_MMA_SYNC_MS``);
18. summary: a ``{"kernels": [...]}`` line with all ten kernels (the
    BatchNorm rows at batch 32 -- the statistics now the cooperative CUDA
    kernel, route "cuda"; the rowblock row sums dgrad and fwd1x1 at their
    best bm; the kernel list marks the kernels redesigned since their first
    port), the nvidia-smi
    line, then ``{"ok": true, "device": {...}}`` as the last line;
19. the data-parallel slice, completed (run before the summary is
    printed): ``examples.train_imagenet``'s ``main`` on the NCCL world of
    one, ResNet-50 at full width (224x224, batch 32, bf16, seed 0,
    synthetic data) with ``--zero --allreduce-grad-dtype bfloat16
    --optimizer momentum --warmup-epochs 0.5``, ``P19_STEPS`` iterations
    over epochs of ``P19_EPOCH`` (the evaluator, ``AllreducePersistent``
    and the log fire at each epoch end) with ``--checkpoint`` into a
    directory under ``build/`` (removed afterwards) every ``P19_FREQ``
    iterations: finite losses; 53 launches a step of the statistics,
    backward-reduction and dx kernels, 53 a step plus 53 a validation
    batch of apply, and 2 casts a step (ZeRO-1's wire: the cast in and the
    cast back); images/sec beside phase 3's, the peak memory and the ms
    of each save, printed.  A second ``main`` call resumes from the
    mid-run snapshot (copied into a fresh directory) and runs to the same
    end: its parameters, BatchNorm buffers and optimizer shards equal the
    uninterrupted run's bit for bit (cuDNN deterministic, benchmark off).
    Then one float32 step (TF32 off) of ResNet-50 from the same
    ``weights.py``-converted weights with ``zero=True`` and with the plain
    optimizer, for SGD momentum and for Adam: the parameters are equal bit
    for bit (on a world of one ZeRO-1 is the same elementwise update on a
    flat view);
20. the sequence-parallel slice (run after phase 19, before the summary),
    float32 with TF32 off, on the NCCL world of one (a ring of one rank):
    (a) ``examples.train_lm``'s ``main`` at phase 11's width (vocab 32768,
    d_model 2048, 8 layers, 16 heads, T 8192, batch 1, seed 0) for
    ``P20_STEPS`` Adam steps with ``--attention ring_flash`` and with
    ``--attention flash``: the losses within 1e-4 relative and every
    gradient of step 0 within a relative L2 error of 1e-3 (phase 12's
    gates); the flash launches of the ring_flash run exactly 2 L P forward
    and L P each of dK/dV and dQ a step (L 8 layers, P 1 rank: the fold is
    rematerialised in the backward pass); tokens/sec and peak memory of
    both.  (b) q/k/v at the LM's attention shape (B 1, T 8192, H 16, D 128,
    causal) split into ``P20_BLOCKS`` blocks of 2048 and folded with
    ``parallel.sequence.ring_flash_block`` with the offsets and merge a
    4-rank ring would use (nonzero offsets, fully masked blocks, the lse's
    cotangent into dK/dV and dQ), in bf16 and float32, against the plain
    versions of the flash kernels over the whole sequence (plain PyTorch:
    no CUDA kernel on that side) and against ``flash_attention`` over the
    whole sequence: output and q/k/v gradients within phase 10's relative
    L2 limits for both.  (c) ``ring`` and
    ``ulysses`` at ``P20_LAYERS_C`` layers (their plain attention keeps
    16 x 8192^2 float32 scores a layer) against ``flash`` at the same
    depth, with (a)'s gates;
21. the model-parallel slice (after phase 20, before the summary), float32
    with TF32 off for cuBLAS and cuDNN (whose LSTM takes TF32 by default),
    on the NCCL world of one, both stages on the card: (a)
    ``examples.seq2seq``'s ``main`` at its defaults (5 epochs of the
    synthetic copy-reverse corpus): the loss falls from epoch 1 to the
    last, ``val_bleu`` is printed; tokens/sec over the steps after the
    first, the median step and the peak memory.  (b) One step of the
    ``MultiNodeChainList`` (the in-process channel) against
    ``decoder(encoder(src, src_len), tgt_in)`` composed directly from the
    same weights: the loss and every gradient equal bit for bit (the
    direct composition is also run twice, to show the determinism this
    rests on).  (c) The wide run ``S2S_WIDE`` (hidden and embedding 1024,
    vocabulary 32000, sentences up to 48, 16,384 pairs, batch 128, one
    epoch): (a)'s numbers, then ``S2S_PROFILED`` more steps on one batch
    of a middle length under ``torch.profiler``: wall and device ms a
    step, the device's busy share, device ms by category
    (``S2S_CATEGORIES``).
22. the repeat loops (after phase 21, before the summary), for the
    intermittent faults of ROADMAP.md Queue C 12 and 13: ``C12_LOOPS``
    passes of the flash autograd check (the test
    ``tests/test_torch_kernels_gpu.py::test_flash_attention_autograd_on_the_card``
    in a loop, the precision flags checked at each pass's start; see
    ``phase_c12``), every pass within the test's 1e-5 and both sides'
    bits the first pass's; then ``WGRAD_LOOPS`` launches of phase 14's
    probe wgrad on one input, every result the first's bits.

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
SOURCE = "chainermn_tpu_torch/ops/fused_norm.py"
BN_CUDA_SOURCE = "chainermn_tpu_torch/csrc/fused_norm.cu"
# wrapper -> (JSON name, TPU kernel it replaces, its pass in the traffic
# model, float32 operations per element counted from the kernel body,
# route, source)
KERNELS = {
    "stats_call": ("fused_norm.stats", "chainermn_tpu/ops/fused_norm.py:78",
                   "fwd_stats", 3, "cuda", BN_CUDA_SOURCE),
    "apply_call": ("fused_norm.apply", "chainermn_tpu/ops/fused_norm.py:97",
                   "fwd_apply", 4, "triton", SOURCE),
    "bwd_reduce_call": ("fused_norm.bwd_reduce",
                        "chainermn_tpu/ops/fused_norm.py:119", "bwd_reduce",
                        9, "cuda", BN_CUDA_SOURCE),
    "bwd_dx_call": ("fused_norm.bwd_dx",
                    "chainermn_tpu/ops/fused_norm.py:140", "bwd_dx", 11,
                    "triton", SOURCE),
}
BENCH_BATCH = 256    # the bench's batch (phase 16), timed in phase 4 too
LM = dict(vocab=32768, d_model=2048, n_layers=8, n_heads=16, max_len=8192)
LM_T = 8192
LM_STEPS = 8         # LM steps; tokens/sec over those after LM_WARMUP
LM_WARMUP = 3
LM_PROFILED = 2
EXAMPLE_STEPS = 10
FLASH_SOURCE = "chainermn_tpu_torch/csrc/flash_attention.cu"
# wrapper -> (JSON name, TPU kernel it replaces, kind for the work counts)
FLASH = {
    "flash_fwd": ("flash.fwd", "chainermn_tpu/ops/flash_attention.py:136",
                  "fwd"),
    "flash_bwd_dkv": ("flash.bwd_dkv",
                      "chainermn_tpu/ops/flash_attention.py:307", "bwd_dkv"),
    "flash_bwd_dq": ("flash.bwd_dq",
                     "chainermn_tpu/ops/flash_attention.py:393", "bwd_dq"),
}
# relative L2 error limits of the flash kernels against their plain
# versions: float32 products agree to rounding; bf16/fp16 kernels round P
# and dS to the input type before their products
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-2}
# CUDA-graph ms of the mma.sync forward, dK/dV and dQ at the LM's
# attention shape, measured by phase 13 of this script on an NVIDIA H100
# 80GB HBM3 at 700 W before each was redesigned with wgmma: the yardstick
# phase 13 prints each kernel's time against
FLASH_MMA_SYNC_MS = {"flash_fwd": 2.2804, "flash_bwd_dkv": 3.6619,
                     "flash_bwd_dq": 2.7811}
# CUDA-graph ms of the float32 forward, dK/dV and dQ at the same shape
# (TF32 off) before their register-blocked redesign: the first CUDA-core
# kernels (32-row tiles staged in shared memory), measured by phase 13 of
# this script on an NVIDIA H100 80GB HBM3 at 700 W; phase 13 prints the
# float32 rows against them
FLASH_F32_CUDA_CORE_MS = {"flash_fwd": 16.6493, "flash_bwd_dkv": 51.3594,
                          "flash_bwd_dq": 22.4158}
# kernels whose ptxas report (registers, spills) the build phase prints
PTXAS_KERNELS = {"flash_attention": ("fwd_wgmma_kernel", "dkv_wgmma_kernel",
                                     "dq_wgmma_kernel", "fwd_f32_kernel",
                                     "dkv_f32_kernel", "dq_f32_kernel"),
                 "fused_norm": ("bn_stats_kernel", "bn_bwd_reduce_kernel"),
                 "probe_matmul": ("wgrad_kernel", "span_sum_kernel",
                                  "rowblock_kernel")}
# marks of a mangled kernel name -> its label's tags, the first that match
# taken out of the name before the next are looked for
PTXAS_TAGS = (("ILi64ELi256E", "dgrad"), ("ILi256ELi64E", "fwd1x1"),
              ("Li64E", "D64"), ("Li128E", "D128"), ("Li16E", "D16"),
              ("Li32E", "D32"), ("Lb1E", "vector"), ("Lb0E", "scalar"))
# the float32 flash kernels that must not spill at D 128 (the build phase
# fails if one does)
F32_NO_SPILL = ("fwd_f32_kernel D128", "dkv_f32_kernel D128",
                "dq_f32_kernel D128")
# kernels redesigned for Hopper since their first port (PERF.md section 6
# says when), marked in the summary's kernel list
REDESIGNED = {"fused_norm.stats", "fused_norm.bwd_reduce", "flash.fwd",
              "flash.bwd_dkv", "flash.bwd_dq", "probe.wgrad",
              "probe.rowblock"}
# the profile category of the CUDA statistics kernel (utils/trace.py)
STATS_CATEGORY = "fused_norm stats (CUDA)"
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


def ptxas_registers(lines, kernels):
    """``{label: (registers, spill store bytes, spill load bytes)}`` of
    every instance of ``kernels`` in ptxas -v output ``lines``; the label
    names the kernel, its type where it has one, and its head dim, path or
    probe case (``PTXAS_TAGS``) from the mangled name."""
    out, cur = {}, None
    for line in lines:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = None
            for kern in kernels:
                if kern in name:
                    tags = [kern] + [dt for mark, dt in (
                        ("bfloat16", "bf16"), ("__half", "fp16"),
                        ("IfL", "f32")) if mark in name][:1]
                    rest = name
                    for mark, tag in PTXAS_TAGS:
                        if mark in rest:
                            tags.append(tag)
                            rest = rest.replace(mark, "")
                    cur = " ".join(tags)
        elif cur and "spill stores" in line:
            w = line.split()
            out.setdefault(cur, [0, 0, 0])[1:] = [int(w[w.index("spill") - 2]),
                                                  int(w[-4])]
        elif cur and "Used" in line and "registers" in line:
            w = line.split()
            out.setdefault(cur, [0, 0, 0])[0] = int(w[w.index("registers,")
                                                      - 1])
    return {k: tuple(v) for k, v in sorted(out.items())}


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


def bn_shapes(fn, batch):
    """The distinct [R, C] of ResNet-50's 53 BN boundaries at ``batch``."""
    return sorted({(n * h * w, c) for _, (n, h, w, c), _ in
                   fn.resnet_bn_boundaries(batch)}, reverse=True)


def phase_kernels(fn, torch, dev, shapes, dtypes, errs):
    """Every kernel against its plain version at each [R, C] of ``shapes``
    in each of ``dtypes``; keeps the max abs errors in ``errs``."""
    gen = torch.Generator(device=dev).manual_seed(1)
    for r, c in shapes:
        for dt in dtypes:
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
        log(f"kernels: [{r}, {c}] "
            f"{'+'.join(str(dt).split('.')[1] for dt in dtypes)} within "
            "tolerance")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_stats_edges(fn, torch, dev, errs):
    """The statistics kernel at its edges: C not a multiple of 8 and C of
    several channel tiles, R 1 and 7, fp16, a view one element into its
    buffer (the scalar path), against ``stats_plain``; then data of mean
    100 and standard deviation 1 against a float64 reference, where the
    fast variance's cancellation leaves an absolute error of a few float32
    roundings of mean(x^2)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = [(r, c, dt) for r, c in ((1, 64), (7, 13), (7, 4104), (1, 1),
                                     (12547, 100), (1001, 2050),
                                     (300, 4104))
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(100352, 256, torch.float16), (6272, 1024, torch.float16)]
    for r, c, dt in cases:
        x = (torch.randn((r, c), device=dev, generator=gen) * 1.5
             + 0.3).to(dt)
        buf = torch.empty(r * c + 1, dtype=dt, device=dev)
        off = buf[1:].view(r, c)   # contiguous, off the 16-byte grid
        off.copy_(x)
        want = fn.stats_plain(x)
        for view in (x, off):
            for got, w in zip(fn.stats_call(view), want):
                check("stats_call", got, w, 1e-4, 1e-4, errs)
    worst = [0.0, 0.0]
    for dt in (torch.bfloat16, torch.float32):
        x = (torch.randn((100352, 256), device=dev, generator=gen)
             + 100.0).to(dt)
        x64 = x.double()
        m64, v64 = x64.mean(0), x64.var(0, correction=0)
        mean, var = fn.stats_call(x)
        rel_m = float(((mean.double() - m64).abs() / m64.abs()).max())
        rel_v = float(((var.double() - v64).abs()
                       / (x64 * x64).mean(0)).max())
        if not (rel_m <= 1e-5 and rel_v <= 1e-5):
            raise AssertionError(f"stats_call at mean 100 ({dt}): mean rel "
                                 f"{rel_m:.3g}, var err / mean(x^2) "
                                 f"{rel_v:.3g} (limits 1e-5)")
        worst = [max(worst[0], rel_m), max(worst[1], rel_v)]
    torch.cuda.synchronize()
    log(f"kernels: stats_call edges ({len(cases)} shapes x aligned and "
        f"offset views) within tolerance; mean 100: mean rel "
        f"{worst[0]:.3g}, var err / mean(x^2) {worst[1]:.3g}")


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
        "--profile-steps", str(PROFILED), "--val-size", "0"])
    counts = fn.launch_counts()
    losses = out["losses"]
    cats = out["profile"]["device_ms_by_category"]
    if not cats.get(STATS_CATEGORY):
        raise AssertionError(f"the profile holds no {STATS_CATEGORY} time: "
                             f"{cats}")
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


def phase_timing(fn, torch, dev, card, batch):
    """Each kernel over one bf16 step's 53 boundaries at ``batch``: kernel,
    plain, library ms, and the bound on ``card`` (its ``gpu_info``
    rates)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for name, shape, relu in fn.resnet_bn_boundaries(batch):
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
        pass_name, ops_per_el = KERNELS[wrapper][2:4]
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
        bytes_ms = nbytes / card.hbm_bytes_per_s * 1e3
        ops_ms = ops / (card.f32_tflops * 1e12) * 1e3
        out[wrapper] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=max(bytes_ms, ops_ms),
                            bound_by="bytes" if bytes_ms >= ops_ms
                            else "operations", bytes=nbytes, ops=ops)
        log(f"timing: {wrapper} over 53 boundaries at batch {batch} (CUDA "
            f"graph replay): "
            f"kernel {ms:.4f} ms (eager launches: {eager_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, library ({LIBRARY[wrapper]}) "
            f"{library_ms:.4f} ms, bound {out[wrapper]['bound_ms']:.4f} ms "
            f"({out[wrapper]['bound_by']}: {nbytes} B, {ops} ops)")
    del cases
    torch.cuda.empty_cache()
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
        "--warmup-steps", str(WARMUP), "--val-size", "0"])
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


def phase_cast_timing(cs, torch, dev, n, size, card):
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
        t["bound_ms"] = t["bytes"] / card.hbm_bytes_per_s * 1e3
        log(f"timing: cast_scale {name} over {n} elements (CUDA graph "
            f"replay): kernel {t['ms']:.4f} ms (eager launch: "
            f"{t['eager_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, library "
            f"(x.to(dst)) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms (bytes: {t['bytes']} B)")
        for k in total:
            total[k] += t[k]
    return total


def start_cuda_builds():
    """Start building every CUDA source of the port, one nvcc each, all at
    once, in the background; returns ``{source name: future}``."""
    from concurrent.futures import ThreadPoolExecutor
    from chainermn_tpu_torch.ops import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    ex = ThreadPoolExecutor(len(names))
    builds = {n: ex.submit(_build.load_library, n) for n in names}
    ex.shutdown(wait=False)
    return builds


def _rel(torch, got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def flash_case(fa, torch, dev, dtype, b, tq, tk, h, hk, d, causal, seg=False,
               rate=0.0, offs=None, glse=False, seed=0, qkv=False):
    """The three kernels and their plain versions on one case; returns
    ``{wrapper: (max abs error, worst relative L2 error)}``.  With ``qkv``
    (Tq == Tk, H == Hkv) q, k and v are views of one ``[B, T, 3 H D]``
    projection, as the model gives them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    if qkv:
        x = (mk(b, tq, 3 * h * d) * 0.5).to(dtype)
        q, k, v = (x[..., i * h * d:(i + 1) * h * d].view(b, tq, h, d)
                   for i in range(3))
    else:
        q = (mk(b, tq, h, d) * 0.5).to(dtype)
        k = (mk(b, tk, hk, d) * 0.5).to(dtype)
        v = mk(b, tk, hk, d).to(dtype)
    g = mk(b, tq, h, d).to(dtype)
    kw = dict(seed=1234 + seed, rate=rate)
    if seg:
        ids = lambda t: torch.randint(0, 3, (b, t), generator=gen,  # noqa
                                      device=dev, dtype=torch.int32)
        kw["qseg"], kw["kseg"] = ids(tq), ids(tk)
        kw["qseg"][0, :7] = 9  # a padding id that matches no key
    if offs == "scalar":
        kw["offs"] = torch.tensor([[5, 3]], device=dev,
                                  dtype=torch.int32).expand(b, 2)
    elif offs == "vector":
        kw["offs"] = torch.stack([torch.arange(b, device=dev) * 7,
                                  torch.arange(b, device=dev).flip(0) * 5],
                                 1).to(torch.int32)
    elif offs == "decode":  # each row a next token after Tk - 100 i keys
        kw["offs"] = torch.stack([tk - 1 - 100 * torch.arange(b, device=dev),
                                  torch.zeros(b, device=dev)],
                                 1).to(torch.int32)
    gl = mk(b, h, tq) if glse else None
    out_k, lse_k = fa.flash_fwd(q, k, v, causal, **kw)
    out_p, lse_p = fa.flash_forward_plain(q, k, v, causal, **kw)
    empty = lse_p >= 1e30
    if not torch.equal(lse_k >= 1e30, empty):
        raise AssertionError("flash_fwd: empty rows differ from the plain "
                             "version's")
    if seg and not (bool((out_k[0, :7] == 0).all())):
        raise AssertionError("flash_fwd: a padding row's output is not 0")
    delta = (g.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    dk_k, dv_k = fa.flash_bwd_dkv(q, k, v, g, lse_p, delta, gl, causal, **kw)
    dq_k = fa.flash_bwd_dq(q, k, v, g, lse_p, delta, gl, causal, **kw)
    dq_p, dk_p, dv_p = fa.flash_backward_plain(q, k, v, g, lse_p, delta, gl,
                                               causal, block_k=1024, **kw)
    torch.cuda.synchronize()
    pairs = {"flash_fwd": [(out_k, out_p), (lse_k[~empty], lse_p[~empty])],
             "flash_bwd_dkv": [(dk_k, dk_p), (dv_k, dv_p)],
             "flash_bwd_dq": [(dq_k, dq_p)]}
    res = {}
    for w, ps in pairs.items():
        ps = [(a, b_) for a, b_ in ps if b_.numel()]
        res[w] = (max(float((a.float() - b_.float()).abs().max())
                      for a, b_ in ps),
                  max(_rel(torch, a, b_) for a, b_ in ps))
    return res


def flash_repeat(fa, torch, dev):
    """Each flash kernel launched twice on the same inputs, at a bf16 D 128
    GQA shape and an fp16 D 64 one (the wgmma kernels), a bf16 D 32 one
    (mma.sync) and float32 D 128 GQA and D 32 ones (the CUDA-core kernels);
    returns ``{wrapper: True if both launches gave the same bits}``.  No
    kernel uses atomics: one block writes each output tile."""
    same = {w: True for w in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    for dtype, d in ((torch.bfloat16, 128), (torch.float16, 64),
                     (torch.bfloat16, 32), (torch.float32, 128),
                     (torch.float32, 32)):
        gen = torch.Generator(device=dev).manual_seed(d)
        mk = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                    device=dev).to(dtype)
        q, g = mk(2, 700, 8, d), mk(2, 700, 8, d)
        k, v = mk(2, 700, 2, d), mk(2, 700, 2, d)
        runs = []
        for _ in range(2):
            out, lse = fa.flash_fwd(q, k, v, True)
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
            bwd = (q, k, v, g, lse, delta, None, True)
            runs.append({"flash_fwd": (out, lse),
                         "flash_bwd_dkv": fa.flash_bwd_dkv(*bwd),
                         "flash_bwd_dq": (fa.flash_bwd_dq(*bwd),)})
        for w in same:
            same[w] &= all(torch.equal(a, b) for a, b in
                           zip(runs[0][w], runs[1][w]))
    return same


def flash_keep_grid(fa, torch, dev, b=2, h=4, t=256, rate=0.1, seed=77):
    """The forward kernel's dropout mask read out exactly (float32, q = 0:
    weight 1/16 on each of 16 keys; v = I: output column j is key j's
    dropped weight), its window walked over ``t`` key positions by kv
    offsets; returns the kernel's mask and the plain ``_keep_mask``."""
    d = 16
    q = torch.zeros(b, t, h, d, device=dev)
    v = torch.eye(d, device=dev).view(1, d, 1, d).expand(b, d, h, d)
    got = []
    for c in range(0, t, d):
        offs = torch.tensor([[0, c]] * b, device=dev, dtype=torch.int32)
        out, _ = fa.flash_fwd(q, q[:, :d], v.contiguous(), False, offs=offs,
                              seed=seed, rate=rate)
        got.append(out.permute(0, 2, 1, 3) > 0)
    bh = torch.arange(b * h, device=dev).view(b, h, 1, 1)
    pos = torch.arange(t, device=dev)
    want = fa._keep_mask(seed, bh, pos.view(1, 1, t, 1),
                         pos.view(1, 1, 1, t), rate)
    return torch.cat(got, dim=-1), want


def phase_flash(fa, torch, dev):
    """Every flash kernel against its plain version; returns the largest
    max-abs error per wrapper and the case lines printed."""
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # (name, dtype, B, Tq, Tk, H, Hk, D, causal, extras)
        ("lm_shape", bf, 1, LM_T, LM_T, 16, 16, 128, True, {}),
        ("gqa4", bf, 2, 512, 512, 16, 4, 128, True, {}),
        ("mqa_noncausal", bf, 2, 256, 256, 8, 1, 64, False, {}),
        ("cross_tq100_tk160", bf, 2, 100, 160, 4, 4, 64, False, {}),
        ("t100_f16", f16, 2, 100, 100, 4, 2, 128, True, {}),
        ("segments_padding", bf, 2, 256, 256, 8, 8, 64, True, {"seg": True}),
        ("dropout", bf, 2, 256, 256, 8, 4, 64, True, {"rate": 0.1}),
        ("offsets_scalar_glse", bf, 2, 96, 128, 4, 4, 32, True,
         {"offs": "scalar", "glse": True}),
        ("offsets_vector_glse_f32", f32, 2, 96, 128, 4, 4, 32, True,
         {"offs": "vector", "glse": True}),
        ("f16_d16_dropout", f16, 2, 130, 130, 8, 2, 16, False, {"rate": 0.1}),
        ("f32_d16", f32, 2, 200, 200, 8, 8, 16, True, {}),
        ("f32_d64", f32, 2, 256, 256, 4, 4, 64, False, {}),
        ("f32_d128_everything", f32, 1, 160, 160, 4, 2, 128, True,
         {"seg": True, "rate": 0.2, "glse": True}),
        # the edges of the wgmma kernels (D 64/128, bf16/fp16): a T no tile
        # divides, a decode shape, a GQA group of 8, the qkv-split views
        # (T stride 3 H D) and fp16 at D 64
        ("t1000_causal_d128", bf, 1, 1000, 1000, 8, 8, 128, True, {}),
        ("decode_tq1_tk4096", bf, 2, 1, 4096, 16, 4, 128, True,
         {"offs": "decode"}),
        ("gqa8_d128", bf, 2, 512, 512, 16, 2, 128, True, {}),
        ("qkv_views_d128", bf, 2, 640, 640, 8, 8, 128, True, {"qkv": True}),
        ("f16_d64", f16, 2, 300, 300, 8, 4, 64, True, {"glse": True}),
        # the same edges for the float32 CUDA-core kernels
        ("t1000_causal_d128_f32", f32, 1, 1000, 1000, 8, 8, 128, True, {}),
        ("decode_tq1_tk4096_f32", f32, 2, 1, 4096, 16, 4, 128, True,
         {"offs": "decode"}),
        ("gqa8_d128_f32", f32, 2, 512, 512, 16, 2, 128, True, {}),
    ]
    errs = {w: 0.0 for w in FLASH}
    for i, (name, dt, b, tq, tk, h, hk, d, causal, extra) in enumerate(cases):
        res = flash_case(fa, torch, dev, dt, b, tq, tk, h, hk, d, causal,
                         seed=i, **extra)
        tol = FLASH_TOL[str(dt).split(".")[1]]
        log(f"flash {name}: {str(dt).split('.')[1]} B{b} Tq{tq} Tk{tk} H{h} "
            f"Hkv{hk} D{d} causal={causal} {extra}: " + ", ".join(
                f"{w} max abs {a:.3g} rel L2 {r:.3g}"
                for w, (a, r) in res.items()) + f" (tol {tol})")
        for w, (a, r) in res.items():
            if not r <= tol:
                raise AssertionError(f"{w} {name}: relative L2 error {r:.3g}"
                                     f" over {tol}")
            errs[w] = max(errs[w], a)
    got, want = flash_keep_grid(fa, torch, dev)
    if not torch.equal(got, want):
        raise AssertionError(f"flash_fwd: dropout mask differs from "
                             f"_keep_mask at {int((got != want).sum())} of "
                             f"{want.numel()} positions")
    log(f"flash dropout mask: {want.numel()} (b, h, q, k) positions equal to "
        f"_keep_mask (keep share {float(want.float().mean()):.4f} at rate "
        f"0.1)")
    same = flash_repeat(fa, torch, dev)
    if not all(same.values()):
        raise AssertionError(f"flash kernels: two launches on the same "
                             f"inputs differ: {same}")
    log("flash repeat: two launches of each kernel gave the same bits (bf16 "
        "D 128 GQA, fp16 D 64, bf16 D 32, float32 D 128 GQA and D 32)")
    torch.cuda.empty_cache()
    return errs


LM_CATEGORIES = (
    ("flash (CUDA)", ("fwd_wgmma_kernel", "dkv_wgmma_kernel",
                      "dq_wgmma_kernel", "fwd_tc_kernel", "dkv_tc_kernel",
                      "dq_tc_kernel", "_f32_kernel")),
    ("cast_scale (CUDA)", ("cast_scale",)),
    ("nccl", ("nccl",)),
    ("memcpy / memset", ("memcpy", "memset")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
)


def phase_lm(fa, cs, torch, dev):
    """TransformerLM at full width through the data-parallel step."""
    import numpy as np
    import torch.distributed as dist
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     make_train_step)
    from chainermn_tpu_torch.examples.train_imagenet import profile_steps
    from chainermn_tpu_torch.examples.train_lm import lm_loss
    from chainermn_tpu_torch.models import TransformerLM
    comm = create_communicator("xla", allreduce_grad_dtype=torch.bfloat16)
    if (dist.get_backend(), comm.size) != ("nccl", 1):
        raise AssertionError("expected an NCCL world of one")
    model = TransformerLM(**LM, attention_impl="flash", dtype=torch.bfloat16,
                          device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    if round(n_params / 1e6, 1) != 553.9:
        raise AssertionError(f"{n_params} parameters, expected 553.9 M")
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9), comm,
        double_buffering=True)
    step = make_train_step(comm, lambda b: lm_loss(model, b), opt)
    # bench_lm.py's tokens: RandomState(0), [batch * size, T], this rank's
    # rows
    rng = np.random.RandomState(0)
    toks = (rng.rand(comm.size, LM_T) * LM["vocab"]).astype(np.int32)
    toks = torch.from_numpy(toks[comm.rank:comm.rank + 1]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    cs.reset_launch_counts()
    losses, secs = [], []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(toks)))  # the loss read ends the step
        secs.append(time.perf_counter() - t0)
    step.finalize()
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts(), cast_scale=cs.cast_scale.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(map(math.isfinite, losses)) or \
            abs(losses[0] - math.log(LM["vocab"])) > 1.5:
        raise AssertionError(f"LM losses {losses}: not finite, or the first "
                             f"far from ln {LM['vocab']}")
    per_step = {w: n / LM_STEPS for w, n in counts.items()}
    if per_step != {"flash_fwd": 8, "flash_bwd_dkv": 8, "flash_bwd_dq": 8,
                    "cast_scale": 2}:
        raise AssertionError(f"launches per LM step {per_step}: expected 8 "
                             f"of each flash kernel (24) and 2 casts")
    tok_s = LM_T * (LM_STEPS - LM_WARMUP) / sum(secs[LM_WARMUP:])

    class _Steps:  # the updater interface profile_steps drives
        update = staticmethod(lambda: step(toks))
        finalize = staticmethod(step.finalize)

    prof = profile_steps(_Steps, LM_PROFILED, dev, LM_CATEGORIES)
    del model, opt, step
    torch.cuda.empty_cache()
    return dict(losses=losses, step_s=secs, tokens_per_sec=tok_s,
                counts=counts, n_params=n_params, peak_gb=peak_gb,
                profile=prof)


def phase_lm_example(fa):
    """examples.train_lm at its own defaults, --attention flash."""
    from chainermn_tpu_torch.examples import train_lm
    fa.reset_launch_counts()
    out = train_lm.main(["--attention", "flash", "--steps",
                         str(EXAMPLE_STEPS)])
    losses = out["losses"]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_lm losses did not fall: {losses}")
    if fa.flash_fwd.launches != 2 * EXAMPLE_STEPS:
        raise AssertionError(f"train_lm: {fa.launch_counts()} flash launches"
                             f" in {EXAMPLE_STEPS} steps of 2 layers")
    return out


def phase_lm_f32(torch, dev):
    """One float32 loss and gradient of the 2-layer LM at T 2048 with the
    kernels and with attention_impl="xla", from the same weights."""
    import numpy as np
    from chainermn_tpu_torch.examples.train_lm import lm_loss
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.utils.compare import (
        GRAD_RTOL, LOSS_RTOL, step_agrees, step_errors)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(LM, n_layers=2, max_len=2048)
    gen = torch.Generator(device=dev).manual_seed(8)
    rng = np.random.RandomState(1)
    toks = torch.from_numpy((rng.rand(1, 2048) * LM["vocab"]).astype(
        np.int32)).to(dev)
    results = []
    state = None
    for impl in ("flash", "xla"):
        model = TransformerLM(**cfg, attention_impl=impl, device=dev,
                              generator=gen)
        if state is None:
            state = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        loss = lm_loss(model, toks)
        loss.backward()
        results.append((float(loss.detach()), {k: p.grad for k, p in
                                      model.named_parameters()}))
        del model
    (lk, gk), (lp, gp) = results
    loss_rel, grad_rel, worst = step_errors([lk], [lp], gk, gp)
    log(f"LM f32 step (2 layers, T 2048, TF32 off): loss kernels {lk:.7f} "
        f"xla {lp:.7f} (rel {loss_rel:.2e}, tol {LOSS_RTOL}); worst gradient "
        f"relative L2 error {grad_rel:.2e} ({worst}; tol {GRAD_RTOL}) over "
        f"{len(gp)} tensors")
    if not step_agrees(loss_rel, grad_rel):
        raise AssertionError("float32 LM step with the flash kernels "
                             "disagrees with the plain attention")
    del results, gk, gp
    torch.cuda.empty_cache()
    return loss_rel, grad_rel


def phase_flash_timing(fa, torch, dev, card, dtype):
    """Each flash kernel at the LM's attention shape in ``dtype``: kernel
    (CUDA graph replay), eager, plain, library and the bound at the peak of
    ``dtype`` (bf16: the tensor cores; float32, TF32 off: the CUDA cores,
    the ``*_f32_kernel`` variants that ``ring_flash`` runs in the float32
    long-context example)."""
    import torch.nn.functional as F
    from chainermn_tpu_torch.utils.compare import no_tf32
    with no_tf32():
        f32 = dtype == torch.float32
        b, t, h, d = 1, LM_T, LM["n_heads"], LM["d_model"] // LM["n_heads"]
        gen = torch.Generator(device=dev).manual_seed(13 if f32 else 9)
        # q, k, v as the model gives them: views of one qkv projection
        qkv = (torch.randn(b, t, 3 * h * d, device=dev, generator=gen)
               * 0.5).to(dtype)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d)
                   for i in range(3))
        g = torch.randn(b, t, h, d, device=dev, generator=gen).to(dtype)
        out, lse = fa.flash_fwd(q, k, v, True)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        bwd = (q, k, v, g, lse, delta, None, True)
        kern = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*bwd),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd)}
        reps = 5 if f32 else 10
        # the plain backward computes dq, dk and dv in one loop: its time
        # stands beside both backward kernels
        plain_fwd = _time(torch, lambda: fa.flash_forward_plain(
            q, k, v, True), 2, graph=False)
        torch.cuda.empty_cache()
        plain_bwd = _time(torch, lambda: fa.flash_backward_plain(
            *bwd, block_k=1024), 2, graph=False)
        torch.cuda.empty_cache()
        q3, k3, v3 = (x.transpose(1, 2) for x in (q, k, v))
        lib_fwd = _time(torch, lambda: F.scaled_dot_product_attention(
            q3, k3, v3, is_causal=True), 2 * reps, graph=True)
        qt, kt, vt = (x.detach().requires_grad_() for x in (q3, k3, v3))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        gt = g.transpose(1, 2)
        lib_bwd_name = "SDPA autograd backward, dq+dk+dv"
        lib_bwd = _time(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), gt, retain_graph=True), reps, graph=False)
        del lib_out
        peak = card.f32_tflops if f32 else card.peak_tflops
        name = str(dtype).split(".")[1]
        out_t = {}
        for w, (_, _, kind) in FLASH.items():
            ops = fa.flash_attention_flops(b, t, t, h, d, True, kind)
            nbytes = fa.flash_attention_bytes(b, t, t, h, h, d, dtype, kind)
            ops_ms = ops / (peak * 1e12) * 1e3
            bytes_ms = nbytes / card.hbm_bytes_per_s * 1e3
            ms = _time(torch, kern[w], reps, graph=True)
            eager_ms = _time(torch, kern[w], reps, graph=False)
            out_t[w] = dict(
                ms=ms, eager_ms=eager_ms,
                plain_ms=plain_fwd if kind == "fwd" else plain_bwd,
                library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops=ops, bytes=nbytes)
            log(f"timing: {w} at B{b} T{t} H{h} D{d} causal {name}"
                f"{', TF32 off' if f32 else ''} (CUDA graph replay): kernel "
                f"{ms:.4f} ms (eager {eager_ms:.4f} ms), plain "
                f"{out_t[w]['plain_ms']:.4f} ms, library "
                f"({'SDPA forward' if kind == 'fwd' else lib_bwd_name}, "
                f"{name}) "
                f"{out_t[w]['library_ms']:.4f} ms, bound "
                f"{out_t[w]['bound_ms']:.4f} ms ({out_t[w]['bound_by']} at "
                f"{peak} TFLOP/s: {ops} FLOPs, {nbytes} B); "
                f"{ops / ms / 1e9:.2f} TFLOP/s, "
                f"{out_t[w]['bound_ms'] / ms:.3f} of the bound"
                + (f"; first CUDA-core design "
                   f"{FLASH_F32_CUDA_CORE_MS[w]:.4f} ms "
                   f"({FLASH_F32_CUDA_CORE_MS[w] / ms:.2f}x this time)"
                   if f32 and w in FLASH_F32_CUDA_CORE_MS else "")
                + ("" if f32 else f"; mma.sync design "
                   f"{FLASH_MMA_SYNC_MS[w]:.4f} ms "
                   f"({FLASH_MMA_SYNC_MS[w] / ms:.2f}x this time)"))
    torch.cuda.empty_cache()
    return out_t


PROBE_M = 256 * 56 * 56      # the probe's M: stage 1 of ResNet-50 at 256
PROBE_BLOCKS = (1024, 2048, 4096, 8192)  # the probe's default bm sweep
# wrapper -> (JSON name, TPU kernel it replaces)
PROBE = {
    "wgrad": ("probe.wgrad",
              "benchmarks/bench_pallas_conv_probe.py:57"),
    "rowblock": ("probe.rowblock",
                 "benchmarks/bench_pallas_conv_probe.py:88"),
}
PROBE_SOURCE = "chainermn_tpu_torch/csrc/probe_matmul.cu"
# CUDA-graph ms of the mma.sync probe kernels at PROBE_M for each bm of the
# sweep, measured by phase 17 of this script on an NVIDIA H100 80GB HBM3 at
# 700 W before they were redesigned as persistent wgmma + TMA kernels: the
# yardstick phase 17 prints each bm's time against
PROBE_MMA_SYNC_MS = {
    "wgrad": {1024: 0.2500, 2048: 0.2185, 4096: 0.2328, 8192: 0.2007},
    "dgrad": {1024: 0.1951, 2048: 0.1975, 4096: 0.2202, 8192: 0.2153},
    "fwd1x1": {1024: 0.1836, 2048: 0.1986, 4096: 0.2107, 8192: 0.2266}}
# M of the probe kernels' short and ragged splits in phase 14: fewer 64-row
# tiles than the kernels' 132 spans, and a tile count that 132 does not
# divide
PROBE_EDGE_M = (64 * 5, 64 * 12547)


def phase_probe(pm, bcp, torch, dev):
    """Both probe kernels against their plain versions at M = 802,816 for
    every bm of the sweep and each (k, n) family; the edges (bm = M, bm
    256, a bm that does not divide M, views with a storage offset, M with
    fewer tiles than spans and a ragged split); then each kernel twice on
    the same inputs, and the same bits at every bm (the kernels do not use
    it).  Returns the largest max-abs error per wrapper and the case
    lines."""
    errs = {"wgrad": 0.0, "rowblock": 0.0}
    lines = []
    for m in PROBE_EDGE_M:
        for name, (sa, sb, kern, _) in bcp.probe_cases(m).items():
            a, b = bcp.operands(dev, sa, sb)
            fn, plain = getattr(pm, kern), getattr(pm, f"{kern}_plain")
            res = pm.agreement(kern, a, b, fn(a, b, 64), plain(a, b, m))
            errs[kern] = max(errs[kern], res["max_abs_err"])
            lines.append(f"{name} M={m} ({m // 64} tiles) bm=64: "
                         f"{json.dumps(res)}")
    for name, (sa, sb, kern, _) in bcp.probe_cases(PROBE_M).items():
        a, b = bcp.operands(dev, sa, sb)
        fn, plain = getattr(pm, kern), getattr(pm, f"{kern}_plain")
        first = None
        for bm in PROBE_BLOCKS + (PROBE_M, 256):
            got = fn(a, b, bm)
            res = pm.agreement(kern, a, b, got, plain(a, b, bm))
            errs[kern] = max(errs[kern], res["max_abs_err"])
            lines.append(f"{name} bm={bm}: {json.dumps(res)}")
            if first is None:
                first = got
            elif not torch.equal(got, first):
                raise AssertionError(f"{name}: bm {bm} gives other bits "
                                     f"than bm {PROBE_BLOCKS[0]}")
        try:
            fn(a, b, 3 * 64)
        except ValueError as e:
            lines.append(f"{name} bm=192 raises: {e}")
        else:
            raise AssertionError(f"{name}: bm 192 does not divide M and "
                                 "was taken")
        # the same rows read through views into a larger buffer: 16-byte
        # aligned (read in place) and one element in (copied)
        for off in (8, 1):
            flat = torch.cat([a.new_zeros(off), a.reshape(-1)])
            view = flat[off:].view(a.shape)
            if not torch.equal(fn(view, b, 2048), fn(a, b, 2048)):
                raise AssertionError(f"{name}: a view at storage offset "
                                     f"{off} gives other bits")
            del flat, view
        if not torch.equal(fn(a, b, 1024), fn(a, b, 1024)):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ")
        lines.append(f"{name}: every bm the same bits; views at storage "
                     f"offsets 8 and 1 give the bits of the tensor itself; "
                     f"two launches the same bits")
        del a, b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errs, lines


def phase_probe_timing(pm, bcp, torch, dev, card):
    """Each probe case at every bm: the kernel by CUDA-graph replay,
    eagerly, its plain version, one library call (``torch.mm`` with the
    output type) and the bound on ``card``; returns per case the figures
    at every bm and the best one."""
    out = {}
    for name, (sa, sb, kern, out_dtype) in bcp.probe_cases(PROBE_M).items():
        a, b = bcp.operands(dev, sa, sb)
        fn, plain = getattr(pm, kern), getattr(pm, f"{kern}_plain")
        flops = pm.probe_flops(sa[0], sa[1], sb[1])
        nbytes = pm.probe_bytes(sa[0], sa[1], sb[1], torch.empty(
            (), dtype=out_dtype).element_size())
        bound, bound_by = pm.bound_ms(flops, nbytes, card)
        lib = _time(torch, lambda: bcp.library_product(a, b, out_dtype), 20,
                    graph=True)
        per_bm = {}
        for bm in PROBE_BLOCKS:
            t = dict(ms=_time(torch, lambda: fn(a, b, bm), 20, graph=True),
                     eager_ms=_time(torch, lambda: fn(a, b, bm), 20,
                                    graph=False),
                     plain_ms=_time(torch, lambda: plain(a, b, bm), 3,
                                    graph=True))
            per_bm[bm] = t
            old = PROBE_MMA_SYNC_MS[name][bm]
            log(f"timing: {kern} {name} bm={bm} (CUDA graph replay): "
                f"kernel {t['ms']:.4f} ms ({flops / t['ms'] / 1e9:.1f} "
                f"TFLOP/s, {bound / t['ms']:.3f} of the bound; eager "
                f"{t['eager_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms; "
                f"mma.sync design {old:.4f} ms ({old / t['ms']:.2f}x this "
                f"time)")
        best = min(per_bm, key=lambda k: per_bm[k]["ms"])
        out[name] = dict(per_bm[best], bm=best, per_bm=per_bm, kernel=kern,
                         library_ms=lib, bound_ms=bound, bound_by=bound_by,
                         flops=flops, bytes=nbytes)
        log(f"timing: {kern} {name} best bm={best}: kernel "
            f"{per_bm[best]['ms']:.4f} ms, library (torch.mm -> "
            f"{str(out_dtype).split('.')[1]}) {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}: {nbytes} B, {flops} FLOPs)")
        del a, b
    torch.cuda.empty_cache()
    return out


def phase_probe_main(pm, bcp):
    """``bench_conv_probe.main`` at its defaults; returns the document and
    the kernel launches it made (per bm: one check, 2 warm-up, 5 timed)."""
    pm.reset_launch_counts()
    doc = bcp.main([])
    counts = pm.launch_counts()
    # per case and bm: the check, the warm-up calls, then the timed calls
    # of each capture (device_time captures again when one lost kernels)
    for w, cases in (("wgrad", 1), ("rowblock", 2)):
        fixed = cases * len(PROBE_BLOCKS) * (1 + bcp.WARMUP)
        timed = counts[w] - fixed
        if timed < cases * len(PROBE_BLOCKS) * bcp.STEPS or \
                timed % bcp.STEPS:
            raise AssertionError(
                f"probe: {w} launched {counts[w]} times, expected {fixed} "
                f"+ {bcp.STEPS} per capture ({cases} case(s) x "
                f"{len(PROBE_BLOCKS)} block sizes)")
    for name, row in doc["cases"].items():
        if name.startswith("conv"):
            continue
        if set(row["kernel_sweep"]) != {str(bm) for bm in PROBE_BLOCKS}:
            raise AssertionError(
                f"{name}: sweep {sorted(row['kernel_sweep'])}")
    return doc, counts


def phase_bench(fn, cs, torch):
    """``benchmarks.bench.main`` at its card defaults: ResNet-50, batch 256,
    the bf16 wire with double buffering, 20 steps after 5 (then 1, and 3 +
    3 a profiler capture for its device time: the profiler's warm-up step
    and the timed one); every BatchNorm kernel 53 times a step, 2 casts a
    step.  Returns the line, the launches and the peak
    memory in GB."""
    from chainermn_tpu_torch.benchmarks import bench
    fn.reset_launch_counts()
    cs.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    line = bench.main([])
    counts = dict(fn.launch_counts(), cast_scale=cs.cast_scale.launches)
    batch, _, steps, warmup = bench.GPU_SHAPE
    total = counts["cast_scale"] // 2  # steps run (device_time may capture
    fixed = steps + warmup + bench.DEVICE_TIME_WARMUP  # more than once)
    want = dict({w: 53 * total for w in fn.launch_counts()},
                cast_scale=2 * total)
    if counts != want or total < fixed + bench.DEVICE_TIME_STEPS or \
            (total - fixed) % bench.DEVICE_TIME_STEPS:
        raise AssertionError(f"bench launches {counts}: expected 53 of each "
                             f"BatchNorm kernel and 2 casts a step, over "
                             f"{fixed} steps + {bench.DEVICE_TIME_STEPS} a "
                             "capture")
    if not (line["metric"] == "resnet50_synthetic_imagenet_train_throughput"
            and math.isfinite(line["value"]) and line["value"] > 0
            and 0 < line["device_ms_per_step"] <= line["step_ms"] * 1.5
            and line["device_ms_by_category"].get(STATS_CATEGORY)):
        raise AssertionError(f"bench line not sane: {line}")
    return line, counts, torch.cuda.max_memory_allocated() / 1e9


P19_STEPS = 12       # phase 19: iterations of the uninterrupted run
P19_EPOCH = 5        # iterations an epoch (--train-size 5 x batch)
P19_FREQ = 6         # snapshot every 6 iterations: the resume starts at 6
P19_VAL = 2 * BATCH  # validation examples: 2 batches at each epoch end


def _p19_state(res):
    """Parameters, buffers and optimizer shards of a ``main`` result."""
    out = {f"model/{k}": v.detach().clone()
           for k, v in res["model"].state_dict().items()}
    opt = res["optimizer"].local_optimizer
    for i, st in opt.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": v.clone() for k, v in st.items()
                    if hasattr(v, "clone")})
    return out


def phase_dp(fn, cs, torch):
    """Phase 19: ``train_imagenet.main`` with ZeRO-1, the bf16 wire, the
    schedule, the evaluator and snapshots; a resumed run against the
    uninterrupted one; ZeRO-1 against the plain optimizer for one float32
    step.  Returns what the log line prints."""
    import glob
    import shutil
    import tempfile
    from chainermn_tpu_torch.examples import train_imagenet
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_",
                            dir=os.path.join(HERE, "build"))
    flags = ["--arch", "resnet50", "--communicator", "xla", "--zero",
             "--allreduce-grad-dtype", "bfloat16", "--optimizer", "momentum",
             "--warmup-epochs", "0.5", "--batchsize", str(BATCH),
             "--dtype", "bfloat16", "--seed", "0",
             "--train-size", str(BATCH * P19_EPOCH),
             "--val-size", str(P19_VAL),
             "--epoch", str(P19_STEPS // P19_EPOCH + 1),
             "--iterations", str(P19_STEPS), "--checkpoint-freq",
             str(P19_FREQ), "--log-interval", str(P19_STEPS),
             "--warmup-steps", str(WARMUP)]
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        fn.reset_launch_counts()
        cs.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases'
        full = train_imagenet.main(flags + [
            "--checkpoint", os.path.join(root, "full")])
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        counts = dict(fn.launch_counts(), cast_scale=cs.cast_scale.launches)
        evals = (P19_STEPS // P19_EPOCH) * (P19_VAL // BATCH)
        want = {w: 53 * P19_STEPS for w in fn.launch_counts()}
        want.update(apply_call=53 * (P19_STEPS + evals),
                    cast_scale=2 * P19_STEPS)
        losses = full["losses"]
        if len(losses) != P19_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"phase 19 losses not finite: {losses}")
        if counts != want:
            raise AssertionError(
                f"phase 19 launches {counts}: expected 53 a step of each "
                f"BatchNorm kernel (apply also 53 for each of the {evals} "
                f"validation batches) and 2 casts a step, {want}")
        log = full["log"]
        if len(log) != P19_STEPS // P19_EPOCH or not all(
                math.isfinite(r["validation/loss"]) for r in log):
            raise AssertionError(f"phase 19 epoch log: {log}")
        names = sorted(os.listdir(os.path.join(root, "full")))
        if names != sorted(f"imagenet-resnet50.{i}.rank0.npz"
                           for i in (P19_FREQ, P19_STEPS)):
            raise AssertionError(f"phase 19 snapshots: {names}")
        # the resume: the mid-run snapshot alone in a fresh directory
        os.makedirs(os.path.join(root, "resumed"))
        for f in glob.glob(os.path.join(root, "full",
                                        f"*.{P19_FREQ}.rank*.npz")):
            shutil.copy(f, os.path.join(root, "resumed"))
        resumed = train_imagenet.main(flags + [
            "--checkpoint", os.path.join(root, "resumed")])
        if resumed["resumed_from"] != P19_FREQ or \
                resumed["iterations"] != P19_STEPS:
            raise AssertionError(
                f"phase 19 resume: from {resumed['resumed_from']}, ended at "
                f"{resumed['iterations']}")
        a, b = _p19_state(full), _p19_state(resumed)
        differ = sorted(k for k in a if k not in b or not torch.equal(a[k],
                                                                      b[k]))
        if differ or a.keys() != b.keys() or not any(
                k.startswith("opt/") for k in a):
            raise AssertionError(f"phase 19: the resumed run differs from "
                                 f"the uninterrupted one in {differ[:8]} "
                                 f"({len(differ)} of {len(a)} tensors)")
        same_losses = resumed["losses"] == losses[P19_FREQ:]
        del full["model"], full["optimizer"], resumed
        f32 = phase_dp_f32(torch)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(losses=losses, counts=counts, peak_gb=peak_gb,
                base_gb=base_gb,
                images_per_sec=full["images_per_sec"],
                save_ms=[round(1e3 * t, 1) for t in full["save_seconds"]],
                log=log, tensors=len(a), same_losses=same_losses, f32=f32)


def phase_dp_f32(torch):
    """One float32 step of ResNet-50 from the same weights with
    ``zero=True`` and with the plain optimizer (SGD momentum, Adam): the
    parameters must be bit-equal.  Returns the number of tensors held."""
    import torch.nn.functional as F
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     make_train_step, weights)
    from chainermn_tpu_torch.models import ResNet50
    from chainermn_tpu_torch.utils.compare import no_tf32
    dev = torch.device("cuda", 0)
    with no_tf32():
        src = ResNet50(dtype=torch.float32, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3))
        variables = weights.state_dict_to_flax(src)
        del src
        rng = torch.Generator(device=dev).manual_seed(4)
        batch = (torch.randn((BATCH, 3, 224, 224), device=dev,
                             generator=rng),
                 torch.randint(0, 1000, (BATCH,), device=dev, generator=rng))
        comm = create_communicator("xla")
        held = 0
        for name, make in (
                ("momentum", lambda ps: torch.optim.SGD(ps, lr=0.1,
                                                        momentum=0.9)),
                ("adam", lambda ps: torch.optim.Adam(ps, lr=1e-3))):
            params = []
            for zero in (False, True):
                model = ResNet50(dtype=torch.float32, device=dev)
                weights.load_flax_variables(model, variables)
                model.train()
                opt = create_multi_node_optimizer(
                    make(model.parameters()), comm, zero=zero)
                step = make_train_step(
                    comm, lambda b: F.cross_entropy(model(b[0]), b[1]), opt)
                if not math.isfinite(float(step(batch))):
                    raise AssertionError(f"f32 {name} zero={zero}: loss")
                params.append([p.detach().clone()
                               for p in model.parameters()])
                del model, opt, step
            bad = sum(not torch.equal(x, y) for x, y in zip(*params))
            if bad:
                raise AssertionError(f"f32 {name}: ZeRO-1 and the plain "
                                     f"optimizer differ in {bad} of "
                                     f"{len(params[0])} parameters")
            held += len(params[0])
        return held



P20_STEPS = 3        # phase 20: Adam steps of each train_lm run
P20_BLOCKS = 4       # the ring the one-card fold of (b) stands in for
P20_LAYERS_C = 2     # (c): ring and ulysses keep [16, T, T] float32 scores


def _p20_argv(attention, layers):
    """train_lm at the LM's width (phase 11's), float32, seed 0."""
    return ["--attention", attention, "--seq-len", str(LM_T),
            "--batchsize", "1", "--steps", str(P20_STEPS),
            "--vocab", str(LM["vocab"]), "--d-model", str(LM["d_model"]),
            "--layers", str(layers), "--heads", str(LM["n_heads"]),
            "--lr", "1e-3", "--seed", "0"]


def _p20_run(fa, torch, attention, layers):
    """``train_lm.main`` with the flash counts set to 0 just before it:
    losses, step 0's gradients, launches, tokens/sec, peak memory."""
    from chainermn_tpu_torch.examples import train_lm
    grads = {}

    def keep(i, model):
        if i == 0:
            grads.update({k: p.grad.detach().clone()
                          for k, p in model.named_parameters()})

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    out = train_lm.main(_p20_argv(attention, layers), on_grads=keep)
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    losses = out["losses"]
    if len(losses) != P20_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"phase 20 {attention}: losses {losses}")
    # tokens/sec after the first step, which pays the first calls' costs
    steady = out["step_seconds"][1:]
    return dict(losses=losses, grads=grads, counts=counts,
                tokens_per_sec=LM_T * len(steady) / sum(steady),
                step_s=out["step_seconds"], peak_gb=out["peak_memory_gb"],
                world=out["world"])


def _p20_gate(name, got, want):
    """Phase 12's float32 gates (``utils.compare``): every step's loss
    within 1e-4 relative, every gradient of step 0 within a relative L2
    error of 1e-3."""
    from chainermn_tpu_torch.utils.compare import (
        GRAD_RTOL, LOSS_RTOL, step_agrees, step_errors)
    loss_rel, grad_rel, worst = step_errors(got["losses"], want["losses"],
                                            got["grads"], want["grads"])
    log(f"phase 20 {name}: losses {got['losses']} vs {want['losses']} (rel "
        f"{loss_rel:.2e}, tol {LOSS_RTOL}); worst step-0 gradient relative "
        f"L2 {grad_rel:.2e} ({worst}; tol {GRAD_RTOL}) over "
        f"{len(want['grads'])} tensors")
    if not step_agrees(loss_rel, grad_rel):
        raise AssertionError(f"phase 20 {name} disagrees with flash")
    return loss_rel, grad_rel


def p20_fold(fa, seq, torch, dev, dtype):
    """(b): q/k/v at the LM's attention shape (B 1, T 8192, H 16, D 128,
    causal) split into ``P20_BLOCKS`` blocks and folded with
    ``sequence.ring_flash_block`` as the ranks of a ring would (block r
    visited by the k/v of r, r-1, ... with their global offsets; blocks
    after r fully masked).  Returns the relative L2 errors of the output
    and the q/k/v gradients of ``sum(out * g)`` against the plain versions
    of the flash kernels over the whole sequence (``"plain"``: no CUDA
    kernel on that side) and against ``flash_attention`` over the whole
    sequence (``"flash"``)."""
    b, t, h = 1, LM_T, LM["n_heads"]
    d = LM["d_model"] // h
    gen = torch.Generator(device=dev).manual_seed(20)
    q, k, v = ((torch.randn(b, t, h, d, generator=gen, device=dev) * s)
               .to(dtype).requires_grad_(True) for s in (0.5, 0.5, 1.0))
    g = torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
    tb = t // P20_BLOCKS
    blk = lambda x, i: x[:, i * tb:(i + 1) * tb]  # noqa: E731
    outs = []
    for r in range(P20_BLOCKS):
        o = torch.zeros(b, tb, h, d, device=dev)
        lse = torch.full((b, h, tb), float("-inf"), device=dev)
        for step in range(P20_BLOCKS):
            src = (r - step) % P20_BLOCKS
            o, lse = seq.ring_flash_block(
                blk(q, r), blk(k, src), blk(v, src), o, lse, causal=True,
                sm_scale=None, attn_fn=fa.flash_attention, q_offset=r * tb,
                kv_offset=src * tb)
        outs.append(o.to(dtype))
    folded = torch.cat(outs, dim=1)
    got = (folded.detach(),) + torch.autograd.grad(folded, (q, k, v), g)
    del outs, folded
    whole = fa.flash_attention(q, k, v, True)
    refs = {"flash": (whole.detach(),)
            + torch.autograd.grad(whole, (q, k, v), g)}
    del whole
    q, k, v = (x.detach() for x in (q, k, v))
    out_p, lse_p = fa.flash_forward_plain(q, k, v, True)
    delta = (g.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    refs["plain"] = (out_p,) + fa.flash_backward_plain(
        q, k, v, g, lse_p, delta, None, True, block_k=1024)
    torch.cuda.synchronize()
    return {ref: {name: _rel(torch, a, w) for name, a, w in
                  zip(("out", "dq", "dk", "dv"), got, want)}
            for ref, want in refs.items()}


def phase_sp(fa, torch, dev):
    """Phase 20: the sequence-parallel slice on one card (see the module
    docstring); returns what its log lines print."""
    from chainermn_tpu_torch.parallel import sequence as seq
    from chainermn_tpu_torch.utils.compare import no_tf32
    with no_tf32():
        layers = LM["n_layers"]
        runs = {att: _p20_run(fa, torch, att, layers)
                for att in ("ring_flash", "flash")}
        torch.cuda.empty_cache()
        p = runs["ring_flash"]["world"]
        # the design's count: the fold of each of the P blocks a layer is
        # rematerialised in the backward pass (its forward kernel runs
        # twice), dK/dV and dQ once
        want = {"flash_fwd": 2 * layers * p * P20_STEPS,
                "flash_bwd_dkv": layers * p * P20_STEPS,
                "flash_bwd_dq": layers * p * P20_STEPS}
        if runs["ring_flash"]["counts"] != want:
            raise AssertionError(f"phase 20 ring_flash launches "
                                 f"{runs['ring_flash']['counts']}, predicted "
                                 f"{want}")
        gates = {"ring_flash": _p20_gate("(a) ring_flash, full width",
                                         runs["ring_flash"], runs["flash"])}
        for r in runs.values():
            del r["grads"]
        torch.cuda.empty_cache()
        fold = {}
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            fold[name] = p20_fold(fa, seq, torch, dev, dtype)
            tol = FLASH_TOL[name]
            for ref, errs in fold[name].items():
                log(f"phase 20 (b) {P20_BLOCKS}-block ring_flash fold vs "
                    f"whole-sequence {ref}, {name}, B 1 T {LM_T} H 16 D 128 "
                    f"causal: relative L2 {json.dumps(errs)} (tol {tol})")
                if not all(e <= tol for e in errs.values()):
                    raise AssertionError(f"phase 20 (b) fold {name} "
                                         f"disagrees with {ref}")
            torch.cuda.empty_cache()
        torch.cuda.empty_cache()
        short = {att: _p20_run(fa, torch, att, P20_LAYERS_C)
                 for att in ("ring", "ulysses", "flash")}
        for att in ("ring", "ulysses"):
            gates[att] = _p20_gate(f"(c) {att}, {P20_LAYERS_C} layers",
                                   short[att], short["flash"])
        for r in short.values():
            del r["grads"]
    torch.cuda.empty_cache()
    return dict(runs=runs, short=short, fold=fold, gates=gates)


# phase 21: the example's wide run (the reference era's 1024 units; the
# vocabulary under the example's own --max-vocab 40000)
S2S_WIDE = ["--hidden", "1024", "--embed-dim", "1024", "--vocab", "32000",
            "--seq-len", "48", "--n-train", "16384", "--batchsize", "128",
            "--epoch", "1"]
S2S_PROFILED = 5     # further wide steps under torch.profiler
S2S_CATEGORIES = (
    ("lstm (cuDNN)", ("RNN", "rnn", "LSTM", "lstm", "cudnn")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
    ("softmax / cross entropy", ("softmax", "nll_loss", "cross_entropy")),
    ("embedding", ("embedding", "indexSelect", "index_select")),
    ("adam", ("adam", "Adam", "multi_tensor", "foreach")),
    ("memcpy / memset", ("memcpy", "memset")),
)


def _s2s_grads(model):
    return [p.grad.clone() for s in range(model.n_stages)
            for p in model.stage(s).parameters() if p.requires_grad]


def p21_chain_vs_direct(torch, dev):
    """(b): one float32 step of the chain list (both stages on the card,
    the in-process channel) against ``decoder(encoder(src, src_len),
    tgt_in)`` composed directly, from the same weights: loss and every
    gradient bit-equal; the direct composition run twice for the
    determinism it rests on."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.datasets.nmt import bucket_batches
    from chainermn_tpu_torch.examples import seq2seq as ex
    args = ex.parse_args([])
    train, _, sv, tv = ex.load_data(args)
    model = ex.build_model(create_communicator("xla"), len(sv), len(tv),
                           args.embed_dim, args.hidden, args.seed)
    tb = ex.batch_tensors(next(bucket_batches(train, args.batchsize,
                                         step=args.bucket_step,
                                         shuffle=False)), dev)
    enc, dec = model.stage(0), model.stage(1)
    runs = {}
    for name, fwd in (("chain", lambda: model(
            tb["src"], stage_inputs={0: (tb["src_len"],),
                                     1: (tb["tgt_in"],)})),
                      ("direct", lambda: dec(enc(tb["src"], tb["src_len"]),
                                             tb["tgt_in"])),
                      ("direct again", lambda: dec(enc(
                          tb["src"], tb["src_len"]), tb["tgt_in"]))):
        for s in (enc, dec):
            s.zero_grad(set_to_none=True)
        loss, _ = ex.masked_loss(fwd(), tb)
        loss.backward()
        runs[name] = (loss.detach().clone(), _s2s_grads(model))
    torch.cuda.synchronize()

    def same(a, b):
        return torch.equal(a[0], b[0]) and all(
            torch.equal(x, y) for x, y in zip(a[1], b[1]))

    return dict(loss=float(runs["chain"][0]), tensors=len(runs["chain"][1]),
                equal=same(runs["chain"], runs["direct"]),
                deterministic=same(runs["direct"], runs["direct again"]))


def p21_profile(torch, dev):
    """``S2S_PROFILED`` steps of the wide configuration on one batch of a
    middle length under ``torch.profiler``
    (``train_imagenet.profile_steps``)."""
    import functools
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.datasets.nmt import bucket_batches
    from chainermn_tpu_torch.examples import seq2seq as ex
    from chainermn_tpu_torch.examples.train_imagenet import profile_steps
    from chainermn_tpu_torch.optimizers import create_per_stage_optimizer
    args = ex.parse_args(S2S_WIDE)
    train, _, sv, tv = ex.load_data(args)
    model = ex.build_model(create_communicator("xla"), len(sv), len(tv),
                           args.embed_dim, args.hidden, args.seed)
    opt = create_per_stage_optimizer(
        functools.partial(torch.optim.Adam, lr=2e-3))
    opt.init(model)
    batches = list(bucket_batches(train, args.batchsize,
                                  step=args.bucket_step, shuffle=False))
    batch = batches[len(batches) // 2]  # a middle length (buckets ascend)
    step = lambda: next(ex.train_steps(model, opt, [batch]))  # noqa: E731
    for _ in range(2):
        step()

    class _Steps:  # the updater interface profile_steps drives
        update = staticmethod(step)
        finalize = staticmethod(lambda: None)

    prof = profile_steps(_Steps, S2S_PROFILED, dev, S2S_CATEGORIES)
    prof["batch_shape"] = [list(batch["src"].shape),
                           list(batch["tgt_out"].shape)]
    del model, opt
    torch.cuda.empty_cache()
    return prof


def phase_seq2seq(torch, dev):
    """Phase 21 (see the module docstring); returns what its log prints."""
    from chainermn_tpu_torch.examples import seq2seq as ex
    from chainermn_tpu_torch.utils.compare import no_tf32
    with no_tf32():
        runs = {}
        for name, argv in (("defaults", []), ("wide", S2S_WIDE)):
            torch.cuda.empty_cache()
            res = ex.main(argv)
            losses = res["losses"]
            if res["world"] != 1 or not all(map(math.isfinite, losses)):
                raise AssertionError(f"phase 21 {name}: world "
                                     f"{res['world']}, losses {losses}")
            if res["final"] is None or "val_bleu" not in res["final"]:
                raise AssertionError(f"phase 21 {name}: no val_bleu in "
                                     f"{res['final']}")
            steady = res["step_seconds"][1:]
            runs[name] = dict(
                epoch_loss=[r["loss"] for r in res["log"]],
                final=res["final"], steps=len(losses),
                tokens_per_sec=res["steady_tokens_per_sec"],
                step_ms=1e3 * sorted(steady)[len(steady) // 2],
                peak_gb=res["peak_memory_gb"])
        ep = runs["defaults"]["epoch_loss"]
        if not ep[-1] < ep[0]:
            raise AssertionError(f"phase 21 (a): the loss did not fall "
                                 f"from epoch 1 to the last: {ep}")
        bits = p21_chain_vs_direct(torch, dev)
        if not bits["equal"]:
            raise AssertionError(f"phase 21 (b): the chain differs from the "
                                 f"direct composition: {bits}")
        prof = p21_profile(torch, dev)
    torch.cuda.empty_cache()
    return dict(runs=runs, bits=bits, profile=prof)


C12_LOOPS = 300      # phase 22: passes of the flash autograd check
WGRAD_LOOPS = 600    # phase 22: launches of the probe wgrad


def phase_c12(fa, torch, dev, loops):
    """ROADMAP.md Queue C 12: ``tests/test_torch_kernels_gpu.py::
    test_flash_attention_autograd_on_the_card`` looped ``loops`` times in
    this process after every other phase: each pass checks the global
    precision flags the test's fixture leaves (TF32 off, float32 matmul
    precision "highest"), runs the float32 D 32 forward and both backward
    kernels through ``flash_attention`` and the plain autograd on the CPU
    from the same inputs, and records the relative L2 error of out, lse,
    dq, dk and dv and whether each side's bits equal its first pass's."""
    names = ("out", "lse", "dq", "dk", "dv")
    worst = dict.fromkeys(names, 0.0)
    over, first = 0, None
    gpu_same = cpu_same = 0
    from chainermn_tpu_torch.utils.compare import no_tf32
    with no_tf32():
        for i in range(loops):
            flags = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())
            if flags != (False, False, "highest"):
                raise AssertionError(f"C12 pass {i}: precision flags "
                                     f"{flags}")
            gen = torch.Generator(device=dev).manual_seed(3)
            q, k, v = (torch.randn(2, 64, 4, 32, generator=gen, device=dev)
                       .requires_grad_() for _ in range(3))
            out, lse = fa.flash_attention(q, k, v, True, return_lse=True)
            (out.square().sum() + lse.sum()).backward()
            got = [t.detach().cpu()
                   for t in (out, lse, q.grad, k.grad, v.grad)]
            ref = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
            out_p, lse_p = fa.flash_attention(*ref, True, return_lse=True)
            (out_p.square().sum() + lse_p.sum()).backward()
            want = [out_p.detach(), lse_p.detach()] + [t.grad for t in ref]
            if first is None:
                first = (got, want)
            gpu_same += all(torch.equal(a, b) for a, b in zip(got, first[0]))
            cpu_same += all(torch.equal(a, b) for a, b in zip(want, first[1]))
            errs = [_rel(torch, a, b) for a, b in zip(got, want)]
            over += any(e > 1e-5 for e in errs)
            for n, e in zip(names, errs):
                worst[n] = max(worst[n], e)
    return dict(loops=loops, over_gate=over, worst=worst,
                gpu_bits_repeat=gpu_same, cpu_bits_repeat=cpu_same)


def phase_wgrad_repeat(pm, bcp, torch, dev, loops):
    """Phase 14's check that two launches give the same bits, ``loops``
    times: ``probe_matmul.wgrad`` at M = 802,816 (bm 1024) on the same
    inputs against its first launch; for every launch that differs, the
    count of differing elements and the largest difference, and how far
    each side is from the plain version."""
    a, b = bcp.operands(dev, (256, PROBE_M), (PROBE_M, 64))
    first = pm.wgrad(a, b, 1024)
    plain = pm.wgrad_plain(a, b, 1024)
    diffs = []
    for i in range(loops):
        got = pm.wgrad(a, b, 1024)
        if not torch.equal(got, first):
            d = (got - first).abs()
            diffs.append(dict(
                launch=i + 1, elements=int((d > 0).sum()),
                max_diff=float(d.max()),
                vs_plain=float((got - plain).abs().max()),
                first_vs_plain=float((first - plain).abs().max())))
    torch.cuda.synchronize()
    return dict(loops=loops, differing=len(diffs), diffs=diffs[:10])


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import importlib
    fn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    pm = importlib.import_module("chainermn_tpu_torch.ops.probe_matmul")
    from chainermn_tpu_torch.benchmarks import bench_conv_probe as bcp
    from chainermn_tpu_torch.utils.gpu_info import card_info
    import triton

    t_build = time.perf_counter()
    builds = start_cuda_builds()  # nvcc runs beside the Triton phase
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton "
        f"{triton.__version__}, python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    card, matched = card_info(dev)
    log(f"card rates for the bounds (utils/gpu_info, key {matched!r}): "
        f"{card}; peak_assumed={matched is None}")
    t0 = time.perf_counter()
    errs = {}
    # ResNet-50's batch-32 boundaries (phase 3) and a ragged row count
    phase_kernels(fn, torch, dev, [(401408, 64), (100352, 256), (6272, 1024),
                                   (1568, 2048), (12547, 512)],
                  (torch.bfloat16, torch.float32), errs)
    # the bench's (phase 16): batch 256, bfloat16, up to 3,211,264 rows
    phase_kernels(fn, torch, dev, bn_shapes(fn, 256), (torch.bfloat16,),
                  errs)
    phase_stats_edges(fn, torch, dev, errs)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s, max abs err "
        f"{json.dumps(errs)}")
    for f in builds.values():
        f.result()  # a failed build raises here
    log(f"CUDA builds ({', '.join(builds)}): done "
        f"{time.perf_counter() - t_build:.1f} s after their start")
    from chainermn_tpu_torch.ops import _build
    for src, kerns in PTXAS_KERNELS.items():
        regs = ptxas_registers(_build.build_report(src).splitlines(), kerns)
        log(f"ptxas -v {src}.cu (registers, spill store / load bytes): "
            + ", ".join(f"{k} {r}/{st}/{ld}"
                        for k, (r, st, ld) in regs.items()))
        spills = {k: regs.get(k) for k in F32_NO_SPILL
                  if src == "flash_attention" and regs.get(k, (0, 1, 1))[1:]
                  != (0, 0)}
        if spills:
            raise AssertionError(f"float32 flash kernels spill at D 128 (or "
                                 f"are missing from the report): {spills}")

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
    times = phase_timing(fn, torch, dev, card, BATCH)
    times_bench = phase_timing(fn, torch, dev, card, BENCH_BATCH)
    log(f"phase timing: {time.perf_counter() - t0:.1f} s; at batch "
        f"{BENCH_BATCH}: " + json.dumps(
            {w: {k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms")}
             for w, t in times_bench.items()}))

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
                               dist.get_world_size(), card)
    log(f"phase cast timing: {time.perf_counter() - t0:.1f} s; both legs: "
        f"{json.dumps(cast_t)}")

    t0 = time.perf_counter()
    flash_errs = phase_flash(fa, torch, dev)
    log(f"phase flash: {time.perf_counter() - t0:.1f} s; max abs err "
        f"{json.dumps(flash_errs)}")

    t0 = time.perf_counter()
    lm = phase_lm(fa, cs, torch, dev)
    lm_prof = lm["profile"]
    if not lm_prof["device_ms_per_step"]:
        lm_prof = "not measured (the profiler saw no device time)"
    log(f"phase lm: {time.perf_counter() - t0:.1f} s; TransformerLM "
        f"{lm['n_params']} parameters, bf16, T {LM_T}, batch 1, xla "
        f"communicator with the bfloat16 wire, SGD momentum, double "
        f"buffering; losses {lm['losses']}; step seconds {lm['step_s']}; "
        f"launches {json.dumps(lm['counts'])} in {LM_STEPS} steps; "
        f"tokens/sec (steps {LM_WARMUP + 1}..{LM_STEPS}) "
        f"{lm['tokens_per_sec']:.1f} on {gpu}; peak memory "
        f"{lm['peak_gb']:.1f} GB; profile of {LM_PROFILED} more steps: "
        f"{json.dumps(lm_prof)}")

    t0 = time.perf_counter()
    ex = phase_lm_example(fa)
    log(f"phase lm example: {time.perf_counter() - t0:.1f} s; train_lm "
        f"--attention flash (float32, seq 2048, batch 4, d_model 128, 8 "
        f"heads: D 16): losses {ex['losses']}; {ex['tokens_per_sec']:.1f} "
        f"tokens/sec over all {EXAMPLE_STEPS} steps")

    t0 = time.perf_counter()
    phase_lm_f32(torch, dev)
    log(f"phase lm f32: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    flash_t = phase_flash_timing(fa, torch, dev, card, torch.bfloat16)
    flash_t32 = phase_flash_timing(fa, torch, dev, card, torch.float32)
    log(f"phase flash timing: {time.perf_counter() - t0:.1f} s; float32 "
        f"rows: " + json.dumps({w: {k: t[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for w, t in flash_t32.items()}) + f" on {gpu}")

    t0 = time.perf_counter()
    probe_errs, probe_lines = phase_probe(pm, bcp, torch, dev)
    for line in probe_lines:
        log(f"probe kernels: {line}")
    log(f"phase probe kernels: {time.perf_counter() - t0:.1f} s; max abs "
        f"err {json.dumps(probe_errs)}")

    t0 = time.perf_counter()
    probe_doc, probe_counts = phase_probe_main(pm, bcp)
    log(f"phase probe: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(probe_counts)}; document above, on {gpu}")

    t0 = time.perf_counter()
    bench_line, bench_counts, bench_gb = phase_bench(fn, cs, torch)
    log(f"phase bench: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(bench_counts)}; peak memory {bench_gb:.1f} GB; "
        f"line above, on {gpu}")

    t0 = time.perf_counter()
    probe_t = phase_probe_timing(pm, bcp, torch, dev, card)
    log(f"phase probe timing: {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(probe_t)}")

    t0 = time.perf_counter()
    dp = phase_dp(fn, cs, torch)
    log(f"phase dp (19): {time.perf_counter() - t0:.1f} s; ResNet-50 "
        f"--zero --allreduce-grad-dtype bfloat16 --optimizer momentum "
        f"--warmup-epochs 0.5 --checkpoint, {P19_STEPS} iterations: losses "
        f"{dp['losses']}; launches {json.dumps(dp['counts'])}; epoch log "
        f"{json.dumps(dp['log'])}; images/sec (steps {WARMUP + 1}.."
        f"{P19_STEPS}, with the evaluations and saves in the window) "
        f"{dp['images_per_sec']:.1f}, phase 3 {out['images_per_sec']:.1f}; "
        f"peak memory {dp['peak_gb']:.2f} GB ({dp['base_gb']:.2f} GB held "
        f"by earlier phases at its start); save ms {dp['save_ms']}; the "
        f"run resumed at {P19_FREQ} equals the uninterrupted one bit for "
        f"bit in all {dp['tensors']} parameters, buffers and optimizer "
        f"shards (losses bit-equal too: {dp['same_losses']}); float32 step, "
        f"ZeRO-1 = plain optimizer bit for bit (SGD momentum, Adam; "
        f"{dp['f32']} parameter tensors) on {gpu}")

    t0 = time.perf_counter()
    sp = phase_sp(fa, torch, dev)
    runs, short = sp["runs"], sp["short"]
    log(f"phase sp (20): {time.perf_counter() - t0:.1f} s; train_lm at the "
        f"LM's width in float32 ({LM_T} tokens, {P20_STEPS} Adam steps, "
        f"world of one): " + "; ".join(
            f"{att}: launches {json.dumps(r['counts'])}, step seconds "
            f"{r['step_s']}, tokens/sec (steps 2..{P20_STEPS}) "
            f"{r['tokens_per_sec']:.1f}, peak memory {r['peak_gb']:.2f} GB"
            for att, r in runs.items()) + f"; at {P20_LAYERS_C} layers: "
        + "; ".join(f"{att}: step seconds {r['step_s']}, tokens/sec "
                    f"{r['tokens_per_sec']:.1f}, peak memory "
                    f"{r['peak_gb']:.2f} GB" for att, r in short.items())
        + f" on {gpu}")

    t0 = time.perf_counter()
    s2s = phase_seq2seq(torch, dev)
    d, w, b = s2s["runs"]["defaults"], s2s["runs"]["wide"], s2s["bits"]
    log(f"phase seq2seq (21): {time.perf_counter() - t0:.1f} s; float32, "
        f"TF32 off, world of one (both stages on the card): (a) defaults, "
        f"epoch losses {d['epoch_loss']}, final {json.dumps(d['final'])}, "
        f"tokens/sec (steps after the first) {d['tokens_per_sec']:.1f}, "
        f"median step {d['step_ms']:.3f} ms, peak memory {d['peak_gb']:.3f} "
        f"GB; (b) one step of the chain vs decoder(encoder(...)): loss "
        f"{b['loss']!r} and {b['tensors']} gradients bit-equal "
        f"{b['equal']} (direct twice bit-equal {b['deterministic']}); (c) "
        f"{' '.join(S2S_WIDE)}: {w['steps']} steps, epoch loss "
        f"{w['epoch_loss']}, final {json.dumps(w['final'])}, tokens/sec "
        f"(steps after the first) {w['tokens_per_sec']:.1f}, median step "
        f"{w['step_ms']:.3f} ms, peak memory {w['peak_gb']:.3f} GB; profile "
        f"of {S2S_PROFILED} steps: {json.dumps(s2s['profile'])} on {gpu}")

    t0 = time.perf_counter()
    c12 = phase_c12(fa, torch, dev, C12_LOOPS)
    rep = phase_wgrad_repeat(pm, bcp, torch, dev, WGRAD_LOOPS)
    log(f"phase repeat loops (22): {time.perf_counter() - t0:.1f} s; C12 "
        f"{json.dumps(c12)}; probe wgrad {json.dumps(rep)} on {gpu}")
    if (c12["over_gate"] or c12["gpu_bits_repeat"] != C12_LOOPS
            or c12["cpu_bits_repeat"] != C12_LOOPS or rep["differing"]):
        raise AssertionError("phase 22: a pass over the 1e-5 gate, or a "
                             "launch whose bits differ from the first's")

    dist.destroy_process_group()
    kernels = []
    for wrapper, (name, replaces, _, _, route, source) in KERNELS.items():
        t = times[wrapper]
        kernels.append({
            "name": name, "route": route, "source": source,
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
    for wrapper, (name, replaces, _) in FLASH.items():
        t = flash_t[wrapper]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces, "launches": lm["counts"][wrapper],
            "max_abs_err": flash_errs[wrapper], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # rowblock's row: dgrad and fwd1x1, each at its best bm, summed
    for wrapper, (name, replaces) in PROBE.items():
        rows = [t for t in probe_t.values() if t["kernel"] == wrapper]
        total = {k: sum(t[k] for t in rows)
                 for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        kernels.append(dict(
            name=name, route="cuda", source=PROBE_SOURCE, replaces=replaces,
            launches=probe_counts[wrapper], max_abs_err=probe_errs[wrapper],
            bound_by="bytes" if all(t["bound_by"] == "bytes" for t in rows)
            else "operations", **total))
    log("kernels: " + ", ".join(
        k["name"] + (" (redesigned)" if k["name"] in REDESIGNED else "")
        for k in kernels))
    log(json.dumps({"kernels": kernels}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
