#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 31   # the builds and phase 31 alone
    python3 chip_smoke.py --phase 32   # the builds and phase 32 alone
    python3 chip_smoke.py --phase 33   # the builds and phase 33 alone
    python3 chip_smoke.py --phase 34   # the builds and phase 34 alone
    python3 chip_smoke.py --phase 35   # the builds and phase 35 alone

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
23. the reference's other models (after phase 21, before phase 22, which
    stays the last before the summary): (a) ``examples.train_cifar``'s
    ``main`` at its defaults (VGG-16, batch 64, bfloat16, seed 0, the
    JAX example's synthetic CIFAR) with ``--double-buffering
    --allreduce-grad-dtype float16`` for ``P23_ITERS`` iterations: exactly
    13 launches a step of each BatchNorm kernel and 2 casts a step, finite
    losses whose last five sum below the first five; images/sec and peak
    memory.  (b) One float32 step of VGG-16 (batch 64, dropout 0, TF32 off,
    cuDNN deterministic) on the card with the kernels, from the same
    ``weights.py`` weights and batch, against the same step on the card
    and on the CPU with the plain reference norm, both taking the kernel
    run's ReLU and max-pool branches (see ``p23_f32_step``):
    ``utils.compare``'s gates (loss 1e-4 relative, every gradient tensor
    1e-3 relative L2).  (c) The four BatchNorm
    kernels against their plain versions in bfloat16 at VGG-16's boundary
    shapes at batch 64 ([65536, 64] to [256, 512]) and 256, phase 2's
    limits.  (d) ``examples.train_imagenet``'s ``main`` for ``alex``,
    ``googlenet``, ``googlenetbn --aux-loss`` and ``nin`` at 224 pixels,
    1000 classes, batch 32, bfloat16, lr 0.01 (the reference example's
    MomentumSGD), ``P23_ARCH_ITERS`` iterations:
    finite losses, images/sec and peak memory; GoogLeNetBN launches each
    BatchNorm kernel exactly 66 times a step, the others none.  (e)
    ``benchmarks.run_configs`` with ``P23_CONFIGS``: the ResNet-50 and
    VGG-16 rows on the card (full shapes, 5 timed windows and the device
    time) and ``mnist_mlp`` on a gloo world of 8 CPU processes, one JSON
    line each.
24. serving (after 23, before 22), through
    ``benchmarks.bench_serving`` at phase 11's LM, uncut (seed-0 weights,
    bf16; 16 slots of 64-token chunks, 2,048 pages of 16, 128 a
    sequence): first ``cmn_flash_fwd`` against its plain version on a
    paged cache at the engine's shapes (``serving_case``: B 16, Tk 2048,
    Tq 64 and 5, kv heads 16 and 4, bf16 and float32, idle rows at offset
    0), phase 10's limits.  (a) The open-loop trace (seed 0, 32 requests,
    prompts 128-1024, up to 64 new tokens, 200 requests/s) under
    ``continuous`` then ``static``: tokens/s, requests/s, steps, TTFT and
    inter-token p50/p99, mean active slots, the device's busy share over
    5 profiled steps, peak memory; gated: every page free after each
    drain, flash forward launches exactly 8 x the target passes and no
    backward launch, continuous in no more steps than static.  Row 6 is
    timed at B 16, Tq 64, Tk 2048 (``serving_timing``, with SDPA under the
    equivalent mask).  (c) The same trace as one burst through two engines
    stepped together, the kernel's and the plain attention's: the kept
    logits within phase 10's bf16 limit (relative L2 over all rows
    compared), equal tokens wherever the plain run's top-two gap exceeds
    ``_gap_limit`` (``P24_GAP`` and two bf16 spacings at the top logit).
    (d) ``prefix`` (32 requests, 1024-token prompts 0.9
    shared, cache off then on: speedup, hit tokens) and ``spec`` (k 4, the
    one-layer draft, 16 requests, prompts 64-256, 128 new tokens: tokens a
    verify pass), the spec completions equal to greedy decoding's
    wherever its gap exceeds that limit, launches 8 x target + 1 x draft
    passes.  (e) ``fleet``: 2 replicas, 16 requests over 8 sessions: TTFT
    p50/p99, every session served by one replica.  (b) Float32 (TF32 off)
    at ``P24_B_LAYERS`` layers of the same width: each step's kept logits
    of 3 requests within ``utils/compare.py``'s relative L2 of a
    cache-free forward over the sequence so far, equal tokens where its
    gap exceeds 1e-3.  The summary's row 6 adds the serving launches.
25. the ImageNet example whole (after 24, before 22; ``phase_imagenet``).
    (a) ``benchmarks.bench_vit`` at its card defaults (ViT-B/16, batch
    256, bf16, the bf16 wire, double buffering), ``--attention flash``
    then ``xla``: images/s per GPU, MFU, step and device ms, busy share;
    gated: each flash kernel launched exactly 12 times a step call under
    flash and never under xla, 2 casts a step call, a finite and falling
    loss.  (b) ViT-B/16's width at 2 layers in float32 (TF32 off), flash
    against xla from the same weights: ``utils/compare.py``'s gates.  (c)
    Rows 6-8 at the ViT shape (phase 10 adds its bf16 and float32 cases:
    B 256, T 197, H 12, D 64, non-causal, qkv views), timed in phase 13's
    way beside SDPA without a mask.  (d) ``bench --stem s2d`` with phase
    16's gates (the same 53 BatchNorm boundaries); ``run_configs
    --tune-remat`` (each policy's rate and peak memory, "block" below
    "none"); one float32 ResNet-50 step under "block" and "norm" against
    "none": loss relative 1e-6, gradients relative L2 1e-5, running
    buffers relative 1e-6 (moved once), the BatchNorm kernels' launches
    (the blocks' 52 boundaries recomputed: statistics and apply 105, the
    backward kernels 53), the convolutions dispatched ("block" 52 more,
    "norm" none more), and "block"'s peak memory below "none"'s.  (e)
    ``train_imagenet`` ResNet-50 bf16 batch 32 on a generated ImageFolder
    (1,024 JPEGs of 8 classes at 300-500 px, 256 validation images) with 4
    loader threads: an epoch, its evaluation and 3 profiled steps, exact
    BatchNorm launches, the loader-wait share and busy share; the
    synthetic rate and a ``--train-root`` npz run in the same call.  (f)
    ``train_imagenet --arch vit_s16`` float32, one step of batch 64 with
    ``--accum-steps 4`` against one full-batch step: ``utils/compare.py``'s
    gates, and the peak memory of each.  The summary's rows add phase
    25's launches (flash and cast: (a); BatchNorm: (d)'s bench and (e)).
26. FSDP (after 25, before 22; ``phase_fsdp``), gated, cuDNN
    deterministic.  (a) ``train_imagenet --fsdp`` (ResNet-50, batch 32,
    float32, momentum SGD, 3 steps) with one bucket and with 4 (prefetch
    1): losses and parameters bit-equal to each other and to the plain
    step's, the plain step's BatchNorm launches (53 a step of each), one
    and 4 gathers and reduce-scatters a step, at most 1 and 2 gathers in
    flight.  (b) ``train_lm --attention ring_flash`` at the LM's width
    (float32, T 8192, 3 Adam steps at 1e-3) with and without ``--fsdp``:
    losses within 1e-6 relative, the same flash launches; tokens/sec and
    peak memory of both; ``fsdp_init`` of the LM leaves the allocation
    where it was (the module's parameters freed).  (c) The bfloat16 wire
    at 4 buckets: 4 ``cast_scale`` launches a bucket a step, step 0's loss
    within 1e-4 of the float32 wire's.  (d) A snapshot at iteration 2
    resumed through the example: its third step bit-equal to (a)'s; a
    resume with 2 buckets refused; ``load_inference_params(metas=)`` equal
    to the gathered parameters bit for bit.  (e)
    ``benchmarks.bench_fsdp_overlap`` at its defaults: each row's counters.
    (f) A Linear-BatchNorm-Linear model's FSDP step on the card against
    the same step on the CPU (float32 wire: 1e-5 / 2e-5; bfloat16 wire:
    5e-3).  The summary's rows add phase 26's launches (BatchNorm: (a),
    (c), (d); cast: (c); flash: (b)'s ``--fsdp`` run).
27. tensor and expert parallelism (after 26, before 22; ``phase_moe``),
    gated.  (a) The MoE LM at the LM's width (8 layers, 8 experts, top 2,
    2.43 B parameters, bf16, ``attention_impl="flash"``, T 8192, batch 1)
    through ``examples.train_moe_lm``'s ``build`` and ``train_step`` (Adam
    at the example's lr, a world of one): 3 steps, each flash kernel
    launched exactly 8 times a step, aux, overflow and the expert loads
    finite; tokens/sec per GPU, peak memory, and a profile of 2 more
    steps (device ms by category: flash, cuBLAS, the routing scatter and
    gather, the rest; busy share).  (b) Its width at 2 layers, T 2048, in
    float32 (TF32 off): one loss and gradient on the card (the flash
    kernels) against the CPU (their plain versions) from the same
    weights, the card's routing replayed into the CPU run
    (``moe_card_vs_cpu``): loss within 1e-4, gradients within 1e-3
    relative L2, at least 0.99 of the tokens routed as the CPU would
    itself, each kernel once a layer.  (c) The MoE LM (8 layers, bf16)
    served at ep 1 with phase 24's engine settings and seeded trace
    (continuous policy): tokens/s, busy share, row 6 launched once a layer
    a forward; the trace as one burst through a kernel engine and a
    plain-attention engine stepped together, the kernel engine's routing
    replayed into the plain one, at phase 24 (c)'s gates.  (d) Row 6 at a
    tensor-parallel rank's serving shape (8 and 4 heads, bf16 and float32)
    against its plain version, and timed beside its bound and SDPA.  The
    summary's rows 6-8 add (a)'s launches, row 6 (c)'s.
28. pipeline parallelism (after 27, before 22; ``phase_pipeline``),
    gated, on the world of one (one stage).  (a) The LM's 8 blocks at
    phase 11's width (bf16, flash, T 8192) as the stage, the embeddings
    before the pipeline and the loss through the frozen final norm and
    head, ``P28_M`` micro-batches of one sequence: ``make_pipeline_train_fn``
    (1F1B) and GPipe under autograd for ``P28_STEPS`` steps each: the
    first step's flash launches exactly 2 L M forwards (forward and
    recompute) and L M of dK/dV and dQ under 1F1B, L M each under GPipe;
    tokens/s over the later steps and the peak memory above the
    parameters.  (b) Float32 (TF32 off) at 2 layers, T 2048: 1F1B's loss
    and gradients against GPipe's and against one sequential pass over
    the whole batch, with the kernels and with the plain attention, and
    the kernels' 1F1B against the plain sequential pass
    (``utils/compare.py``'s gates).  The summary's rows 6-8 add (a)'s
    launches.
29. gradient compression (after 28, before 22; ``phase_compression``),
    gated.  (a) ResNet-50's gradients of one bf16 step at batch 32
    (25,557,032 values; 53 launches of each BatchNorm kernel):
    ``NoCompression("bfloat16"/"float16")`` on the flat flavor against the
    xla flavor's ``allreduce_grad_dtype``, bit for bit, 4 cast launches
    each.  (b) int8 and fp8 (deterministic) over those gradients for
    ``P29_EF_STEPS`` EF steps through ``allreduce_grad`` on the card
    against the same codec on the CPU: every step's wire (codes, flags),
    residual, exponents, step and mean bit for bit; encode and decode ms
    by CUDA events, ``wire_bits_per_param``, and stochastic rounding's
    error after the steps beside deterministic's.  (c) ``train_mnist``
    (``P29_MNIST``) uncompressed, ``--compression int8`` and ``fp8``:
    JAX's contract (the loss falls; the last within 0.1 x the
    uncompressed run's first).  (d) The LM (phase 11's width, bf16,
    flash) under FSDP for ``P29_FSDP_STEPS`` Adam steps: plain, the bf16
    wire, int8 buckets at K 1 and 4: the losses (int8 within JAX's
    contract of plain), the reduce-scatter bytes a step (int8 at least
    3.5x fewer than float32), exact flash launches; then at
    ``P29_RT_LAYERS`` layers the EF checkpoint round trip (a resumed state
    steps bit for bit as the uninterrupted one).  (e) Phase 24's LM with
    ``load_inference_params(int8_weights=True)`` (JAX's channel axes):
    phase 24 (c)'s kernel-against-plain gates on the round-tripped
    weights.  The summary's rows 1-4 add (a)'s step, row 5 (a)'s casts,
    rows 6-8 (d)'s launches.
30. the collective planner (after 29, before 22; ``phase_planner``),
    gated, on the NCCL world of one.  (a) ``bench_allreduce --sweep`` at
    ``P30_SIZES_KB``: every candidate plan checked for the mean, then
    timed by CUDA events; the rows validate, ``autotune_from_rows`` builds
    the table, which round-trips through JSON; the gradient bucket
    (ResNet-50's 102.2 MB of float32, ``<=256MiB``) holds the bf16 flat
    plan (put there whatever the world of one picked, which is printed).
    (b) ResNet-50's gradients of one bf16 step at batch 32 (53 launches of
    each BatchNorm kernel): each of the seven flavors (and xla with the
    bf16 wire) bit-equal to ``execute_plan(comm.plan())``.  (c) ``auto``
    with the table picks the bf16 flat plan for them and is bit-equal to
    ``xla`` + the bf16 wire, with 2 ``cast_scale`` launches a call; the
    card's bits equal the CPU's for the same plan.  (d) ``P30_STEPS``
    ResNet-50 steps of ``train_imagenet`` through ``auto --plan-table``
    and through ``xla`` + bf16, plain and double-buffered (cuDNN
    deterministic): finite losses, each auto run bit-equal to its xla
    run (losses and parameters), 53 launches a step of each BatchNorm
    kernel and 2 casts; images/sec beside phase 3's.  (e) The per-hop plan
    (int8 on the inter-node hop of the 2-D chain, float32 legs) equal to
    ``allreduce_grad(compressor="int8")`` bit for bit over
    ``P30_EF_STEPS`` deterministic EF steps.  (f) The
    ``__plan_table_meta__`` round trip and its two refusals.  The
    summary's rows 1-4 add (b)'s step and (d)'s runs, row 5 the casts of
    (b), (c) and (d).
31. the control plane and observability (after 22, before the summary;
    ``phase_obs``), gated.  (a) ``train_mnist`` at the example's width
    (``--unit 1000 --batchsize 100``, two epochs, xla + the float16 wire +
    double buffering), without and with ``--observability`` (a flight
    recorder installed), ``P31_PAIRS`` pairs in turn: ``cast_scale``
    launches 2 x iterations in every run, every run's parameters bit-equal
    to the first's, ``metrics.jsonl`` holding the float16
    ``allreduce_grad`` calls and bytes and the step telemetry; the second
    epoch's step time off and on, their medians, ranges and pairs.  (b)
    ``execute_plan`` of the two-dimensional plan on the bfloat16 wire over
    ResNet-50's packed gradient size, without and with
    ``pobs=get_plan_obs(comm)``: one ``plan_stage_begin``/``_end`` pair a
    stage in stage order, outputs bit-equal, the same cast launches; a
    call's host time off and on.  (c) Phase 24's LM (bf16) serving phase
    24's trace, submitted at once, without and with observability,
    ``P31_ONE_PAIR`` pair in turn: the same tokens in every run, the
    ``serving_*`` counters equal to the engine's completions and tokens,
    ``layers x passes`` flash launches; the wall time off and on.  (d)
    ``SocketControlPlane`` worlds of 2 and 4 processes on the native
    transport (built here), then a Python rank with a native one: the
    collectives' results and a frame both ways; round-trip latency at 1
    KiB and goodput at 64 MiB of both transports.  (e) A bucketed FSDP
    step (``P31_FSDP``) without and with observability, ``P31_ONE_PAIR``
    pair in turn: the shards bit-equal, each bucket's gather and
    reduce-scatter a begin/end pair a step (the edges' CUDA events, read
    at the step's end); the step time off and on.  The summary's row 5
    adds (a)'s and (b)'s casts, row 6 (c)'s launches.
32. observability's second slice (after 31, before the summary;
    ``phase_obs2``), gated.  (a) Phase 31 (a)'s observed MNIST run with
    ``CHAINERMN_TPU_WATCHDOG`` 0 and 1 (the watchdog's defaults),
    ``P32_PAIRS`` pairs in turn: no ``flight_*.json``, no watchdog thread
    after ``finalize``, the parameters bit-equal, 2 casts an iteration; the
    second epoch's step time without and with the watchdog.  (b) The same
    run with the watchdog polling every 0.1 s and iteration
    ``P32_STALL_AT``'s stream held by ``torch.cuda._sleep`` (a stimulus of
    a device-side hang): one ``step_stall`` dump, written inside the held
    step while the main thread waits in the stream synchronize (its stack
    in the dump), and the run's parameters bit-equal to (a)'s.  (c)
    ``bench_allreduce --traced`` on the bf16 plan over ResNet-50's packed
    gradient size (``P32_TRACED``): ``tracing_overhead/v1`` with its
    per-repeat pairs and spread, 2 casts a call; ``--replay-spans`` on the
    committed degraded dump gives the CPU's decision (``P32_REPLAY_HASH``).
    (d) ``diff_runs`` of (a)'s last observed run against a run with
    ``P32_DELAY_S`` of host time a batch names ``host_input``; the run
    against itself names none.  (e) Phase 24's trace with observability
    on, then one ``TelemetryAggregator.collect``: the fleet p50/p95/p99 of
    the ``serving_*`` streaming histograms equal the registry's; flash
    launches ``layers x passes``.  The summary's row 5 adds (a)-(d)'s
    casts, row 6 (e)'s launches.
33. the elastic runtime and the run ledger (after 32, before the summary;
    ``phase_elastic``), gated.  (a) ResNet-50's data-parallel train state
    (about 205 MB: float32 parameters, BatchNorm statistics, SGD momentum)
    with bf16 steps through the BatchNorm kernels and the float16 wire's
    cast, ``P33_SAVES`` saves through ``npz`` and through ``async`` in
    turn, ``P33_GAP`` steps before each: each save's stall (what ``save``
    blocks for) as median and range, async below npz; both backends then
    save the same step, a step updates the state in place, and after the
    drain the two generations are equal bit for bit; 53 launches of each
    BatchNorm kernel and 2 casts a step.  (b) ``tools.elastic_smoke``
    (``P33_SMOKE``): its A/B leg on the card, the chaos world started on 2
    gloo ranks on the CPU, rank 1 SIGKILLed, relaunched by the supervisor
    on the card at world 1 (NCCL) through ``resume_resized``: a restart
    manifest with the survivor's dump, at most one lost step, losses
    within 1e-4 of the uninterrupted run; then ``tools.perf_gate
    --elastic`` with the port's budgets.  (c) ``tools.ledger ingest`` of
    the committed artifacts and of (a)'s and (b)'s under ``build/p33``
    into one ledger: everything classifies, the card's records form a cell
    of their own, and the card's baseline is a card's; ``tools.
    obs_report`` over phase 31's metrics JSONL.  The summary's rows 1-5
    add (a)'s launches.
34. static analysis (after 33, before the summary; ``phase_lint``),
    gated.  (a) ResNet-50 at full width (batch 32, bf16,
    ``FusedBatchNormAct`` at every boundary) on the float16 wire of the
    NCCL world of one, ``P34_STEPS`` steps under ``analysis.lint_step``
    (``census-drift`` against the xla flavor, ``wire-dtype-mismatch``
    against its float16 plan, ``async-pair``, ``captured-constant``,
    ``donation-alias``): no finding, a float16 all-reduce recorded, the
    parameters and buffers bit-equal to a twin's bare steps (cuDNN
    deterministic), 53 launches of each BatchNorm kernel and 2 casts a
    step (and 2 of the census probe); then as many steps bare and
    recorded for the recorder's cost.  (b) Planted faults, each caught
    with JAX's rule ID: a rank-branching variant recorded dry at ranks 0
    and 1 of a fake world of 2 in a process with no card
    (``schedule-desync``, nothing issued), a float32 all-reduce under a
    float16 plan (``wire-dtype-mismatch``), a handle never waited
    (``async-pair``), a 64 MiB CUDA tensor closed over
    (``captured-constant``).  (c) ``tools.cmn_lint --protocol`` over the
    port's tree: no finding.  (d) ``tools.check_db_overlap`` on the card:
    "not judgeable" at a world of one.  The summary's rows 1-5 add (a)'s
    launches.
35. the rest of the reference's measurement tools (after 34, before the
    summary; ``phase_queue_a``), gated.  (a) ``benchmarks.bench_lm`` at
    its card defaults (phase 11's LM, 553.9 M parameters, T 8192, bf16,
    the bf16 wire, double buffering, 10 timed steps): the line's keys
    (JAX's, and the MFU), 3.6239 train GFLOP/token, finite losses, 8
    launches of each flash kernel and 2 casts a step.  (b)
    ``benchmarks.bench_flash_64k`` at T 65536 (B 1, H 4, D 128, bf16,
    causal): every stage, the window check within the bf16 tolerance, the
    training step's losses moving and its weight delta non-zero; and
    ``tools.gpu_smoke``'s T 262144 step with its window check (the first
    length whose T^2 passes 2^32).  (c) ``gpu_smoke``'s checks that no
    phase covers: GQA rectangular attention (out, dq, dk, dv against the
    plain version's autograd within ``FLASH_TOL`` relative L2), the
    forward and backward at T 32768 with the window check there.  (d) the
    BatchNorm kernels against their plain versions at every [R, C] of
    ResNet-50 at 32 px and batch 16 in bf16 (R 4096 down to 16), then
    ``tools.convergence_ledger`` rows ``mnist_mlp`` and
    ``tiny_resnet_synthetic_imagenet`` at or above JAX's floors (the
    ResNet row through the BatchNorm kernels at those shapes).  The
    summary's rows add (a)-(d)'s launches, less those that compared a
    kernel with its plain version.

The cast check (6) runs right after the BatchNorm kernel check (2).
"""

import contextlib
import json
import math
import os
import shutil
import statistics
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
    from chainermn_tpu_torch.utils.gpu_info import smi_line
    return smi_line(0)


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
        # ViT-B/16's attention (phase 25): T 197 (three 64-row tiles and
        # one of 5), non-causal, D 64, q/k/v views of the qkv projection
        ("vit_qkv_views_d64", bf, 256, 197, 197, 12, 12, 64, False,
         {"qkv": True}),
        ("vit_qkv_views_d64_f32", f32, 256, 197, 197, 12, 12, 64, False,
         {"qkv": True}),
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


def phase_flash_timing(fa, torch, dev, card, dtype, shape=None,
                       causal=True):
    """Each flash kernel at the LM's attention shape in ``dtype`` (or at
    ``shape`` = (B, T, H, D), ``causal`` or not): kernel (CUDA graph
    replay), eager, plain, library and the bound at the peak of ``dtype``
    (bf16: the tensor cores; float32, TF32 off: the CUDA cores, the
    ``*_f32_kernel`` variants that ``ring_flash`` runs in the float32
    long-context example)."""
    import torch.nn.functional as F
    from chainermn_tpu_torch.utils.compare import no_tf32
    with no_tf32():
        f32 = dtype == torch.float32
        lm = shape is None
        b, t, h, d = shape or (1, LM_T, LM["n_heads"],
                               LM["d_model"] // LM["n_heads"])
        gen = torch.Generator(device=dev).manual_seed(13 if f32 else 9)
        # q, k, v as the model gives them: views of one qkv projection
        qkv = (torch.randn(b, t, 3 * h * d, device=dev, generator=gen)
               * 0.5).to(dtype)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d)
                   for i in range(3))
        g = torch.randn(b, t, h, d, device=dev, generator=gen).to(dtype)
        out, lse = fa.flash_fwd(q, k, v, causal)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        bwd = (q, k, v, g, lse, delta, None, causal)
        kern = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, causal),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*bwd),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd)}
        reps = 5 if f32 else 10
        # the plain backward computes dq, dk and dv in one loop: its time
        # stands beside both backward kernels
        plain_fwd = _time(torch, lambda: fa.flash_forward_plain(
            q, k, v, causal), 2, graph=False)
        torch.cuda.empty_cache()
        plain_bwd = _time(torch, lambda: fa.flash_backward_plain(
            *bwd, block_k=1024), 2, graph=False)
        torch.cuda.empty_cache()
        q3, k3, v3 = (x.transpose(1, 2) for x in (q, k, v))
        lib_fwd = _time(torch, lambda: F.scaled_dot_product_attention(
            q3, k3, v3, is_causal=causal), 2 * reps, graph=True)
        qt, kt, vt = (x.detach().requires_grad_() for x in (q3, k3, v3))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
        gt = g.transpose(1, 2)
        lib_bwd_name = "SDPA autograd backward, dq+dk+dv"
        lib_bwd = _time(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), gt, retain_graph=True), reps, graph=False)
        del lib_out
        peak = card.f32_tflops if f32 else card.peak_tflops
        name = str(dtype).split(".")[1]
        out_t = {}
        for w, (_, _, kind) in FLASH.items():
            ops = fa.flash_attention_flops(b, t, t, h, d, causal, kind)
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
            log(f"timing: {w} at B{b} T{t} H{h} D{d} "
                f"{'causal' if causal else 'non-causal'} {name}"
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
                   if lm and f32 and w in FLASH_F32_CUDA_CORE_MS else "")
                + ("" if f32 or not lm else f"; mma.sync design "
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


def phase_bench(fn, cs, torch, argv=()):
    """``benchmarks.bench.main`` at its card defaults (and ``argv``):
    ResNet-50, batch 256, the bf16 wire with double buffering, 20 steps
    after 5 (then 1, and 3 + 3 a profiler capture for its device time: the
    profiler's warm-up step and the timed one); every BatchNorm kernel 53
    times a step (the s2d stem has the same 53 boundaries), 2 casts a
    step.  Returns the line, the launches and the peak memory in GB."""
    from chainermn_tpu_torch.benchmarks import bench
    fn.reset_launch_counts()
    cs.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    line = bench.main(list(argv))
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


# phase 23: the reference's other models
P23_ITERS = 30       # (a) train_cifar iterations at its defaults
P23_ARCH_ITERS = 10  # (d) train_imagenet iterations of each arch
P23_ARCHS = (("alex", []), ("googlenet", []), ("googlenetbn", ["--aux-loss"]),
             ("nin", []))
P23_LR = "0.01"      # (d): the reference ImageNet example's MomentumSGD lr
P23_BN = {"googlenetbn": 66}  # BatchNorm boundaries a step of (d)'s archs
P23_CONFIGS = "resnet50_xla,vgg16_cifar_db,mnist_mlp"


def vgg_bn_shapes(batch):
    """The [R, C] of VGG-16's 13 BatchNorm boundaries at 32 pixels."""
    shapes, size = [], 32
    for c in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
              512, "M", 512, 512, 512, "M"):
        if c == "M":
            size //= 2
        else:
            shapes.append((batch * size * size, c))
    return shapes


class _Decisions:
    """Stands in for ``torch.nn.functional`` inside ``models.vgg`` during
    phase 23 (b): records the ReLU masks and max-pool indices of a run
    (``replay`` None), or replays a recorded run's (``replay`` set), so
    that two runs take the same branches; ``flips`` counts the decisions
    a replaying run would have taken otherwise."""

    def __init__(self, F):
        self.F, self.record, self.replay, self.flips = F, [], None, 0

    def __getattr__(self, name):
        return getattr(self.F, name)

    def _pinned(self, own):
        if self.replay is None:
            self.record.append(own)
            return own
        got = next(self.replay).to(own.device)
        self.flips += int((got != own).sum())
        return got

    def relu(self, x):
        return x * self._pinned(x.detach() > 0)

    def max_pool2d(self, x, k, s):
        idx = self._pinned(self.F.max_pool2d(x.detach(), k, s,
                                             return_indices=True)[1])
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)


def p23_f32_step(fn, torch, dev):
    """(b): one float32 step of VGG-16 (batch 64, dropout 0, TF32 off,
    cuDNN deterministic) from the same weights and batch: on the card with
    the kernels, then on the card and on the CPU with the plain reference
    norm; ``utils.compare``'s gates (loss 1e-4, every gradient tensor 1e-3
    relative L2).  The plain runs take the kernel run's branches: its
    ReLU masks (each norm's, and the dense layer's) and max-pool indices
    are replayed (``_Decisions``; ``_Pinned`` norms).  Without that, a
    ReLU input or a max-pool pair within the runs' float32 drift takes
    the other branch, and one such element moves every gradient below it
    by ~5e-3 (PR 14's first runs: 6 of 17.7 million ReLU outputs, 9.69e-3
    and 6.00e-3 worst).  The decisions each plain run would have taken
    otherwise are counted and printed.  Returns the errors."""
    import importlib
    import torch.nn.functional as F
    from chainermn_tpu_torch import weights
    from chainermn_tpu_torch.models import VGG16
    from chainermn_tpu_torch.utils.compare import (
        no_tf32, step_agrees, step_errors)
    vgg = importlib.import_module("chainermn_tpu_torch.models.vgg")
    dec = _Decisions(F)
    masks = []

    class _Pinned(fn.ReferenceBatchNormAct):
        """The plain norm without its ReLU, times the kernel run's mask."""

        def forward(self, x):
            self.fuse_relu = False
            y = super().forward(x)
            return y * dec._pinned(y.detach() > 0)

    src = VGG16(device="cpu", generator=torch.Generator().manual_seed(3))
    variables = weights.state_dict_to_flax(src)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((64, 3, 32, 32), generator=gen)
    y = torch.randint(0, 10, (64,), generator=gen)
    runs = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    vgg.F = dec
    try:
        with no_tf32():
            for name, d, norm in (("kernels", dev, fn.FusedBatchNormAct),
                                  ("plain", dev, _Pinned),
                                  ("cpu", torch.device("cpu"), _Pinned)):
                model = weights.load_flax_variables(
                    VGG16(dropout_rate=0.0, norm_cls=norm, device=d),
                    variables)
                model.train()
                if name == "kernels":
                    for m in model.norms:  # the fused ReLU's mask
                        m.register_forward_hook(
                            lambda m, i, o: masks.append(o.detach() > 0))
                else:
                    dec.replay, dec.flips = iter(dec.record), 0
                loss = F.cross_entropy(model(x.to(d)), y.to(d))
                loss.backward()
                if name == "kernels":
                    # the order the plain runs meet them in: a norm's mask
                    # before the pool or ReLU after it
                    pools = iter(dec.record)
                    dec.record = []
                    norms = iter(masks)
                    for c in vgg.CFG_16:
                        dec.record.append(next(pools if c == "M" else norms))
                    dec.record.append(next(pools))  # the dense layer's ReLU
                runs[name] = (loss.item(), {
                    k: p.grad.detach().cpu()
                    for k, p in model.named_parameters()}, dec.flips)
                del model
    finally:
        vgg.F = F
        torch.backends.cudnn.deterministic = det
    out = {}
    lk, gk, _ = runs["kernels"]
    for other in ("plain", "cpu"):
        lp, gp, flips = runs[other]
        loss_rel, grad_rel, worst = step_errors([lk], [lp], gk, gp)
        log(f"phase 23 (b): float32 VGG-16 step, kernels on the card vs "
            f"{other} with the kernels' branches: loss {lk:.7f} / {lp:.7f} "
            f"(rel {loss_rel:.2e}); worst gradient relative L2 "
            f"{grad_rel:.2e} ({worst}) over {len(gp)} tensors; gates 1e-4 "
            f"and 1e-3; decisions it would have taken otherwise: {flips}")
        if not step_agrees(loss_rel, grad_rel):
            raise AssertionError(f"phase 23 (b): the float32 VGG-16 step "
                                 f"with the kernels disagrees with {other}")
        out[other] = dict(loss_rel=loss_rel, grad_rel=grad_rel, worst=worst,
                          flips=flips)
    return out


def phase_models(fn, cs, torch, dev):
    """Phase 23: the reference's other models (see the module docstring).
    Returns what the log line prints."""
    from chainermn_tpu_torch.benchmarks import run_configs
    from chainermn_tpu_torch.examples import train_cifar, train_imagenet
    out = {}
    # (a) train_cifar at its defaults, on the float16 wire with double
    # buffering
    fn.reset_launch_counts()
    cs.reset_launch_counts()
    res = train_cifar.main(["--double-buffering", "--allreduce-grad-dtype",
                            "float16", "--iterations", str(P23_ITERS),
                            "--log-interval", str(P23_ITERS),
                            "--warmup-steps", "5"])
    counts = dict(fn.launch_counts(), cast_scale=cs.cast_scale.launches)
    want = dict({w: 13 * P23_ITERS for w in fn.launch_counts()},
                cast_scale=2 * P23_ITERS)
    losses = res["losses"]
    if counts != want:
        raise AssertionError(f"phase 23 (a) launches {counts}, expected "
                             f"{want} (13 BatchNorm boundaries and 2 casts "
                             "a step)")
    if len(losses) != P23_ITERS or not all(map(math.isfinite, losses)) or \
            not sum(losses[-5:]) < sum(losses[:5]):
        raise AssertionError(f"phase 23 (a): losses {losses}")
    out["cifar"] = dict(losses=losses, counts=counts,
                        images_per_sec=res["images_per_sec"],
                        peak_gb=res["peak_memory_gb"])
    del res
    # (b) float32 step, card against CPU
    out["f32"] = p23_f32_step(fn, torch, dev)
    # (c) the BatchNorm kernels at VGG-16's boundaries, batch 64 and 256
    errs = {}
    phase_kernels(fn, torch, dev, sorted(set(vgg_bn_shapes(64))
                                         | set(vgg_bn_shapes(256)),
                                         reverse=True),
                  (torch.bfloat16,), errs)
    out["kernel_errs"] = errs
    # (d) the ImageNet example's other archs at full width
    out["archs"] = {}
    for arch, extra in P23_ARCHS:
        fn.reset_launch_counts()
        torch.cuda.empty_cache()
        res = train_imagenet.main([
            "--arch", arch, "--communicator", "xla", "--batchsize",
            str(BATCH), "--iterations", str(P23_ARCH_ITERS), "--dtype",
            "bfloat16", "--train-size", str(BATCH * P23_ARCH_ITERS),
            "--val-size", "0", "--seed", "0", "--log-interval",
            str(P23_ARCH_ITERS), "--warmup-steps", str(WARMUP), "--lr",
            P23_LR] + extra)
        losses = res["losses"]
        counts = fn.launch_counts()
        n_bn = P23_BN.get(arch, 0)
        if len(losses) != P23_ARCH_ITERS or \
                not all(map(math.isfinite, losses)):
            raise AssertionError(f"phase 23 (d) {arch}: losses {losses}")
        if counts != {w: n_bn * P23_ARCH_ITERS for w in counts}:
            raise AssertionError(f"phase 23 (d) {arch}: launches {counts}, "
                                 f"expected {n_bn} of each a step")
        out["archs"][" ".join([arch] + extra)] = dict(
            losses=losses, bn_launches=counts,
            images_per_sec=res["images_per_sec"],
            peak_gb=res["peak_memory_gb"])
        del res
    # (e) the configs runner: two card rows and the CPU world's
    torch.cuda.empty_cache()
    rows = run_configs.main(["--configs", P23_CONFIGS])
    for r in rows:
        if not (math.isfinite(r["value"]) and r["value"] > 0
                and math.isfinite(r["final_loss"]) and r["card"]) or (
                r["config"] != "mnist_mlp"
                and not r["device_ms_per_step"] > 0):
            raise AssertionError(f"phase 23 (e): row not sane: {r}")
    out["configs"] = {r["config"]: r["value"] for r in rows}
    torch.cuda.empty_cache()
    return out


# phase 24: serving (bench_serving's engine at the LM's full width)
P24_FLAGS = ["--device", "cuda", "--dtype", "bfloat16", "--seed", "0",
             "--vocab", str(LM["vocab"]), "--d-model", str(LM["d_model"]),
             "--n-layers", str(LM["n_layers"]),
             "--n-heads", str(LM["n_heads"]), "--max-len",
             str(LM["max_len"]), "--page-size", "16", "--num-pages", "2048",
             "--max-seqs", "16", "--chunk-tokens", "64",
             "--max-pages-per-seq", "128", "--rate", "200"]
# (a) and (e): the open-loop trace; (d) the prefix and spec bursts
P24_TRACE = ["--requests", "32", "--min-prompt", "128", "--max-prompt",
             "1024", "--max-new", "64"]
P24_PREFIX = ["--requests", "32", "--prefix-prompt", "1024",
              "--prefix-share", "0.9", "--prefix-max-new", "4"]
P24_SPEC = ["--requests", "16", "--min-prompt", "64", "--max-prompt", "256",
            "--spec-k", "4", "--spec-max-new", "128"]
P24_FLEET = ["--requests", "16", "--min-prompt", "128", "--max-prompt",
             "1024", "--max-new", "64", "--replicas", "2", "--sessions",
             "8"]
P24_PARAMS_M = 553.9  # the LM's parameters (phase 11's check), millions
P24_B_LAYERS = 2     # (b): the float32 check's depth
P24_B_PROMPTS = (200, 77, 9)   # (b): prompt lengths (200: 4 prefill chunks)
P24_B_NEW = 6
# (c), (d): tokens are compared where the plain run's top-two gap exceeds
# P24_GAP and two bfloat16 spacings at its top logit.  The logits are bf16
# (the head's output): from 2 to 4 they step by 1/64, from 4 to 8 by 1/32,
# so two runs whose logits differ below a spacing can still round a pair
# apart by one spacing each, a flip at a gap of up to two spacings
P24_GAP = 2e-2
# the flash forward at serving shapes: (B, Tq, Tk, H, D) and each row's
# offset (rows 0 and 14 idle at offset 0; 2047 a decode at the cache's
# last position, its padded rows past Tk)
SERVE_SHAPE = (16, 64, 2048, 16, 128)
SERVE_OFFS = (0, 5, 63, 64, 100, 511, 777, 1000, 1023, 1024, 1500, 1984,
              2000, 2047, 0, 300)


def serving_case(fa, kv, torch, dev, dtype, tq, hk, seed=0, page=16,
                 h=None):
    """The flash forward against its plain version on a paged cache at a
    serving shape (``h`` query heads, default the LM's 16; a tensor-parallel
    rank's 8 or 4): every active row holds the pages its offset reaches
    (drawn at random from 2048), the rest of its table and all of an idle
    row's point at the trash page; keys past a row's length hold the
    cache's other contents.  ``(max abs error, relative L2 error)``."""
    b, _, tk, h0, d = SERVE_SHAPE
    h = h or h0
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages, per_row = 2048, tk // page
    cache_k = torch.randn(n_pages + 1, page, hk, d, generator=gen,
                          device=dev).mul_(0.5).to(dtype)
    cache_v = torch.randn(n_pages + 1, page, hk, d, generator=gen,
                          device=dev).to(dtype)
    table = torch.full((b, per_row), n_pages, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    used = 0
    for i, off in enumerate(SERVE_OFFS):
        if i in (0, 14):
            continue
        n = min(per_row, -(-(off + tq) // page))
        table[i, :n] = perm[used:used + n]
        used += n
    q = (torch.randn(b, tq, h, d, generator=gen, device=dev) * 0.5).to(dtype)
    kc, vc = kv.gather_kv(cache_k, table), kv.gather_kv(cache_v, table)
    offs = torch.tensor([[o, 0] for o in SERVE_OFFS], dtype=torch.int32,
                        device=dev)
    out_k, _ = fa.flash_fwd(q, kc, vc, True, offs=offs)
    out_p, _ = fa.flash_forward_plain(q, kc, vc, True, offs=offs)
    torch.cuda.synchronize()
    return (float((out_k.float() - out_p.float()).abs().max()),
            _rel(torch, out_k, out_p))


def serving_timing(fa, kv, torch, dev, card, h=None):
    """Row 6 at the serving shape (bf16, H = Hkv = 16, or ``h``: a
    tensor-parallel rank's heads; the phase's offsets): the kernel by
    CUDA-graph replay, its plain version, and SDPA with the equivalent
    boolean mask; the bound counts the bytes of q, the gathered K/V, out
    and lse (the work is far under the product bound)."""
    import torch.nn.functional as F
    b, tq, tk, h0, d = SERVE_SHAPE
    h = h or h0
    gen = torch.Generator(device=dev).manual_seed(1)
    mk = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                device=dev).to(torch.bfloat16)
    q, k, v = mk(b, tq, h, d), mk(b, tk, h, d), mk(b, tk, h, d)
    offs = torch.tensor([[o, 0] for o in SERVE_OFFS], dtype=torch.int32,
                        device=dev)
    qpos = offs[:, :1, None] + torch.arange(tq, device=dev)[None, :, None]
    mask = (torch.arange(tk, device=dev)[None, None, :] <= qpos)[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = _time(torch, lambda: fa.flash_fwd(q, k, v, True, offs=offs), 20,
               True)
    plain_ms = _time(torch, lambda: fa.flash_forward_plain(
        q, k, v, True, offs=offs), 5, False)
    library_ms = _time(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 20, True)
    # the bytes this data needs: q, out and lse, and of K and V only the
    # keys some query of the row can see (the kernel skips the tiles past
    # each row's diagonal; rows of small offsets read few pages)
    seen = sum(min(o + tq, tk) for o in SERVE_OFFS)
    nbytes = (fa.flash_attention_bytes(b, tq, 0, h, h, d, torch.bfloat16)
              + 2 * seen * h * d * 2)
    pairs = sum(fa._pairs(tq, tk, True, o) for o in SERVE_OFFS)
    flops = 4 * d * h * pairs
    bound = max(nbytes / card.hbm_bytes_per_s,
                flops / (card.peak_tflops * 1e12)) * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bytes=nbytes, flops=flops,
                bound_by="bytes" if nbytes / card.hbm_bytes_per_s
                >= flops / (card.peak_tflops * 1e12) else "operations")


def _bf16_ulp(x):
    """The spacing of bfloat16 values at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def _spacings(flips):
    """``{gap in bf16 spacings at the top logit: flips}``."""
    out = {}
    for f in flips:
        k = str(round(f["gap"] / _bf16_ulp(f["top"]), 3))
        out[k] = out.get(k, 0) + 1
    return out


def _gap_limit(top):
    """The top-two gap above which phase 24 compares tokens (P24_GAP)."""
    return max(P24_GAP, 2 * _bf16_ulp(top))


def _top2_gap(row):
    top = row.float().topk(2).values
    return float(top[0] - top[1])


class _PlainAttention:
    """Inside the block, ``serving.kv_cache``'s attention is the flash
    forward's plain version (phase 24 (c)'s reference run on the card)."""

    def __init__(self, fa, kv, torch):
        self.fa, self.kv, self.torch = fa, kv, torch

    def __enter__(self):
        fa, torch = self.fa, self.torch

        def plain(q, k, v, causal, sm_scale=None, q_offset=None):
            off = q_offset.to(torch.int32)
            offs = torch.stack([off, torch.zeros_like(off)], 1)
            return fa.flash_forward_plain(q, k, v, causal, sm_scale,
                                          offs=offs)[0]

        self.orig, self.kv.flash_attention = self.kv.flash_attention, plain

    def __exit__(self, *exc):
        self.kv.flash_attention = self.orig


def p24_b(torch, args):
    """(b): float32 (TF32 off) at P24_B_LAYERS layers of the LM's width
    (``args``: the phase's flags with those changes and 64 pages): each
    step's kept logits of 3 requests against a cache-free forward of the
    same model (its plain attention) over the sequence so far;
    ``(worst relative L2, rows, near-ties)``."""
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    from chainermn_tpu_torch.serving import InferenceEngine
    from chainermn_tpu_torch.utils.compare import GRAD_RTOL, no_tf32, rel_l2
    import numpy as np
    model = bs.build_model(args)
    dev = torch.device(args.device)
    eng = InferenceEngine(model, bs._config(args, keep_logits=True))
    rng = np.random.default_rng(24)
    ctx = {}
    for n in P24_B_PROMPTS:
        p = list(map(int, rng.integers(1, LM["vocab"], size=n)))
        ctx[eng.submit(p, P24_B_NEW)] = p
    worst, rows, ties = 0.0, 0, 0
    with no_tf32(), torch.inference_mode():
        while not eng.idle():
            res = eng.step()
            slot = {s.rid: i for i, s in enumerate(eng.scheduler.slots)
                    if s is not None}
            for rid, tok, _ in res.emitted:
                ref = model(torch.tensor([ctx[rid]], device=dev))[0, -1]
                got = torch.from_numpy(res.last_logits[slot[rid]])
                err = rel_l2(got, ref.cpu())
                worst, rows = max(worst, err), rows + 1
                if not err <= GRAD_RTOL:
                    raise AssertionError(f"phase 24 (b): rid {rid} logits "
                                         f"rel L2 {err:.3g} over {GRAD_RTOL}")
                if tok != int(ref.argmax()):
                    if _top2_gap(ref) > 1e-3:
                        raise AssertionError(
                            f"phase 24 (b): rid {rid} token {tok}, the full "
                            f"context's {int(ref.argmax())} (gap "
                            f"{_top2_gap(ref):.3g})")
                    ties += 1
                ctx[rid].append(tok)
    if rows != len(P24_B_PROMPTS) * P24_B_NEW:
        raise AssertionError(f"phase 24 (b): {rows} rows compared")
    del model, eng
    return dict(worst_rel=worst, rows=rows, near_ties=ties)


def p24_c(fa, kv, torch, model, args):
    """(c): the (a) trace as one burst through two bf16 engines stepped
    together, one with the kernel, one with its plain version: the kept
    logits of every row whose request's tokens agree so far (relative L2
    of them all within phase 10's bf16 limit), equal tokens where the
    plain run's top-two gap exceeds ``_gap_limit``; a request is compared
    up to its first differing token, which is recorded.  A MoE model's
    routing is the kernel engine's, replayed into the plain engine step by
    step (``_Routes``; its own flips counted): a gate near a tie moves a
    token's whole MLP output, as a ReLU branch does in phase 23."""
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    from chainermn_tpu_torch.serving import InferenceEngine
    cfg = bs._config(args, keep_logits=True)
    engs = [InferenceEngine(model, cfg) for _ in range(2)]
    for _, prompt, max_new in bs.build_trace(args):
        for e in engs:
            e.submit(prompt, max_new)
    diverged, num, den, worst = set(), 0.0, 0.0, 0.0
    tokens, flips, max_abs = 0, [], 0.0
    moe = bool(getattr(model, "moe_experts", 0))
    route_flips = route_decisions = 0
    while not engs[0].idle():
        routes = _Routes()
        with routes.record() if moe else contextlib.nullcontext():
            rk = engs[0].step()
        with _PlainAttention(fa, kv, torch), \
                routes.replay() if moe else contextlib.nullcontext():
            rp = engs[1].step()
        route_flips += routes.flips
        route_decisions += routes.decisions
        if rk.plan != rp.plan:
            raise AssertionError("phase 24 (c): the plans differ")
        if not rk.ran_forward:
            continue
        slot = {s.rid: i for i, s in enumerate(engs[0].scheduler.slots)
                if s is not None}
        for rid, i in slot.items():
            if rid in diverged or rk.n_new[i] == 0:
                continue
            a = torch.from_numpy(rk.last_logits[i])
            b = torch.from_numpy(rp.last_logits[i])
            num += float((a - b).norm() ** 2)
            den += float(b.norm() ** 2)
            worst = max(worst, _rel(torch, a, b))
            max_abs = max(max_abs, float((a - b).abs().max()))
        pt = {rid: (tok, slot[rid]) for rid, tok, _ in rp.emitted}
        for rid, tok, _ in rk.emitted:
            if rid in diverged:
                continue
            ptok, i = pt[rid]
            if tok == ptok:
                tokens += 1
                continue
            a = torch.from_numpy(rk.last_logits[i])
            b = torch.from_numpy(rp.last_logits[i])
            flips.append(dict(
                rid=rid, kernel=tok, plain=ptok,
                gap=_top2_gap(b), top=float(b.max()),
                kernel_logits=[float(a[tok]), float(a[ptok])],
                plain_logits=[float(b[tok]), float(b[ptok])]))
            diverged.add(rid)
    rel = (num / den) ** 0.5
    over = [f for f in flips if f["gap"] > _gap_limit(f["top"])]
    del engs
    out = dict(rel_l2=rel, worst_row_rel=worst, max_abs=max_abs,
               tokens=tokens, flips=len(flips), flip_gaps=_spacings(flips),
               over=over, ok=rel <= FLASH_TOL["bfloat16"] and not over)
    if moe:
        out.update(routing_flips=route_flips,
                   routing_decisions=route_decisions)
    return out


def p24_spec_gate(torch, model, args, spec):
    """(d): the spec run's completions against plain greedy decoding of
    the same burst (a vanilla engine keeping its logits): equal tokens up
    to the first position where greedy's top-two gap is within
    ``_gap_limit``."""
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    from chainermn_tpu_torch.serving import InferenceEngine
    eng = InferenceEngine(model, bs._config(args, keep_logits=True))
    trace = bs.build_spec_trace(args)
    bs._warm(eng, trace[0][0])  # as run_spec's engines: the same rids
    for prompt, max_new in trace:
        eng.submit(prompt, max_new)
    gaps = {}
    while not eng.idle():
        res = eng.step()
        slot = {s.rid: i for i, s in enumerate(eng.scheduler.slots)
                if s is not None}
        for rid, tok, _ in res.emitted:
            row = torch.from_numpy(res.last_logits[slot[rid]])
            gaps.setdefault(rid, []).append((_top2_gap(row),
                                             float(row.max())))
    greedy = {c.rid: c.tokens for c in eng.completions}
    equal, flips = 0, []
    for rid, toks in spec["completions"].items():
        for j, (a, b) in enumerate(zip(toks, greedy[rid])):
            if a != b:
                flips.append(dict(rid=rid, at=j, spec=a, greedy=b,
                                  gap=gaps[rid][j][0], top=gaps[rid][j][1]))
                break
            equal += 1
    del eng
    over = [f for f in flips if f["gap"] > _gap_limit(f["top"])]
    return dict(equal_tokens=equal, flips=len(flips),
                flip_gaps=_spacings(flips), over=over, ok=not over)


def _p24_launches(fa, passes, layers, draft_layers=1):
    """The flash launches since the last reset against the passes that
    ran; raises unless forward == layers x target + draft_layers x draft
    passes and no backward kernel launched."""
    counts = fa.launch_counts()
    want = {"flash_fwd": layers * passes.get("target", 0)
            + draft_layers * passes.get("draft", 0),
            "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    if counts != want:
        raise AssertionError(f"phase 24 launches {counts}, expected {want} "
                             f"(passes {passes})")
    return counts["flash_fwd"]


def phase_serving(fa, torch, dev, card):
    """Phase 24: serving (see the module docstring).  Returns what the log
    lines print."""
    import importlib
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    kv = importlib.import_module("chainermn_tpu_torch.serving.kv_cache")
    p = bs.parser()
    args = p.parse_args(P24_FLAGS + P24_TRACE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"shape_errs": {}}
    # the kernel at the phase's attention shapes first (its first launch
    # at them, before the engine's)
    h = SERVE_SHAPE[3]
    for dt in (torch.bfloat16, torch.float32):
        for tq in (SERVE_SHAPE[1], 5):  # a chunk; spec's k + 1 at k 4
            for hk in (h, h // 4):
                err = serving_case(fa, kv, torch, dev, dt, tq, hk)
                tol = FLASH_TOL[str(dt).split(".")[1]]
                out["shape_errs"][f"{str(dt)[6:]} Tq{tq} Hkv{hk}"] = err
                if not err[1] <= tol:
                    raise AssertionError(f"phase 24: flash at a serving "
                                         f"shape: {err} over {tol}")
    model = bs.build_model(args)
    n_params = sum(x.numel() for x in model.parameters())
    if round(n_params / 1e6, 1) != P24_PARAMS_M:
        raise AssertionError(f"{n_params} parameters, expected "
                             f"{P24_PARAMS_M} M")
    # (a): the main path, counted
    fa.reset_launch_counts()
    pol = {pl: bs.run_policy(pl, model, bs.build_trace(args), args)
           for pl in ("continuous", "static")}
    passes = {"target": sum(r["passes"]["target"] for r in pol.values())}
    out["launches"] = _p24_launches(fa, passes, LM["n_layers"])
    for pl, r in pol.items():
        if r["free_pages"] != r["num_pages"] or \
                r["requests"] != args.requests:
            raise AssertionError(f"phase 24 (a) {pl}: {r['requests']} "
                                 f"requests, {r['free_pages']} pages free")
    if pol["continuous"]["steps"] > pol["static"]["steps"]:
        raise AssertionError("phase 24 (a): continuous took more steps than "
                             "static")
    out["policies"] = pol
    out["timing"] = serving_timing(fa, kv, torch, dev, card)
    # (c) the same trace, kernel vs plain, bf16
    out["c"] = p24_c(fa, kv, torch, model, args)
    # (d) prefix and spec
    fa.reset_launch_counts()
    pa = p.parse_args(P24_FLAGS + P24_PREFIX)
    out["prefix"] = bs.run_prefix(model, pa)
    sa = p.parse_args(P24_FLAGS + P24_SPEC)
    out["spec"] = bs.run_spec(model, sa)
    out["launches_d"] = _p24_launches(fa, {
        k: out["prefix"]["passes"].get(k, 0) + out["spec"]["passes"].get(
            k, 0) for k in ("target", "draft")}, LM["n_layers"])
    out["spec_gate"] = p24_spec_gate(torch, model, sa, out["spec"])
    # (e) the fleet
    fa.reset_launch_counts()
    fa_args = p.parse_args(P24_FLAGS + P24_FLEET)
    out["fleet"] = bs.run_fleet(model, bs.build_trace(fa_args), fa_args)
    out["launches_e"] = _p24_launches(fa, out["fleet"]["passes"],
                                      LM["n_layers"])
    if not out["fleet"]["session_affinity_ok"] or \
            out["fleet"]["requests"] != fa_args.requests:
        raise AssertionError(f"phase 24 (e): {out['fleet']}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["serving_launches"] = (out["launches"] + out["launches_d"]
                               + out["launches_e"])
    del model
    torch.cuda.empty_cache()
    # (b) float32 at two layers
    out["b"] = p24_b(torch, p.parse_args(
        P24_FLAGS + ["--dtype", "float32", "--n-layers", str(P24_B_LAYERS),
                     "--num-pages", "64"]))
    torch.cuda.empty_cache()
    out["failed"] = [k for k in ("c", "spec_gate") if not out[k]["ok"]]
    return out


def _lat(r):
    return (f"TTFT p50/p99 {r['ttft_s']['p50']:.4f}/{r['ttft_s']['p99']:.4f}"
            f" s, inter-token p50/p99 {r['per_token_s']['p50']:.5f}/"
            f"{r['per_token_s']['p99']:.5f} s")


def log_serving(srv, gpu, secs):
    """Phase 24's lines: (a) per policy, the kernel at serving shapes and
    its timing, (b)-(e)."""
    for pl, r in srv["policies"].items():
        busy = r.get("busy") or {}
        log(f"phase serving (24) (a) {pl}: {r['generated_tokens']} tokens "
            f"of {r['requests']} requests in {r['steps']} steps, "
            f"{r['wall_s']:.3f} s: {r['tokens_per_sec']:.1f} tokens/s, "
            f"{r['requests_per_sec']:.2f} requests/s; {_lat(r)}; mean "
            f"active slots {r['mean_active']:.2f}; busy share over "
            f"{busy.get('steps')} profiled steps {busy.get('busy_share')} "
            f"(device {busy.get('device_ms_per_step')} ms of wall "
            f"{busy.get('wall_ms_per_step')} ms a step; by category "
            f"{json.dumps(busy.get('device_ms_by_category'))}); peak memory "
            f"{r['peak_gb']:.2f} GB; pages free after the drain "
            f"{r['free_pages']}/{r['num_pages']}; passes "
            f"{json.dumps(r['passes'])}")
    t = srv["timing"]
    pr, sp, fl = srv["prefix"], srv["spec"], srv["fleet"]
    log(f"phase serving (24): {secs:.1f} s; cmn_flash_fwd launches (a) "
        f"{srv['launches']} = 8 x target passes, no backward launches; (d) "
        f"{srv['launches_d']}, (e) {srv['launches_e']}; flash at serving "
        f"shapes (B, Tq, Tk, H, D {SERVE_SHAPE}; max abs, rel L2) "
        f"{json.dumps(srv['shape_errs'])}; row 6 at that shape, bf16, "
        f"offsets {list(SERVE_OFFS)}: {json.dumps(t)}; (b) float32 "
        f"{P24_B_LAYERS} layers vs the full-context forward "
        f"{json.dumps(srv['b'])}; (c) bf16 kernel vs plain "
        f"{json.dumps(srv['c'])}; (d) prefix speedup {pr['speedup']:.3f} "
        f"({pr['cached']['tokens_per_sec']:.1f} vs "
        f"{pr['uncached']['tokens_per_sec']:.1f} tokens/s), hit tokens "
        f"{pr['cached']['stats']['hit_tokens']} of "
        f"{pr['cached']['stats']['prompt_tokens']}; spec k {sp['k']}: "
        f"{sp['accept_tokens_per_step']:.3f} tokens per verify pass "
        f"(acceptance {sp['acceptance_rate']:.3f}), "
        f"{sp['spec']['tokens_per_sec']:.1f} vs vanilla "
        f"{sp['vanilla']['tokens_per_sec']:.1f} tokens/s, against greedy "
        f"{json.dumps(srv['spec_gate'])}; (e) fleet x{fl['replicas']}, "
        f"{fl['sessions']} sessions: {fl['tokens_per_sec']:.1f} tokens/s, "
        f"{_lat(fl)}, per replica {fl['requests_per_replica']}, affinity "
        f"{fl['session_affinity_ok']}, prefix hits {fl['prefix_hits']}; "
        f"peak memory {srv['peak_gb']:.2f} GB on {gpu}")


# phase 25: the ImageNet example whole (ViT, s2d and remat, real images,
# accumulation)
P25_VIT_LAYERS = 12          # ViT-B/16: each flash kernel 12 times a step
P25_VIT_SHAPE = (256, 197, 12, 64)   # its attention: B, T, H, D
P25_F32 = dict(batch=32, layers=2)   # (b): ViT-B/16 width, float32
P25_REMAT_BATCH = 16         # (d): the float32 ResNet-50 step
P25_BLOCK_BN = 52            # BatchNorm boundaries inside ResNet-50's blocks
P25_IMAGES = dict(train=1024, val=256, classes=8, min_side=300,
                  max_side=500)
P25_REAL_ITERS = 32          # (e): one epoch of the generated folder
P25_REAL_PROFILED = 3
P25_NPZ = (256, 256)         # (e): uint8 images, side (augmented to 224)
P25_ACCUM = dict(batch=64, k=4)      # (f): ViT-S/16, float32


def p25_vit_bench(fa, cs, torch):
    """(a) ``bench_vit.main`` at its card defaults, flash then xla: exact
    flash launches (12 of each kernel a step call, none under xla), 2
    casts a step call (the bf16 wire), finite and falling loss."""
    from chainermn_tpu_torch.benchmarks import bench_vit
    out = {}
    for att in ("flash", "xla"):
        for w in fa.KERNELS:
            w.launches = 0
        cs.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        line = bench_vit.main(["--attention", att])
        calls = line["step_calls"]
        counts = {w.__name__: w.launches for w in fa.KERNELS}
        counts["cast_scale"] = cs.cast_scale.launches
        want = {w.__name__: P25_VIT_LAYERS * calls if att == "flash" else 0
                for w in fa.KERNELS}
        want["cast_scale"] = 2 * calls
        if counts != want:
            raise AssertionError(f"bench_vit --attention {att}: launches "
                                 f"{counts}, expected {want}")
        if not (math.isfinite(line["final_loss"])
                and line["final_loss"] < line["first_loss"]
                and line["value"] > 0
                and 0 < line["device_ms_per_step"]
                <= line["step_ms"] * 1.5):
            raise AssertionError(f"bench_vit line not sane: {line}")
        out[att] = dict(line=line, counts=counts,
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.empty_cache()
    return out


def p25_vit_f32(torch, dev):
    """(b) ViT-B/16's width at 2 layers in float32, TF32 off: one loss and
    gradient with the flash kernels (the CUDA-core float32 kernels at D 64)
    and with the plain attention, from the same weights."""
    import numpy as np
    import torch.nn.functional as F
    from chainermn_tpu_torch.models import ViT
    from chainermn_tpu_torch.utils.compare import (
        no_tf32, step_agrees, step_errors)
    rng = np.random.RandomState(5)
    b = P25_F32["batch"]
    x = torch.from_numpy(rng.randn(b, 3, 224, 224).astype(np.float32)) \
        .to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, size=b)).to(dev)
    results, state = [], None
    with no_tf32():
        for impl in ("flash", "xla"):
            model = ViT(n_layers=P25_F32["layers"], attention_impl=impl,
                        device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
            if state is None:
                state = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state)
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            results.append((float(loss.detach()), {
                k: p.grad for k, p in model.named_parameters()}))
            del model
    (lk, gk), (lp, gp) = results
    loss_rel, grad_rel, worst = step_errors([lk], [lp], gk, gp)
    if not step_agrees(loss_rel, grad_rel):
        raise AssertionError(f"float32 ViT step, flash vs xla: loss rel "
                             f"{loss_rel:.3g}, gradient rel L2 {grad_rel:.3g}"
                             f" ({worst})")
    torch.cuda.empty_cache()
    return dict(loss=lk, loss_xla=lp, loss_rel=loss_rel, grad_rel=grad_rel,
                worst=worst, tensors=len(gp))


class _ConvCounts:
    """Convolutions dispatched at the ATen level inside the block (one that
    a selective checkpoint serves from its cache never arrives)."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode
        ops = (torch.ops.aten.convolution.default,
               torch.ops.aten._convolution.default)
        counts = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func in ops:
                    counts.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self.mode = 0, Mode()


def p25_remat_f32(fn, torch, dev):
    """(d) One float32 ResNet-50 step (TF32 off) under each remat policy
    from the same weights and batch: the loss, gradients and running
    buffers of "block" and "norm" against "none" (relative 1e-6, relative
    L2 1e-5, relative 1e-6), the buffers moved once, the BatchNorm kernels'
    launches (the blocks' 52 boundaries recomputed: statistics and apply
    105 a step, the backward kernels 53), the convolutions dispatched
    ("block" recomputes the blocks' 52, "norm" none) and the peak memory
    ("block" below "none"); the cyclic collector runs before each step
    (garbage freed inside one would move its peak)."""
    import gc
    import numpy as np
    import torch.nn.functional as F
    from chainermn_tpu_torch.models import ResNet50
    from chainermn_tpu_torch.utils.compare import no_tf32, rel_l2
    rng = np.random.RandomState(6)
    b = P25_REMAT_BATCH
    x = torch.from_numpy(rng.randn(b, 3, 224, 224).astype(np.float32)) \
        .to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, size=b)).to(dev)
    res = {}
    with no_tf32():
        for policy in ("none", "block", "norm"):
            model = ResNet50(remat_policy=policy, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(4))
            model.train()
            before = {k: v.clone() for k, v in model.named_buffers()}
            fn.reset_launch_counts()
            convs = _ConvCounts(torch)
            torch.cuda.synchronize()
            gc.collect()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with convs.mode:
                loss = F.cross_entropy(model(x), y)
                loss.backward()
            torch.cuda.synchronize()
            res[policy] = dict(
                loss=float(loss.detach()), launches=fn.launch_counts(),
                convs=convs.n, before=before,
                peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                grads={k: p.grad.clone() for k, p in
                       model.named_parameters()},
                buffers={k: v.clone() for k, v in model.named_buffers()
                         if v.is_floating_point()})
            del model, loss
            torch.cuda.empty_cache()
    ref = res["none"]
    out = {"none": dict(peak_gb=ref["peak_gb"], launches=ref["launches"],
                        convs=ref["convs"])}
    if any(ref["buffers"][k].equal(ref["before"][k])
           for k in ref["buffers"] if "running" in k):
        raise AssertionError("remat none: a running buffer did not move")
    for policy in ("block", "norm"):
        r = res[policy]
        loss_rel = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        grad_rel, worst = max((rel_l2(r["grads"][k], g), k)
                              for k, g in ref["grads"].items())
        buf_rel = max(rel_l2(r["buffers"][k], v)
                      for k, v in ref["buffers"].items())
        want = {w: 53 + (P25_BLOCK_BN if w in ("stats_call", "apply_call")
                         else 0) for w in fn.launch_counts()}
        convs = ref["convs"] + (P25_BLOCK_BN if policy == "block" else 0)
        out[policy] = dict(loss_rel=loss_rel, grad_rel=grad_rel,
                           worst=worst, buffer_rel=buf_rel,
                           peak_gb=r["peak_gb"], launches=r["launches"],
                           convs=r["convs"])
        if not (loss_rel <= 1e-6 and grad_rel <= 1e-5 and buf_rel <= 1e-6
                and r["launches"] == want and r["convs"] == convs
                and ref["launches"] == {w: 53 for w in want}):
            raise AssertionError(f"remat {policy} against none: {out}")
    if not res["block"]["peak_gb"] < ref["peak_gb"]:
        raise AssertionError(f"remat block's peak memory is not below "
                             f"none's: {out}")
    return out


def p25_resnet(fn, cs, torch, dev):
    """(d) ResNet-50 with the s2d stem (``bench --stem s2d``, phase 16's
    gates), ``run_configs --tune-remat`` (its rows and peak memory;
    "block" below "none" in memory) and the float32 remat step."""
    from chainermn_tpu_torch.benchmarks import run_configs
    line, counts, peak = phase_bench(fn, cs, torch, ["--stem", "s2d"])
    if line["stem"] != "s2d":
        raise AssertionError(f"bench --stem s2d ran the {line['stem']} stem")
    fn.reset_launch_counts()
    doc = run_configs.main(["--tune-remat"])
    rows = doc["configs"]["resnet50_xla"]["rows"]
    if not (list(rows) == ["none", "block", "norm"]
            and all(math.isfinite(r["final_loss"]) for r in rows.values())
            and rows["block"]["peak_memory_gb"]
            < rows["none"]["peak_memory_gb"]
            and all(n > 0 for n in fn.launch_counts().values())):
        raise AssertionError(f"tune-remat rows not sane: {rows}")
    return dict(bench=line, bench_counts=counts, bench_peak_gb=peak,
                tune=doc, f32=p25_remat_f32(fn, torch, dev))


def p25_real_images(fn, torch):
    """(e) ``train_imagenet`` ResNet-50 in bf16 at batch 32 on a generated
    ImageFolder (``datasets.write_image_folder``: 1,024 JPEGs of 8 classes
    at 300-500 px, and 256 validation images) through 4 loader threads
    and 2 batches of prefetch, an epoch (32 steps) and its evaluation,
    then 3 profiled steps: exact BatchNorm launches (53 a step, apply also
    53 a validation batch), the share of the timed steps the loop waited
    on the loader, the device's busy share; beside it the synthetic rate
    and a ``--train-root`` npz run (uint8 at 256 px, augmented to 224) in
    the same call."""
    import numpy as np
    from chainermn_tpu_torch.datasets import (
        PrefetchIterator, write_image_folder)
    from chainermn_tpu_torch.examples import train_imagenet
    root = os.path.join(HERE, "build", "chip_smoke_images")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    im = P25_IMAGES
    kw = dict(min_side=im["min_side"], max_side=im["max_side"])
    train = write_image_folder(os.path.join(root, "train"), im["train"],
                               im["classes"], **kw)
    val = write_image_folder(os.path.join(root, "val"), im["val"],
                             im["classes"], seed=1, **kw)
    write_s = time.perf_counter() - t0
    common = ["--arch", "resnet50", "--batchsize", str(BATCH), "--dtype",
              "bfloat16", "--seed", "0", "--warmup-steps", str(WARMUP),
              "--log-interval", "8"]
    waits = []
    nxt = PrefetchIterator.__next__

    def timed_next(self):
        t = time.perf_counter()
        try:
            return nxt(self)
        finally:
            waits.append(time.perf_counter() - t)

    def timed(on):
        # the updater calls next(), an alias of __next__
        PrefetchIterator.__next__ = PrefetchIterator.next = \
            timed_next if on else nxt

    out = {"write_s": write_s}
    try:
        out["synthetic"] = train_imagenet.main(common + [
            "--iterations", str(P25_REAL_ITERS), "--train-size",
            str(im["train"]), "--val-size", "0"])
        fn.reset_launch_counts()
        timed(True)
        try:
            real = train_imagenet.main(common + [
                "--data", train, "--val-data", val, "--loader-workers", "4",
                "--prefetch", "2", "--iterations", str(P25_REAL_ITERS),
                "--profile-steps", str(P25_REAL_PROFILED)])
        finally:
            timed(False)
        if len(waits) < P25_REAL_ITERS:
            raise AssertionError(f"real images: the loader was asked for "
                                 f"{len(waits)} batches in "
                                 f"{P25_REAL_ITERS} steps")
        steps = P25_REAL_ITERS + P25_REAL_PROFILED
        val_batches = im["val"] // BATCH
        want = {w: 53 * (steps + (val_batches if w == "apply_call" else 0))
                for w in fn.launch_counts()}
        if fn.launch_counts() != want:
            raise AssertionError(f"real images: launches "
                                 f"{fn.launch_counts()}, expected {want}")
        losses = real["losses"]
        if not (len(losses) == P25_REAL_ITERS
                and all(map(math.isfinite, losses))
                and math.isfinite(real["log"][0]["validation/loss"])):
            raise AssertionError(f"real images: losses {losses}, log "
                                 f"{real['log']}")
        timed = waits[WARMUP:P25_REAL_ITERS]
        wall = (P25_REAL_ITERS - WARMUP) * BATCH / real["images_per_sec"]
        out["real"] = real
        out["loader_wait_share"] = sum(timed) / wall
        rng = np.random.RandomState(2)
        n, side = P25_NPZ
        path = os.path.join(root, "train.npz")
        np.savez(path, x=rng.randint(0, 256, size=(n, side, side, 3))
                 .astype(np.uint8), y=rng.randint(0, im["classes"], size=n))
        out["npz"] = train_imagenet.main(common + [
            "--train-root", path, "--n-classes", str(im["classes"]),
            "--iterations", str(n // BATCH)])
        if not all(map(math.isfinite, out["npz"]["losses"])):
            raise AssertionError(f"npz run: losses {out['npz']['losses']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in ("synthetic", "real", "npz"):
        out[k] = {key: out[k][key] for key in (
            "losses", "images_per_sec", "peak_memory_gb", "log", "profile")
            if key in out[k]}
    torch.cuda.empty_cache()
    return out


def p25_accum(torch):
    """(f) ``train_imagenet --arch vit_s16`` in float32 (TF32 off), one
    step of batch 64 with ``--accum-steps 4`` against one full-batch step
    from the same seed: phase 12's gates on the loss and the reduced
    gradients, and each run's peak memory."""
    from chainermn_tpu_torch.examples import train_imagenet
    from chainermn_tpu_torch.utils.compare import (
        no_tf32, step_agrees, step_errors)
    runs = {}
    with no_tf32():
        for k in (P25_ACCUM["k"], 1):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = train_imagenet.main([
                "--arch", "vit_s16", "--dtype", "float32", "--batchsize",
                str(P25_ACCUM["batch"]), "--train-size",
                str(P25_ACCUM["batch"]), "--val-size", "0", "--iterations",
                "1", "--accum-steps", str(k), "--seed", "0"])
            runs[k] = dict(loss=res["losses"][0],
                           peak_gb=res["peak_memory_gb"],
                           grads={n: p.grad.clone() for n, p in
                                  res["model"].named_parameters()})
            del res
            torch.cuda.empty_cache()
    acc, full = runs[P25_ACCUM["k"]], runs[1]
    loss_rel, grad_rel, worst = step_errors(
        [acc["loss"]], [full["loss"]], acc["grads"], full["grads"])
    if not step_agrees(loss_rel, grad_rel):
        raise AssertionError(f"--accum-steps {P25_ACCUM['k']} against one "
                             f"full-batch step: loss rel {loss_rel:.3g}, "
                             f"gradient rel L2 {grad_rel:.3g} ({worst})")
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, worst=worst,
                peak_gb={k: r["peak_gb"] for k, r in runs.items()},
                losses={k: r["loss"] for k, r in runs.items()})


def phase_imagenet(fn, cs, fa, torch, dev, card):
    """Phase 25: the ImageNet example whole on the card, (a)-(f) (each
    sub-phase's docstring); returns their results and seconds."""
    out, secs = {}, {}
    for key, run in (
            ("vit", lambda: p25_vit_bench(fa, cs, torch)),
            ("vit_f32", lambda: p25_vit_f32(torch, dev)),
            ("flash_vit", lambda: phase_flash_timing(
                fa, torch, dev, card, torch.bfloat16, shape=P25_VIT_SHAPE,
                causal=False)),
            ("resnet", lambda: p25_resnet(fn, cs, torch, dev)),
            ("real", lambda: p25_real_images(fn, torch)),
            ("accum", lambda: p25_accum(torch))):
        t0 = time.perf_counter()
        out[key] = run()
        secs[key] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def log_imagenet(p25, gpu, secs):
    """Phase 25's lines."""
    for att, r in p25["vit"].items():
        line = r["line"]
        log(f"phase 25 (a) bench_vit --attention {att}: "
            f"{line['value']:.1f} images/s per GPU, MFU {line['mfu']:.4f}, "
            f"step {line['step_ms']:.2f} ms, device "
            f"{line['device_ms_per_step']:.2f} ms (busy "
            f"{line['device_busy_share']:.3f}), loss "
            f"{line['first_loss']:.4f} -> {line['final_loss']:.4f}, "
            f"launches {json.dumps(r['counts'])} in {line['step_calls']} "
            f"step calls, peak memory {r['peak_gb']:.2f} GB; by category "
            f"{json.dumps(line['device_ms_by_category'])} on {gpu}")
    f = p25["vit_f32"]
    log(f"phase 25 (b) ViT-B/16 width, {P25_F32['layers']} layers, float32, "
        f"TF32 off, batch {P25_F32['batch']}: loss flash {f['loss']:.7f} xla "
        f"{f['loss_xla']:.7f} (rel {f['loss_rel']:.2e}); worst gradient "
        f"relative L2 {f['grad_rel']:.2e} ({f['worst']}) over "
        f"{f['tensors']} tensors")
    log(f"phase 25 (c) flash at the ViT shape (B, T, H, D) {P25_VIT_SHAPE} "
        f"bf16 non-causal: " + json.dumps(
            {w: {k: t[k] for k in ("ms", "eager_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")}
             for w, t in p25["flash_vit"].items()}))
    r = p25["resnet"]
    b = r["bench"]
    log(f"phase 25 (d) bench --stem s2d: {b['value']:.1f} images/s per GPU, "
        f"MFU {b['mfu']:.4f}, step {b['step_ms']:.2f} ms, device "
        f"{b['device_ms_per_step']:.2f} ms, launches "
        f"{json.dumps(r['bench_counts'])}, peak memory "
        f"{r['bench_peak_gb']:.2f} GB on {gpu}")
    for policy, row in r["tune"]["configs"]["resnet50_xla"]["rows"].items():
        log(f"phase 25 (d) tune-remat resnet50_xla/{policy}: "
            f"{row['ms_per_step']:.3f} ms a step, "
            f"{row['images_per_sec_per_gpu']:.1f} images/s per GPU, device "
            f"{row.get('device_ms_per_step', float('nan')):.3f} ms, peak "
            f"memory {row['peak_memory_gb']:.3f} GB")
    log(f"phase 25 (d) tune-remat selected "
        f"{r['tune']['configs']['resnet50_xla']['selected']!r}; float32 "
        f"step (batch {P25_REMAT_BATCH}) against none: "
        f"{json.dumps(r['f32'])}")
    e = p25["real"]
    real, syn, npz = e["real"], e["synthetic"], e["npz"]
    log(f"phase 25 (e) real images: folder written in {e['write_s']:.1f} s; "
        f"ImageFolder {real['images_per_sec']:.1f} images/s (loader wait "
        f"{e['loader_wait_share']:.3f} of the timed steps; profile "
        f"{json.dumps(real.get('profile'))}), validation "
        f"{json.dumps(real['log'][0])}; synthetic "
        f"{syn['images_per_sec']:.1f} images/s; npz "
        f"{npz['images_per_sec']:.1f} images/s; peak memory "
        f"{real['peak_memory_gb']:.2f} GB on {gpu}")
    a = p25["accum"]
    log(f"phase 25 (f) vit_s16 float32 batch {P25_ACCUM['batch']}, "
        f"--accum-steps {P25_ACCUM['k']} against one step: loss rel "
        f"{a['loss_rel']:.2e}, worst gradient relative L2 "
        f"{a['grad_rel']:.2e} ({a['worst']}); losses "
        f"{json.dumps(a['losses'])}; peak memory GB "
        f"{json.dumps(a['peak_gb'])}")
    log(f"phase 25: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in p25["seconds"].items()) + ")")


P26_STEPS = 3        # phase 26: steps of each run
P26_BUCKETS = 4      # (a), (c), (d): the bucketed runs' K (prefetch 1)
P26_SAVE = 2         # (d): the snapshot's iteration
P26_BF16_RTOL = 5e-3  # (f): ZeRO-1's bfloat16-wire tolerance (its CPU test)
# (c): step 0's loss with the bfloat16 wire against the float32 wire's: about
# ten times the 9.49e-6 read on an H100, well under the 3.4e-3 that a
# ResNet-50 with every gathered parameter zero would show (ln 1000 = 6.9078
# against 6.9313)
P26_BF16_STEP0_RTOL = 1e-4
P26_LM_RTOL = 1e-6   # (b): the LM's losses, --fsdp against without
P26_CPU = dict(batch=256, n_in=64, hidden=128, classes=10)  # card vs CPU


def _p26_argv(extra):
    """train_imagenet: ResNet-50 at full width, batch 32, synthetic,
    momentum SGD, float32."""
    return ["--arch", "resnet50", "--communicator", "xla", "--optimizer",
            "momentum", "--batchsize", str(BATCH), "--dtype", "float32",
            "--seed", "0", "--train-size", str(BATCH * 8), "--val-size",
            "0", "--iterations", str(P26_STEPS), "--log-interval", "100",
            "--warmup-steps", "1"] + extra


def _p26_run(fn, cs, torch, extra):
    """``train_imagenet.main`` with the BatchNorm and cast counts set to 0
    just before it: losses, the trained parameters, launches, the FSDP
    step's counters, images/sec and peak memory."""
    from chainermn_tpu_torch.examples import train_imagenet
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn.reset_launch_counts()
    cs.reset_launch_counts()
    res = train_imagenet.main(_p26_argv(extra))
    torch.cuda.synchronize()
    counts = dict(fn.launch_counts(), cast_scale=cs.cast_scale.launches)
    out = dict(losses=res["losses"], counts=counts,
               stats=res["step_stats"], images_per_sec=res["images_per_sec"],
               peak_gb=res["peak_memory_gb"],
               resumed_from=res["resumed_from"],
               params={k: v.detach().clone()
                       for k, v in res["model"].named_parameters()},
               state=res["fsdp_state"], meta=res["fsdp_meta"])
    if len(out["losses"]) != res["iterations"] - (res["resumed_from"] or 0) \
            or not all(map(math.isfinite, out["losses"])):
        raise AssertionError(f"phase 26 {extra}: losses {out['losses']}")
    return out


def _p26_differ(torch, a, b):
    """Names of the parameters of ``a`` that differ from ``b``'s."""
    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def p26_resnet(fn, cs, torch):
    """(a) ``train_imagenet --fsdp`` (ResNet-50, float32, momentum SGD):
    K=1 and K=4 (prefetch 1) bit-equal to each other and to the plain
    step, with the plain step's BatchNorm launches; (c) the bfloat16 wire
    at K=4: four casts a bucket a step, step 0's loss (the wire's
    rounding alone) within ``P26_BF16_STEP0_RTOL`` of the float32 wire's;
    (d) a snapshot at iteration 2 resumed bit for bit, a resume with
    another bucket count refused, ``load_inference_params(metas=)`` equal
    to the gathered parameters."""
    import glob
    import shutil
    import tempfile
    from chainermn_tpu_torch.examples import train_imagenet
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.serving.weights import load_inference_params
    k = str(P26_BUCKETS)
    runs = {"plain": _p26_run(fn, cs, torch, []),
            "k1": _p26_run(fn, cs, torch, ["--fsdp"]),
            "k4": _p26_run(fn, cs, torch, ["--fsdp", "--fsdp-buckets", k]),
            "bf16": _p26_run(fn, cs, torch, [
                "--fsdp", "--fsdp-buckets", k, "--allreduce-grad-dtype",
                "bfloat16"])}
    gates = {}
    plain, k1, k4, bf = (runs[n] for n in ("plain", "k1", "k4", "bf16"))
    gates["k4 = k1 (bits)"] = (k4["losses"] == k1["losses"]
                               and not _p26_differ(
                                   torch, k4["params"], k1["params"]))
    gates["k1 = plain (bits, SGD momentum)"] = (
        k1["losses"] == plain["losses"]
        and not _p26_differ(torch, k1["params"], plain["params"]))
    bn = {w: n for w, n in plain["counts"].items() if w != "cast_scale"}
    gates["BatchNorm launches = plain's"] = all(
        {w: n for w, n in r["counts"].items() if w != "cast_scale"} == bn
        for r in (k1, k4, bf)) and bn == {w: 53 * P26_STEPS for w in bn}
    counters = ("gathers", "reduce_scatters", "casts", "max_in_flight")
    gates["gathers/scatters 1 and 4 a step, 1 and 2 in flight"] = (
        {c: k1["stats"][c] for c in counters} == dict(
            gathers=1, reduce_scatters=1, casts=0, max_in_flight=1)
        and {c: k4["stats"][c] for c in counters} == dict(
            gathers=P26_BUCKETS, reduce_scatters=P26_BUCKETS, casts=0,
            max_in_flight=2))
    want_casts = 4 * P26_BUCKETS  # one float32 buffer a bucket
    gates["bf16 wire: 4 casts a buffer a step"] = (
        bf["stats"]["casts"] == want_casts
        and bf["counts"]["cast_scale"] == want_casts * P26_STEPS
        and k4["counts"]["cast_scale"] == 0)
    # step 0's loss sees the wire alone (every parameter rounded to it);
    # the later steps add the rounded gradients' updates, printed beside
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(bf["losses"],
                                                    k4["losses"])]
    gates[f"bf16 wire step-0 loss within {P26_BF16_STEP0_RTOL}"] = \
        loss_rel[0] <= P26_BF16_STEP0_RTOL
    # (d) checkpoints through the example
    root = tempfile.mkdtemp(prefix="chip_smoke_fsdp_",
                            dir=os.path.join(HERE, "build"))
    try:
        flags = ["--fsdp", "--fsdp-buckets", k, "--checkpoint-freq",
                 str(P26_SAVE), "--checkpoint", root]
        saved = _p26_run(fn, cs, torch, flags + ["--iterations",
                                                 str(P26_SAVE)])
        resumed = _p26_run(fn, cs, torch, flags)
        gates["resumed step = straight step (bits)"] = (
            resumed["resumed_from"] == P26_SAVE
            and resumed["losses"] == k4["losses"][P26_SAVE:]
            and not _p26_differ(torch, resumed["params"], k4["params"]))
        try:
            train_imagenet.main(_p26_argv(["--fsdp", "--fsdp-buckets", "2",
                                           "--checkpoint", root]))
            gates["resume with 2 buckets refused"] = False
        except ValueError as e:
            gates["resume with 2 buckets refused"] = \
                f"num_buckets={P26_BUCKETS}" in str(e)
        ckpt = create_multi_node_checkpointer(
            create_communicator("xla"), root, name="imagenet-resnet50")
        got = load_inference_params({"optimizer": resumed["state"]},
                                    resumed["meta"], checkpointer=ckpt)
        gates["load_inference_params = fsdp_full_params (bits)"] = \
            list(got["optimizer"]) == list(saved["params"]) and \
            not _p26_differ(torch, got["optimizer"], saved["params"])
        names = sorted(os.path.basename(f)
                       for f in glob.glob(os.path.join(root, "*.npz")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r in list(runs.values()) + [saved, resumed]:
        del r["params"], r["state"]
    bn_launches = {w: sum(r["counts"][w] for r in (k1, k4, bf, saved,
                                                   resumed))
                   for w in bn}
    torch.cuda.empty_cache()
    return dict(runs=runs, gates=gates, loss_rel=loss_rel, files=names,
                bn_launches=bn_launches, casts=bf["counts"]["cast_scale"])


def p26_lm(fa, torch, dev):
    """(b) ``train_lm --attention ring_flash`` at the LM's width (float32,
    T 8192, batch 1, 3 Adam steps at 1e-3) with and without ``--fsdp``:
    losses, flash launches, tokens/sec, peak memory; and ``fsdp_init``
    frees the module's parameters (they hold no storage, and the
    allocation does not grow).

    An earlier run's model and optimizer state can sit in reference
    cycles (frames kept by a caught exception's traceback) until the
    cyclic collector runs, which frees gigabytes at a moment nothing
    here chooses.  So each run starts after ``gc.collect()``, and the
    collector is off while ``fsdp_init``'s allocation change is read."""
    import gc
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples import train_lm
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel import fsdp_init
    runs = {}
    for name, extra in (("plain", []), ("fsdp", ["--fsdp"])):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        fa.reset_launch_counts()
        out = train_lm.main(_p20_argv("ring_flash", LM["n_layers"]) + extra)
        torch.cuda.synchronize()
        steady = out["step_seconds"][1:]
        runs[name] = dict(losses=out["losses"], counts=fa.launch_counts(),
                          peak_gb=out["peak_memory_gb"],
                          tokens_per_sec=LM_T * len(steady) / sum(steady),
                          step_s=out["step_seconds"])
        del out
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    gc.collect()
    garbage = held - torch.cuda.memory_allocated(dev)
    torch.cuda.empty_cache()
    comm = create_communicator("xla", device=dev)
    model = TransformerLM(**LM, attention_impl="flash", device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    try:
        before = torch.cuda.memory_allocated(dev)
        state, _ = fsdp_init(comm, model, opt)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated(dev) - before
    finally:
        gc.enable()
    emptied = all(p.untyped_storage().nbytes() == 0
                  for p in model.parameters())
    del state, model, opt
    torch.cuda.empty_cache()
    p, f = runs["plain"], runs["fsdp"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(f["losses"], p["losses"]))
    gates = {f"LM losses within {P26_LM_RTOL}": rel <= P26_LM_RTOL,
             "LM flash launches = without --fsdp": f["counts"] == p["counts"]
             and all(n > 0 for n in f["counts"].values()),
             "fsdp_init frees the parameters": emptied
             and abs(grown) <= 0.01 * nbytes}
    return dict(runs=runs, gates=gates, loss_rel=rel, param_gb=nbytes / 1e9,
                init_grown_gb=grown / 1e9, garbage_gb=garbage / 1e9,
                emptied=emptied)


def p26_card_vs_cpu(torch, dev, wire=None):
    """The FSDP step on the card against the same step on the CPU: a
    Linear-FusedBatchNormAct(ReLU)-Linear model (``P26_CPU``), two
    buckets, SGD momentum, 3 steps, float32 with TF32 off; the card runs
    the BatchNorm kernels (and ``cast_scale`` on ``wire``), the CPU their
    plain versions.  Returns the losses' worst relative difference, the
    parameters' worst absolute difference and the card's launches."""
    import importlib
    import torch.distributed as dist
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.communicators.mesh_communicator_base import (
        MeshCommunicator)
    from chainermn_tpu_torch.ops.fused_norm import FusedBatchNormAct
    from chainermn_tpu_torch.parallel import (
        fsdp_full_params, fsdp_init, make_fsdp_train_step)
    from chainermn_tpu_torch.parallel.topology import Topology
    from chainermn_tpu_torch.utils.compare import no_tf32
    fn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    c = P26_CPU
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(c["batch"], c["n_in"], generator=gen)
    y = torch.randint(0, c["classes"], (c["batch"],), generator=gen)
    card = create_communicator("xla")
    cpu = MeshCommunicator(
        topology=Topology(rank=0, size=1, intra_rank=0, intra_size=1,
                          device=torch.device("cpu")),
        group=dist.new_group([0], backend="gloo"))
    out = {}
    with no_tf32():
        for name, comm in (("cpu", cpu), ("card", card)):
            d = comm.device
            torch.manual_seed(6)
            model = torch.nn.Sequential(
                torch.nn.Linear(c["n_in"], c["hidden"]),
                FusedBatchNormAct(c["hidden"], fuse_relu=True),
                torch.nn.Linear(c["hidden"], c["classes"])).to(d)
            state, meta = fsdp_init(comm, model, torch.optim.SGD(
                model.parameters(), lr=0.05, momentum=0.9), num_buckets=2)
            step = make_fsdp_train_step(
                comm, lambda b, m=model: torch.nn.functional.cross_entropy(
                    m(b[0]), b[1]), state, meta, wire_dtype=wire)
            fn.reset_launch_counts()
            cs.reset_launch_counts()
            losses = [float(step((x.to(d), y.to(d))))
                      for _ in range(P26_STEPS)]
            out[name] = dict(losses=losses, counts=dict(
                fn.launch_counts(), cast_scale=cs.cast_scale.launches),
                params={k: v.cpu() for k, v in fsdp_full_params(
                    state, meta, comm).items()})
    a, b = out["card"], out["cpu"]
    return dict(
        loss_rel=max(abs(p - q) / abs(q)
                     for p, q in zip(a["losses"], b["losses"])),
        param_abs=max(float((a["params"][k] - b["params"][k]).abs().max())
                      for k in b["params"]),
        counts=a["counts"], cpu_counts=b["counts"])


def p26_card_gates(torch, dev):
    """(f) the card against the CPU, float32 and bfloat16 wires: losses
    within 1e-5 relative and parameters within 2e-5 (float32), within
    ``P26_BF16_RTOL`` (bfloat16); every BatchNorm kernel and, on the wire,
    ``cast_scale`` launched (none on the CPU)."""
    res = {w or "float32": p26_card_vs_cpu(torch, dev, w)
           for w in (None, "bfloat16")}
    f, b = res["float32"], res["bfloat16"]
    gates = {
        "card = CPU, float32 wire": f["loss_rel"] <= 1e-5
        and f["param_abs"] <= 2e-5,
        "card = CPU, bf16 wire": b["loss_rel"] <= P26_BF16_RTOL
        and b["param_abs"] <= P26_BF16_RTOL,
        "card launched the kernels": all(
            n == P26_STEPS for w, n in f["counts"].items()
            if w != "cast_scale") and b["counts"]["cast_scale"]
        == 4 * 2 * P26_STEPS and not any(f["cpu_counts"].values())}
    return dict(res=res, gates=gates)


def phase_fsdp(fn, cs, fa, torch, dev):
    """Phase 26: FSDP on the card, (a)-(f) (``p26_resnet``, ``p26_lm``,
    ``p26_card_gates``, ``bench_fsdp_overlap`` at its defaults); every
    gate must hold."""
    from chainermn_tpu_torch.benchmarks import bench_fsdp_overlap
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    out, secs = {}, {}
    try:
        for key, run in (("resnet", lambda: p26_resnet(fn, cs, torch)),
                         ("lm", lambda: p26_lm(fa, torch, dev)),
                         ("cpu", lambda: p26_card_gates(torch, dev)),
                         ("bench", lambda: bench_fsdp_overlap.main([]))):
            t0 = time.perf_counter()
            out[key] = run()
            secs[key] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    gates = dict(out["resnet"]["gates"], **out["lm"]["gates"],
                 **out["cpu"]["gates"])
    gates["bench counters"] = all(r["schedule_ok"] for r in out["bench"])
    out["gates"], out["seconds"] = gates, secs
    return out


def log_fsdp(p26, gpu, secs):
    """Phase 26's lines."""
    r = p26["resnet"]
    for name, run in r["runs"].items():
        log(f"phase 26 (a/c) train_imagenet {name}: losses {run['losses']}; "
            f"launches {json.dumps(run['counts'])}; FSDP step counters "
            f"{json.dumps(run['stats'])}; images/sec (steps 2.."
            f"{P26_STEPS}) {run['images_per_sec']}; peak memory "
            f"{run['peak_gb']} GB on {gpu}")
    log(f"phase 26 (c) bf16 wire against float32 wire at K "
        f"{P26_BUCKETS}: losses rel {r['loss_rel']} (step 0 gated)")
    log(f"phase 26 (d) snapshot files {r['files']}")
    lm = p26["lm"]
    for name, run in lm["runs"].items():
        log(f"phase 26 (b) train_lm ring_flash {name}: losses "
            f"{run['losses']}; flash launches {json.dumps(run['counts'])}; "
            f"step seconds {run['step_s']}; tokens/sec (steps 2.."
            f"{P20_STEPS}) {run['tokens_per_sec']:.1f}; peak memory "
            f"{run['peak_gb']} GB on {gpu}")
    log(f"phase 26 (b) losses rel {lm['loss_rel']:.3e}; parameters "
        f"{lm['param_gb']:.3f} GB; allocation change over fsdp_init "
        f"{lm['init_grown_gb']:.6f} GB, parameters' storage freed "
        f"{lm['emptied']}; the runs left {lm['garbage_gb']:.6f} GB in "
        f"reference cycles (freed by gc.collect before the reading)")
    for w, c in p26["cpu"]["res"].items():
        log(f"phase 26 (f) card vs CPU, {w} wire: loss rel "
            f"{c['loss_rel']:.3e}, worst parameter abs "
            f"{c['param_abs']:.3e}, card launches {json.dumps(c['counts'])}")
    for row in p26["bench"]:
        log(f"phase 26 (e) bench_fsdp_overlap: {json.dumps(row)}")
    log(f"phase 26 gates: {json.dumps(p26['gates'])}")
    log(f"phase 26: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in p26["seconds"].items()) + ")")


# phase 27: the MoE LM (expert parallelism, A9 c) and MoE serving (A12)
P27_MOE = dict(moe_experts=8, moe_top_k=2)
P27_LAYERS = 8       # (a): the MoE LM's depth at the LM's width
P27_STEPS = 3        # (a): Adam steps through the example's train_step
P27_PROFILED = 2     # (a): further steps under torch.profiler
P27_B = dict(n_layers=2, max_len=2048)   # (b): float32, T 2048
P27_AGREE = 0.99     # (b): least share of routing decisions card == CPU
P27_TP_HEADS = (8, 4)  # (d): a tensor-parallel rank's heads at tp 2 and 4
# (a): device time by category ("elementwise" collects the rest: GELU,
# LayerNorm, softmax, casts, loss and Adam)
MOE_CATEGORIES = (
    ("flash (CUDA)", ("fwd_wgmma_kernel", "dkv_wgmma_kernel",
                      "dq_wgmma_kernel", "_f32_kernel")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
    ("routing scatter / gather", ("index", "scatter", "gather", "sort",
                                  "cumsum", "scan", "one_hot")),
    ("memcpy / memset", ("memcpy", "memset")),
)


def _moe_args(layers, seq):
    from chainermn_tpu_torch.examples import train_moe_lm as tm
    return tm.parser().parse_args([
        "--vocab", str(LM["vocab"]), "--d-model", str(LM["d_model"]),
        "--layers", str(layers), "--heads", str(LM["n_heads"]),
        "--seq-len", str(seq), "--batchsize", "1", "--steps",
        str(P27_STEPS), "--experts", str(P27_MOE["moe_experts"]),
        "--top-k", str(P27_MOE["moe_top_k"])])


def p27_train(fa, torch, dev):
    """(a): the MoE LM at the LM's width, bf16, flash, P27_STEPS Adam steps
    of ``train_moe_lm.train_step`` on the motif task (T 8192, batch 1),
    then P27_PROFILED profiled steps."""
    import gc
    from chainermn_tpu_torch.examples import train_moe_lm as tm
    from chainermn_tpu_torch.examples.train_imagenet import profile_steps
    args = _moe_args(P27_LAYERS, LM_T)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    model, opt = tm.build(args, None, dev, attention_impl="flash",
                          dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    toks = tm.make_motif_task(1, LM_T, LM["vocab"], seed=0).to(dev)
    fa.reset_launch_counts()
    rows, secs = [], []
    for _ in range(P27_STEPS):
        t0 = time.perf_counter()
        out = tm.train_step(model, opt, toks, args.aux_weight)
        loss, ce, aux, over, load = (float(out[0]), float(out[1]),
                                     float(out[2]), float(out[3]),
                                     out[4].float().cpu().tolist())
        secs.append(time.perf_counter() - t0)
        rows.append(dict(loss=loss, ce=ce, aux=aux, overflow=over,
                         load_min=min(load), load_max=max(load)))
    counts = fa.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {w: P27_LAYERS * P27_STEPS for w in counts}
    if counts != want:
        raise AssertionError(f"phase 27 (a): flash launches {counts}, "
                             f"expected {want}")
    if not all(math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"phase 27 (a): not finite: {rows}")

    class _Steps:  # the updater interface profile_steps drives
        update = staticmethod(lambda: tm.train_step(model, opt, toks,
                                                    args.aux_weight))
        finalize = staticmethod(lambda: None)

    prof = profile_steps(_Steps, P27_PROFILED, dev, MOE_CATEGORIES)
    tok_s = LM_T * (P27_STEPS - 1) / sum(secs[1:])
    del model, opt, _Steps
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, rows=rows, step_s=secs, counts=counts,
                tokens_per_sec=tok_s, peak_gb=peak_gb, base_gb=base_gb,
                profile=prof)


class _Routes:
    """Routing decisions recorded from one run and replayed into another:
    inside ``record``, ``expert.top_k_indices`` keeps each layer's result;
    inside ``replay``, it returns them in order (on the caller's device)
    and counts the decisions that its own choice would have changed."""

    def __init__(self):
        from chainermn_tpu_torch.parallel import expert
        self.expert, self.orig = expert, expert.top_k_indices
        self.kept, self.flips, self.decisions = [], 0, 0

    def record(self):
        def rec(gates, k):
            topi = self.orig(gates, k)
            self.kept.append(topi)
            return topi
        return self._patched(rec)

    def replay(self):
        it = iter(list(self.kept))

        def rep(gates, k):
            topi = next(it).to(gates.device)
            own = self.orig(gates, k)
            self.flips += int((own != topi).any(-1).sum())
            self.decisions += topi.shape[0]
            return topi
        return self._patched(rep)

    @contextlib.contextmanager
    def _patched(self, fn):
        self.expert.top_k_indices = fn
        try:
            yield
        finally:
            self.expert.top_k_indices = self.orig


def moe_card_vs_cpu(torch, dev, width, seq, seed=9):
    """One float32 (TF32 off) loss and gradient of the MoE LM of ``width``
    (TransformerLM kwargs) at T ``seq``: the card (the flash kernels)
    against the CPU (their plain versions) from the same weights, the
    card's routing replayed into the CPU run.  Returns the loss and worst
    gradient errors, the routing flips and the card's launches."""
    import importlib
    from chainermn_tpu_torch.examples import train_moe_lm as tm
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.utils.compare import no_tf32, step_errors
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    toks = tm.make_motif_task(1, seq, width["vocab"], seed=1)
    routes, runs = _Routes(), []
    state = None
    with no_tf32():
        for card, d, ctx in ((True, dev, routes.record),
                             (False, torch.device("cpu"), routes.replay)):
            model = TransformerLM(**width, attention_impl="flash",
                                  device=d, **P27_MOE,
                                  generator=torch.Generator(d).manual_seed(
                                      seed))
            if state is None:
                state = {k: v.detach().cpu().clone()
                         for k, v in model.state_dict().items()}
            model.load_state_dict(state)
            fa.reset_launch_counts()
            with ctx():
                loss = tm.moe_loss(model, toks.to(d), 1e-2)[0]
                loss.backward()
            if card:
                counts = fa.launch_counts()
            elif any(fa.launch_counts().values()):
                raise AssertionError("a CPU run launched a kernel")
            runs.append((float(loss.detach()),
                         {k: p.grad.detach().cpu()
                          for k, p in model.named_parameters()}))
            del model, loss
    (lk, gk), (lp, gp) = runs
    loss_rel, grad_rel, worst = step_errors([lk], [lp], gk, gp)
    return dict(loss_card=lk, loss_cpu=lp, loss_rel=loss_rel,
                grad_rel=grad_rel, worst=worst, tensors=len(gp),
                flips=routes.flips, decisions=routes.decisions,
                agree=1.0 - routes.flips / max(routes.decisions, 1),
                counts=counts)


def p27_serving(fa, kv, torch, dev, card):
    """(c): the MoE LM (8 layers, bf16) through phase 24's engine settings
    and seeded trace at ep 1 (continuous policy), its row 6 launches, and
    p24_c's kernel-vs-plain gates; (d): row 6 at a tensor-parallel rank's
    8 and 4 heads against its plain version, and timed."""
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    from chainermn_tpu_torch.models import TransformerLM
    args = bs.parser().parse_args(P24_FLAGS + P24_TRACE)
    torch.cuda.empty_cache()
    model = TransformerLM(**LM, attention_impl="xla", dtype=torch.bfloat16,
                          device=dev, **P27_MOE,
                          generator=torch.Generator(dev).manual_seed(0))
    fa.reset_launch_counts()
    pol = bs.run_policy("continuous", model, bs.build_trace(args), args)
    launches = _p24_launches(fa, pol["passes"], LM["n_layers"])
    if pol["free_pages"] != pol["num_pages"] or \
            pol["requests"] != args.requests:
        raise AssertionError(f"phase 27 (c): {pol['requests']} requests, "
                             f"{pol['free_pages']} pages free")
    c = p24_c(fa, kv, torch, model, args)
    del model
    torch.cuda.empty_cache()
    tp = {}
    for h in P27_TP_HEADS:
        errs = {str(dt)[6:]: serving_case(fa, kv, torch, dev, dt, tq, h, h=h)
                for dt in (torch.bfloat16, torch.float32)
                for tq in (SERVE_SHAPE[1],)}
        for dt, err in errs.items():
            if not err[1] <= FLASH_TOL[dt]:
                raise AssertionError(f"phase 27 (d): flash at H {h}: {err}")
        tp[h] = dict(errs=errs, timing=serving_timing(fa, kv, torch, dev,
                                                      card, h=h))
    return dict(policy=pol, launches=launches, c=c, tp=tp)


def phase_moe(fa, torch, dev, card):
    """Phase 27 (see the module docstring)."""
    import importlib
    from chainermn_tpu_torch.utils.compare import step_agrees
    kv = importlib.import_module("chainermn_tpu_torch.serving.kv_cache")
    out, secs = {}, {}
    t0 = time.perf_counter()
    out["a"] = p27_train(fa, torch, dev)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = moe_card_vs_cpu(torch, dev, dict(LM, **P27_B), P27_B[
        "max_len"])
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["srv"] = p27_serving(fa, kv, torch, dev, card)
    secs["srv"] = time.perf_counter() - t0
    b = out["b"]
    out["gates"] = {
        "(b) float32 card vs CPU": step_agrees(b["loss_rel"], b["grad_rel"]),
        "(b) routing agreement": b["agree"] >= P27_AGREE,
        "(b) flash launches": b["counts"] == {w: P27_B["n_layers"]
                                              for w in b["counts"]},
        "(c) kernel vs plain": out["srv"]["c"]["ok"]}
    out["seconds"] = secs
    return out


def log_moe(p27, gpu, secs):
    """Phase 27's lines."""
    a = p27["a"]
    for i, r in enumerate(a["rows"]):
        log(f"phase 27 (a) step {i}: loss {r['loss']:.6f} ce {r['ce']:.6f} "
            f"aux {r['aux']:.4f} overflow {r['overflow']:.4f} "
            f"load[min/max] {r['load_min']:.4f}/{r['load_max']:.4f}; "
            f"{a['step_s'][i]:.3f} s")
    prof = a["profile"]
    log(f"phase 27 (a) MoE LM ({a['n_params']} parameters: {P27_LAYERS} "
        f"layers of the LM's width, {P27_MOE['moe_experts']} experts, top "
        f"{P27_MOE['moe_top_k']}, bf16, flash, T {LM_T}, batch 1, Adam, "
        f"world of one): flash launches {json.dumps(a['counts'])} in "
        f"{P27_STEPS} steps; tokens/sec per GPU (steps 2..{P27_STEPS}) "
        f"{a['tokens_per_sec']:.1f}; peak memory {a['peak_gb']:.2f} GB "
        f"({a['base_gb']:.2f} GB held before); profile of {P27_PROFILED} "
        f"steps {json.dumps(prof)} on {gpu}")
    b = p27["b"]
    log(f"phase 27 (b) float32 MoE LM ({P27_B['n_layers']} layers, T "
        f"{P27_B['max_len']}, TF32 off) card vs CPU, routing replayed: "
        f"loss {b['loss_card']:.7f} / {b['loss_cpu']:.7f} (rel "
        f"{b['loss_rel']:.2e}), worst gradient rel L2 {b['grad_rel']:.2e} "
        f"({b['worst']}) of {b['tensors']}; routing flips {b['flips']} of "
        f"{b['decisions']} tokens (agree {b['agree']:.6f}); card launches "
        f"{json.dumps(b['counts'])}")
    srv = p27["srv"]
    r = srv["policy"]
    busy = r.get("busy") or {}
    log(f"phase 27 (c) MoE LM serving at ep 1 (8 layers, bf16, phase 24's "
        f"trace, continuous): {r['generated_tokens']} tokens of "
        f"{r['requests']} requests in {r['steps']} steps, {r['wall_s']:.3f} "
        f"s: {r['tokens_per_sec']:.1f} tokens/s; {_lat(r)}; busy share "
        f"{busy.get('busy_share')} (device {busy.get('device_ms_per_step')} "
        f"ms of wall {busy.get('wall_ms_per_step')} ms a step; "
        f"{json.dumps(busy.get('device_ms_by_category'))}); peak memory "
        f"{r.get('peak_gb', 0):.2f} GB; row 6 launches {srv['launches']} = "
        f"{LM['n_layers']} x {r['passes']['target']} passes; kernel vs plain "
        f"{json.dumps(srv['c'])}")
    for h, t in srv["tp"].items():
        log(f"phase 27 (d) row 6 at a tensor-parallel rank's H {h} (serving "
            f"shape, Hkv {h}): errors {json.dumps(t['errs'])}; "
            f"{json.dumps(t['timing'])} on {gpu}")
    log(f"phase 27 gates: {json.dumps(p27['gates'])}")
    log(f"phase 27: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in p27["seconds"].items()) + ")")


# phase 28: pipeline parallelism (A9 d) on a world of one
P28_M = 4            # micro-batches of one sequence each
P28_STEPS = 3        # (a): steps of each schedule, the first one counted
P28_F32 = dict(n_layers=2, max_len=2048)   # (b): float32, TF32 off


def _p28_setup(torch, dev, dtype, cfg, impl, seq, state=None, m=P28_M,
               blocks=None):
    """The LM's blocks as a pipeline stage (``blocks``, a slice of them:
    all of them by default, a world of one): the embeddings run before the
    pipeline, the loss is the next-token cross entropy through the frozen
    final norm and head (JAX's stage loss takes no parameters).  Returns
    ``(model, stage params, x [m, T, d], targets [m, T], stage_fn,
    loss_fn)``."""
    import numpy as np
    import torch.nn.functional as F
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel import module_stage_fn
    model = TransformerLM(**cfg, attention_impl=impl, dtype=dtype,
                          device=dev, generator=torch.Generator(
                              device=dev).manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    for frozen in (model.tok_emb, model.pos_emb, model.ln_f, model.head):
        frozen.requires_grad_(False)
    stage = torch.nn.Sequential(*model.blocks[blocks or slice(None)])
    params = dict(stage.named_parameters())
    rng = np.random.RandomState(0)
    toks = torch.from_numpy((rng.rand(m, seq + 1) * cfg["vocab"])
                            .astype(np.int64)).to(dev)
    with torch.no_grad():
        x = model.tok_emb(toks[:, :-1]) + model.pos_emb(
            torch.arange(seq, device=dev))

    def loss_fn(y, t):
        logits = model.head(model.ln_f(y)).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               t.reshape(-1))

    return model, params, x, toks[:, 1:], module_stage_fn(stage), loss_fn


def _p28_gpipe(comm, stage_fn, loss_fn, params, x, tgt):
    """GPipe under autograd: the mean of the micro-batches' losses (on
    every rank) and the stage's gradients.  The outputs stay on the last
    stage (``collect="last"``), which alone computes the loss, its scalar
    summed over the ranks as JAX's example does; the other ranks' backward
    starts from a zero cotangent."""
    from chainermn_tpu_torch.parallel import pipeline_apply
    m = int(x.shape[0])
    for p in params.values():
        p.grad = None
    out = pipeline_apply(stage_fn, params, x.reshape(
        (m, 1) + tuple(x.shape[1:])), comm, collect="last")
    if comm.rank == comm.size - 1:
        t = tgt.reshape(m, 1, -1)
        loss = sum(loss_fn(out[i], t[i]) for i in range(m)) / m
        loss.backward()
        loss = loss.detach()
    else:
        out.backward(out.new_zeros(out.shape))
        loss = out.new_zeros(()).float()
    if comm.size > 1:
        loss = comm.allreduce(loss, "sum")
    return loss, {k: p.grad for k, p in params.items()}


def _p28_1f1b(comm, stage_fn, loss_fn, params, x, tgt):
    from chainermn_tpu_torch.parallel import make_pipeline_train_fn
    return make_pipeline_train_fn(stage_fn, loss_fn, comm,
                                  n_microbatches=int(x.shape[0]))(
        params, x, tgt)


def p28_schedules(fa, torch, dev):
    """(a): the LM's 8 blocks at phase 11's width (bf16, flash) as one
    stage, M micro-batches of B 1: 1F1B and GPipe, each for P28_STEPS
    steps (the first one's flash launches counted), tokens/s over the
    others, peak memory."""
    import gc
    from chainermn_tpu_torch import create_communicator
    comm = create_communicator("flat")
    model, params, x, tgt, stage_fn, loss_fn = _p28_setup(
        torch, dev, torch.bfloat16, LM, "flash", LM_T)
    out = {}
    for name, run in (("1f1b", _p28_1f1b), ("gpipe", _p28_gpipe)):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, secs, counts = [], [], None
        for i in range(P28_STEPS):
            torch.cuda.synchronize()
            if i == 0:
                fa.reset_launch_counts()
            t0 = time.perf_counter()
            loss, grads = run(comm, stage_fn, loss_fn, params, x, tgt)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                counts = fa.launch_counts()
            losses.append(float(loss))
            del grads
        out[name] = dict(
            losses=losses, counts=counts, step_s=secs,
            tokens_per_sec=P28_M * LM_T * (P28_STEPS - 1) / sum(secs[1:]),
            peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    for p in params.values():
        p.grad = None
    del model, params, x
    gc.collect()
    torch.cuda.empty_cache()
    L = LM["n_layers"]
    out["want"] = {"1f1b": {"flash_fwd": 2 * L * P28_M,
                            "flash_bwd_dkv": L * P28_M,
                            "flash_bwd_dq": L * P28_M},
                   "gpipe": {w: L * P28_M for w in FLASH}}
    return out


def p28_f32(torch, dev):
    """(b): float32 (TF32 off) at 2 layers and T 2048, M 4 on a world of
    one: 1F1B's loss and gradients against GPipe's and against one
    sequential pass over the whole batch, with the flash kernels and with
    the plain attention, and the kernels' 1F1B against the plain
    sequential pass (``utils/compare.py``'s gates)."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.utils.compare import (
        no_tf32, step_agrees, step_errors)
    comm = create_communicator("flat")
    cfg, seq = dict(LM, **P28_F32), P28_F32["max_len"]
    res, state = {}, None
    with no_tf32():
        for impl in ("flash", "xla"):
            model, params, x, tgt, stage_fn, loss_fn = _p28_setup(
                torch, dev, torch.float32, cfg, impl, seq, state)
            if state is None:
                state = {k: v.clone() for k, v in model.state_dict().items()}
            l1, g1 = _p28_1f1b(comm, stage_fn, loss_fn,
                               {k: v.detach() for k, v in params.items()},
                               x, tgt)
            lg, gg = _p28_gpipe(comm, stage_fn, loss_fn, params, x, tgt)
            gg = {k: v.clone() for k, v in gg.items()}
            for p in params.values():
                p.grad = None
            y = stage_fn(params, x)
            ls = sum(loss_fn(y[i:i + 1], tgt[i:i + 1])
                     for i in range(P28_M)) / P28_M
            ls.backward()
            gs = {k: p.grad.clone() for k, p in params.items()}
            res[impl] = (float(l1), g1, float(lg), gg, float(ls.detach()), gs)
            del model, params, x, y
    out, ok = {}, True
    for impl, (l1, g1, lg, gg, ls, gs) in res.items():
        for ref, (lr, gr) in (("gpipe", (lg, gg)), ("sequential", (ls, gs))):
            lrel, grel, worst = step_errors([l1], [lr], g1, gr)
            out[f"{impl} 1f1b vs {ref}"] = dict(loss_rel=lrel, grad_rel=grel,
                                               worst=worst)
            ok = ok and step_agrees(lrel, grel)
    l1, g1 = res["flash"][:2]
    ls, gs = res["xla"][4:]
    lrel, grel, worst = step_errors([l1], [ls], g1, gs)
    out["flash 1f1b vs xla sequential"] = dict(loss_rel=lrel, grad_rel=grel,
                                              worst=worst)
    out["ok"] = ok and step_agrees(lrel, grel)
    out["losses"] = {impl: r[0] for impl, r in res.items()}
    del res
    torch.cuda.empty_cache()
    return out


def phase_pipeline(fa, torch, dev):
    """Phase 28 (see the module docstring)."""
    out, secs = {}, {}
    t0 = time.perf_counter()
    out["a"] = p28_schedules(fa, torch, dev)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = p28_f32(torch, dev)
    secs["b"] = time.perf_counter() - t0
    a = out["a"]
    out["gates"] = {
        "(a) 1f1b flash launches": a["1f1b"]["counts"] == a["want"]["1f1b"],
        "(a) gpipe flash launches": a["gpipe"]["counts"] == a["want"]["gpipe"],
        "(a) finite losses": all(math.isfinite(v) for r in ("1f1b", "gpipe")
                                 for v in a[r]["losses"]),
        "(b) float32 1f1b vs gpipe and sequential": out["b"]["ok"]}
    out["seconds"] = secs
    return out


def log_pipeline(p28, gpu, secs):
    a = p28["a"]
    for name in ("1f1b", "gpipe"):
        r = a[name]
        log(f"phase 28 (a) {name}: the LM's {LM['n_layers']} blocks as one "
            f"stage (d {LM['d_model']}, H {LM['n_heads']}, T {LM_T}, bf16, "
            f"flash), M {P28_M} micro-batches of B 1, world of one: losses "
            f"{r['losses']}; step seconds {r['step_s']}; flash launches "
            f"(step 1) {json.dumps(r['counts'])} (want "
            f"{json.dumps(a['want'][name])}); tokens/s (steps 2..{P28_STEPS}) "
            f"{r['tokens_per_sec']:.1f}; peak memory {r['peak_gb']:.2f} GB "
            f"on {gpu}")
    log(f"phase 28 (a) 1F1B / GPipe tokens/s "
        f"{a['1f1b']['tokens_per_sec'] / a['gpipe']['tokens_per_sec']:.4f}, "
        f"peak memory {a['1f1b']['peak_gb'] / a['gpipe']['peak_gb']:.4f}")
    b = p28["b"]
    log(f"phase 28 (b) float32 ({P28_F32['n_layers']} layers, T "
        f"{P28_F32['max_len']}, M {P28_M}, TF32 off): losses "
        f"{json.dumps(b['losses'])}; " + "; ".join(
            f"{k}: loss rel {v['loss_rel']:.2e}, worst gradient rel L2 "
            f"{v['grad_rel']:.2e} ({v['worst']})" for k, v in b.items()
            if isinstance(v, dict) and "loss_rel" in v))
    log(f"phase 28 gates: {json.dumps(p28['gates'])}")
    log(f"phase 28: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in p28["seconds"].items()) + ")")


# phase 29: gradient compression (A10)
P29_EF_STEPS = 3     # (b): EF steps of each quantizer, card against CPU
P29_TIMED = 5        # (b): encode + decode calls timed
P29_MNIST = ["--epoch", "2", "--prefetch", "0"]   # (c)
P29_FSDP_STEPS = 3   # (d): steps of each LM FSDP run
P29_RT_LAYERS = 2    # (d): the checkpoint round trip's depth
RESNET_GRADS = 25557032   # ResNet-50's packed gradient (phase 6's count)


def p29_resnet_grads(fn, torch, dev):
    """ResNet-50's gradients of one bf16 step at batch 32 (seed-0 weights,
    synthetic batch); the BatchNorm kernels' launches of the step."""
    import torch.nn.functional as F
    from chainermn_tpu_torch.models import ResNet50
    model = ResNet50(dtype=torch.bfloat16, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(BATCH, 3, 224, 224, device=dev, generator=g)
    y = torch.randint(0, 1000, (BATCH,), device=dev, generator=g)
    torch.cuda.synchronize()
    fn.reset_launch_counts()
    F.cross_entropy(model(x).float(), y).backward()
    torch.cuda.synchronize()
    counts = fn.launch_counts()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    n = sum(v.numel() for v in grads.values())
    if n != RESNET_GRADS or counts != {w: 53 for w in KERNELS}:
        raise AssertionError(f"phase 29: {n} gradients, BatchNorm "
                             f"launches {counts}")
    return grads, counts


def _bits_equal(torch, a, b):
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.element_size() == 1:
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return torch.equal(a.view({2: torch.int16, 4: torch.int32}[
        a.element_size()]), b.view({2: torch.int16, 4: torch.int32}[
            b.element_size()]))


def p29_wire(cs, torch, grads):
    """(a): ``NoCompression(wire)`` on a plain flavor against the
    ``allreduce_grad_dtype`` knob, bfloat16 and float16: the same bits,
    and the cast kernel's launches (two a call)."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.compression import NoCompression
    plain = create_communicator("flat")
    out = {}
    for wire in (torch.bfloat16, torch.float16):
        knob = create_communicator("xla", allreduce_grad_dtype=wire)
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        a = knob.allreduce_grad(grads)
        b = plain.allreduce_grad(grads, compressor=NoCompression(wire))
        torch.cuda.synchronize()
        out[str(wire)[6:]] = dict(
            same_bits=all(_bits_equal(torch, a[k], b[k]) for k in grads),
            casts=cs.launch_counts()["cast_scale"])
    return out


def p29_ef(torch, dev, grads):
    """(b): int8 and fp8 over ResNet-50's gradients, P29_EF_STEPS steps of
    EF (deterministic), ``allreduce_grad`` on the card against the same
    codec on the CPU: every step's wire (codes, flags), residual,
    exponents, step and mean bit for bit; encode and decode timed by CUDA
    events; ``wire_bits_per_param``; stochastic mode's mean error."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators import _packing
    from chainermn_tpu_torch.compression import (
        Fp8Compressor, Int8Compressor, wire_bits_per_param)
    comm = create_communicator("flat")
    buf = _packing.pack(grads, comm_dtype=torch.float32)[0][0]
    n = int(buf.shape[0])
    host = buf.cpu()
    out = {}
    for cls in (Int8Compressor, Fp8Compressor):
        comp = cls(stochastic=False)
        st = comm.init_compression_state(grads, comp)
        stc = comp.init_state(n)
        equal = []
        for _ in range(P29_EF_STEPS):
            wire, _ = comp.compress(buf, st, rank=0, world_size=1)
            mean, st = comm.allreduce_grad(grads, compressor=comp, state=st)
            wc, stc = comp.compress(host, stc, rank=0, world_size=1)
            oc, stc = comp.decompress(wc, stc, world_size=1)
            mflat = _packing.pack(mean, comm_dtype=torch.float32)[0][0]
            equal.append({
                "wire": _bits_equal(torch, wire, wc),
                "ef": _bits_equal(torch, st.ef, stc.ef),
                "scale": _bits_equal(torch, st.scale, stc.scale),
                "step": _bits_equal(torch, st.step, stc.step),
                "mean": _bits_equal(torch, mflat, oc[:n])})
        # the codec's own time on the packed buffer (a world of one moves
        # nothing): compress, then decompress of its output
        s0 = comp.init_state(n, device=dev)
        s0.scale.copy_(st.scale)
        ms = {}
        w1, s1 = comp.compress(buf, s0, 0, 1)
        comp.decompress(w1, s1, 1)
        for what in ("encode", "decode"):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            for _ in range(P29_TIMED):
                if what == "encode":
                    comp.compress(buf, s0, 0, 1)
                else:
                    comp.decompress(w1, s1, 1)
            ev[1].record()
            torch.cuda.synchronize()
            ms[what] = ev[0].elapsed_time(ev[1]) / P29_TIMED
        # stochastic rounding: the third step's error against the
        # gradient, with deterministic rounding's beside it
        errs = {}
        for stochastic in (True, False):
            c2 = cls(stochastic=stochastic, seed=3)
            s2 = comm.init_compression_state(grads, c2)
            for _ in range(P29_EF_STEPS):
                mean, s2 = comm.allreduce_grad(grads, compressor=c2,
                                               state=s2)
            d = _packing.pack(mean, comm_dtype=torch.float32)[0][0] - buf
            errs["stochastic" if stochastic else "deterministic"] = dict(
                mean=float(d.mean()), mean_abs=float(d.abs().mean()),
                grad_mean_abs=float(buf.abs().mean()))
        out[comp.name] = dict(
            equal=equal, ok=all(all(e.values()) for e in equal), ms=ms,
            bits_per_param=wire_bits_per_param(comp, n), errors=errs)
        del st, stc, s0, w1, s1
    return out


def p29_mnist():
    """(c): ``train_mnist`` at full width with ``--compression int8`` and
    ``fp8``, against uncompressed: JAX's contract (the loss falls; the
    final loss within 0.1 x the uncompressed run's first)."""
    from chainermn_tpu_torch.examples import train_mnist
    out = {}
    for name in ("none", "int8", "fp8"):
        d = os.path.join(HERE, "build", f"chip_smoke_p29_mnist_{name}")
        flags = [] if name == "none" else ["--compression", name]
        res = train_mnist.main(P29_MNIST + ["--out", d] + flags)
        shutil.rmtree(d, ignore_errors=True)
        out[name] = [r["main/loss"] for r in res["log"]]
    base = out["none"]
    out["ok"] = all(
        out[q][-1] < out[q][0] and abs(out[q][-1] - base[-1])
        < 0.1 * abs(base[0]) for q in ("int8", "fp8"))
    return out


def _p29_lm(torch, dev, comm, layers, steps, num_buckets=1, comps=None,
            wire=None):
    """The LM (phase 11's width at ``layers`` blocks, bf16, flash) under
    FSDP for ``steps`` Adam steps: losses, the last step's counters, and
    the state, step and model."""
    import numpy as np
    from chainermn_tpu_torch.examples.train_lm import lm_loss
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel import fsdp_init, make_fsdp_train_step
    model = TransformerLM(**dict(LM, n_layers=layers), attention_impl="flash",
                          dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    state, meta = fsdp_init(comm, model, torch.optim.Adam(
        model.parameters(), lr=1e-4), num_buckets=num_buckets,
        bucket_compressors=comps)
    step = make_fsdp_train_step(comm, lambda b: lm_loss(model, b), state,
                                meta, wire_dtype=wire)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy((rng.rand(1, LM_T) * LM["vocab"]).astype(
        np.int32)).to(dev)
    losses = [float(step(toks)) for _ in range(steps)]
    return losses, dict(step.stats), state, step, toks


def p29_fsdp(fa, torch, dev):
    """(d): the LM under FSDP with int8 buckets at K 1 and 4 against plain
    FSDP (float32 wire) and the bfloat16 wire: losses over
    P29_FSDP_STEPS steps, the reduce-scatter bytes a step; then the EF
    checkpoint round trip at P29_RT_LAYERS layers (a resumed state steps
    bit for bit as the uninterrupted one)."""
    import gc
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.optim import init_optimizer_state
    comm = create_communicator("xla")
    runs = {}
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    for name, kw in (("plain", {}), ("bf16 wire", dict(wire="bfloat16")),
                     ("int8 K1", dict(comps="int8")),
                     ("int8 K4", dict(num_buckets=4, comps="int8"))):
        losses, stats, state, step, _ = _p29_lm(
            torch, dev, comm, LM["n_layers"], P29_FSDP_STEPS, **kw)
        runs[name] = dict(losses=losses, scatter_bytes=stats["scatter_bytes"],
                          gather_bytes=stats["gather_bytes"],
                          reduce_scatters=stats["reduce_scatters"])
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    base = runs["plain"]
    for name in ("int8 K1", "int8 K4"):
        r = runs[name]
        r["ratio_vs_f32"] = base["scatter_bytes"] / r["scatter_bytes"]
        r["ratio_vs_bf16"] = (runs["bf16 wire"]["scatter_bytes"]
                              / r["scatter_bytes"])
        r["loss_rel"] = [abs(a - b) / abs(b) for a, b in
                         zip(r["losses"], base["losses"])]
    # the EF checkpoint round trip
    d = os.path.join(HERE, "build", "chip_smoke_p29_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    _, _, state, step, toks = _p29_lm(torch, dev, comm, P29_RT_LAYERS, 2,
                                      num_buckets=4, comps="int8")
    ckpt = create_multi_node_checkpointer(comm, d, "p29")
    t0 = time.perf_counter()
    ckpt.save({"fsdp": state}, 2)
    save_s = time.perf_counter() - t0
    _, _, fresh, step2, _ = _p29_lm(torch, dev, comm, P29_RT_LAYERS, 0,
                                    num_buckets=4, comps="int8")
    init_optimizer_state(fresh.inner)
    t0 = time.perf_counter()
    _, gen = ckpt.resume({"fsdp": fresh})
    load_s = time.perf_counter() - t0
    l_cont, l_res = float(step(toks)), float(step2(toks))
    same = (gen == 2 and l_cont == l_res and all(
        _bits_equal(torch, a, b) for a, b in zip(fresh.flat_shards(),
                                                 state.flat_shards()))
        and all(_bits_equal(torch, getattr(a, k), getattr(b, k))
                for a, b in zip(fresh.comp, state.comp)
                for k in ("ef", "scale", "step")))
    shutil.rmtree(d, ignore_errors=True)
    del state, step, fresh, step2
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, counts=counts, roundtrip=dict(
        same=same, loss=l_cont, save_s=save_s, load_s=load_s))


def p29_serving(fa, torch):
    """(e): phase 24's LM with ``load_inference_params(int8_weights=True)``
    (JAX's per-channel axes, ``weights.channel_axes``): phase 24 (c)'s
    kernel-against-plain comparison on the same round-tripped weights."""
    import importlib
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    from chainermn_tpu_torch.serving.weights import load_inference_params
    from chainermn_tpu_torch.weights import channel_axes
    kv = importlib.import_module("chainermn_tpu_torch.serving.kv_cache")
    args = bs.parser().parse_args(P24_FLAGS + P24_TRACE)
    model = bs.build_model(args)
    sd = model.state_dict()
    q = load_inference_params(sd, int8_weights=True,
                              channel_axes=channel_axes(model))
    moved = max(float((q[k] - sd[k]).abs().max() / sd[k].abs().max())
                for k in sd if sd[k].ndim >= 2)
    model.load_state_dict(q)
    out = p24_c(fa, kv, torch, model, args)
    out["weights_rel_max"] = moved
    del model, sd, q
    torch.cuda.empty_cache()
    return out


def phase_compression(fn, cs, fa, torch, dev):
    """Phase 29 (see the module docstring)."""
    out, secs = {}, {}
    t0 = time.perf_counter()
    grads, out["bn_counts"] = p29_resnet_grads(fn, torch, dev)
    out["a"] = p29_wire(cs, torch, grads)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = p29_ef(torch, dev, grads)
    secs["b"] = time.perf_counter() - t0
    del grads
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["c"] = p29_mnist()
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["d"] = p29_fsdp(fa, torch, dev)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["e"] = p29_serving(fa, torch)
    secs["e"] = time.perf_counter() - t0
    d = out["d"]["runs"]
    L = LM["n_layers"]
    out["gates"] = {
        "(a) NoCompression = the knob": all(
            r["same_bits"] and r["casts"] == 4 for r in out["a"].values()),
        "(b) card = CPU bit for bit": all(r["ok"] for r in out["b"].values()),
        "(c) mnist int8/fp8 contract": out["c"]["ok"],
        "(d) int8 tracks plain FSDP": all(
            abs(d[k]["losses"][-1] - d["plain"]["losses"][-1])
            < 0.1 * abs(d["plain"]["losses"][0]) for k in ("int8 K1",
                                                           "int8 K4")),
        "(d) int8 wire >= 3.5x fewer bytes": all(
            d[k]["ratio_vs_f32"] >= 3.5 for k in ("int8 K1", "int8 K4")),
        "(d) flash launches": out["d"]["counts"] == {
            w: 4 * L * P29_FSDP_STEPS for w in FLASH},
        "(d) EF checkpoint round trip": out["d"]["roundtrip"]["same"],
        "(e) int8 weights kernel vs plain": out["e"]["ok"]}
    out["seconds"] = secs
    return out


def log_compression(p29, gpu, secs):
    log(f"phase 29 (a) ResNet-50 bf16 step at batch {BATCH} ({RESNET_GRADS} "
        f"gradients; BatchNorm launches {json.dumps(p29['bn_counts'])}): "
        f"NoCompression(wire) on flat vs the xla knob: "
        f"{json.dumps(p29['a'])}")
    for name, r in p29["b"].items():
        log(f"phase 29 (b) {name} (chunk 1024, deterministic) over the "
            f"ResNet-50 gradient, {P29_EF_STEPS} EF steps, card vs CPU bit "
            f"for bit {json.dumps(r['equal'])}; encode {r['ms']['encode']:.4f}"
            f" ms, decode {r['ms']['decode']:.4f} ms (CUDA events, "
            f"{P29_TIMED} calls); wire bits/param {r['bits_per_param']:.6f}; "
            f"step-{P29_EF_STEPS} mean error {json.dumps(r['errors'])} on "
            f"{gpu}")
    log(f"phase 29 (c) train_mnist {' '.join(P29_MNIST)} epoch losses: "
        + json.dumps({k: v for k, v in p29["c"].items() if k != "ok"}))
    d = p29["d"]
    for name, r in d["runs"].items():
        log(f"phase 29 (d) LM FSDP ({LM['n_layers']} layers at the LM's "
            f"width, bf16, flash, T {LM_T}, Adam 1e-4) {name}: losses "
            f"{r['losses']}; reduce-scatter bytes a step "
            f"{r['scatter_bytes']}, gather bytes {r['gather_bytes']}"
            + (f"; vs float32 {r['ratio_vs_f32']:.4f}x fewer, vs the bf16 "
               f"wire {r['ratio_vs_bf16']:.4f}x; loss rel to plain "
               f"{r['loss_rel']}" if "ratio_vs_f32" in r else ""))
    log(f"phase 29 (d) flash launches {json.dumps(d['counts'])}; EF "
        f"checkpoint round trip ({P29_RT_LAYERS} layers, int8 K4): "
        f"{json.dumps(d['roundtrip'])}")
    e = p29["e"]
    log(f"phase 29 (e) serving with int8 weights (largest change "
        f"{e['weights_rel_max']:.3e} of a weight's amax): kernel vs plain "
        f"{json.dumps({k: v for k, v in e.items() if k != 'weights_rel_max'})}"
        f" on {gpu}")
    log(f"phase 29 gates: {json.dumps(p29['gates'])}")
    log(f"phase 29: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in p29["seconds"].items()) + ")")


P30_SIZES_KB = "4,64,1024,16384"   # phase 30 (a): the sweep's ladder
P30_ITERS = 20       # (a): timed calls a plan and size (after 3 warm-ups)
P30_STEPS = 4        # (d): ResNet-50 steps of each run
P30_EF_STEPS = 2     # (e): EF steps of the per-hop plan
P30_FLAVORS = (("naive", "naive", {}), ("flat", "flat", {}),
               ("hierarchical", "hierarchical", {}),
               ("two_dimensional", "two_dimensional", {}),
               ("single_node", "single_node", {}),
               ("non_cuda_aware", "non_cuda_aware", {}), ("xla", "xla", {}),
               ("xla_bf16", "xla", {"allreduce_grad_dtype": "bfloat16"}))


def p30_sweep(root):
    """(a): ``bench_allreduce --sweep`` on the NCCL world of one; the rows
    validate, ``autotune_from_rows`` builds the table, the table
    round-trips through JSON; the gradient bucket's entry is the bf16
    flat plan (put there when the sweep picked another).  Writes the
    table to ``root``."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.benchmarks import bench_allreduce
    from chainermn_tpu_torch.planner import (
        PlanTable, autotune_from_rows, candidate_plans, size_bucket,
        validate_sweep_rows)
    doc = bench_allreduce.main([
        "--sweep", os.path.join(root, "sweep.json"), "--sweep-sizes-kb",
        P30_SIZES_KB, "--iters", str(P30_ITERS), "--warmup", "3"])
    rows = doc["rows"]
    validate_sweep_rows(rows)
    table, comparison = autotune_from_rows(rows)
    topo = create_communicator("xla").plan_topology()
    nbytes = 4 * RESNET_GRADS
    swept = table.lookup(topo, "float32", nbytes).name
    bf16 = next(p for p in candidate_plans(topo) if p.name == "flat_bfloat16")
    table.put(topo, "float32", size_bucket(nbytes), bf16)
    path = os.path.join(root, "plan_table.json")
    table.save(path)
    again = PlanTable.load(path)
    us = {}
    for r in rows:
        us.setdefault(r["plan"], {})[r["bytes"]] = r["us"]
    return dict(rows=len(rows), us=us, comparison=comparison,
                roundtrip=again.to_dict() == table.to_dict(),
                swept_pick=swept, bucket=size_bucket(nbytes), path=path,
                table=table)


def p30_flavors(cs, torch, grads):
    """(b): each flavor's ``allreduce_grad`` against
    ``execute_plan(comm.plan())`` of ResNet-50's gradients, bit for bit;
    the cast launches of the bf16 xla pair."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.planner import execute_plan
    out, casts = {}, 0
    for label, name, kw in P30_FLAVORS:
        comm = create_communicator(name, **kw)
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        a = comm.allreduce_grad(grads)
        b = execute_plan(comm.plan(), comm, grads)
        torch.cuda.synchronize()
        casts += cs.launch_counts()["cast_scale"]
        out[label] = all(_bits_equal(torch, a[k], b[k]) for k in grads)
    return out, casts


def p30_auto(cs, torch, grads, table_path):
    """(c): ``auto`` with the table against ``xla`` + bf16 on the
    gradients: its pick, the same bits, 2 cast launches a call, and the
    card's bits against the CPU's for the same plan."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.planner import execute_plan
    auto = create_communicator("auto", plan_table=table_path)
    xla = create_communicator("xla", allreduce_grad_dtype=torch.bfloat16)
    pick = auto._select(grads)
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    a = auto.allreduce_grad(grads)
    torch.cuda.synchronize()
    casts = cs.launch_counts()["cast_scale"]
    cs.reset_launch_counts()
    b = xla.allreduce_grad(grads)
    torch.cuda.synchronize()
    xla_casts = cs.launch_counts()["cast_scale"]
    # the CPU: a scope of one rank issues no collective, so the plan runs
    # on CPU tensors through the same communicator (the casts' plain form)
    cpu = execute_plan(pick, auto, {k: v.cpu() for k, v in grads.items()})
    return dict(pick=pick.name, casts=casts, xla_casts=xla_casts,
                same_bits=all(_bits_equal(torch, a[k], b[k]) for k in grads),
                card_cpu=all(_bits_equal(torch, a[k], cpu[k])
                             for k in grads))


def _p30_argv(extra):
    """train_imagenet: ResNet-50 at full width, batch 32, bf16, synthetic,
    momentum SGD, ``P30_STEPS`` steps."""
    return ["--arch", "resnet50", "--batchsize", str(BATCH), "--iterations",
            str(P30_STEPS), "--dtype", "bfloat16", "--train-size",
            str(BATCH * P30_STEPS), "--seed", "0", "--log-interval", "100",
            "--warmup-steps", "1", "--val-size", "0"] + extra


def p30_resnet(fn, cs, torch, table_path):
    """(d): ``P30_STEPS`` ResNet-50 steps through ``auto`` with the table
    and through ``xla`` + the bf16 wire, plain and double-buffered (cuDNN
    deterministic): losses, parameters bit for bit, launches, images/s."""
    from chainermn_tpu_torch.examples import train_imagenet
    runs = {}
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        for db in ([], ["--double-buffering"]):
            for label, extra in (
                    ("xla", ["--communicator", "xla",
                             "--allreduce-grad-dtype", "bfloat16"]),
                    ("auto", ["--communicator", "auto", "--plan-table",
                              table_path])):
                name = label + (" db" if db else "")
                torch.cuda.synchronize()
                fn.reset_launch_counts()
                cs.reset_launch_counts()
                res = train_imagenet.main(_p30_argv(extra + db))
                torch.cuda.synchronize()
                runs[name] = dict(
                    losses=res["losses"], images_per_sec=res[
                        "images_per_sec"],
                    counts=dict(fn.launch_counts(),
                                cast_scale=cs.cast_scale.launches),
                    params={k: v.detach().clone() for k, v in
                            res["model"].named_parameters()})
                del res
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    want = dict({w: 53 * P30_STEPS for w in KERNELS},
                cast_scale=2 * P30_STEPS)
    out = {}
    for name, r in runs.items():
        ref = runs[name.replace("auto", "xla")]
        out[name] = dict(
            losses=r["losses"], images_per_sec=r["images_per_sec"],
            counts=r["counts"], counts_ok=r["counts"] == want,
            finite=len(r["losses"]) == P30_STEPS and all(
                map(math.isfinite, r["losses"])),
            same_as_xla=r["losses"] == ref["losses"] and all(
                torch.equal(r["params"][k], ref["params"][k])
                for k in r["params"]))
    del runs
    torch.cuda.empty_cache()
    return out


def p30_per_hop(torch, grads):
    """(e): the per-hop plan (int8 on the inter-node hop of the 2-D chain,
    float32 NVLink legs) on the world of one against
    ``allreduce_grad(compressor="int8")``, deterministic, over
    ``P30_EF_STEPS`` EF steps: means and residuals bit for bit.  With the
    default bf16 NVLink legs the plan rounds through bf16 first: its
    largest difference is printed, not gated."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.compression import resolve_compressor
    from chainermn_tpu_torch.planner import compressed_two_dimensional
    spec = {"name": "int8", "stochastic": False}
    comm = create_communicator("flat")
    plan = compressed_two_dimensional(dict(spec), wire_dtype=None,
                                      name="two_dimensional_int8_f32")
    legs = compressed_two_dimensional(dict(spec))
    comp = resolve_compressor(dict(spec))
    sp, sl = (comm.init_compression_state(grads, p) for p in (plan, legs))
    sq = comm.init_compression_state(grads, comp)
    same, worst = True, 0.0
    for _ in range(P30_EF_STEPS):
        a, sp = comm.allreduce_grad(grads, compressor=plan, state=sp)
        c, sl = comm.allreduce_grad(grads, compressor=legs, state=sl)
        b, sq = comm.allreduce_grad(grads, compressor=comp, state=sq)
        same = same and all(_bits_equal(torch, a[k], b[k]) for k in grads)
        same = same and _bits_equal(torch, sp[1].ef, sq.ef)
        worst = max(worst, max(float((c[k].float() - b[k].float()).abs()
                                     .max()) for k in grads))
    return dict(same_bits=same, hops=sorted(sp), bf16_legs_max_diff=worst)


def p30_sidecar(torch, root, table):
    """(f): the ``__plan_table_meta__`` round trip and its two refusals."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer)
    from chainermn_tpu_torch.planner import (
        PlanTable, active_plan_table_meta, clear_active_plan_table,
        flavor_plan, set_active_plan_table)
    comm = create_communicator("xla")
    ckpt = create_multi_node_checkpointer(comm, os.path.join(root, "ckpt"),
                                          name="p30")
    state = {"w": torch.arange(6.0, device=comm.device),
             "it": torch.tensor(P30_STEPS)}
    out = {}
    try:
        set_active_plan_table(table, step=P30_STEPS)
        pin = active_plan_table_meta()
        ckpt.save(state, P30_STEPS)
        got, gen = ckpt.resume({"w": torch.zeros(6, device=comm.device),
                                "it": torch.tensor(0)})
        out["round_trip"] = gen == P30_STEPS and torch.equal(got["w"],
                                                             state["w"])
        other = PlanTable()
        other.put(comm.plan_topology(), "float32", "<=4KiB",
                  flavor_plan("flat"))
        for label, live, msg in (("other_table", other, "pins plan table"),
                                 ("no_table", None, "no active plan table")):
            clear_active_plan_table()
            if live is not None:
                set_active_plan_table(live, step=0)
            try:
                ckpt.resume(state)
                out[label] = False
            except ValueError as e:
                out[label] = msg in str(e)
        out["pin"] = pin
    finally:
        clear_active_plan_table()
    return out


def phase_planner(fn, cs, torch, dev):
    """Phase 30 (see the module docstring)."""
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_planner_",
                            dir=os.path.join(HERE, "build"))
    out, secs = {}, {}
    try:
        t0 = time.perf_counter()
        out["a"] = p30_sweep(root)
        secs["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        grads, bn = p29_resnet_grads(fn, torch, dev)
        out["b"], b_casts = p30_flavors(cs, torch, grads)
        secs["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["c"] = p30_auto(cs, torch, grads, out["a"]["path"])
        secs["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["e"] = p30_per_hop(torch, grads)
        secs["e"] = time.perf_counter() - t0
        del grads
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["d"] = p30_resnet(fn, cs, torch, out["a"]["path"])
        secs["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["f"] = p30_sidecar(torch, root, out["a"]["table"])
        secs["f"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the main path's launches: (b)'s step and (d)'s runs of the BatchNorm
    # kernels; (b)'s, (c)'s and (d)'s casts
    out["bn_counts"] = {w: bn[w] + sum(r["counts"][w] for r in
                                       out["d"].values()) for w in KERNELS}
    out["casts"] = b_casts + out["c"]["casts"] + out["c"]["xla_casts"] + sum(
        r["counts"]["cast_scale"] for r in out["d"].values())
    d = out["d"]
    out["gates"] = {
        "(a) sweep rows validate, table round-trips": out["a"]["roundtrip"],
        "(b) flavors = execute_plan(comm.plan())": all(out["b"].values()),
        "(c) auto bf16 = xla bf16": out["c"]["same_bits"]
        and out["c"]["pick"] == "flat_bfloat16",
        "(c) 2 casts a call": out["c"]["casts"] == 2
        and out["c"]["xla_casts"] == 2,
        "(c) card = CPU": out["c"]["card_cpu"],
        "(d) finite losses, exact launches": all(
            r["finite"] and r["counts_ok"] for r in d.values()),
        "(d) auto = xla bf16 bit for bit": all(
            r["same_as_xla"] for r in d.values()),
        "(e) per-hop int8 = int8": out["e"]["same_bits"],
        "(f) plan-table sidecar": all(
            out["f"][k] for k in ("round_trip", "other_table", "no_table"))}
    out["seconds"] = secs
    return out


def log_planner(p30, images_per_sec_p3, gpu, secs):
    a = p30["a"]
    log(f"phase 30 (a) bench_allreduce --sweep on the NCCL world of one "
        f"(sizes {P30_SIZES_KB} KiB; a plan's us: the least of 3 medians "
        f"of {P30_ITERS} calls, each between CUDA events): "
        f"{a['rows']} rows; us by plan and bytes {json.dumps(a['us'])}; "
        f"the sweep's pick for the gradient bucket {a['bucket']}: "
        f"{a['swept_pick']} (the table holds flat_bfloat16 there); "
        f"tuned vs best fixed {json.dumps(a['comparison'])} on {gpu}")
    log(f"phase 30 (b) ResNet-50's {RESNET_GRADS} gradients: each flavor "
        f"= execute_plan(comm.plan()) bit for bit {json.dumps(p30['b'])}")
    log(f"phase 30 (c) auto with the table: {json.dumps(p30['c'])}")
    for name, r in p30["d"].items():
        log(f"phase 30 (d) train_imagenet ResNet-50 {name} ({P30_STEPS} "
            f"steps, batch {BATCH}, bf16): losses {r['losses']}; same as "
            f"xla + bf16 {r['same_as_xla']}; launches "
            f"{json.dumps(r['counts'])}; images/sec (steps 2..{P30_STEPS}) "
            f"{r['images_per_sec']:.1f} (phase 3, xla, steps "
            f"{WARMUP + 1}..{STEPS}: {images_per_sec_p3:.1f}) on {gpu}")
    log(f"phase 30 (e) per-hop int8 plan vs compressor int8 "
        f"({P30_EF_STEPS} EF steps): {json.dumps(p30['e'])}")
    log(f"phase 30 (f) plan-table sidecar: {json.dumps(p30['f'])}")
    log(f"phase 30 launches: BatchNorm {json.dumps(p30['bn_counts'])}, "
        f"cast_scale {p30['casts']}")
    log(f"phase 30 gates: {json.dumps(p30['gates'])}")
    log(f"phase 30: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in p30["seconds"].items()) + ")")


P31_MNIST = ["--epoch", "2", "--unit", "1000", "--batchsize", "100",
             "--communicator", "xla", "--allreduce-grad-dtype", "float16",
             "--double-buffering"]
P31_PAIRS = 3        # (a): interleaved off / on pairs timed
# (c), (e): one off / on pair each; their gates (same tokens and counters,
# same bits and edges) need no more, and the script's time limit is tight
P31_ONE_PAIR = 1
P31_PLAN_CALLS = 10  # (b): timed calls of the plan, off and on
P31_SIZES = [1 << 10, 1 << 26]   # (d): the transports' payloads
P31_REPS = 6         # (d): the most repeats a payload's goodput takes
# (e): bench_fsdp_overlap's tanh MLP, 4 buckets, a prefetch window of 1
P31_FSDP = {"layers": 8, "width": 4096, "batch": 256, "buckets": 4,
            "prefetch": 1, "steps": 10}


def _obs_reset():
    from chainermn_tpu_torch import observability as obs
    obs.disable()
    obs.reset_flight_recorder()
    obs.get_registry().reset()


def _p31_spread(off, on):
    """Medians, ranges and the pairs' relative differences of ``off`` and
    ``on`` (interleaved runs); ``resolved``: the medians differ by more
    than either label's range."""
    med = {k: statistics.median(v) for k, v in (("off", off), ("on", on))}
    rng = {k: [min(v), max(v)] for k, v in (("off", off), ("on", on))}
    effect = med["on"] - med["off"]
    return {"off": off, "on": on, "median": med, "range": rng,
            "pairs_pct": [100.0 * (b / a - 1.0) for a, b in zip(off, on)],
            "effect_pct": 100.0 * effect / med["off"],
            "resolved": abs(effect) > max(r[1] - r[0]
                                          for r in rng.values())}


def p31_mnist(cs, torch):
    """(a): the MNIST example without and with ``--observability``, two
    epochs a run, ``P31_PAIRS`` interleaved pairs; a run's step time is
    its second epoch's (the first holds the start-up)."""
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.examples import train_mnist
    runs = {"off": [], "on": []}
    for label in ("off", "on") * P31_PAIRS:
        out_dir = os.path.join(HERE, "build", f"chip_smoke_obs_{label}")
        shutil.rmtree(out_dir, ignore_errors=True)
        flags = P31_MNIST + ["--out", out_dir]
        if label == "on":
            obs.install_flight_recorder()
            flags.append("--observability")
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        try:
            res = train_mnist.main(flags)
            torch.cuda.synchronize()
        finally:
            _obs_reset()
        e1, e2 = res["log"][-2:]
        run = {"casts": cs.launch_counts()["cast_scale"],
               "iters": e2["iteration"],
               "step_ms": (e2["elapsed_time"] - e1["elapsed_time"])
               / (e2["iteration"] - e1["iteration"]) * 1e3,
               "params": {k: v.detach().clone()
                          for k, v in res["model"].state_dict().items()}}
        if label == "on":
            recs = [json.loads(ln) for ln in open(
                os.path.join(out_dir, "metrics.jsonl"))]
            run["metrics"] = _p31_metrics(recs)
            shutil.copy(os.path.join(out_dir, "metrics.jsonl"), P31_METRICS)
        runs[label].append(run)
        shutil.rmtree(out_dir, ignore_errors=True)
    runs["step_ms"] = _p31_spread([r["step_ms"] for r in runs["off"]],
                                  [r["step_ms"] for r in runs["on"]])
    return runs


def _p31_metrics(recs):
    """What (a) holds ``metrics.jsonl`` to: the float16 allreduce_grad
    calls and bytes, the telemetry phases' counts, the record kinds."""
    def metric(name, **labels):  # the last window's: cumulative
        for r in reversed(recs):
            if r.get("kind") == "metric" and r["name"] == name and all(
                    r["labels"].get(k) == v for k, v in labels.items()):
                return r
        return {}
    calls = metric("comm_collective_calls", op="allreduce_grad")
    nbytes = metric("comm_collective_bytes", op="allreduce_grad")
    return {"kinds": sorted({r.get("kind") for r in recs}),
            "calls": calls.get("value"),
            "bytes": nbytes.get("value"),
            "dtype": nbytes.get("labels", {}).get("dtype"),
            "phases": {ph: metric("step_phase_seconds", phase=ph).get(
                "count") for ph in ("data_load", "host_put", "dispatch",
                                    "device_block")}}


def p31_plan(cs, torch, dev):
    """(b): the bf16 two-dimensional plan over ResNet-50's packed gradient
    size, without and with the per-stage spans."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.planner import Plan, execute_plan, flavor_plan
    comm = create_communicator("xla")
    two_d = flavor_plan("two_dimensional")
    plan = Plan(name="two_dimensional_bf16", packing="flat",
                wire_dtype="bfloat16", stages=two_d.stages)
    g = torch.Generator(device=dev).manual_seed(31)
    grads = {"resnet50": torch.randn(RESNET_GRADS, device=dev, generator=g)}
    out = {}
    try:
        for label in ("off", "on"):
            pobs = None
            if label == "on":
                obs.enable()
                pobs = obs.get_plan_obs(comm)
            res = execute_plan(plan, comm, grads, pobs=pobs)  # warm
            times = []
            torch.cuda.synchronize()
            cs.reset_launch_counts()
            for _ in range(P31_PLAN_CALLS):
                t0 = time.perf_counter()
                res = execute_plan(plan, comm, grads, pobs=pobs)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            run = {"out": res["resnet50"],
                   "casts": cs.launch_counts()["cast_scale"],
                   "call_ms": sorted(times)[len(times) // 2] * 1e3}
            if label == "on":
                evs = [e for e in obs.get_flight_recorder().snapshot()
                       if e["kind"].startswith("plan_stage_")]
                run["events"] = [(e["kind"][len("plan_stage_"):],
                                  e["stage"], e["op"], e["scope"])
                                 for e in evs]
                run["ts_sorted"] = all(a["ts"] <= b["ts"]
                                       for a, b in zip(evs, evs[1:]))
                run["stage_ms"] = {
                    r["labels"]["stage"]: r["quantiles"]["0.5"] * 1e3
                    for r in obs.get_registry().snapshot()
                    if r["name"] == "plan_stage_seconds"}
            out[label] = run
    finally:
        _obs_reset()
    stages = [(i, st.op, st.scope) for i, st in enumerate(plan.stages)]
    want = [(edge, i, op, scope) for i, op, scope in stages
            for edge in ("begin", "end")] * (P31_PLAN_CALLS + 1)
    out["stages"] = len(stages)
    out["events_ok"] = out["on"]["events"] == want and out["on"]["ts_sorted"]
    out["same_bits"] = _bits_equal(torch, out["on"]["out"], out["off"]["out"])
    out["casts_ok"] = out["on"]["casts"] == out["off"]["casts"] == \
        2 * P31_PLAN_CALLS
    for label in ("off", "on"):
        del out[label]["out"]
    return out


def p31_serving(fa, torch):
    """(c): phase 24's trace, all of it submitted at once, through the LM's
    engine without and with observability, ``P31_ONE_PAIR`` interleaved
    pair."""
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    args = bs.parser().parse_args(P24_FLAGS + P24_TRACE)
    model = bs.build_model(args)
    trace = bs.build_trace(args)
    names = ("steps", "retired", "admitted", "generated_tokens")
    runs = {"off": [], "on": []}
    try:
        for label in ("off", "on") * P31_ONE_PAIR:
            if label == "on":
                obs.enable()
                obs.install_flight_recorder()
            eng = bs._engine(model, args, policy="continuous")
            bs._warm(eng, trace[0][1])  # cuBLAS and the kernel, untimed
            reg = obs.get_registry()
            base = {k: reg.get(f"serving_{k}").value()
                    for k in names} if label == "on" else {}
            passes0 = eng.passes["target"]
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            for _, prompt, max_new in trace:
                eng.submit(prompt, max_new_tokens=max_new)
            comps = eng.run_until_idle()
            torch.cuda.synchronize()
            run = {"tokens": [c.tokens for c in comps],
                   "wall_s": time.perf_counter() - t0,
                   "launches": fa.launch_counts()["flash_fwd"],
                   "passes": eng.passes["target"] - passes0}
            if label == "on":  # the trace's counts, past the warm-up's
                run["counters"] = {
                    k: reg.get(f"serving_{k}").value() - base[k]
                    for k in names}
                _obs_reset()
            runs[label].append(run)
            del eng
    finally:
        _obs_reset()
    del model
    torch.cuda.empty_cache()
    first = runs["off"][0]["tokens"]
    out = {"requests": len(trace),
           "tokens": sum(len(t) for t in first),
           "launches": sum(r["launches"] for rs in runs.values()
                           for r in rs),
           "wall_s": _p31_spread([r["wall_s"] for r in runs["off"]],
                                 [r["wall_s"] for r in runs["on"]])}
    out["same_tokens"] = all(r["tokens"] == first for rs in runs.values()
                             for r in rs)
    out["counters_ok"] = all(
        r["counters"]["retired"] == r["counters"]["admitted"]
        == len(r["tokens"]) == len(trace)
        and r["counters"]["generated_tokens"]
        == sum(len(t) for t in r["tokens"]) for r in runs["on"])
    out["launches_ok"] = all(r["launches"] == LM["n_layers"] * r["passes"]
                             for rs in runs.values() for r in rs)
    out["counters"] = runs["on"][0]["counters"]
    return out


def _p31_edges_ok(evs, leg, bucket, n):
    """``n`` begin/end pairs of one bucket's leg, each end no earlier than
    its begin on the monotonic clock."""
    seq = [(e["kind"].rsplit("_", 1)[1], e["mono"]) for e in evs
           if e["kind"].startswith(f"fsdp_{leg}_")
           and e["bucket"] == bucket]
    return len(seq) == 2 * n and all(
        b[0] == "begin" and e[0] == "end" and b[1] <= e[1]
        for b, e in zip(seq[::2], seq[1::2]))


def p31_fsdp(torch, dev):
    """(e): ``P31_FSDP``'s bucketed FSDP step on a world of one without and
    with observability, ``P31_ONE_PAIR`` interleaved pair of a warm step
    and ``steps`` timed ones."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.benchmarks.bench_fsdp_overlap import tanh_mlp
    from chainermn_tpu_torch.parallel.fsdp import (
        fsdp_init, make_fsdp_train_step)
    cfg = P31_FSDP
    comm = create_communicator("xla")
    g = torch.Generator().manual_seed(31)
    xs, ys = (torch.randn(cfg["batch"], cfg["width"], generator=g).to(dev)
              for _ in range(2))
    runs = {"off": [], "on": []}
    try:
        for label in ("off", "on") * P31_ONE_PAIR:
            if label == "on":
                obs.enable()
                obs.install_flight_recorder()
            model = tanh_mlp(cfg["layers"], cfg["width"], 0, dev)
            state, meta = fsdp_init(comm, model, torch.optim.Adam(
                model.parameters(), lr=1e-3), num_buckets=cfg["buckets"])
            step = make_fsdp_train_step(
                comm, lambda b: torch.mean((model(b[0]) - b[1]) ** 2),
                state, meta, prefetch=cfg["prefetch"])
            step((xs, ys))  # warm
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            torch.cuda.synchronize()
            t0.record()
            for _ in range(cfg["steps"]):
                step((xs, ys))
            t1.record()
            t1.synchronize()
            run = {"step_ms": t0.elapsed_time(t1) / cfg["steps"],
                   "shards": [s.detach().clone()
                              for s in state.flat_shards()]}
            if label == "on":
                evs = [e for e in obs.get_flight_recorder().snapshot()
                       if e["kind"].startswith("fsdp_")]
                seconds = obs.get_registry().histogram(
                    "fsdp_overlap_seconds")
                run["edges_ok"] = all(
                    _p31_edges_ok(evs, leg, k, cfg["steps"] + 1)
                    and seconds.count(leg=leg, bucket=str(k))
                    == cfg["steps"] + 1
                    for leg in ("gather", "scatter")
                    for k in range(meta.num_buckets))
                run["events"] = len(evs)
                _obs_reset()
            runs[label].append(run)
            del model, state, step
    finally:
        _obs_reset()
    torch.cuda.empty_cache()
    first = runs["off"][0]["shards"]
    out = {"buckets": cfg["buckets"],
           "events": runs["on"][0]["events"],
           "step_ms": _p31_spread([r["step_ms"] for r in runs["off"]],
                                  [r["step_ms"] for r in runs["on"]])}
    out["same_bits"] = all(
        len(r["shards"]) == len(first) and all(
            _bits_equal(torch, a, b) for a, b in zip(r["shards"], first))
        for rs in runs.values() for r in rs)
    out["edges_ok"] = all(r["edges_ok"] for r in runs["on"]) and \
        out["events"] == 4 * cfg["buckets"] * (cfg["steps"] + 1)
    return out


def p31_plane():
    """(d): socket control-plane worlds on the native transport, a mixed
    world, and the transports' latency and goodput."""
    from concurrent.futures import ThreadPoolExecutor
    from chainermn_tpu_torch.benchmarks import bench_transport as bt
    from chainermn_tpu_torch.runtime import native
    native._load()  # one g++ build before the worlds start together
    out = {"worlds": {}}
    worlds = {"native x2": ["native"] * 2, "native x4": ["native"] * 4,
              "python + native": ["python", "native"]}
    with ThreadPoolExecutor(len(worlds)) as ex:  # untimed: together
        futs = {k: ex.submit(bt.run_plane_world, b)
                for k, b in worlds.items()}
        results = {k: f.result() for k, f in futs.items()}
    for name, backends in worlds.items():
        res = results[name]
        n = len(backends)
        ok = all(
            r["transport"] == ("PyTransport" if b == "python"
                               else "NativeTransport")
            and r["bcast"] == {"seed": 42}
            and r["gather"] == ([10 * i for i in range(n)] if i == 0
                                else None)
            and r["scatter"] == f"s{i}"
            and r["allreduce"] == {"n": n, "m": [n - 1]}
            and r["allgather"] == list(range(n))
            for i, (r, b) in enumerate(zip(res, backends)))
        frames = res[0].get("frame") and res[-1].get("frame")
        out["worlds"][name] = bool(ok and frames)
    for backend in ("native", "python"):
        r = bt.run_sweep(P31_SIZES, backend, reps_cap=P31_REPS)
        out[backend] = {"rtt_us_1KiB": r["rtt_us"],
                        "MB_per_s_64MiB": r["mb_per_s"][str(1 << 26)]}
    out["native_vs_python_64MiB"] = (out["native"]["MB_per_s_64MiB"]
                                     / out["python"]["MB_per_s_64MiB"])
    return out


def phase_obs(cs, fa, torch, dev):
    """Phase 31 (see the module docstring)."""
    out, secs = {}, {}
    for key, run in (("a", lambda: p31_mnist(cs, torch)),
                     ("b", lambda: p31_plan(cs, torch, dev)),
                     ("c", lambda: p31_serving(fa, torch)),
                     ("d", p31_plane),
                     ("e", lambda: p31_fsdp(torch, dev))):
        t0 = time.perf_counter()
        out[key] = run()
        secs[key] = time.perf_counter() - t0
    a = out["a"]
    runs = a["off"] + a["on"]
    first = a["off"][0]["params"]
    out["a_casts"] = sum(r["casts"] for r in runs)
    m = [r["metrics"] for r in a["on"]]
    iters = a["on"][0]["iters"]
    out["gates"] = {
        "(a) 2 casts an iteration": all(
            r["casts"] == 2 * r["iters"] for r in runs),
        "(a) on = off bit for bit": all(
            _bits_equal(torch, r["params"][k], first[k])
            for r in runs for k in first),
        "(a) metrics.jsonl": all(
            x["calls"] == iters and x["dtype"] == "float16" and x["bytes"]
            and set(x["phases"].values()) == {iters}
            and {"step_report", "metric", "straggler_report"}
            <= set(x["kinds"]) for x in m),
        "(b) a begin/end pair a stage, in order": out["b"]["events_ok"],
        "(b) on = off bit for bit, same casts": out["b"]["same_bits"]
        and out["b"]["casts_ok"],
        "(c) same tokens": out["c"]["same_tokens"],
        "(c) serving counters = completions": out["c"]["counters_ok"],
        "(c) flash launches = layers x passes": out["c"]["launches_ok"],
        "(d) socket worlds": all(out["d"]["worlds"].values()),
        "(e) on = off bit for bit": out["e"]["same_bits"],
        "(e) a begin/end pair a bucket's leg a step":
        out["e"]["edges_ok"]}
    for r in runs:
        del r["params"]
    out["seconds"] = secs
    return out


def _spread_text(sp, unit, nd=4):
    return (f"off {[round(x, nd) for x in sp['off']]}, on "
            f"{[round(x, nd) for x in sp['on']]} {unit}; medians "
            f"{sp['median']['off']:.{nd}f} / {sp['median']['on']:.{nd}f}, "
            f"on - off {sp['effect_pct']:+.2f}% (pairs "
            f"{[round(x, 2) for x in sp['pairs_pct']]}%), ranges off "
            f"{[round(x, nd) for x in sp['range']['off']]} on "
            f"{[round(x, nd) for x in sp['range']['on']]}; the medians' "
            f"difference above both ranges: {sp['resolved']}")


def log_obs(p31, gpu, secs):
    a = p31["a"]
    log(f"phase 31 (a) train_mnist {' '.join(P31_MNIST)}, "
        f"{a['on'][0]['iters']} iterations a run, {P31_PAIRS} off / on "
        f"pairs in turn: the second epoch's step (epoch time / iterations) "
        f"{_spread_text(a['step_ms'], 'ms')}; cast launches "
        f"{[r['casts'] for r in a['off'] + a['on']]}; metrics "
        f"{json.dumps(a['on'][0]['metrics'])} on {gpu}")
    b = p31["b"]
    log(f"phase 31 (b) execute_plan two_dimensional bf16 over "
        f"{RESNET_GRADS} float32 gradients ({b['stages']} stages): call ms "
        f"(median of {P31_PLAN_CALLS}) off {b['off']['call_ms']:.4f}, on "
        f"{b['on']['call_ms']:.4f}; stage ms (median) "
        f"{json.dumps(b['on']['stage_ms'])}; casts off {b['off']['casts']} "
        f"on {b['on']['casts']} on {gpu}")
    c = p31["c"]
    log(f"phase 31 (c) serving phase 24's trace ({c['requests']} requests "
        f"at once, {c['tokens']} tokens), {P31_ONE_PAIR} off / on pair: "
        f"wall {_spread_text(c['wall_s'], 's')}; on counters "
        f"{json.dumps(c['counters'])}; flash launches {c['launches']} on "
        f"{gpu}")
    d = p31["d"]
    log(f"phase 31 (d) control plane worlds {json.dumps(d['worlds'])}; "
        f"native {json.dumps(d['native'])}, python {json.dumps(d['python'])}"
        f", native / python at 64 MiB {d['native_vs_python_64MiB']:.3f} "
        f"(localhost TCP, host CPU) on {gpu}")
    e = p31["e"]
    log(f"phase 31 (e) FSDP {json.dumps(P31_FSDP)} on a world of one, "
        f"{P31_ONE_PAIR} off / on pair: step (CUDA events over the timed "
        f"steps) {_spread_text(e['step_ms'], 'ms')}; {e['events']} flight "
        f"events a run on {gpu}")
    log(f"phase 31 gates: {json.dumps(p31['gates'])}")
    log(f"phase 31: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in p31["seconds"].items()) + ")")


P32_PAIRS = 2        # (a): interleaved watchdog off / on pairs timed
P32_STALL_AT = 100   # (b): the iteration whose stream is held
P32_STALL_CYCLES = 1 << 31   # (b): torch.cuda._sleep's cycles (~1.1-1.3 s)
P32_STALL_ENV = {"CHAINERMN_TPU_WATCHDOG_POLL": "0.1",
                 "CHAINERMN_TPU_WATCHDOG_MAX_DUMPS": "1"}
P32_DELAY_S = 1e-3   # (d): the host delay a batch in the candidate run
P32_TRACED = ["--communicators", "xla", "--allreduce-grad-dtype",
              "bfloat16", "--mb", repr(RESNET_GRADS * 4 / (1 << 20)),
              "--iters", "20", "--warmup", "3", "--repeats", "5"]
P32_REPLAY = "tests/data/degraded_dcn_spans.json"
P32_REPLAY_HASH = "81094b6ac05b3840"  # the CPU's (and JAX's) decision


@contextlib.contextmanager
def _p32_env(env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _p32_patch(obj, name, wrap):
    """``obj.name`` replaced by ``wrap(original)`` for the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _p32_mnist(cs, torch, label, env=None, patch=None):
    """One observed ``train_mnist`` run (``P31_MNIST`` + ``--observability``,
    a flight recorder installed) under ``env`` and ``patch``: its second
    epoch's step ms, casts, parameters, flight events, the dumps left in
    its directory and the watchdog threads alive after it."""
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.examples import train_mnist
    out_dir = os.path.join(HERE, "build", f"chip_smoke_p32_{label}")
    shutil.rmtree(out_dir, ignore_errors=True)
    obs.install_flight_recorder()
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    try:
        with _p32_env(env or {}), (patch or contextlib.nullcontext()):
            res = train_mnist.main(P31_MNIST + ["--out", out_dir,
                                                "--observability"])
        torch.cuda.synchronize()
        events = obs.get_flight_recorder().snapshot()
    finally:
        _obs_reset()
    e1, e2 = res["log"][-2:]
    dumps = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("flight_") and name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                dumps[name] = json.load(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"casts": cs.launch_counts()["cast_scale"],
            "iters": e2["iteration"],
            "step_ms": (e2["elapsed_time"] - e1["elapsed_time"])
            / (e2["iteration"] - e1["iteration"]) * 1e3,
            "params": {k: v.detach().clone()
                       for k, v in res["model"].state_dict().items()},
            "events": events, "dumps": dumps,
            "threads": obs.watchdog_thread_count()}


def p32_watchdog(cs, torch):
    """(a): ``P32_PAIRS`` interleaved pairs of the observed MNIST run
    without and with ``CHAINERMN_TPU_WATCHDOG=1`` (its defaults)."""
    runs = {"off": [], "on": []}
    for label in ("off", "on") * P32_PAIRS:
        env = {"CHAINERMN_TPU_WATCHDOG": "1" if label == "on" else "0"}
        runs[label].append(_p32_mnist(cs, torch, f"a_{label}", env))
    runs["step_ms"] = _p31_spread([r["step_ms"] for r in runs["off"]],
                                  [r["step_ms"] for r in runs["on"]])
    return runs


def p32_stall(cs, torch):
    """(b): the watchdog on (``P32_STALL_ENV``: a 0.1 s poll, one dump)
    and iteration ``P32_STALL_AT``'s stream held by ``torch.cuda._sleep``
    after its step was issued -- the stimulus of a device-side hang: the
    host then waits in the updater's stream synchronize."""
    from chainermn_tpu_torch.training import trainer as tr

    def wrap(apply_step):
        def held(self, batch):
            out = apply_step(self, batch)
            if self.iteration == P32_STALL_AT:
                torch.cuda._sleep(P32_STALL_CYCLES)
            return out
        return held

    run = _p32_mnist(cs, torch, "b", dict(P32_STALL_ENV,
                                          CHAINERMN_TPU_WATCHDOG="1"),
                     _p32_patch(tr.StandardUpdater, "_apply_step", wrap))
    (doc,) = run["dumps"].values() or [None]
    steps = [e for e in run["events"] if e["kind"] == "step"
             and e["iteration"] == P32_STALL_AT + 1]
    out = {"dumps": sorted(run["dumps"]), "threads": run["threads"],
           "casts": run["casts"], "iters": run["iters"],
           "params": run["params"]}
    if doc is not None:
        main = [t for t in doc["threads"] if t["thread"] == "MainThread"]
        out.update(reason=doc["reason"], exchange=doc.get("exchange"),
                   in_sync=bool(main) and any(
                       "synchronize" in ln for ln in main[0]["stack"]))
        if steps:  # the dump inside the held step's window
            end = steps[0]["ts"]
            out["stalled_s"] = steps[0]["dur_s"]
            out["dump_after_start_s"] = doc["ts"] - (end - steps[0]["dur_s"])
            out["dump_in_step"] = end - steps[0]["dur_s"] <= doc["ts"] <= end
    return out


def p32_traced(cs, torch):
    """(c): ``bench_allreduce --traced`` on the bf16 plan over ResNet-50's
    packed gradient size, then ``--replay-spans`` on the committed dump."""
    from chainermn_tpu_torch.benchmarks import bench_allreduce as ba
    path = os.path.join(HERE, "build", "chip_smoke_p32_traced.json")
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    doc = ba.main(P32_TRACED + ["--traced", path])
    torch.cuda.synchronize()
    casts = cs.launch_counts()["cast_scale"]
    a = ba.parse_args(P32_TRACED)
    calls = 2 * a.repeats * (1 + a.warmup + 3 * a.iters)
    rep = ba.main(["--replay-spans", os.path.join(HERE, P32_REPLAY),
                   "--replay-out", path + ".replay"])
    for p in (path, path + ".replay"):
        os.remove(p)
    return {"doc": doc, "casts": casts, "calls": calls,
            "repeats": a.repeats,
            "replay": {"n_spans": rep["n_spans"],
                       "observed_gbps": rep["observed_gbps"],
                       **{k: rep["retune"][k] for k in (
                           "swap", "best_speedup", "table_hash")}}}


def p32_diff(cs, torch, base):
    """(d): an observed MNIST run with ``P32_DELAY_S`` of host time a batch
    (in the updater's host-put), diffed against (a)'s last observed run,
    and that run against itself."""
    from chainermn_tpu_torch.observability import diff_runs
    from chainermn_tpu_torch.training import trainer as tr

    def wrap(put):
        def slow(self, batch):
            time.sleep(P32_DELAY_S)
            return put(self, batch)
        return slow

    cand = _p32_mnist(cs, torch, "d", {"CHAINERMN_TPU_WATCHDOG": "0"},
                      _p32_patch(tr.StandardUpdater, "_put", wrap))
    diff = diff_runs(base["events"], cand["events"])
    self_diff = diff_runs(base["events"], base["events"])
    reg = diff["regression"] or {}
    return {"casts": cand["casts"], "iters": cand["iters"],
            "bucket": reg.get("bucket"), "delta_s": reg.get("delta_s"),
            "ratio": reg.get("ratio"), "confidence": reg.get("confidence"),
            "buckets": {r["bucket"]: [r["base_s"], r["cand_s"]]
                        for r in diff["buckets"]},
            "self_regression": self_diff["regression"]}


def p32_fleet(fa, torch):
    """(e): phase 24's trace through the LM's engine with observability on,
    then one ``TelemetryAggregator.collect`` on the world of one: the fleet
    p50/p95/p99 of each ``serving_*`` streaming histogram against the
    registry's own."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    args = bs.parser().parse_args(P24_FLAGS + P24_TRACE)
    model = bs.build_model(args)
    trace = bs.build_trace(args)
    try:
        obs.enable()
        obs.install_flight_recorder()
        eng = bs._engine(model, args, policy="continuous")
        bs._warm(eng, trace[0][1])
        reg = obs.get_registry()
        for name in reg.names():  # the trace's series alone
            if name.startswith("serving_"):
                reg.get(name).reset()
        passes0 = eng.passes["target"]
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        for _, prompt, max_new in trace:
            eng.submit(prompt, max_new_tokens=max_new)
        comps = eng.run_until_idle()
        torch.cuda.synchronize()
        launches = fa.launch_counts()["flash_fwd"]
        passes = eng.passes["target"] - passes0
        comm = create_communicator("xla")
        t0 = time.perf_counter()
        doc = obs.TelemetryAggregator(comm).collect(0)
        collect_ms = (time.perf_counter() - t0) * 1e3
        want = {}
        for name, slo in doc["slo"].items():
            h = reg.get(name)
            counts = [0] * (len(h.bounds) + 1)
            for labels in h.labels_seen():
                for i, c in enumerate(h.state(**labels)["counts"]):
                    counts[i] += c
            want[name] = {f"p{int(q * 100)}": h._quantile_from_counts(
                counts, q) for q in (0.5, 0.95, 0.99)}
            if len(h.labels_seen()) == 1:  # and the series' own quantile
                want[name + " (series)"] = {
                    f"p{int(q * 100)}": h.quantile(q, **h.labels_seen()[0])
                    for q in (0.5, 0.95, 0.99)}
    finally:
        _obs_reset()
        del model
        torch.cuda.empty_cache()
    got = {k: v["quantiles"] for k, v in doc["slo"].items()}
    return {"requests": len(trace), "completions": len(comps),
            "launches": launches, "passes": passes,
            "collect_ms": collect_ms, "slo": doc["slo"],
            "stragglers": doc["stragglers"],
            "equal": bool(got) and all(
                got[k.split(" ")[0]] == v for k, v in want.items()),
            "names": sorted(got)}


def phase_obs2(cs, fa, torch):
    """Phase 32 (see the module docstring)."""
    out, secs = {}, {}
    for key, run in (("a", lambda: p32_watchdog(cs, torch)),
                     ("b", lambda: p32_stall(cs, torch)),
                     ("c", lambda: p32_traced(cs, torch)),
                     ("d", lambda: p32_diff(cs, torch, out["a"]["on"][-1])),
                     ("e", lambda: p32_fleet(fa, torch))):
        t0 = time.perf_counter()
        out[key] = run()
        secs[key] = time.perf_counter() - t0
    a, b, c, d, e = (out[k] for k in "abcde")
    runs = a["off"] + a["on"]
    first = a["off"][0]["params"]
    traced = c["doc"]
    out["casts"] = sum(r["casts"] for r in runs) + b["casts"] \
        + c["casts"] + d["casts"]
    out["gates"] = {
        "(a) no flight dump, no watchdog thread after finalize": all(
            not r["dumps"] and r["threads"] == 0 for r in runs),
        "(a) watchdog on = off bit for bit": all(
            _bits_equal(torch, r["params"][k], first[k])
            for r in runs for k in first),
        "(a) 2 casts an iteration": all(
            r["casts"] == 2 * r["iters"] for r in runs + [b, d]),
        "(b) one step_stall dump, main thread in synchronize":
        b["dumps"] == ["flight_0.json"] and b.get("reason", "").startswith(
            "step_stall") and b.get("in_sync") is True
        and b.get("dump_in_step") is True and b["threads"] == 0,
        "(b) stalled run = (a) bit for bit": all(
            _bits_equal(torch, b["params"][k], first[k]) for k in first),
        "(c) tracing_overhead/v1 with its spread":
        traced["schema"] == "tracing_overhead/v1"
        and traced["events_per_traced_run"] > 0
        and len(traced["per_repeat_pct"]) == c["repeats"]
        and c["casts"] == 2 * c["calls"],
        "(c) replay = the CPU's decision": c["replay"]["swap"] is True
        and c["replay"]["table_hash"] == P32_REPLAY_HASH,
        "(d) the delayed run names host_input": d["bucket"] == "host_input",
        "(d) a run against itself names none": d["self_regression"] is None,
        "(e) fleet quantiles = the registry's": e["equal"]
        and {"serving_ttft_seconds", "serving_token_seconds",
             "serving_step_seconds"} <= set(e["names"]),
        "(e) flash launches = layers x passes": e["launches"]
        == LM["n_layers"] * e["passes"]
        and e["completions"] == e["requests"]}
    for r in runs:
        del r["params"], r["events"]
    del b["params"]
    out["seconds"] = secs
    return out


def log_obs2(p32, gpu, secs):
    a, b, c, d, e = (p32[k] for k in "abcde")
    log(f"phase 32 (a) train_mnist {' '.join(P31_MNIST)} --observability, "
        f"{a['on'][0]['iters']} iterations a run, {P32_PAIRS} pairs of "
        f"CHAINERMN_TPU_WATCHDOG 0 / 1 in turn: the second epoch's step "
        f"{_spread_text(a['step_ms'], 'ms')}; cast launches "
        f"{[r['casts'] for r in a['off'] + a['on']]}; dumps "
        f"{[sorted(r['dumps']) for r in a['off'] + a['on']]} on {gpu}")
    log(f"phase 32 (b) iteration {P32_STALL_AT}'s stream held "
        f"(torch.cuda._sleep({P32_STALL_CYCLES})), {json.dumps(P32_STALL_ENV)}"
        f": dumps {b['dumps']}, reason {b.get('reason')!r}, main thread in "
        f"synchronize {b.get('in_sync')}, the held step "
        f"{b.get('stalled_s')} s, dump {b.get('dump_after_start_s')} s "
        f"after its start, exchange {b.get('exchange')}, casts "
        f"{b['casts']} on {gpu}")
    t = c["doc"]
    log(f"phase 32 (c) bench_allreduce {' '.join(P32_TRACED)} --traced: "
        f"plan {t['plan']}, off ms {[round(x, 4) for x in t['times_ms_off']]}"
        f", on ms {[round(x, 4) for x in t['times_ms_on']]}, collect "
        f"{t['streaming_collect_ms']} ms, tracing_overhead_pct "
        f"{t['tracing_overhead_pct']} (raw {t['raw_overhead_pct']}, pairs "
        f"{t['per_repeat_pct']}, spread {t['spread_pct']}, noise_dominated "
        f"{t['noise_dominated']}), {t['events_per_traced_run']} events a "
        f"traced arm, {c['casts']} casts in {c['calls']} calls; replay "
        f"{json.dumps(c['replay'])} on {gpu}")
    log(f"phase 32 (d) diff of a run with {P32_DELAY_S * 1e3:.1f} ms of host "
        f"time a batch against (a)'s last observed run: bucket "
        f"{d['bucket']}, delta_s {d['delta_s']}, ratio {d['ratio']}, "
        f"confidence {d['confidence']}; buckets (base, cand) s "
        f"{json.dumps(d['buckets'])}; the run against itself: "
        f"{d['self_regression']} on {gpu}")
    log(f"phase 32 (e) phase 24's trace ({e['requests']} requests, "
        f"{e['completions']} completions, {e['launches']} flash launches in "
        f"{e['passes']} passes), one collect {e['collect_ms']:.3f} ms: fleet "
        f"{json.dumps({k: v['quantiles'] for k, v in e['slo'].items()})} = "
        f"the registry's: {e['equal']} on {gpu}")
    log(f"phase 32 gates: {json.dumps(p32['gates'])}")
    log(f"phase 32: {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in p32["seconds"].items()) + ")")


P33_SAVES = 5        # phase 33 (a): saves of each backend, in turn
P33_GAP = 6          # (a): steps before each save (the persist's cover)
P33_DIR = os.path.join(HERE, "build", "p33")
P33_SMOKE = ["--device", "cuda", "--chaos-start-device", "cpu",
             "--resize-schedule", "2,1", "--timeout", "300"]
P31_METRICS = os.path.join(HERE, "build", "p31_metrics.jsonl")


def _npz_members(path):
    """``{member: bytes}`` of an npz: its arrays bit for bit."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def p33_async_ab(fn, cs, torch, dev):
    """(a): ResNet-50's data-parallel state through the npz and the async
    backends in turn, the steps between them through the BatchNorm kernels
    and the float16 wire's cast."""
    import tempfile

    import torch.nn.functional as F
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     make_train_step)
    from chainermn_tpu_torch.extensions.checkpoint import (
        _leaves, create_multi_node_checkpointer)
    from chainermn_tpu_torch.models import ResNet50
    from chainermn_tpu_torch.optim import optimizer_state_tree
    root = tempfile.mkdtemp(prefix="chip_smoke_p33_",
                            dir=os.path.join(HERE, "build"))
    gen = torch.Generator(device=dev).manual_seed(33)
    model = ResNet50(dtype=torch.bfloat16, device=dev, generator=gen)
    comm = create_communicator("xla", allreduce_grad_dtype="float16")
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)
    batch = (torch.randn((BATCH, 3, 224, 224), device=dev, generator=gen),
             torch.randint(0, 1000, (BATCH,), device=dev, generator=gen))
    step = make_train_step(
        comm, lambda b: F.cross_entropy(model(b[0]), b[1]), opt)

    def state():
        return {"model": dict(model.state_dict()),
                "optimizer": optimizer_state_tree(opt.local_optimizer)}

    model.train()
    try:
        step(batch)  # momentum exists from here on (not counted)
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size()
                     for t in _leaves(state()).values())
        sync = create_multi_node_checkpointer(
            comm, os.path.join(root, "npz"), "ab", keep=2)
        asy = create_multi_node_checkpointer(
            comm, os.path.join(root, "async"), "ab", keep=2, backend="async")
        fn.reset_launch_counts()
        cs.reset_launch_counts()
        steps, losses, sync_ms = 0, [], []

        def run(n):
            nonlocal steps
            for _ in range(n):
                losses.append(float(step(batch)))
                steps += 1

        for _ in range(P33_SAVES):
            run(P33_GAP)
            asy.save(state(), steps)
            run(P33_GAP)
            asy.drain()  # the sync save does not compete with the persist
            t0 = time.perf_counter()
            sync.save(state(), steps)
            sync_ms.append((time.perf_counter() - t0) * 1e3)
        # gate 2: both backends save the same step, then a step updates
        # the parameters and the momentum in place before the drain
        same = steps
        sync.save(state(), same)
        asy.save(state(), same)
        run(1)
        torch.cuda.synchronize()
        in_flight = asy._q.unfinished_tasks > 0
        asy.drain()
        counts = dict(fn.launch_counts(), cast_scale=cs.cast_scale.launches)
        equal = _npz_members(sync._file(same)) == \
            _npz_members(asy._inner._file(same))
        stall = list(asy.stall_ms[:P33_SAVES])
        asy.finalize()
        return {"bytes": nbytes, "steps": steps, "losses": losses,
                "counts": counts, "async_ms": stall, "sync_ms": sync_ms,
                "async": _spread(stall), "sync": _spread(sync_ms),
                "persist_ms": _spread(asy.persist_ms),
                "copy_gbps": nbytes / (statistics.median(stall) * 1e-3)
                / 1e9,
                "same_step_equal": equal, "persist_in_flight": in_flight}
    finally:
        del model, opt
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)


def _p33_tool(name, args):
    """``python -m chainermn_tpu_torch.tools.<name> <args>`` in this
    process (no interpreter or card start-up a call): ``(rc, stdout,
    stderr)``."""
    import importlib
    import io
    mod = importlib.import_module(f"chainermn_tpu_torch.tools.{name}")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(args)
    return rc, out.getvalue(), err.getvalue()


def p33_chaos():
    """(b): the elastic smoke, its chaos world started on 2 CPU ranks and
    relaunched on the card, then the elastic gate on its artifact."""
    art = os.path.join(P33_DIR, "ELASTIC_CARD_r1.json")
    t0 = time.perf_counter()
    rc, out, err = _p33_tool(
        "elastic_smoke", ["--out", art, "--work-dir",
                          os.path.join(P33_DIR, "work")] + P33_SMOKE)
    secs = time.perf_counter() - t0
    if rc:
        log(f"phase 33 (b) elastic_smoke rc {rc}: {err[-3000:]}")
    doc = json.load(open(art)) if os.path.exists(art) else {}
    grc, gout, gerr = _p33_tool(
        "perf_gate", ["--elastic", art, "--out",
                      os.path.join(P33_DIR, "elastic_gate.json")])
    chaos = doc.get("chaos") or {}
    dumps = {}
    if chaos.get("manifest") and os.path.exists(chaos["manifest"]):
        dumps = json.load(open(chaos["manifest"]))["flight_dumps"]
    return {"rc": rc, "seconds": secs, "doc": doc, "gate_rc": grc,
            "gate": gout.strip().splitlines()[-1:] + gerr.strip()
            .splitlines()[-3:], "survivor_dump": "0" in dumps}


def p33_ledger(torch, a):
    """(c): (a)'s document and (b)'s artifact into the run ledger beside
    the committed ones, then obs_report over phase 31's metrics."""
    from chainermn_tpu_torch.observability.ledger import (RunLedger,
                                                          stamp_envelope)
    card = torch.cuda.get_device_name(0)
    doc = stamp_envelope({
        "kind": "elastic_smoke/v1", "ok": True, "chaos": None,
        "async_ckpt": {"state_bytes": a["bytes"],
                       "stall_ms": a["async"]["median"],
                       "sync_stall_ms": a["sync"]["median"],
                       "stall_ms_all": a["async_ms"],
                       "sync_stall_ms_all": a["sync_ms"],
                       "ok": a["async"]["median"] < a["sync"]["median"]}},
        "elastic_smoke/v1", n_devices=1, backend="cuda")
    with open(os.path.join(P33_DIR, "ELASTIC_CARD_RESNET_r1.json"), "w") as f:
        json.dump(doc, f, indent=2)
    runs = os.path.join(P33_DIR, "runs.jsonl")
    if os.path.exists(runs):
        os.remove(runs)
    ingest = []
    for root in (HERE, P33_DIR):
        rc, out, err = _p33_tool(
            "ledger", ["ingest", "--root", root, "--ledger", runs])
        ingest.append({"rc": rc, "summary": json.loads(
            out.strip().splitlines()[-1]) if out.strip() else err[-500:]})
    led = RunLedger.load(runs)
    mine = [r for r in led.records()
            if r["artifact"].startswith("ELASTIC_CARD")]
    theirs = [r for r in led.records() if r not in mine]
    base = led.baseline("elastic_smoke/v1", card, "async_ckpt_stall_ms",
                        "lower")
    cpu_base = led.baseline("elastic_smoke/v1", "cpu", "async_ckpt_stall_ms",
                            "lower")
    metrics = P31_METRICS
    if not os.path.exists(metrics):  # phase 33 alone: one observed run
        from chainermn_tpu_torch.examples import train_mnist
        out_dir = os.path.join(HERE, "build", "chip_smoke_p33_obs")
        train_mnist.main(P31_MNIST + ["--out", out_dir, "--observability"])
        _obs_reset()
        shutil.copy(os.path.join(out_dir, "metrics.jsonl"), metrics)
        shutil.rmtree(out_dir, ignore_errors=True)
    rc, out, err = _p33_tool("obs_report", [metrics])
    return {"ingest": ingest, "card": card,
            "cells": {f"{dk}/{s}": n for (dk, s), n in led.cells().items()},
            "mine": len(mine),
            "separate": bool(mine) and all(r["device_kind"] == card
                                           for r in mine)
            and not any(r["device_kind"] == card for r in theirs),
            "baseline_is_card": base is not None
            and base["device_kind"] == card
            and base["artifact"].startswith("ELASTIC_CARD"),
            "cpu_baseline_not_card": cpu_base is None
            or cpu_base["device_kind"] == "cpu",
            "report_rc": rc, "report_lines": len(out.splitlines()),
            "report_ok": rc == 0 and all(
                h in out for h in ("per-step summary", "per-collective "
                                   "summary", "straggler report"))}


def phase_elastic(fn, cs, torch, dev):
    """Phase 33 (see the module docstring)."""
    shutil.rmtree(P33_DIR, ignore_errors=True)
    os.makedirs(P33_DIR)
    out, secs = {}, {}
    for key, run in (("a", lambda: p33_async_ab(fn, cs, torch, dev)),
                     ("b", p33_chaos),
                     ("c", lambda: p33_ledger(torch, out["a"]))):
        t0 = time.perf_counter()
        out[key] = run()
        secs[key] = time.perf_counter() - t0
    a, b, c = out["a"], out["b"], out["c"]
    chaos = b["doc"].get("chaos") or {}
    out["gates"] = {
        "(a) async below sync": a["async"]["median"] < a["sync"]["median"],
        "(a) async = sync at the same step, bit for bit":
        a["same_step_equal"],
        "(a) 53 BatchNorm launches and 2 casts a step": all(
            n == (2 if w == "cast_scale" else 53) * a["steps"]
            for w, n in a["counts"].items()),
        "(a) finite losses": all(map(math.isfinite, a["losses"])),
        "(b) elastic_smoke ok": b["rc"] == 0 and bool(b["doc"].get("ok")),
        "(b) manifest holds the survivor's dump": b["survivor_dump"],
        "(b) lost steps <= 1": chaos.get("lost_steps", 99) <= 1,
        "(b) losses within 1e-4": chaos.get("max_loss_delta", 1.0) <= 1e-4,
        "(b) relaunched on the card at world 1": [
            (x["world"], x["device"]) for x in chaos.get("attempts", [])]
        == [(2, "cpu"), (1, None)],
        "(b) perf_gate --elastic": b["gate_rc"] == 0,
        "(c) every artifact classifies": all(
            i["rc"] == 0 and i["summary"]["unknown"] == 0
            for i in c["ingest"]),
        "(c) the card's records in a cell of their own": c["separate"]
        and c["mine"] == 2,
        "(c) the card's baseline is the card's": c["baseline_is_card"]
        and c["cpu_baseline_not_card"],
        "(c) obs_report over phase 31's metrics": c["report_ok"]}
    out["seconds"] = secs
    return out


def log_elastic(p33, gpu, secs):
    a, b, c = p33["a"], p33["b"], p33["c"]
    chaos = b["doc"].get("chaos") or {}
    ab = b["doc"].get("async_ckpt") or {}
    log(f"phase 33 (a) ResNet-50 data-parallel state ({a['bytes']} bytes: "
        f"parameters, BatchNorm statistics, SGD momentum), batch {BATCH} "
        f"bf16 steps on the float16 wire, {P33_SAVES} saves of each backend "
        f"every {P33_GAP} steps: stall ms npz {json.dumps(a['sync'])} "
        f"(all {[round(v, 3) for v in a['sync_ms']]}), async "
        f"{json.dumps(a['async'])} (all {[round(v, 3) for v in a['async_ms']]}"
        f"); the snapshot's copy {a['copy_gbps']:.2f} GB/s; persist ms "
        f"{json.dumps(a['persist_ms'])}; the same step's generations equal "
        f"{a['same_step_equal']} (persist still in flight after the next "
        f"step: {a['persist_in_flight']}); launches {json.dumps(a['counts'])}"
        f" in {a['steps']} steps on {gpu}")
    log(f"phase 33 (b) elastic_smoke {' '.join(P33_SMOKE)} ({b['seconds']:.1f}"
        f" s): A/B over {ab.get('state_bytes')} bytes on the card, stall ms "
        f"{ab.get('stall_ms')} vs sync {ab.get('sync_stall_ms')}; chaos: "
        f"attempts {json.dumps(chaos.get('attempts'))}, resumed from "
        f"{chaos.get('resumed_from')}, lost steps {chaos.get('lost_steps')}, "
        f"max loss delta {chaos.get('max_loss_delta')} over "
        f"{chaos.get('steps_compared')} steps, resize "
        f"{json.dumps(chaos.get('resize'))}, baseline "
        f"{chaos.get('baseline_s')} s, manifest reason "
        f"{chaos.get('manifest_reason')!r}, dumps "
        f"{chaos.get('n_embedded_dumps')}; perf_gate --elastic rc "
        f"{b['gate_rc']}: {b['gate']}")
    log(f"phase 33 (c) ledger ingest {json.dumps(c['ingest'])}; cells "
        f"{json.dumps(c['cells'])}; obs_report over phase 31's metrics rc "
        f"{c['report_rc']}, {c['report_lines']} lines")
    log(f"phase 33 gates: {json.dumps(p33['gates'])}")
    log(f"phase 33: {secs:.1f} s (" + ", ".join(
        f"({k}) {v:.1f} s" for k, v in p33["seconds"].items()) + ")")


P34_STEPS = 3        # phase 34 (a): steps under the recorder (and bare)
P34_CAPTURED = 16 << 20   # (b): the closed-over tensor's float32 elements

_P34_DRY = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch, torch.distributed as dist
from chainermn_tpu_torch.analysis import extract_schedule, lint_step
from chainermn_tpu_torch.communicators import create_communicator

def body():
    comm = create_communicator("xla", device="cpu")
    x = torch.ones(1024)
    ops = ((dist.ReduceOp.SUM, dist.ReduceOp.MAX) if comm.rank == 0
           else (dist.ReduceOp.MAX, dist.ReduceOp.SUM))
    for op in ops:
        dist.all_reduce(x, op=op, group=comm._group)
    return dist.get_backend()

seen = {}
def variant(r):
    def run():
        seen[r] = body()
    return extract_schedule(run, rank=r, world=2, label=f"rank{r}")
rep = lint_step(None, variants={f"rank{r}": variant(r) for r in (0, 1)},
                rules=["schedule-desync"], raise_on_error=False)
print("RESULT " + json.dumps({
    "findings": [f.as_dict() for f in rep.findings], "backends": seen,
    "cuda_initialized": torch.cuda.is_initialized()}))
"""


def p34_resnet(fn, cs, torch, dev):
    """(a): ResNet-50 on the float16 wire, ``P34_STEPS`` steps under
    ``lint_step`` against as many bare steps of a twin built from the
    same seed; then as many again, recorded against bare, for the
    recorder's cost."""
    import torch.nn.functional as F
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer,
                                     make_train_step)
    from chainermn_tpu_torch.analysis import lint_step, record
    from chainermn_tpu_torch.models import ResNet50
    comm = create_communicator("xla", allreduce_grad_dtype="float16")
    gen = torch.Generator(device=dev).manual_seed(34)
    batch = (torch.randn((BATCH, 3, 224, 224), device=dev, generator=gen),
             torch.randint(0, 1000, (BATCH,), device=dev, generator=gen))

    def build():
        g = torch.Generator(device=dev).manual_seed(3434)
        model = ResNet50(dtype=torch.bfloat16, device=dev, generator=g)
        model.train()
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)
        step = make_train_step(
            comm, lambda b: F.cross_entropy(model(b[0]), b[1]), opt)

        def fn_step(state, b):
            del state  # the step holds it
            return step(b)
        return model, opt, step, fn_step

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / P34_STEPS

    def state(model):
        return [t.detach().clone() for t in list(model.parameters())
                + list(model.buffers())]

    deterministic = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        bare_m, _, bare_step, _ = build()
        rec_m, rec_opt, rec_step, fn_step = build()
        bare_step(batch)  # the builds' first launches, on both twins
        rec_step(batch)
        bare_losses, bare_ms = timed(
            lambda: [float(bare_step(batch)) for _ in range(P34_STEPS)])
        fn.reset_launch_counts()
        cs.reset_launch_counts()
        rep, lint_ms = timed(lambda: lint_step(
            fn_step, (rec_m, rec_opt), batch, comm=comm, census=True,
            plan=comm.plan(), donate_argnums=(0,), steps=P34_STEPS,
            name="resnet50[xla,float16 wire]", raise_on_error=False,
            rules=["census-drift", "wire-dtype-mismatch", "async-pair",
                   "captured-constant", "donation-alias"]))
        counts = dict(fn.launch_counts(), cast_scale=cs.cast_scale.launches)
        rec_losses = [float(x) for x in rep.outputs]
        equal = all(torch.equal(a, b) for a, b in zip(state(bare_m),
                                                        state(rec_m)))
        # the recorder's cost: as many steps again, bare against recorded
        _, bare2_ms = timed(lambda: [bare_step(batch)
                                     for _ in range(P34_STEPS)])
        _, rec2_ms = timed(lambda: record(
            lambda: [rec_step(batch) for _ in range(P34_STEPS)],
            comms=[comm]))
        equal2 = all(torch.equal(a, b) for a, b in zip(state(bare_m),
                                                         state(rec_m)))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = deterministic
    sched = rep.schedule
    return {"report": rep.to_json(), "counts": counts,
            "steps": P34_STEPS, "losses": rec_losses,
            "bare_losses": bare_losses,
            "bit_equal": equal and bare_losses == rec_losses,
            "bit_equal_after_cost": equal2,
            "collectives": [[op.kind, op.dtype, op.nbytes, op.async_op]
                            for op in sched],
            "bare_ms": bare_ms, "lint_ms": lint_ms,
            "bare2_ms": bare2_ms, "recorded_ms": rec2_ms}


def p34_dry_start():
    """(b)'s rank-branching variant, dry, in a process with no card and no
    process group (this one has an NCCL world): started first, so its
    interpreter's start-up runs beside (a)."""
    import subprocess
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", _P34_DRY, HERE], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=HERE)


def p34_faults(torch, dev, dry_proc):
    """(b): one planted fault a rule; each must fire with its JAX ID."""
    import torch.distributed as dist
    from chainermn_tpu_torch.analysis import lint_step
    from chainermn_tpu_torch.planner.plans import flavor_plan
    out = {}
    stdout, stderr = dry_proc.communicate(timeout=300)
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
    dry = json.loads(line[-1][7:]) if line else {"error": stderr[-800:]}
    out["desync"] = dict(dry, rc=dry_proc.returncode)
    # float32 all-reduce under the float16 plan
    g = torch.ones(1 << 20, device=dev)
    rep = lint_step(lambda x: dist.all_reduce(x.clone()), g,
                    plan=flavor_plan("xla", wire_dtype="float16"),
                    rules=["wire-dtype-mismatch"], raise_on_error=False)
    out["wire"] = [f.as_dict() for f in rep.findings]
    # a handle never waited
    pending = []

    def leaky(x):
        pending.append(dist.all_reduce(x, async_op=True))
        return x
    rep = lint_step(leaky, torch.ones(1024, device=dev),
                    rules=["async-pair"], raise_on_error=False)
    for w in pending:
        w.wait()
    out["async"] = [f.as_dict() for f in rep.findings]
    # a 64 MiB CUDA tensor closed over
    big = torch.ones(P34_CAPTURED, device=dev)
    rep = lint_step(lambda x: x + big.sum(), torch.ones(8, device=dev),
                    rules=["captured-constant"], raise_on_error=False)
    out["captured"] = [f.as_dict() for f in rep.findings]
    del big
    return out


def phase_lint(fn, cs, torch, dev):
    """Phase 34 (see the module docstring)."""
    out, secs = {}, {}
    dry = p34_dry_start()
    for key, run in (("a", lambda: p34_resnet(fn, cs, torch, dev)),
                     ("b", lambda: p34_faults(torch, dev, dry)),
                     ("c", lambda: _p33_tool("cmn_lint",
                                             ["--protocol", "--json"])),
                     ("d", lambda: __import__(
                         "chainermn_tpu_torch.tools.check_db_overlap",
                         fromlist=["run"]).run(steps=4))):
        t0 = time.perf_counter()
        out[key] = run()
        secs[key] = time.perf_counter() - t0
    a, b, (c_rc, c_out, _), d = out["a"], out["b"], out["c"], out["d"]
    out["c"] = json.loads(c_out) if c_rc == 0 else {"rc": c_rc,
                                                     "tail": c_out[-800:]}
    findings = a["report"]["findings"]
    dry = b["desync"]
    one = lambda fs, rule: [f["rule"] for f in fs] == [rule]  # noqa: E731
    out["gates"] = {
        "(a) census, wire, async, captured, donation clean": not findings
        and not a["report"]["skipped"],
        "(a) a float16 all-reduce recorded": any(
            k == "all-reduce" and dt == "f16"
            for k, dt, _, _ in a["collectives"]),
        "(a) recorded steps bit-equal to bare steps": a["bit_equal"]
        and a["bit_equal_after_cost"],
        "(a) 53 launches of rows 1-4 and 2 casts a step (+2 census)": all(
            n == (2 * a["steps"] + 2 if w == "cast_scale"
                  else 53 * a["steps"]) for w, n in a["counts"].items()),
        "(b) schedule-desync, dry on the fake group": dry.get("rc") == 0
        and one(dry.get("findings", []), "schedule-desync")
        and dry["findings"][0]["details"]["index"] == 0
        and set(dry.get("backends", {}).values()) == {"fake"}
        and not dry.get("cuda_initialized", True),
        "(b) wire-dtype-mismatch on a float32 all-reduce": one(
            b["wire"], "wire-dtype-mismatch")
        and b["wire"][0]["details"]["expected_dtype"] == "f16",
        "(b) async-pair on a handle never waited": one(b["async"],
                                                       "async-pair"),
        "(b) captured-constant on 64 MiB": one(b["captured"],
                                               "captured-constant")
        and b["captured"][0]["details"]["constants"][0]["nbytes"]
        == 4 * P34_CAPTURED,
        "(c) cmn_lint --protocol: 0 errors": c_rc == 0
        and out["c"].get("ok") is True and not out["c"].get("findings"),
        "(d) check_db_overlap on one card": d["ok"]
        and d["verdict"].startswith("not judgeable")}
    out["seconds"] = secs
    return out


def log_lint(p34, gpu, secs):
    a, b, c, d = p34["a"], p34["b"], p34["c"], p34["d"]
    log(f"phase 34 (a) ResNet-50 batch {BATCH} bf16 on the float16 wire, "
        f"{a['steps']} steps under lint_step: findings "
        f"{json.dumps(a['report']['findings'])}, skipped "
        f"{json.dumps(a['report']['skipped'])}; collectives a run "
        f"{json.dumps(a['collectives'])}; bit-equal to the bare twin "
        f"{a['bit_equal']} (after the cost runs {a['bit_equal_after_cost']}"
        f"); losses {a['losses']}; launches {json.dumps(a['counts'])}; "
        f"ms a step: bare {a['bare_ms']:.3f}, under lint_step "
        f"{a['lint_ms']:.3f} (rules and the census probe included), then "
        f"bare {a['bare2_ms']:.3f} vs recorded {a['recorded_ms']:.3f} "
        f"(x{a['recorded_ms'] / a['bare2_ms']:.3f}) on {gpu}")
    log(f"phase 34 (b) planted faults: desync (dry, rc "
        f"{b['desync'].get('rc')}, backends "
        f"{b['desync'].get('backends')}) "
        f"{[f['rule'] for f in b['desync'].get('findings', [])]}; wire "
        f"{[(f['rule'], f['details'].get('observed_dtypes')) for f in b['wire']]}"
        f"; async {[f['rule'] for f in b['async']]}; captured "
        f"{[(f['rule'], f['details']['constants'][0]['nbytes']) for f in b['captured']]}")
    log(f"phase 34 (c) cmn_lint --protocol: ok {c.get('ok')}, "
        f"{(c.get('protocol') or {}).get('n_sites')} call sites, findings "
        f"{len(c.get('findings', []))}")
    log(f"phase 34 (d) check_db_overlap: {d['verdict']}; NCCL all-reduce "
        f"kernels {d['n_all_reduce']} in {d['steps']} steps")
    log(f"phase 34 gates: {json.dumps(p34['gates'])}")
    log(f"phase 34: {secs:.1f} s (" + ", ".join(
        f"({k}) {v:.1f} s" for k, v in p34["seconds"].items()) + ")")


P35_GFLOP_TOKEN = 3.6239    # (a): JAX's count at the LM's configuration
P35_LM_KEYS = ("metric", "value", "unit", "seq_len", "d_model", "layers",
               "n_params_m", "train_gflop_per_token", "mfu", "peak_tflops",
               "step_ms", "device_ms_per_step", "device_busy_share")
P35_SMOKE = "flash_gqa_rectangular,flash_throughput_T32k,flash_bwd_T32k"
P35_CONV = "mnist_mlp,tiny_resnet_synthetic_imagenet"
P35_DIR = os.path.join(HERE, "build", "p35")


def p35_bench_lm(fa, cs, torch):
    """(a): bench_lm at its card defaults, counted."""
    from chainermn_tpu_torch.benchmarks import bench_lm
    fa.reset_launch_counts()
    cs.reset_launch_counts()
    line = bench_lm.main([])
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts(), cast_scale=cs.cast_scale.launches)
    per_step = {w: n / line["step_calls"] for w, n in counts.items()}
    gates = {
        "keys": all(k in line for k in P35_LM_KEYS)
        and line.get("schema") == "bench_lm/v1",
        "gflop_per_token": line["train_gflop_per_token"] == P35_GFLOP_TOKEN,
        "params": line["n_params_m"] == P24_PARAMS_M,
        "finite": all(map(math.isfinite, (line["first_loss"],
                                          line["final_loss"], line["mfu"]))),
        "launches": per_step == {"flash_fwd": 8, "flash_bwd_dkv": 8,
                                 "flash_bwd_dq": 8, "cast_scale": 2}}
    return dict(line=line, counts=counts, per_step=per_step, gates=gates)


def p35_flash(fa, torch):
    """(b) and (c): bench_flash_64k at T 65536 with its window check, then
    gpu_smoke's T 262144 step and the checks no phase covers, counted; the
    launches that compared a kernel with its plain version (the window
    checks, the GQA check) are taken out of the count."""
    from chainermn_tpu_torch.benchmarks import bench_flash_64k
    from chainermn_tpu_torch.tools import gpu_smoke
    os.makedirs(P35_DIR, exist_ok=True)
    probe_out = os.path.join(P35_DIR, "flash_64k.json")
    smoke_out = os.path.join(P35_DIR, "gpu_smoke.json")
    if os.path.exists(smoke_out):
        os.remove(smoke_out)
    fa.reset_launch_counts()
    rc = bench_flash_64k.main(["--out", probe_out])
    torch.cuda.empty_cache()
    rc_smoke = gpu_smoke.main(["--only", "flash_train_T256k," + P35_SMOKE,
                               "--out", smoke_out])
    torch.cuda.synchronize()
    launches = fa.launch_counts()
    with open(probe_out) as f:
        probe = json.load(f)
    with open(smoke_out) as f:
        smoke = json.load(f)
    torch.cuda.empty_cache()
    st, ck = probe["stages"], smoke["checks"]
    compared = [st.get("window", {}).get("launches", {})] + [
        c.get("compare_launches", {}) for c in ck.values()]
    for w in launches:
        launches[w] -= sum(c.get(w, 0) for c in compared)
    step = st.get("train_step", {})
    big = ck.get("flash_train_T256k", {})
    gqa = ck.get("flash_gqa_rectangular", {})

    def window_ok(w):
        return bool(w) and all(e <= w["tol"] for e in w["rel_l2"].values())

    gates = {
        "probe_ok": rc == 0 and probe["ok"] and probe["T"] == 65536,
        "window": st.get("window", {}).get("ok", False)
        and window_ok(st["window"]),
        "T64k_step_moves": step.get("ok", False)
        and step["weight_delta_norm"] > 0
        and all(a != b for a, b in zip(step["losses"], step["losses"][1:])),
        "T256k_step_moves": big.get("ok", False) and big.get("T") == 262144
        and big["weight_delta_norm"] > 0
        and all(a != b for a, b in zip(big["train_losses"],
                                       big["train_losses"][1:])),
        "T256k_window": big.get("ok", False) and window_ok(big["window"]),
        "T32k_window": ck.get("flash_bwd_T32k", {}).get("ok", False)
        and window_ok(ck["flash_bwd_T32k"]["window"]),
        "gqa_vs_plain": gqa.get("ok", False) and set(gqa["rel_l2"]) == {
            "out", "dq", "dk", "dv"}
        and all(e <= gqa["tol"] for e in gqa["rel_l2"].values()),
        "smoke_ok": rc_smoke == 0 and smoke["ok"] and smoke["on_gpu"]}
    return dict(probe=probe, smoke=smoke, launches=launches, gates=gates)


def p35_convergence(fn, torch, dev):
    """(d): the BatchNorm kernels against their plain versions at the tiny
    ResNet row's shapes, then the two convergence rows, counted."""
    from chainermn_tpu_torch.tools import convergence_ledger
    shapes = sorted({(n * h * w, c) for _, (n, h, w, c), _ in
                     fn.resnet_bn_boundaries(16, image=32)}, reverse=True)
    errs, kernel_error = {}, None
    try:
        phase_kernels(fn, torch, dev, shapes, (torch.bfloat16,), errs)
    except AssertionError as e:
        kernel_error = str(e)
    os.makedirs(P35_DIR, exist_ok=True)
    out = os.path.join(P35_DIR, "convergence.json")
    fn.reset_launch_counts()
    rc = convergence_ledger.main(["--only", P35_CONV, "--out", out])
    torch.cuda.synchronize()
    with open(out) as f:
        doc = json.load(f)
    counts = fn.launch_counts()
    rows = doc["checks"]
    gates = {
        "bn_vs_plain": kernel_error is None and set(errs) == {
            "stats_call", "apply_call", "bwd_reduce_call", "bwd_dx_call"},
        "ok": rc == 0 and doc["ok"] and set(rows) == set(P35_CONV.split(",")),
        "floors": all(r.get("ok") and r["val_accuracy"] >= r["floor"]
                      for r in rows.values()),
        "bn_kernels": all(n > 0 for n in counts.values())}
    return dict(doc=doc, counts=counts, gates=gates, shapes=shapes,
                kernel_errs=errs, kernel_error=kernel_error)


def phase_queue_a(fn, cs, fa, torch, dev):
    """Phase 35 (see the module docstring)."""
    out = {"seconds": {}}
    for key, call in (("a", lambda: p35_bench_lm(fa, cs, torch)),
                      ("bc", lambda: p35_flash(fa, torch)),
                      ("d", lambda: p35_convergence(fn, torch, dev))):
        t0 = time.perf_counter()
        out[key] = call()
        out["seconds"][key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["gates"] = {f"{k}:{g}": ok for k in ("a", "bc", "d")
                    for g, ok in out[k]["gates"].items()}
    return out


def log_queue_a(p35, gpu, secs):
    a, bc, d = p35["a"], p35["bc"], p35["d"]
    ln = a["line"]
    log(f"phase 35 (a) bench_lm: {ln['value']:.1f} tokens/s per GPU, MFU "
        f"{ln['mfu']:.4f} (peak {ln['peak_tflops']} TFLOP/s, assumed "
        f"{ln['peak_assumed']}), {ln['train_gflop_per_token']} train "
        f"GFLOP/token, {ln['n_params_m']} M parameters, step "
        f"{ln['step_ms']:.2f} ms, device {ln['device_ms_per_step']:.2f} ms "
        f"(busy {ln['device_busy_share']:.3f}), loss {ln['first_loss']:.4f} "
        f"-> {ln['final_loss']:.4f}; launches a step "
        f"{json.dumps(a['per_step'])} over {ln['step_calls']} step calls on "
        f"{gpu}")
    st = bc["probe"]["stages"]
    for name, stage in st.items():
        log(f"phase 35 (b) bench_flash_64k T {bc['probe']['T']} {name}: "
            + json.dumps(stage))
    for name, chk in bc["smoke"]["checks"].items():
        log(f"phase 35 (b/c) gpu_smoke {name}: " + json.dumps(chk))
    log(f"phase 35 (b/c) flash launches {json.dumps(bc['launches'])}")
    log(f"phase 35 (d) BatchNorm kernels against plain at {len(d['shapes'])}"
        f" [R, C] of ResNet-50 at 32 px, batch 16, bf16 "
        f"({d['shapes'][0]} .. {d['shapes'][-1]}): max abs "
        f"{json.dumps(d['kernel_errs'])}"
        + (f"; FAILED: {d['kernel_error']}" if d["kernel_error"] else ""))
    for name, row in d["doc"]["checks"].items():
        log(f"phase 35 (d) convergence {name}: " + json.dumps(row))
    log(f"phase 35 (d) BatchNorm launches {json.dumps(d['counts'])}")
    log(f"phase 35 gates: {json.dumps(p35['gates'])}")
    log(f"phase 35: {secs:.1f} s (" + ", ".join(
        f"({k}) {v:.1f} s" for k, v in p35["seconds"].items()) + ")")


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
    models = phase_models(fn, cs, torch, dev)
    cif = models["cifar"]
    log(f"phase models (23): {time.perf_counter() - t0:.1f} s; (a) "
        f"train_cifar (VGG-16, batch 64, bf16, xla + float16 wire + double "
        f"buffering), {P23_ITERS} iterations: losses {cif['losses']}; "
        f"launches {json.dumps(cif['counts'])}; images/sec (steps 6.."
        f"{P23_ITERS}) {cif['images_per_sec']:.1f}; peak memory "
        f"{cif['peak_gb']:.2f} GB; (b) float32 step (loss rel, worst "
        f"gradient rel L2, tensor) {json.dumps(models['f32'])}; (c) BN "
        f"kernels at VGG-16's shapes, batch 64 and 256, bf16: max abs err "
        f"{json.dumps(models['kernel_errs'])}; (d) train_imagenet, 224 px, "
        f"batch {BATCH}, bf16: " + "; ".join(
            f"{a}: losses {r['losses']}, BN launches "
            f"{json.dumps(r['bn_launches'])}, images/sec (steps "
            f"{WARMUP + 1}..{P23_ARCH_ITERS}) {r['images_per_sec']:.1f}, "
            f"peak memory {r['peak_gb']:.2f} GB"
            for a, r in models["archs"].items())
        + f"; (e) run_configs values {json.dumps(models['configs'])} "
        f"(rows above) on {gpu}")

    t0 = time.perf_counter()
    srv = phase_serving(fa, torch, dev, card)
    log_serving(srv, gpu, time.perf_counter() - t0)
    if srv["failed"]:
        raise AssertionError(f"phase 24: gates {srv['failed']} failed "
                             "(their lines above)")

    t0 = time.perf_counter()
    p25 = phase_imagenet(fn, cs, fa, torch, dev, card)
    log_imagenet(p25, gpu, time.perf_counter() - t0)

    t0 = time.perf_counter()
    p26 = phase_fsdp(fn, cs, fa, torch, dev)
    log_fsdp(p26, gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p26["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 26: gates {failed} failed (their "
                             "lines above)")

    t0 = time.perf_counter()
    p27 = phase_moe(fa, torch, dev, card)
    log_moe(p27, gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p27["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 27: gates {failed} failed (their "
                             "lines above)")

    t0 = time.perf_counter()
    p28 = phase_pipeline(fa, torch, dev)
    log_pipeline(p28, gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p28["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 28: gates {failed} failed (their "
                             "lines above)")

    t0 = time.perf_counter()
    p29 = phase_compression(fn, cs, fa, torch, dev)
    log_compression(p29, gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p29["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 29: gates {failed} failed (their "
                             "lines above)")

    t0 = time.perf_counter()
    p30 = phase_planner(fn, cs, torch, dev)
    log_planner(p30, out["images_per_sec"], gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p30["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 30: gates {failed} failed (their "
                             "lines above)")

    t0 = time.perf_counter()
    c12 = phase_c12(fa, torch, dev, C12_LOOPS)
    rep = phase_wgrad_repeat(pm, bcp, torch, dev, WGRAD_LOOPS)
    log(f"phase repeat loops (22): {time.perf_counter() - t0:.1f} s; C12 "
        f"{json.dumps(c12)}; probe wgrad {json.dumps(rep)} on {gpu}")
    if (c12["over_gate"] or c12["gpu_bits_repeat"] != C12_LOOPS
            or c12["cpu_bits_repeat"] != C12_LOOPS or rep["differing"]):
        raise AssertionError("phase 22: a pass over the 1e-5 gate, or a "
                             "launch whose bits differ from the first's")

    t0 = time.perf_counter()
    p31 = phase_obs(cs, fa, torch, dev)
    log_obs(p31, gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p31["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 31: gates {failed} failed (their "
                             "lines above)")

    t0 = time.perf_counter()
    p32 = phase_obs2(cs, fa, torch)
    log_obs2(p32, gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p32["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 32: gates {failed} failed (their "
                             "lines above)")

    t0 = time.perf_counter()
    p33 = phase_elastic(fn, cs, torch, dev)
    log_elastic(p33, gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p33["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 33: gates {failed} failed (their "
                             "lines above)")

    t0 = time.perf_counter()
    p34 = phase_lint(fn, cs, torch, dev)
    log_lint(p34, gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p34["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 34: gates {failed} failed (their "
                             "lines above)")

    t0 = time.perf_counter()
    p35 = phase_queue_a(fn, cs, fa, torch, dev)
    log_queue_a(p35, gpu, time.perf_counter() - t0)
    failed = sorted(g for g, ok in p35["gates"].items() if not ok)
    if failed:
        raise AssertionError(f"phase 35: gates {failed} failed (their "
                             "lines above)")
    log(f"phases done: {time.perf_counter() - t_build:.1f} s since the "
        f"builds started")

    dist.destroy_process_group()
    # phase 25's launches on the main path: (a) flash and casts, (d)'s
    # bench and (e)'s real-image run the BatchNorm kernels
    p25_bn = {w: p25["resnet"]["bench_counts"][w]
              + 53 * (P25_REAL_ITERS + P25_REAL_PROFILED + (
                  P25_IMAGES["val"] // BATCH if w == "apply_call" else 0))
              for w in KERNELS}
    p25_vit = p25["vit"]["flash"]["counts"]
    # phase 26's launches on the main path: the FSDP example runs' BatchNorm
    # kernels, the bfloat16 wire's casts, the FSDP LM's flash kernels
    for w in KERNELS:
        p25_bn[w] += p26["resnet"]["bn_launches"][w]
        p25_bn[w] += p29["bn_counts"][w] + p30["bn_counts"][w] \
            + p33["a"]["counts"][w] + p34["a"]["counts"][w] \
            + p35["d"]["counts"][w]
    p26_flash = p26["lm"]["runs"]["fsdp"]["counts"]
    # phases 28 and 29 on the main path: the pipelines' and the FSDP LM's
    # flash kernels, the wire's casts
    p2829_flash = {w: p28["a"]["1f1b"]["counts"][w]
                   + p28["a"]["gpipe"]["counts"][w] + p29["d"]["counts"][w]
                   for w in FLASH}
    kernels = []
    for wrapper, (name, replaces, _, _, route, source) in KERNELS.items():
        t = times[wrapper]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": counts[wrapper] + p25_bn[wrapper],
            "max_abs_err": errs[wrapper], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    kernels.append({
        "name": "cast_scale", "route": "cuda",
        "source": "chainermn_tpu_torch/csrc/cast_scale.cu",
        "replaces": "chainermn_tpu/ops/cast_scale.py:33",
        "launches": mnist_casts + p25_vit["cast_scale"]
        + p25["vit"]["xla"]["counts"]["cast_scale"] + p26["resnet"]["casts"]
        + sum(r["casts"] for r in p29["a"].values()) + p30["casts"]
        + p31["a_casts"] + p31["b"]["off"]["casts"]
        + p31["b"]["on"]["casts"] + p32["casts"]
        + p33["a"]["counts"]["cast_scale"]
        + p34["a"]["counts"]["cast_scale"]
        + p35["a"]["counts"]["cast_scale"],
        "max_abs_err": cast_err,
        "ms": cast_t["ms"], "plain_ms": cast_t["plain_ms"],
        "bound_ms": cast_t["bound_ms"], "bound_by": "bytes",
        "library_ms": cast_t["library_ms"]})
    for wrapper, (name, replaces, _) in FLASH.items():
        t = flash_t[wrapper]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces, "launches": lm["counts"][wrapper]
            + p25_vit[wrapper] + p26_flash[wrapper]
            + p27["a"]["counts"][wrapper] + p2829_flash[wrapper]
            + p35["a"]["counts"][wrapper] + p35["bc"]["launches"][wrapper]
            + (srv["serving_launches"] + p27["srv"]["launches"]
               + p31["c"]["launches"] + p32["e"]["launches"]
               if wrapper == "flash_fwd" else 0),
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


def phase_alone(n):
    """``python3 chip_smoke.py --phase 31`` (or ``32``-``35``): the CUDA
    builds and that phase alone, gated as in the whole run; no summary and
    no result line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import importlib
    import torch.distributed as dist
    from chainermn_tpu_torch import init_distributed
    for f in start_cuda_builds().values():
        f.result()
    init_distributed()
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    t0 = time.perf_counter()
    if n == "31":
        res = phase_obs(cs, fa, torch, torch.device("cuda", 0))
        log_obs(res, gpu, time.perf_counter() - t0)
    elif n == "33":
        fn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")
        res = phase_elastic(fn, cs, torch, torch.device("cuda", 0))
        log_elastic(res, gpu, time.perf_counter() - t0)
    elif n == "34":
        fn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")
        res = phase_lint(fn, cs, torch, torch.device("cuda", 0))
        log_lint(res, gpu, time.perf_counter() - t0)
    elif n == "35":
        fn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")
        res = phase_queue_a(fn, cs, fa, torch, torch.device("cuda", 0))
        log_queue_a(res, gpu, time.perf_counter() - t0)
    else:
        res = phase_obs2(cs, fa, torch)
        log_obs2(res, gpu, time.perf_counter() - t0)
    dist.destroy_process_group()
    return 1 if not all(res["gates"].values()) else 0


if __name__ == "__main__":
    sys.exit(phase_alone(sys.argv[2]) if sys.argv[1:2] == ["--phase"]
             and sys.argv[2:] in (["31"], ["32"], ["33"], ["34"], ["35"])
             else main())
