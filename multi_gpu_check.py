"""The data-, sequence- and model-parallel slices on every card of one host.

    python3 multi_gpu_check.py [--logs DIR]
        [--parts dp,sp,mp,configs,fsdp,tp_ep,pp,compression,planner,obs,
                 elastic,lint,collectives]
    # needs two CUDA cards or more

1. prints the cards' names and power limits (``nvidia-smi``) and torch's
   versions;
2. runs ``tests/test_torch_nccl_gpu.py`` (marker ``gpu``): the object
   plane, the array collectives, ``non_cuda_aware``'s staging,
   ``split_axes``, the multi-node iterator, the checkpointer and ZeRO-1
   on NCCL worlds of one card and of every card;
3. times ``examples.train_imagenet`` under ``torchrun`` on every card,
   ZeRO-1, plain, ZeRO-1, plain (ResNet-50, batch 32 a card, bfloat16,
   the bfloat16 wire, synthetic data, 30 iterations of which the first 5
   are left out): each run's images/sec over all cards and rank 0's peak
   device memory;
4. drives ``--zero --checkpoint`` with two epoch ends inside the run
   (``Snapshot``, ``AllreducePersistent`` and the evaluator on the NCCL
   world): 12 iterations straight, then 6 and a resume to 12 in another
   directory.  The resumed run's parameters, buffers and every rank's
   optimizer shards must equal the straight run's bit for bit (cuDNN
   deterministic, benchmark off);
5. (part ``sp``) ``examples.train_lm`` at the LM's width (vocab 32768,
   d_model 2048, 8 layers, 16 heads, batch 1, float32, TF32 off, seed 0,
   ``SP_STEPS`` Adam steps) at T 8192: ``--attention flash`` on one card,
   then ``ring_flash``, ``ring`` and ``ulysses`` under ``torchrun`` on
   every card (T/P tokens a card): each run's losses within 1e-4 relative
   of the one-card run's, and rank 0's gradients of step 0 (summed over
   the ranks) within a relative L2 error of 1e-3 of its gradients; then
   ``ring_flash`` at T 32768 (8192 tokens a card on four); each run's
   tokens/sec of the whole sequence (over every step, and over the steps
   after the first) and every card's peak memory; then
   ``benchmarks.bench_ring_attention`` on every card at T 8192 and 16384;
6. (part ``mp``) ``tests/test_torch_p2p_gpu.py`` (marker ``gpu``):
   ``cross_send``/``cross_recv`` and the chain list on NCCL worlds of one,
   two and four cards (the four-card world skips with fewer cards, and the
   output says so); then ``examples.seq2seq`` (float32, TF32 off) at its
   defaults and at phase 21's wide configuration
   (``chip_smoke.S2S_WIDE``), on one card and under ``torchrun`` on two
   (encoder on rank 0, decoder on rank 1): rank 1's losses within 1e-5 relative of the one-card run's (a
   transfer copies bits: expect equality), ``final:`` and ``val_bleu``
   printed by rank 1 only; each run's tokens/sec (over the steps after the
   first) and every card's peak memory;
7. (part ``configs``, not in the default) ``benchmarks.run_configs``'s
   multi-rank configs under ``torchrun``: ``seq2seq_mp`` on two cards and
   ``resnet50_hier`` on four (``intra_size`` 2: two "nodes" of two), each
   row with finite values, every rank's the same final loss; then
   ``run_configs --tune-remat --repeats 1`` on four cards (``resnet50_xla``
   and ``resnet50_hier`` under each remat policy: finite rows, the same
   final losses on every rank, "block" below "none" in peak memory) and
   ``examples.train_parallel_conv`` at its defaults on four cards, its
   loss falling, the same on every rank.  With fewer cards than a run
   needs, the output says it did not run.

8. (part ``fsdp``, not in the default) FSDP on every card under
   ``torchrun``, float32 with TF32 off and cuDNN deterministic:
   ``examples.train_imagenet --fsdp`` (ResNet-50, batch 32 a card, momentum
   SGD, 3 steps) at one bucket and at four (prefetch 1) against the plain
   data-parallel run, the four-bucket run bit-equal to the one-bucket
   run, and
   ``examples.train_lm --fsdp --attention ring_flash`` at the LM's width
   (T 8192) against ``ring_flash`` without it: every step's loss within
   1e-5 relative and rank 0's parameters within 2e-5 (``allclose``, rtol
   and atol; the LM's key bias, whose gradient is float noise that Adam
   scales to +-lr, within 2 x steps x lr); every rank's peak memory and, for the LM, its allocation
   after the last step (the persistent state: FSDP about a quarter of
   plain's), FSDP against plain; then
   ``benchmarks.bench_fsdp_overlap`` at K 1, 2, 4, 8 and prefetch 0, 1, 2
   at the LM's width (2048, 8 layers), its rows, their counters and the
   same final loss in every row.

9. (part ``tp_ep``, not in the default) tensor and expert parallelism on
   every card: ``tests/test_torch_tp_ep_gpu.py`` (its NCCL world of every
   card); the MoE LM (``examples.train_moe_lm``'s model and
   ``train_step`` with the flash attention, 8 experts, top 2, Adam at
   1e-3) in float32 (TF32 off) at the LM's width, 2 layers, T 2048, 4
   sequences, over 1, 2 and 4 ranks, each rank's capacity its token count
   (no choice dropped; under JAX's default capacity each rank's tokens
   compete for its own slots, so worlds would differ) and one card's
   routing replayed: each run's overflow 0, its losses within 1e-5
   relative of one card's, its step-0 gradients (the experts gathered
   from their owners) within a relative L2 error of 1e-3, and after the
   steps every parameter within 2 x steps x lr (Adam's reach on float
   noise), the elements past 2e-5 counted; then
   in bf16 at 8 layers, T 8192, a sequence a card over every card: its
   tokens/s per card and peak memory; then serving phase 24's LM
   (``chip_smoke.P24_FLAGS``) at ``tp_size`` 2 and 4, the MoE LM at
   ``ep_size`` 2 and 4 and phase 24's spec burst at ``tp_size`` 2, each
   against one card: a burst of the seeded trace, every request's tokens
   equal up to a difference where one card's top-two gap is within phase
   24's limit, the worst top-8 logit gap and the share of bit-equal rows;
   the generated tokens/s per card of the burst, and for the dense LM
   ``bench_serving``'s continuous policy at ``--tp``.

10. (part ``pp``, not in the default) pipeline parallelism, one stage a
    card: the LM's width in bf16 with ``PP_BLOCKS`` blocks a stage
    (chip_smoke phase 28's setup: embeddings before the pipeline, the loss
    through the frozen norm and head), 1F1B at M 8, 16 and 32 and GPipe at
    M 8 and 16 micro-batches of one 8192-token sequence (``PP_MS``), for
    ``PP_STEPS`` steps: the losses
    (the same on every rank), tokens/s per card over the steps after the
    first, every card's peak memory, and step 0's loss against one card's
    sequential pass over the whole model; then float32 (TF32 off, T 2048,
    M 4): 1F1B's and GPipe's loss and every stage's gradients against one
    card's sequential pass (``utils/compare.py``'s gates).
11. (part ``compression``, not in the default) int8 and fp8
    ``allreduce_grad`` (deterministic, 3 EF steps, ``COMP_N`` elements a
    rank) on the cards' NCCL world bit for bit equal to the same world of
    gloo CPU processes; ``examples.train_mnist --compression int8`` on
    every card against uncompressed (JAX's contract: the loss falls, the
    final within 0.1 x the uncompressed first; every rank the same log);
    the LM (bf16, flash) under FSDP with int8 buckets at K 1 and 4
    against the float32 and bfloat16 wires: the reduce-scatter bytes a
    step (int8 at least 3.5x fewer than float32) and the losses.
12. (part ``planner``, not in the default) the collective planner on every
    card at ``--intra-size`` 2 (topology ``inter:2,intra:2`` on four: the
    "inter-node" hop is NVLink too on one host): ``bench_allreduce
    --sweep`` on NCCL (``PLANNER_SIZES_KB``), the table
    ``autotune_from_rows`` builds from the measured rows printed by bucket
    with each plan's us against the best fixed flavor's; then every
    candidate plan's mean against the flat plan's (within the rounding of
    the plan's coarsest wire; quantized plans within 1e-2 on rank-valued
    buffers, as the sweep checks), the seven flavors (and xla with the
    bf16 wire) bit-equal to ``execute_plan`` of their plans, the MoE
    exchange with every all-to-all plan bit-equal to ``plan=None``, the
    weight multicast plans giving rank 0's weights exactly; then
    ``train_imagenet`` (ResNet-50, bf16, 3 steps, cuDNN deterministic)
    through ``auto`` with the swept table, its losses and parameters
    bit-equal to the run of the plan the table picked for the gradient
    bucket (its flavor run directly, or the same plan through a table of
    that one entry when no flavor is that plan).
13. (part ``obs``, not in the default) the socket control plane and
    observability on every card: ``examples.train_mnist`` (one epoch at
    the example's width, xla + the float16 wire + double buffering,
    ``--observability``, so ``MetricsReport``'s straggler report is an
    ``allgather_obj``) through ``train_mnist.train`` on a communicator
    on ``get_control_plane()`` (a socket world at MASTER_PORT + 1 on the
    native transport) and on the default gloo object plane: every
    rank's ``comm_collective_calls`` equal, the object ops (bcast, gather,
    scatter, allgather, allreduce, a split's allgather) giving on the
    socket plane what they give on gloo, each rank's parameters bit-equal
    between the two runs, rank 0's straggler report over every rank.
    Then, on the socket plane (native): a ``contention/v1`` report of one
    FSDP step with a hierarchical all-to-all plan's hops in its window
    (``consistency_ok``, every rank merged by its clock offset), a
    ``fleet_telemetry/v1`` document gathered on the telemetry tag with
    the last rank's steps five times longer (flagged the straggler), and
    an online tuner armed on rank 0 only swapping on every rank at step
    11 (one table hash, pin and 8 MiB plan).  Last, the hang: every rank
    on an instrumented ``non_cuda_aware`` communicator (a host-staged,
    blocking all-reduce) with the watchdog on the socket plane, the last
    rank skipping one ``allreduce_grad``; every rank must dump, rank 0's
    dump name the last rank (``desynced_ranks``), and once the harness
    has ended the world the cards hold no process.
14. (part ``elastic``, not in the default) the elastic runtime on every
    card: the LM at the width of part ``fsdp`` (vocab 32768, d_model
    2048, 16 heads; ``ELASTIC`` cuts the depth to 2 layers, T 2048, a
    sequence a card) under FSDP (K 2 buckets, Adam, float32, TF32 off)
    through the flash kernels, on every card under the elastic
    supervisor, saving every step through the ``async`` backend; the last
    rank SIGKILLs itself after step ``kill_step`` (its earlier snapshots
    drained first, so a generation of every rank exists); the survivors'
    watchdogs dump (heartbeat loss on the socket plane), the supervisor
    harvests the dumps into a restart manifest, frees the cards and
    relaunches at half the world, which resumes through
    ``resume_resized``: the resumed state, consolidated, equals the saved
    generation's parameters and Adam moments bit for bit; its next step
    equals, bit for bit, the step of a half world started directly from
    the consolidated state (its shards and moments cut by hand); the cards
    hold no process afterwards; the seconds to restart and to resume and
    the resharded bytes are printed.  Then ``tools.attribution_smoke`` on
    every card.
15. (part ``lint``, not in the default) static analysis on every card:
    under ``torchrun`` each of the seven flavors' ``allreduce_grad``
    (``hierarchical`` and ``two_dimensional`` at intra 2, so both levels
    hold two cards) recorded over the real NCCL groups
    (``analysis.allreduce_schedule``) equals ``issued_census_kinds`` of
    its plan on the communicator's topology in JAX's census kinds, on
    every rank, and ``census-drift`` finds nothing; the xla flavor's
    float16 wire records a float16 all-reduce.  Then
    ``tools.check_db_overlap`` judged on every card (two NCCL all-reduce
    kernels a step, the pending one overlapping the next forward), and
    ``tools.contention_smoke --n-procs 2 --device cuda`` (its check 4 is
    ``lint_step``'s ``overlapping-collectives``).
16. (part ``collectives``, not in the default) the five NCCL collectives
    at the LM's wire size (``COLL_ELEMS``: the 553,897,984 gradients of
    phase 11's LM in bf16, 1.108 GB a rank) on worlds of 2 cards and of
    every card: all-reduce, reduce-scatter, all-gather, all-to-all and
    broadcast, ``COLL_WARMUP`` calls then ``COLL_ITERS`` timed, each after
    a barrier and a device sync so that no rank's wait for a late rank
    counts as transfer.  Each call's time is the slowest rank's CUDA-event
    interval; the host clock's arrival skew (the spread of the ranks'
    issue times) is measured beside it.  Printed per collective and world:
    median and least ms, algorithm bandwidth (bytes over time) and bus
    bandwidth (NCCL's factors: all-reduce 2(n-1)/n, reduce-scatter,
    all-gather and all-to-all (n-1)/n, broadcast 1), and the skew's median
    and largest.  The result must match its plain reference (every rank's
    values are small integers, so each sum is exact).  ``nvidia-smi
    nvlink -s`` (the links' rates) is written to the logs.

Prints one JSON object as its last line; exits 1 if a check failed.  Runs
write under ``build/`` (removed afterwards), their logs under ``--logs``
(default ``build/multi_gpu_logs/``).
"""

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

from chip_smoke import S2S_WIDE

HERE = os.path.dirname(os.path.abspath(__file__))
TIMED = ["--arch", "resnet50", "--communicator", "xla",
         "--allreduce-grad-dtype", "bfloat16", "--batchsize", "32",
         "--dtype", "bfloat16", "--iterations", "30", "--warmup-steps", "5",
         "--train-size", "4096", "--val-size", "0", "--log-interval", "30",
         "--seed", "0"]
SP_BENCH = ["--seq-lens", "8192,16384", "--json"]
# 12 iterations, epochs of 5, snapshots every 6
RESUME = ["--arch", "resnet50", "--communicator", "xla", "--zero",
          "--allreduce-grad-dtype", "bfloat16", "--optimizer", "momentum",
          "--warmup-epochs", "0.5", "--batchsize", "32",
          "--dtype", "bfloat16", "--seed", "0", "--epoch", "3",
          "--val-size", "256", "--checkpoint-freq", "6",
          "--log-interval", "12", "--warmup-steps", "3"]

FSDP_IMAGENET = ["--arch", "resnet50", "--communicator", "xla",
                 "--optimizer", "momentum", "--batchsize", "32", "--dtype",
                 "float32", "--iterations", "3", "--val-size", "0",
                 "--seed", "0", "--warmup-steps", "1", "--log-interval",
                 "100"]
FSDP_BENCH = ["--buckets", "1,2,4,8", "--prefetch", "0,1,2", "--width",
              "2048", "--layers", "8", "--json"]
FSDP_RTOL, FSDP_PARAM_TOL = 1e-5, 2e-5

SP_STEPS = 3
SP = ["--batchsize", "1", "--steps", str(SP_STEPS), "--vocab", "32768",
      "--d-model", "2048", "--layers", "8", "--heads", "16", "--lr", "1e-3",
      "--seed", "0"]


def _digest(res) -> str:
    """sha256 of this rank's parameters, buffers and optimizer state."""
    import torch
    h = hashlib.sha256()
    tensors = sorted(res["model"].state_dict().items())
    state = res["optimizer"].local_optimizer.state_dict()["state"]
    tensors += [(f"opt/{i}/{k}", v) for i, st in sorted(state.items())
                for k, v in sorted(st.items()) if isinstance(v, torch.Tensor)]
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().reshape(-1).contiguous().cpu()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def worker(out_prefix, flags):
    """One rank under ``torchrun``: ``train_imagenet.main(flags)``, then
    ``{out_prefix}.rank{r}.json``."""
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.examples import train_imagenet
    res = train_imagenet.main(flags)
    rank = int(os.environ["RANK"])
    doc = {k: res[k] for k in ("losses", "images_per_sec", "iterations",
                               "world", "resumed_from", "peak_memory_gb",
                               "save_seconds")}
    doc["digest"] = _digest(res)
    doc["epochs"] = len(res["log"])
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump(doc, f)


def lm_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``train_lm.main(flags)`` in float32
    with TF32 off, then ``{out_prefix}.rank{r}.json``; rank 0 also saves
    its gradients of step 0 (summed over the ranks) to
    ``{out_prefix}.grads.pt``."""
    import torch
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.examples import train_lm
    from chainermn_tpu_torch.utils.compare import no_tf32
    rank = int(os.environ["RANK"])

    def keep(i, model):
        if i == 0 and rank == 0:
            torch.save({k: p.grad.detach().cpu()
                        for k, p in model.named_parameters()},
                       f"{out_prefix}.grads.pt")

    with no_tf32():
        res = train_lm.main(flags, on_grads=keep)
    doc = {k: res[k] for k in ("losses", "tokens_per_sec", "world",
                               "peak_memory_gb", "seconds", "step_seconds")}
    # tokens/sec after the first step, which pays the first calls' costs
    # (the kernels' build among them)
    args = train_lm.parse_args(flags)
    steady = res["step_seconds"][1:]
    doc["steady_tokens_per_sec"] = (args.batchsize * args.seq_len
                                    * len(steady) / sum(steady))
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump(doc, f)


def bench_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``bench_ring_attention.main(flags)``,
    its rows in ``{out_prefix}.rank{r}.json``."""
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.benchmarks import bench_ring_attention
    rows = bench_ring_attention.main(flags)
    with open(f"{out_prefix}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(rows, f)


def s2s_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``seq2seq.main(flags)`` in float32 with
    TF32 off (cuBLAS and cuDNN), its standard output captured, then
    ``{out_prefix}.rank{r}.json``."""
    import contextlib
    import io
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.examples import seq2seq
    from chainermn_tpu_torch.utils.compare import no_tf32
    buf = io.StringIO()
    with no_tf32(), contextlib.redirect_stdout(buf):
        res = seq2seq.main(flags)
    doc = {k: res[k] for k in ("losses", "final", "steady_tokens_per_sec",
                               "tokens_per_sec", "peak_memory_gb", "world",
                               "owns_output")}
    doc["stdout"] = buf.getvalue()
    with open(f"{out_prefix}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(doc, f)


def configs_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``run_configs.main(flags)``, its rows
    in ``{out_prefix}.rank{r}.json``."""
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.benchmarks import run_configs
    rows = run_configs.main(flags)
    with open(f"{out_prefix}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(rows, f)


def pconv_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``train_parallel_conv.main(flags)``,
    its losses in ``{out_prefix}.rank{r}.json``."""
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.examples import train_parallel_conv
    res = train_parallel_conv.main(flags)
    with open(f"{out_prefix}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump({"losses": res["losses"], "world": res["world"]}, f)


def fsdp_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``flags[0]`` names the example
    (``train_imagenet`` or ``train_lm``), run on ``flags[1:]`` in float32
    with TF32 off and cuDNN deterministic; ``{out_prefix}.rank{r}.json``,
    and rank 0's trained parameters in ``{out_prefix}.params.pt``."""
    import importlib
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.utils.compare import no_tf32
    example = importlib.import_module(
        f"chainermn_tpu_torch.examples.{flags[0]}")
    rank = int(os.environ["RANK"])
    with no_tf32():
        res = example.main(flags[1:])
    doc = {k: res.get(k) for k in ("losses", "peak_memory_gb",
                                   "state_memory_gb", "images_per_sec",
                                   "tokens_per_sec", "step_seconds")}
    if rank == 0:
        torch.save({k: v.detach().cpu()
                    for k, v in res["model"].named_parameters()},
                   f"{out_prefix}.params.pt")
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump(doc, f)


def fsdp_bench_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``bench_fsdp_overlap.main(flags)``,
    its rows in ``{out_prefix}.rank{r}.json``."""
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.benchmarks import bench_fsdp_overlap
    rows = bench_fsdp_overlap.main(flags)
    with open(f"{out_prefix}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(rows, f)


WORKERS = {"imagenet": worker, "lm": lm_worker, "bench": bench_worker,
           "s2s": s2s_worker, "configs": configs_worker,
           "pconv": pconv_worker, "fsdp": fsdp_worker,
           "fsdp_bench": fsdp_bench_worker}


def _late_workers():
    """The workers defined after ``WORKERS`` (parts pp, compression and
    planner)."""
    WORKERS.update(pp=pp_worker, comp=comp_worker, mnist=mnist_worker,
                   comp_fsdp=comp_fsdp_worker, sweep=sweep_worker,
                   planner=planner_worker, obs=obs_worker,
                   obs2=obs2_worker, desync=desync_worker,
                   lint=lint_worker, coll=coll_worker)


def torchrun(n, name, flags, work, logs, kind="imagenet"):
    """``n`` ranks of the ``kind`` worker of ``WORKERS``; every rank's
    document, by rank; the ranks' output in ``{logs}/{name}.log``."""
    prefix = os.path.join(work, name)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__), "--worker",
           kind, prefix] + flags
    path = os.path.join(logs, f"{name}.log")
    with open(path, "w") as log:
        rc = subprocess.run(cmd, cwd=HERE, stdout=log,
                            stderr=subprocess.STDOUT, timeout=600).returncode
    if rc:
        raise RuntimeError(f"{name}: torchrun exited {rc} (log: {path})")
    return [json.load(open(f"{prefix}.rank{r}.json")) for r in range(n)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--logs", default=os.path.join(HERE, "build",
                                                  "multi_gpu_logs"),
                   help="directory for the tests' and the runs' output")
    p.add_argument("--parts", default="dp,sp,mp",
                   help="which slices to run: dp (steps 2-4), sp (step 5), "
                   "mp (step 6), configs (step 7), fsdp (step 8), tp_ep "
                   "(step 9), pp (step 10), compression (step 11), planner "
                   "(step 12), obs (step 13), elastic (step 14), lint "
                   "(step 15), collectives (step 16)")
    args = p.parse_args(argv)
    logs = os.path.abspath(args.logs)
    parts = set(args.parts.split(","))
    known = {"dp", "sp", "mp", "configs", "fsdp", "tp_ep", "pp",
             "compression", "planner", "obs", "elastic", "lint",
             "collectives"}
    if not parts or parts - known:
        p.error(f"--parts: {args.parts!r} is not a subset of "
                f"{','.join(sorted(known))}")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("multi_gpu_check.py needs two CUDA cards or more",
              file=sys.stderr)
        return 2
    n = torch.cuda.device_count()
    os.makedirs(logs, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print("\n".join(smi))
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, n,
          flush=True)
    out = {"cards": n, "card": sorted(set(smi)), "ok": False}
    failures = []
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="multi_gpu_check_",
                            dir=os.path.join(HERE, "build"))
    try:
        if "dp" in parts:
            data_parallel(n, out, failures, work, logs)
        if "sp" in parts:
            sequence_parallel(n, out, failures, work, logs)
        if "mp" in parts:
            model_parallel(n, out, failures, work, logs)
        if "configs" in parts:
            configs(n, out, failures, work, logs)
        if "fsdp" in parts:
            fsdp(n, out, failures, work, logs)
        if "tp_ep" in parts:
            tp_ep(n, out, failures, work, logs)
        if "pp" in parts:
            pipeline(n, out, failures, work, logs)
        if "compression" in parts:
            compression(n, out, failures, work, logs)
        if "planner" in parts:
            planner(n, out, failures, work, logs)
        if "obs" in parts:
            observability(n, out, failures, work, logs)
        if "elastic" in parts:
            elastic(n, out, failures, work, logs)
        if "lint" in parts:
            static_analysis(n, out, failures, work, logs)
        if "collectives" in parts:
            collectives(n, out, failures, work, logs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["failures"] = failures
    out["ok"] = not failures
    print(json.dumps(out))
    return 0 if out["ok"] else 1


def gpu_tests(path, logs, name):
    """``pytest -m gpu path`` on the card: ``(rc, summary line)``, the
    output in ``{logs}/{name}.log``."""
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-m", "gpu", "-q", "-rs", path], cwd=HERE,
        capture_output=True, text=True, timeout=900)
    with open(os.path.join(logs, f"{name}.log"), "w") as f:
        f.write(tests.stdout + tests.stderr)
    lines = tests.stdout.strip().splitlines()
    summary = (lines or [""])[-1]
    print(f"{path}: rc {tests.returncode}; {summary}", flush=True)
    return tests.returncode, summary, [l for l in lines
                                       if l.startswith("SKIPPED")]


def configs(n, out, failures, work, logs):
    """Step 7 (see the module docstring)."""
    out["configs"] = {}
    for config, ranks in (("seq2seq_mp", 2), ("resnet50_hier", 4)):
        if n < ranks:
            out["configs"][config] = f"not run: needs {ranks} cards"
            continue
        docs = torchrun(ranks, f"configs_{config}", ["--configs", config],
                        work, logs, kind="configs")
        row = docs[0][0]
        out["configs"][config] = row
        print(json.dumps(row), flush=True)
        losses = {d[0]["final_loss"] for d in docs}
        if not (row["config"] == config and row["devices"] == ranks
                and math.isfinite(row["value"]) and row["value"] > 0
                and row.get("device_ms_per_step", 0) > 0 and len(losses) == 1
                and all(map(math.isfinite, losses))):
            failures.append(f"configs {config}: {row} (final losses by "
                            f"rank {losses})")
    if n < 4:
        out["configs"]["train_parallel_conv"] = "not run: needs 4 cards"
        out["configs"]["tune_remat"] = "not run: needs 4 cards"
        return
    docs = torchrun(4, "tune_remat", ["--tune-remat", "--repeats", "1"],
                    work, logs, kind="configs")
    sweeps = docs[0]["configs"]
    out["configs"]["tune_remat"] = sweeps
    print(json.dumps(sweeps), flush=True)
    for config in ("resnet50_xla", "resnet50_hier"):
        rows = sweeps.get(config, {}).get("rows", {})
        same = all(d["configs"][config]["rows"][p]["final_loss"]
                   == rows[p]["final_loss"] for d in docs for p in rows)
        if not (list(rows) == ["none", "block", "norm"] and same
                and all(math.isfinite(r["final_loss"])
                        and r["peak_memory_gb"] > 0 for r in rows.values())
                and rows["block"]["peak_memory_gb"]
                < rows["none"]["peak_memory_gb"]):
            failures.append(f"tune-remat {config} on 4 cards: {rows} (the "
                            f"same final losses on every rank: {same})")
    docs = torchrun(4, "parallel_conv", [], work, logs, kind="pconv")
    losses = docs[0]["losses"]
    out["configs"]["train_parallel_conv"] = {
        "world": docs[0]["world"], "first": losses[0], "last": losses[-1]}
    if not (losses[-1] < losses[0] and all(d["losses"] == losses
                                           for d in docs)):
        failures.append(f"train_parallel_conv: losses {losses[0]} -> "
                        f"{losses[-1]}, the same on every rank: "
                        f"{all(d['losses'] == losses for d in docs)}")


def model_parallel(n, out, failures, work, logs):
    """Step 6 (see the module docstring)."""
    rc, summary, skipped = gpu_tests("tests/test_torch_p2p_gpu.py", logs,
                                     "p2p_gpu_tests")
    out["mp"] = {"p2p_tests": {"rc": rc, "summary": summary,
                               "not_run": skipped}}
    if rc:
        failures.append("tests/test_torch_p2p_gpu.py")
    for name, flags in (("defaults", []), ("wide", S2S_WIDE)):
        one = torchrun(1, f"s2s_{name}_1card", flags, work, logs,
                       kind="s2s")[0]
        two = torchrun(2, f"s2s_{name}_2card", flags, work, logs,
                       kind="s2s")
        got, want = two[1]["losses"], one["losses"]
        rel = max((abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(got, want)), default=float("inf"))
        row = {"losses_rel": rel, "bit_equal": got == want,
               "steps": len(got), "final_rank1": two[1]["final"],
               "final_1card": one["final"],
               "tokens_per_sec_2card": two[1]["steady_tokens_per_sec"],
               "tokens_per_sec_1card": one["steady_tokens_per_sec"],
               "peak_memory_gb_2card": [d["peak_memory_gb"] for d in two],
               "peak_memory_gb_1card": one["peak_memory_gb"],
               "owners_of_output": [d["owns_output"] for d in two]}
        out["mp"][name] = row
        print(json.dumps({f"s2s {name}": row}), flush=True)
        printed = ["final:" in d["stdout"] and "val_bleu" in d["stdout"]
                   for d in two]
        if len(got) != len(want) or rel > 1e-5 or printed != [False, True] \
                or not all(map(math.isfinite, got)):
            failures.append(f"mp seq2seq {name}: losses rel {rel:.2e}, "
                            f"final/val_bleu printed by rank {printed}")


def _key_bias_apart(got, want, failures):
    """The LM's key bias adds q.b to every score of a row, which softmax
    ignores: its gradient is 0 up to float noise, which Adam scales to
    +-lr a step (ROADMAP.md Queue C7).  Hold that slice of each
    ``qkv.bias`` to 2 x steps x lr apart, then take it out of the
    comparison (``want``'s values in ``got``)."""
    d = int(SP[SP.index("--d-model") + 1])
    reach = 2 * SP_STEPS * float(SP[SP.index("--lr") + 1]) * 1.001
    for k in want:
        if k.endswith("qkv.bias"):
            gap = float((got[k][d:2 * d] - want[k][d:2 * d]).abs().max())
            if gap > reach:
                failures.append(f"fsdp lm: {k}'s key slice {gap:.3g} apart")
            got[k][d:2 * d] = want[k][d:2 * d]


def fsdp(n, out, failures, work, logs):
    """Step 8 (see the module docstring)."""
    import torch
    out["fsdp"] = {}
    lm = ["train_lm", "--attention", "ring_flash", "--seq-len", "8192"] + SP
    imagenet = ["train_imagenet", "--train-size", str(32 * n * 8)] \
        + FSDP_IMAGENET
    # the bucketed window (K 4, prefetch 1) on ResNet-50 beside K 1
    kinds = {"imagenet": {"plain": [], "fsdp": ["--fsdp"],
                          "fsdp_k4": ["--fsdp", "--fsdp-buckets", "4"]},
             "lm": {"plain": [], "fsdp": ["--fsdp"]}}
    for name, flags in (("imagenet", imagenet), ("lm", lm)):
        docs = {}
        params = {}
        for kind, extra in kinds[name].items():
            run = f"fsdp_{name}_{kind}"
            docs[kind] = torchrun(n, run, flags + extra, work, logs,
                                  kind="fsdp")
            path = os.path.join(work, f"{run}.params.pt")
            params[kind] = torch.load(path)
            os.remove(path)
        want, want_p = docs["plain"][0]["losses"], params["plain"]
        if name == "lm":
            for kind in kinds[name]:
                if kind != "plain":
                    _key_bias_apart(params[kind], want_p, failures)
        row = {"plain_losses": want}
        for kind in kinds[name]:
            if kind == "plain":
                continue
            got, got_p = docs[kind][0]["losses"], params[kind]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            far = sorted(k for k in want_p if not torch.allclose(
                got_p[k], want_p[k], rtol=FSDP_PARAM_TOL,
                atol=FSDP_PARAM_TOL))
            worst = max(float((got_p[k] - want_p[k]).abs().max())
                        for k in want_p)
            row[kind] = {"losses": got, "loss_rel": loss_rel,
                         "param_worst_abs": worst,
                         "params_outside": far[:8]}
            if loss_rel > FSDP_RTOL or far or len(got) != len(want):
                failures.append(
                    f"fsdp {name} {kind}: loss rel {loss_rel:.2e}, "
                    f"{len(far)} parameters outside {FSDP_PARAM_TOL}")
        if "fsdp_k4" in docs:
            k1_p, k4_p = params["fsdp"], params["fsdp_k4"]
            same = (docs["fsdp_k4"][0]["losses"] == docs["fsdp"][0]["losses"]
                    and all(torch.equal(k4_p[k], k1_p[k]) for k in k1_p))
            row["k4_bit_equal_k1"] = same
            if not same:
                failures.append(f"fsdp {name}: K 4 not bit-equal to K 1")
        row["peak_memory_gb"] = {k: [d["peak_memory_gb"] for d in v]
                                 for k, v in docs.items()}
        row["rate"] = {k: v[0]["images_per_sec" if name == "imagenet"
                               else "tokens_per_sec"]
                       for k, v in docs.items()}
        if name == "lm":
            row["state_memory_gb"] = {k: [d["state_memory_gb"] for d in v]
                                      for k, v in docs.items()}
            row["step_seconds"] = {k: v[0]["step_seconds"]
                                   for k, v in docs.items()}
        out["fsdp"][name] = row
        print(json.dumps({f"fsdp {name}": row}), flush=True)
    rows = torchrun(n, "fsdp_bench", FSDP_BENCH, work, logs,
                    kind="fsdp_bench")[0]
    out["fsdp"]["bench_fsdp_overlap"] = rows
    for r in rows:
        print(json.dumps(r), flush=True)
    if not all(r["schedule_ok"] for r in rows):
        failures.append("fsdp bench counters")
    # every (K, D) sums each element in the same order: the same loss
    finals = {r["final_loss"] for r in rows}
    if len(finals) != 1:
        failures.append(f"fsdp bench: final losses differ across (K, D): "
                        f"{sorted(finals)}")


def sequence_parallel(n, out, failures, work, logs):
    """Step 5 (see the module docstring)."""
    import torch
    from chainermn_tpu_torch.utils.compare import step_agrees, step_errors
    ref = torchrun(1, "sp_flash", ["--attention", "flash", "--seq-len",
                                   "8192"] + SP, work, logs, kind="lm")[0]
    want_grads = torch.load(os.path.join(work, "sp_flash.grads.pt"))
    out["sp"] = {"flash_1card": ref}
    print(json.dumps({"flash_1card": ref}), flush=True)
    for att in ("ring_flash", "ring", "ulysses"):
        docs = torchrun(n, f"sp_{att}", ["--attention", att, "--seq-len",
                                         "8192"] + SP, work, logs,
                        kind="lm")
        d = docs[0]
        path = os.path.join(work, f"sp_{att}.grads.pt")
        loss_rel, grad_rel, worst = step_errors(
            d["losses"], ref["losses"], torch.load(path), want_grads)
        os.remove(path)
        row = {"losses": d["losses"], "loss_rel": loss_rel,
               "grad_rel": grad_rel, "grad_worst": worst,
               "tokens_per_sec": d["tokens_per_sec"],
               "steady_tokens_per_sec": d["steady_tokens_per_sec"],
               "step_seconds": d["step_seconds"], "world": d["world"],
               "peak_memory_gb": [x["peak_memory_gb"] for x in docs]}
        out["sp"][att] = row
        print(json.dumps({att: row}), flush=True)
        if not (d["world"] == n and step_agrees(loss_rel, grad_rel)):
            failures.append(f"sp {att}: loss rel {loss_rel:.2e}, gradient "
                            f"rel {grad_rel:.2e}")
    del want_grads
    docs = torchrun(n, "sp_ring_flash_32k", [
        "--attention", "ring_flash", "--seq-len", "32768"] + SP, work,
        logs, kind="lm")
    row = {"tokens_per_sec": docs[0]["tokens_per_sec"],
           "steady_tokens_per_sec": docs[0]["steady_tokens_per_sec"],
           "step_seconds": docs[0]["step_seconds"],
           "losses": docs[0]["losses"],
           "peak_memory_gb": [x["peak_memory_gb"] for x in docs]}
    out["sp"]["ring_flash_32k"] = row
    print(json.dumps({"ring_flash_32k": row}), flush=True)
    if not all(map(math.isfinite, row["losses"])):
        failures.append(f"sp ring_flash T 32768: losses {row['losses']}")
    rows = torchrun(n, "bench_ring", SP_BENCH, work, logs, kind="bench")[0]
    out["sp"]["bench_ring_attention"] = rows
    for r in rows:
        print(json.dumps(r), flush=True)


# part tp_ep: the MoE LM's examples flags (LM width); float32 at 2 layers,
# T 2048, 4 sequences over 1, 2 and 4 ranks; bf16 at 8 layers, T 8192, a
# sequence a card
TP_EP_MOE = ["--vocab", "32768", "--d-model", "2048", "--heads", "16",
             "--experts", "8", "--top-k", "2", "--lr", "1e-3",
             "--steps", str(SP_STEPS), "--seed", "0"]
TP_EP_F32 = ["--layers", "2", "--seq-len", "2048", "--batchsize", "4"]
TP_EP_BF16 = ["--layers", "8", "--seq-len", "8192"]
TP_EP_BURST = 16     # requests of phase 24's trace in the token gate's burst


def _routes(spec, rows=None):
    """``spec`` "-", "record:PATH" or "replay:PATH": a ``chip_smoke._Routes``
    and the context around the run: recording the MoE routing (saved to
    PATH by :func:`_save_routes`), or replaying PATH's decisions, ``rows``
    of each (this rank's tokens; all of them where every rank routes the
    same tokens)."""
    import contextlib
    import torch
    from chip_smoke import _Routes
    routes = _Routes()
    mode, _, path = spec.partition(":")
    if mode == "record":
        return routes, routes.record()
    if mode == "replay":
        routes.kept = [t if rows is None else t[rows]
                       for t in torch.load(path)]
        return routes, routes.replay()
    return routes, contextlib.nullcontext()


def _save_routes(spec, routes):
    import torch
    mode, _, path = spec.partition(":")
    if mode == "record":
        torch.save([t.cpu() for t in routes.kept], path)


def moe_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``flags[0]`` the dtype, ``flags[1]``
    the routing's record or replay (:func:`_routes`), the rest the MoE
    example's flags; the model built by ``train_moe_lm.build`` with the
    flash attention, the experts over every rank (in float32 at a capacity
    of the rank's tokens), ``train_step`` for the steps (TF32 off in
    float32).  ``{out_prefix}.rank{r}.json``: ``ce`` a
    step, overflow, step seconds, tokens/s per card, peak memory, the
    routing decisions that differed from the replayed ones; in float32
    also this rank's parameters after the steps and its gradients of step
    0, ``{out_prefix}.params.rank{r}.pt`` and ``.grads.rank{r}.pt``."""
    import contextlib
    import torch
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples import train_moe_lm as tm
    from chainermn_tpu_torch.runtime.bootstrap import init_distributed
    from chainermn_tpu_torch.utils.compare import no_tf32
    dtype, spec = getattr(torch, flags[0]), flags[1]
    args = tm.parser().parse_args(flags[2:])
    topo = init_distributed(device=args.device)
    comm = create_communicator("naive", device=args.device) \
        if topo.size > 1 else None
    rank, n = topo.rank, topo.size
    cuda = topo.device.type == "cuda"
    ctx = no_tf32() if dtype == torch.float32 else contextlib.nullcontext()
    per = args.batchsize // n
    with ctx:
        # float32: a capacity of every local token, so no choice drops and
        # every world computes one function (each rank's tokens compete
        # only for its own slots)
        model, opt = tm.build(args, comm, topo.device, attention_impl="flash",
                              dtype=dtype, capacity=per * args.seq_len
                              if dtype == torch.float32 else None)
        toks = tm.make_motif_task(args.batchsize, args.seq_len, args.vocab,
                                  seed=args.seed)
        mine = toks[rank * per:(rank + 1) * per].to(topo.device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        if dtype == torch.float32:
            # step 0's gradients as the update sees them: the replicated
            # parameters' summed over the ranks, each expert's on its owner
            update = opt.step

            def keep_then_step(*a, **k):
                opt.step = update
                torch.save({k_: p.grad.detach().cpu() for k_, p in
                            model.named_parameters()},
                           f"{out_prefix}.grads.rank{rank}.pt")
                return update(*a, **k)
            opt.step = keep_then_step
        ces, over, secs = [], [], []
        m = per * args.seq_len
        routes, rctx = _routes(spec, slice(rank * m, (rank + 1) * m))
        with rctx:
            for _ in range(args.steps):
                t0 = time.perf_counter()
                res = tm.train_step(model, opt, mine, args.aux_weight, comm)
                ces.append(float(res[1]))
                over.append(float(res[3]))
                secs.append(time.perf_counter() - t0)
        _save_routes(spec, routes)
    doc = {"ce": ces, "overflow": over, "step_seconds": secs, "world": n,
           "route_flips": routes.flips, "route_decisions": routes.decisions,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9
           if cuda else None,
           "tokens_per_sec_per_card": per * args.seq_len * (len(secs) - 1)
           / sum(secs[1:])}
    if dtype == torch.float32:
        torch.save({k: p.detach().cpu() for k, p in model.named_parameters()},
                   f"{out_prefix}.params.rank{rank}.pt")
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump(doc, f)


def serve_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``flags[0]`` the kind -- ``dense``
    (phase 24's LM at ``tp_size`` = the world), ``spec`` (the same with
    ``--spec-k``) or ``moe`` (the MoE LM at ``ep_size`` = the world) --,
    ``flags[1]`` the routing's record or replay (:func:`_routes`: every
    rank routes the same tokens), the rest ``bench_serving``'s flags.
    Rank 0 submits a burst of the seeded trace (``TP_EP_BURST``
    requests; spec: its decode-heavy burst), every
    rank steps in lockstep, rank 0 records each emitted token with its
    row's top-two gap, top logit, top 8 logits and the row's hash; then
    (dense) ``bench_serving.run_policy("continuous")`` with ``--tp`` for
    the rate.  ``{out_prefix}.rank{r}.json``, rank 0's with the records."""
    import torch
    sys.path.insert(0, HERE)
    from chip_smoke import P27_MOE
    from chainermn_tpu_torch.benchmarks import bench_serving as bs
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import InferenceEngine
    kind, routing = flags[0], flags[1]
    args = bs.parser().parse_args(flags[2:])
    n = int(os.environ["WORLD_SIZE"])
    comm = create_communicator("naive", device=args.device) \
        if n > 1 else None
    args.comm, args.tp = comm, n if kind != "moe" else 1
    if comm is not None:
        args.device = str(comm.device)
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if kind == "moe":   # the flags' LM with phase 27's experts
        model = TransformerLM(
            args.vocab, args.d_model, args.n_layers, args.n_heads,
            args.max_len, "xla", dtype=getattr(torch, args.dtype),
            device=dev, **P27_MOE,
            generator=torch.Generator(dev).manual_seed(args.seed))
    else:
        model = bs.build_model(args)
    if comm is not None:
        comm.bcast_data(model)
    spec = kind == "spec"
    eng = InferenceEngine(model, bs._config(
        args, tp_size=args.tp, ep_size=n if kind == "moe" else 1,
        keep_logits=True, spec_k=args.spec_k if spec else 0),
        comm=comm, draft_model=bs.truncated_draft(model) if spec else None)
    burst = ([(p, m) for p, m in bs.build_spec_trace(args)] if spec else
             [(p, m) for _, p, m in bs.build_trace(args)[:TP_EP_BURST]])
    lead = comm is None or comm.rank == 0
    if lead:
        for p, m in burst:
            eng.submit(p, m)
    rows = {}
    routes, rctx = _routes(routing)
    sync()
    t0 = time.perf_counter()
    with rctx:
        while not (comm.bcast_obj(eng.idle(), root=0) if comm
                   else eng.idle()):
            res = eng.step()
            if lead and res.last_logits is not None:
                _keep_rows(eng, res, rows)
    sync()
    wall = time.perf_counter() - t0
    _save_routes(routing, routes)
    doc = {"world": n, "route_flips": routes.flips,
           "route_decisions": routes.decisions}
    if lead:
        doc["tokens"] = {str(c.rid): c.tokens for c in eng.completions}
        doc["rows"] = {str(k): v for k, v in rows.items()}
        doc["burst_tokens_per_sec_per_card"] = sum(
            len(c.tokens) for c in eng.completions) / wall / n
        doc["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
            if dev.type == "cuda" else None
    del eng
    if kind == "dense":
        pol = bs.run_policy("continuous", model, bs.build_trace(args), args)
        if lead:
            doc["policy"] = {k: pol[k] for k in (
                "generated_tokens", "steps", "wall_s", "tokens_per_sec",
                "requests_per_sec", "ttft_s", "per_token_s", "mean_active")}
            doc["policy"]["peak_gb"] = pol.get("peak_gb")
            doc["policy"]["busy_share"] = (pol.get("busy") or {}).get(
                "busy_share")
            doc["policy"]["tokens_per_sec_per_card"] = \
                pol["tokens_per_sec"] / n
    rank = comm.rank if comm is not None else 0
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump(doc, f)


WORKERS.update(moe=moe_worker, serve=serve_worker)


def _keep_rows(eng, res, rows):
    """Each emitted token's record (token, its row's top-two gap, top
    logit, top 8 logits, the row's hash) under its request, in order; a
    token without a row of its own (past the first of a verify pass's)
    None."""
    import hashlib as _hl
    import torch
    from chip_smoke import _top2_gap
    slot = {s.rid: i for i, s in enumerate(eng.scheduler.slots)
            if s is not None}
    seen = set()
    for rid, tok, _ in res.emitted:
        if rid in seen or rid not in slot:
            rows.setdefault(rid, []).append(None)
            continue
        seen.add(rid)
        row = torch.from_numpy(res.last_logits[slot[rid]])
        rows.setdefault(rid, []).append(
            [int(tok), _top2_gap(row), float(row.max()),
             row.float().topk(8).values.tolist(),
             _hl.sha256(row.numpy().tobytes()).hexdigest()[:16]])


def _moe_params(work, name, n, what="params"):
    """A run's parameters (or gradients) whole: the replicated ones from
    rank 0, each expert stack the ranks' slices in rank order."""
    import torch
    files = [os.path.join(work, f"{name}.{what}.rank{r}.pt")
             for r in range(n)]
    parts = [torch.load(f) for f in files]
    for f in files:
        os.remove(f)
    stacks = ("up_kernel", "up_bias", "down_kernel", "down_bias")
    return {k: torch.cat([p[k] for p in parts]) if k.split(".")[-1] in stacks
            else v for k, v in parts[0].items()}


def _token_gate(got, want, failures, label):
    """Each request's tokens against ``want``'s up to the first
    difference, which may fall only where ``want``'s top-two gap is within
    phase 24's limit; the worst top-8 logit gap over the rows compared and
    the share of rows with the same bits."""
    from chip_smoke import _gap_limit
    equal, flips, worst, same, rows = 0, [], 0.0, 0, 0
    for rid, toks in want["tokens"].items():
        mine = got["tokens"][rid]
        wrows, grows = want["rows"].get(rid, []), got["rows"].get(rid, [])
        for j, (a, b) in enumerate(zip(mine, toks)):
            w = wrows[j] if j < len(wrows) else None
            g = grows[j] if j < len(grows) else None
            if w is not None and g is not None:
                rows += 1
                same += g[4] == w[4]
                worst = max(worst, max(abs(x - y)
                                       for x, y in zip(g[3], w[3])))
            if a != b:
                # a token without its own kept row (inside a verify pass)
                # has no known gap: reported, not gated
                flips.append(dict(rid=rid, at=j, gap=None if w is None
                                  else round(w[1], 4)))
                if w is not None and w[1] > _gap_limit(w[2]):
                    failures.append(f"{label}: request {rid} token {j} "
                                    f"differs at gap {w[1]:.3g}")
                break
            equal += 1
    return dict(equal_tokens=equal, flips=flips, worst_top8_gap=worst,
                rows_compared=rows, rows_same_bits=same)


def tp_ep(n, out, failures, work, logs):
    """Part tp_ep (see the module docstring)."""
    rc, summary, skipped = gpu_tests("tests/test_torch_tp_ep_gpu.py", logs,
                                     "gpu_tests_tp_ep")
    out["tp_ep_tests"] = {"rc": rc, "summary": summary}
    if rc or skipped:
        failures.append("tests/test_torch_tp_ep_gpu.py")
    out["tp_ep"] = {}
    tp_ep_train(n, out, failures, work, logs)
    tp_ep_serve(n, out, failures, work, logs)


def tp_ep_train(n, out, failures, work, logs):
    """The MoE LM over 1, 2 and 4 ranks in float32, one card's routing
    replayed into the others (a near-tie gate routes by the last bits of
    its sums, and cuBLAS sums another way at another row count: one
    token's expert moves its gradients wholesale): losses within phase
    26's 1e-5, step 0's gradients within phase 20's relative L2 1e-3, and
    after the Adam steps every parameter within 2 x steps x lr (Adam moves
    an element whose gradient is float noise by up to lr a step either
    way, ROADMAP.md Queue C7), the elements past phase 26's 2e-5 counted;
    then in bf16 over every card."""
    import torch
    from chainermn_tpu_torch.utils.compare import GRAD_RTOL, rel_l2
    reach = 2 * SP_STEPS * float(SP[SP.index("--lr") + 1]) * 1.001
    ways = [w for w in (1, 2, 4) if w <= n]
    row, ref = {}, None
    path = os.path.join(work, "routes_f32.pt")
    for w in ways:
        name = f"moe_f32_ep{w}"
        routing = f"record:{path}" if w == 1 else f"replay:{path}"
        docs = torchrun(w, name, ["float32", routing] + TP_EP_MOE
                        + TP_EP_F32, work, logs, kind="moe")
        params = _moe_params(work, name, w)
        grads = _moe_params(work, name, w, "grads")
        r = {"ce": docs[0]["ce"], "overflow": docs[0]["overflow"],
             "peak_memory_gb": [d["peak_memory_gb"] for d in docs],
             "step_seconds": docs[0]["step_seconds"],
             "route_flips": [d["route_flips"] for d in docs],
             "route_decisions": [d["route_decisions"] for d in docs]}
        if any(docs[0]["overflow"]):
            # each rank's tokens compete for its own capacity: runs over
            # other worlds compute one function only while nothing drops
            failures.append(f"tp_ep moe f32 ep {w}: overflow "
                            f"{docs[0]['overflow']}")
        if ref is None:
            ref = (docs[0]["ce"], params, grads)
        else:
            r["loss_rel"] = max(abs(a - b) / abs(b)
                                for a, b in zip(docs[0]["ce"], ref[0]))
            r["grad_rel"], r["grad_worst"] = max(
                (rel_l2(grads[k], g), k) for k, g in ref[2].items())
            gap = {k: (params[k] - ref[1][k]).abs() for k in ref[1]}
            r["param_worst_abs"] = max(float(v.max()) for v in gap.values())
            r["param_elements_past_2e-5"] = {
                k: int((v > FSDP_PARAM_TOL + FSDP_PARAM_TOL * ref[1][k]
                        .abs()).sum()) for k, v in gap.items()
                if (v > FSDP_PARAM_TOL + FSDP_PARAM_TOL * ref[1][k].abs())
                .any()}
            r["param_elements"] = sum(v.numel() for v in gap.values())
            if r["loss_rel"] > FSDP_RTOL or r["grad_rel"] > GRAD_RTOL \
                    or r["param_worst_abs"] > reach:
                failures.append(f"tp_ep moe f32 ep {w}: loss rel "
                                f"{r['loss_rel']:.2e}, gradients rel L2 "
                                f"{r['grad_rel']:.2e}, a parameter "
                                f"{r['param_worst_abs']:.2e} apart")
        row[f"ep{w}"] = r
        print(json.dumps({f"tp_ep moe f32 ep {w}": r}), flush=True)
    docs = torchrun(n, "moe_bf16", ["bfloat16", "-"] + TP_EP_MOE
                    + TP_EP_BF16 + ["--batchsize", str(n)], work, logs,
                    kind="moe")
    row["bf16_full_width"] = {
        "world": n, "ce": docs[0]["ce"],
        "tokens_per_sec_per_card": docs[0]["tokens_per_sec_per_card"],
        "peak_memory_gb": [d["peak_memory_gb"] for d in docs],
        "step_seconds": docs[0]["step_seconds"]}
    print(json.dumps({"tp_ep moe bf16": row["bf16_full_width"]}), flush=True)
    if not all(map(math.isfinite, docs[0]["ce"])):
        failures.append("tp_ep moe bf16: losses not finite")
    out["tp_ep"]["moe_train"] = row


def tp_ep_serve(n, out, failures, work, logs,
                kinds=("dense", "moe", "spec")):
    """Serving: phase 24's LM at tp 2 and 4, the MoE LM at ep 2 and 4 (one
    card's routing replayed, as in training), spec at tp 2, each against
    one card."""
    from chip_smoke import P24_FLAGS, P24_SPEC, P24_TRACE
    ways = [w for w in (1, 2, 4) if w <= n]
    path = os.path.join(work, "routes_serve.pt")
    for kind, extra, widths in (
            ("dense", P24_TRACE, ways), ("moe", P24_TRACE, ways),
            ("spec", P24_SPEC, [w for w in ways if w <= 2])):
        if kind not in kinds:
            continue
        docs = {}
        for w in widths:
            routing = "-" if kind != "moe" else (
                f"record:{path}" if w == 1 else f"replay:{path}")
            docs[w] = torchrun(w, f"serve_{kind}_{w}", [kind, routing]
                               + list(P24_FLAGS) + extra, work, logs,
                               kind="serve")[0]
        srow = {}
        for w, d in docs.items():
            srow[w] = {k: d[k] for k in (
                "burst_tokens_per_sec_per_card", "peak_memory_gb", "policy",
                "route_flips", "route_decisions") if k in d}
            if w != 1:
                srow[w]["against_1"] = _token_gate(
                    d, docs[1], failures, f"tp_ep serve {kind} {w}")
        out["tp_ep"][f"serve_{kind}"] = srow
        print(json.dumps({f"tp_ep serve {kind}": srow}), flush=True)


# ---- part pp: pipeline parallelism over every card ---------------------------

PP_BLOCKS = 2        # the LM's blocks a stage (8 layers over four cards)
# micro-batches of one sequence each, by schedule: GPipe's last stage
# holds every micro-batch's activations and float32 logits (~4 GB each at
# the LM's width), so M 32 does not fit its 80 GB; 1F1B's memory is flat
# in M
PP_MS = {"1f1b": (8, 16, 32), "gpipe": (8, 16)}
PP_STEPS = 3         # steps of each run; tokens/s over the steps after one
PP_F32 = dict(seq=2048, m=4)   # the float32 parity, TF32 off


def pp_worker(out_prefix, flags):
    """One rank (stage) under ``torchrun``: the LM's ``blocks`` blocks of
    this rank as its stage (phase 28's setup), ``schedule`` (1f1b, gpipe;
    ``sequential``: one card, the whole model in one pass, no pipeline)
    for ``steps`` steps over ``m`` micro-batches of one sequence: losses,
    step seconds, peak memory; with ``grads``, this rank's step-0
    gradients in ``{prefix}.rank{r}.grads.pt``."""
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs_
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.utils.compare import no_tf32
    cfg = json.loads(flags[0])
    comm = create_communicator("flat")
    dev = comm.device
    rank, n, b = comm.rank, comm.size, cfg["blocks"]
    dtype = getattr(torch, cfg["dtype"])
    lm = dict(cs_.LM, n_layers=b * n, max_len=cfg["seq"])
    ctx = no_tf32() if dtype == torch.float32 else \
        __import__("contextlib").nullcontext()
    with ctx:
        model, params, x, tgt, stage_fn, loss_fn = cs_._p28_setup(
            torch, dev, dtype, lm, "flash", cfg["seq"], m=cfg["m"],
            blocks=slice(rank * b, (rank + 1) * b))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, grads = [], [], None
        for i in range(cfg["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cfg["schedule"] == "1f1b":
                loss, g = cs_._p28_1f1b(comm, stage_fn, loss_fn, params, x,
                                        tgt)
            elif cfg["schedule"] == "gpipe":
                loss, g = cs_._p28_gpipe(comm, stage_fn, loss_fn, params, x,
                                         tgt)
            else:
                # the reference: one pass of the whole batch (without a
                # graph unless its gradients are asked for)
                for p in params.values():
                    p.grad = None
                with torch.set_grad_enabled(bool(cfg.get("grads"))):
                    y = stage_fn(params, x)
                    loss = sum(loss_fn(y[j:j + 1], tgt[j:j + 1])
                               for j in range(cfg["m"])) / cfg["m"]
                if cfg.get("grads"):
                    loss.backward()
                g = {k: p.grad for k, p in params.items()}
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if i == 0 and cfg.get("grads"):
                # the stage's names as the whole model's blocks
                grads = {f"{rank * b + int(k.split('.')[0])}."
                         + k.split(".", 1)[1]: v.detach().cpu()
                         for k, v in g.items()}
            del g
    if grads is not None:
        torch.save(grads, f"{out_prefix}.rank{rank}.grads.pt")
    steady = secs[1:] or secs
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump({"losses": losses, "step_s": secs,
                   "tokens_per_sec": cfg["m"] * cfg["seq"] * len(steady)
                   / sum(steady),
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "world": n}, f)


def _pp_run(n, name, cfg, work, logs):
    return torchrun(n, name, [json.dumps(cfg)], work, logs, kind="pp")


def pipeline(n, out, failures, work, logs):
    """Part pp (see the module docstring)."""
    from chainermn_tpu_torch.utils.compare import step_agrees, step_errors
    import torch
    res = {}
    bf16 = dict(blocks=PP_BLOCKS, dtype="bfloat16", seq=8192,
                steps=PP_STEPS)
    for m in PP_MS["1f1b"]:
        ref = _pp_run(1, f"pp_seq_m{m}", dict(
            bf16, blocks=PP_BLOCKS * n, m=m, schedule="sequential",
            steps=1), work, logs)[0]
        for sched in [k for k, ms in PP_MS.items() if m in ms]:
            docs = _pp_run(n, f"pp_{sched}_m{m}", dict(
                bf16, m=m, schedule=sched), work, logs)
            row = {"schedule": sched, "m": m, "stages": n,
                   "losses": docs[0]["losses"],
                   "tokens_per_sec_per_card":
                       docs[0]["tokens_per_sec"] / n,
                   "peak_memory_gb": [d["peak_memory_gb"] for d in docs],
                   "step_s": docs[0]["step_s"],
                   "one_card_sequential_loss": ref["losses"][0],
                   "loss_rel_to_one_card": abs(docs[0]["losses"][0]
                                               - ref["losses"][0])
                   / abs(ref["losses"][0])}
            res[f"{sched}_m{m}"] = row
            print(json.dumps(row), flush=True)
            if not all(math.isfinite(v) for d in docs
                       for v in d["losses"]) or any(
                    d["losses"] != docs[0]["losses"] for d in docs):
                failures.append(f"pp {sched} m{m}: losses")
    # the float32 parity: 1F1B and GPipe over the cards against one card
    f32 = dict(blocks=PP_BLOCKS, dtype="float32", steps=1, grads=True,
               **PP_F32)
    ref = _pp_run(1, "pp_f32_seq", dict(f32, blocks=PP_BLOCKS * n,
                                        schedule="sequential"), work, logs)
    want = torch.load(os.path.join(work, "pp_f32_seq.rank0.grads.pt"))
    for sched in ("1f1b", "gpipe"):
        docs = _pp_run(n, f"pp_f32_{sched}", dict(f32, schedule=sched),
                       work, logs)
        got = {}
        for r in range(n):
            got.update(torch.load(os.path.join(
                work, f"pp_f32_{sched}.rank{r}.grads.pt")))
        loss_rel, grad_rel, worst = step_errors(
            [docs[0]["losses"][0]], [ref[0]["losses"][0]], got, want)
        row = {"loss_rel": loss_rel, "grad_rel": grad_rel, "worst": worst,
               "tensors": len(got)}
        res[f"f32_{sched}"] = row
        print(json.dumps({f"f32_{sched}": row}), flush=True)
        if not step_agrees(loss_rel, grad_rel) or len(got) != len(want):
            failures.append(f"pp float32 {sched}")
    out["pp"] = res


# ---- part compression: the quantized wires over every card -------------------

COMP_N = 4_000_003   # gradient elements a rank (not a multiple of anything)


def comp_worker(out_prefix, flags):
    """One rank under ``torchrun`` (NCCL on the cards, or gloo with
    ``cpu``): int8 and fp8 ``allreduce_grad`` (deterministic) for 3 EF
    steps over this rank's seeded gradient; every step's mean, residual
    and exponents in ``{prefix}.rank{r}.pt``."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch import create_communicator, init_distributed
    from chainermn_tpu_torch.compression import Fp8Compressor, Int8Compressor
    device = flags[0] if flags else None
    init_distributed(device)
    comm = create_communicator("flat", device=device)
    rng = np.random.RandomState(100 + comm.rank)
    g = {"w": torch.from_numpy((rng.randn(COMP_N) * 10.0 ** rng.uniform(
        -4, -1, COMP_N)).astype(np.float32)).to(comm.device),
         "b": torch.from_numpy(rng.randn(77).astype(np.float32)).to(
             comm.device)}
    out = {}
    for comp in (Int8Compressor(stochastic=False),
                 Fp8Compressor(stochastic=False)):
        st = comm.init_compression_state(g, comp)
        for step in range(3):
            mean, st = comm.allreduce_grad(g, compressor=comp, state=st)
            for k, v in mean.items():
                out[f"{comp.name}/{step}/mean/{k}"] = v.cpu()
            for k in ("ef", "scale", "step"):
                out[f"{comp.name}/{step}/{k}"] = getattr(st, k).cpu()
    torch.save(out, f"{out_prefix}.rank{comm.rank}.pt")
    with open(f"{out_prefix}.rank{comm.rank}.json", "w") as f:
        json.dump({"world": comm.size,
                   "backend": __import__("torch.distributed").distributed
                   .get_backend()}, f)


def mnist_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``train_mnist.main(flags)``'s per-epoch
    log."""
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.examples import train_mnist
    res = train_mnist.main(flags)
    rank = int(os.environ["RANK"])
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump({"losses": [r["main/loss"] for r in res["log"]],
                   "acc": [r["validation/accuracy"] for r in res["log"]],
                   "rate": res["examples_per_sec_per_gpu"]}, f)


def comp_fsdp_worker(out_prefix, flags):
    """One rank under ``torchrun``: chip_smoke's LM FSDP run
    (``_p29_lm``: the LM's width, bf16, flash) with the configuration
    ``flags[0]`` (JSON: num_buckets, comps, wire); losses and the step's
    counters."""
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs_
    from chainermn_tpu_torch import create_communicator
    cfg = json.loads(flags[0])
    comm = create_communicator("xla")
    losses, stats, *_ = cs_._p29_lm(
        torch, comm.device, comm, cs_.LM["n_layers"], cs_.P29_FSDP_STEPS,
        num_buckets=cfg.get("num_buckets", 1), comps=cfg.get("comps"),
        wire=cfg.get("wire"))
    with open(f"{out_prefix}.rank{comm.rank}.json", "w") as f:
        json.dump({"losses": losses, "stats": stats,
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9},
                  f)


def compression(n, out, failures, work, logs):
    """Part compression (see the module docstring)."""
    import torch
    res = {}
    # int8 / fp8 allreduce_grad: NCCL on the cards against gloo on the CPU
    card = torchrun(n, "comp_nccl", [], work, logs, kind="comp")
    cpu = torchrun(n, "comp_gloo", ["cpu"], work, logs, kind="comp")
    equal = {}
    for r in range(n):
        a = torch.load(os.path.join(work, f"comp_nccl.rank{r}.pt"))
        b = torch.load(os.path.join(work, f"comp_gloo.rank{r}.pt"))
        for k in a:
            name = k.split("/")[0]
            same = a[k].view(torch.int32).equal(b[k].view(torch.int32))
            equal[name] = equal.get(name, True) and same
    res["allreduce_grad"] = {"backends": [card[0]["backend"],
                                          cpu[0]["backend"]],
                             "bit_equal": equal, "elements": COMP_N + 77}
    print(json.dumps(res["allreduce_grad"]), flush=True)
    if not all(equal.values()) or set(equal) != {"int8", "fp8"}:
        failures.append("compression: NCCL != gloo")
    # the MNIST example with int8 on every card
    mn = {}
    for name, extra in (("none", []), ("int8", ["--compression", "int8"])):
        docs = torchrun(n, f"mnist_{name}", ["--epoch", "3", "--prefetch",
                                             "0"] + extra, work, logs,
                        kind="mnist")
        mn[name] = docs[0]
        if any(d["losses"] != docs[0]["losses"] for d in docs):
            failures.append(f"mnist {name}: ranks disagree")
    base, q = mn["none"]["losses"], mn["int8"]["losses"]
    res["mnist"] = mn
    print(json.dumps({"mnist": mn}), flush=True)
    if not (q[-1] < q[0] and abs(q[-1] - base[-1]) < 0.1 * abs(base[0])):
        failures.append("mnist int8 contract")
    # FSDP's int8 buckets on the LM: the reduce-scatter bytes
    fs = {}
    for name, cfg in (("plain", {}), ("bf16 wire", {"wire": "bfloat16"}),
                      ("int8 K1", {"comps": "int8"}),
                      ("int8 K4", {"comps": "int8", "num_buckets": 4})):
        docs = torchrun(n, "comp_fsdp_" + name.replace(" ", "_"),
                        [json.dumps(cfg)], work, logs, kind="comp_fsdp")
        fs[name] = {"losses": docs[0]["losses"],
                    "scatter_bytes": docs[0]["stats"]["scatter_bytes"],
                    "gather_bytes": docs[0]["stats"]["gather_bytes"],
                    "peak_memory_gb": [d["peak_memory_gb"] for d in docs]}
    for name in ("int8 K1", "int8 K4"):
        r = fs[name]
        r["ratio_vs_f32"] = fs["plain"]["scatter_bytes"] / r["scatter_bytes"]
        r["ratio_vs_bf16"] = (fs["bf16 wire"]["scatter_bytes"]
                              / r["scatter_bytes"])
        if r["ratio_vs_f32"] < 3.5 or not (
                abs(r["losses"][-1] - fs["plain"]["losses"][-1])
                < 0.1 * abs(fs["plain"]["losses"][0])):
            failures.append(f"fsdp {name}")
    res["fsdp"] = fs
    print(json.dumps({"fsdp": fs}), flush=True)
    out["compression"] = res


PLANNER_SIZES_KB = "4,64,1024,16384,131072"
PLANNER_N = 1 << 20          # the checks' gradient elements a rank
PLANNER_RESNET = ["--arch", "resnet50", "--batchsize", "32", "--dtype",
                  "bfloat16", "--iterations", "3", "--train-size", "256",
                  "--val-size", "0", "--seed", "0", "--warmup-steps", "1",
                  "--log-interval", "100", "--intra-size", "2"]
# a swept plan -> the flavor flags that run it directly
PLAN_FLAVORS = {"naive": ["--communicator", "naive"],
                "flat": ["--communicator", "flat"],
                "xla": ["--communicator", "xla"],
                "hierarchical": ["--communicator", "hierarchical"],
                "two_dimensional": ["--communicator", "two_dimensional"],
                "flat_bfloat16": ["--communicator", "xla",
                                  "--allreduce-grad-dtype", "bfloat16"]}
_UNIT = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8,
         "float16": 2.0 ** -11}


def sweep_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``bench_allreduce.main(flags)``."""
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.benchmarks import bench_allreduce
    doc = bench_allreduce.main(flags)
    rank = int(os.environ["RANK"])
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump({"rows": len(doc["rows"])}, f)


def planner_worker(out_prefix, flags):
    """One rank under ``torchrun`` (NCCL, intra 2): the planner's checks
    of part ``planner``; booleans and worst errors by check."""
    import torch
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.parallel.expert import moe_apply
    from chainermn_tpu_torch.planner import (
        alltoall_plans, broadcast_plans, candidate_plans, execute_plan,
        flavor_plan, plan_compressed_hops)
    from chainermn_tpu_torch.serving import weights as sw
    comm = create_communicator("naive", intra_size=2)
    dev, rank, n = comm.device, comm.rank, comm.size
    topo = comm.plan_topology()
    g = torch.Generator().manual_seed(100 + rank)
    grads = {"w": torch.randn(PLANNER_N, generator=g).to(dev),
             "b": torch.randn(777, generator=g).to(dev)}
    ranked = {"w": torch.full((PLANNER_N,), float(rank), device=dev)}
    out = {"plans": {}, "flavors": {}, "moe": {}, "multicast": {}}
    flat = execute_plan(flavor_plan("flat"), comm, grads)
    flat_r = execute_plan(flavor_plan("flat"), comm, ranked)
    mean_abs = {k: sum(comm.allgather(v.abs())).float() / n
                for k, v in grads.items()}
    for plan in candidate_plans(topo, stripe_ratios=(0.6,)):
        if plan_compressed_hops(plan, topo):
            got = execute_plan(plan, comm, ranked)["w"]
            err = float((got - flat_r["w"]).abs().max())
            out["plans"][plan.name] = [err <= 1e-2 * (n - 1), err]
            continue
        wires = [plan.wire_dtype or "float32"] + [
            st.wire_dtype for grp in plan.stage_groups()
            for st in grp.stages if st.wire_dtype]
        u = max(_UNIT[w] for w in wires)
        got = execute_plan(plan, comm, grads)
        ok, worst = True, 0.0
        for k in grads:
            # two orders of an n-term sum (plus the wire's casts of each
            # term, shared by both): 2 (n - 1) u mean|x| after the mean
            bound = 2 * n * u * mean_abs[k] + 1e-30
            diff = (got[k] - flat[k]).abs()
            ok = ok and bool((diff <= bound).all())
            worst = max(worst, float((diff / bound).max()))
        out["plans"][plan.name] = [ok, worst]
    for label, name, kw in (("naive", "naive", {}), ("flat", "flat", {}),
                            ("hierarchical", "hierarchical", {}),
                            ("two_dimensional", "two_dimensional", {}),
                            ("single_node", "single_node",
                             {"intra_size": n}),
                            ("non_cuda_aware", "non_cuda_aware", {}),
                            ("xla", "xla", {}),
                            ("xla_bf16", "xla",
                             {"allreduce_grad_dtype": "bfloat16"})):
        kw = dict({"intra_size": 2}, **kw)
        c = create_communicator(name, **kw)
        a, b = c.allreduce_grad(grads), execute_plan(c.plan(), c, grads)
        out["flavors"][label] = all(
            torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
            for k in grads)
    x = torch.randn(64, 32, generator=g).to(dev)
    logits = torch.randn(64, 2 * n, generator=g).to(dev)
    base = moe_apply(lambda t: 2.0 * t, logits, x, comm, num_experts=2 * n)
    for plan in alltoall_plans(topo):
        y = moe_apply(lambda t: 2.0 * t, logits, x, comm,
                      num_experts=2 * n, plan=plan)
        narrow = any(st.wire_dtype for grp in plan.stage_groups()
                     for st in grp.stages)
        out["moe"][plan.name] = bool(torch.equal(y, base)) if not narrow \
            else float((y - base).abs().max()) < 0.25
    w0 = {"w": torch.randn(513, 7, generator=torch.Generator().manual_seed(
        rank)).to(dev), "ids": torch.arange(9, device=dev) * (rank + 1)}
    mine = comm.bcast(w0, root=0)
    for plan in broadcast_plans(topo, wire_dtypes=()):
        got = sw.broadcast_inference_params(comm, w0, plan=plan)
        out["multicast"][plan.name] = all(torch.equal(got[k], mine[k])
                                          for k in w0)
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump(out, f)


def planner(n, out, failures, work, logs):
    """Part planner (see the module docstring)."""
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.planner import (
        PlanTable, PlanTopology, autotune_from_rows, size_bucket,
        validate_sweep_rows)
    res = {}
    sweep = os.path.join(work, "planner_sweep.json")
    t0 = time.perf_counter()
    torchrun(n, "planner_sweep", [
        "--intra-size", "2", "--sweep", sweep, "--sweep-sizes-kb",
        PLANNER_SIZES_KB, "--iters", "20", "--warmup", "3",
        "--stripe-ratios", "0.6,0.8"], work, logs, kind="sweep")
    doc = json.load(open(sweep))
    shutil.copy(sweep, os.path.join(logs, "planner_sweep.json"))
    rows = doc["rows"]
    validate_sweep_rows(rows)
    table, comparison = autotune_from_rows(rows)
    tpath = os.path.join(work, "planner_table.json")
    table.save(tpath)
    table.save(os.path.join(logs, "planner_table.json"))
    res["sweep"] = {"topology": doc["topology"], "card": doc.get("card"),
                    "rows": len(rows), "seconds": time.perf_counter() - t0}
    by_bucket = {}
    for r in rows:
        by_bucket.setdefault(size_bucket(r["bytes"]), {}).setdefault(
            r["plan"], []).append(r["us"])
    res["table"] = [{"bucket": c["bucket"], "tuned": c["tuned_plan"],
                     "tuned_us": c["tuned_us"],
                     "best_fixed": c["best_fixed_plan"],
                     "best_fixed_us": c["best_fixed_us"],
                     "speedup": c["speedup"],
                     "us": {p: sum(v) / len(v) for p, v in
                            sorted(by_bucket[c["bucket"]].items())}}
                    for c in comparison]
    for row in res["table"]:
        print(json.dumps(row), flush=True)
    # the checks
    docs = torchrun(n, "planner_checks", [], work, logs, kind="planner")
    res["checks"] = docs[0]
    for r, d in enumerate(docs):
        for kind in ("plans", "flavors", "moe", "multicast"):
            for name, v in d[kind].items():
                ok = v[0] if isinstance(v, list) else v
                if not ok:
                    failures.append(f"planner {kind} {name} (rank {r})")
    print(json.dumps({"checks": docs[0]}), flush=True)
    # auto from the swept table against the plan it picks, run directly
    grad_bytes = 4 * 25557032   # ResNet-50's float32 gradients
    topo = PlanTopology.from_key(doc["topology"])
    pick = table.lookup(topo, "float32", grad_bytes)
    direct = PLAN_FLAVORS.get(pick.name)
    if direct is None:
        one = PlanTable()
        one.put(topo, "float32", size_bucket(grad_bytes), pick)
        opath = os.path.join(work, "planner_one.json")
        one.save(opath)
        direct = ["--communicator", "auto", "--plan-table", opath]
    runs = {}
    for label, flags in (("auto", ["--communicator", "auto", "--plan-table",
                                   tpath]), ("direct", direct)):
        runs[label] = torchrun(n, f"planner_{label}", PLANNER_RESNET + flags,
                               work, logs)
    a, d = runs["auto"], runs["direct"]
    res["auto"] = {"pick": pick.name, "direct": " ".join(direct),
                   "losses": a[0]["losses"], "direct_losses": d[0]["losses"],
                   "images_per_sec": a[0]["images_per_sec"],
                   "direct_images_per_sec": d[0]["images_per_sec"],
                   "same_digest": all(x["digest"] == y["digest"]
                                      for x, y in zip(a, d))}
    print(json.dumps({"auto": res["auto"]}), flush=True)
    if a[0]["losses"] != d[0]["losses"] or not res["auto"]["same_digest"]:
        failures.append("planner: auto != the picked plan run directly")
    if not all(map(math.isfinite, a[0]["losses"])):
        failures.append("planner: auto losses not finite")
    out["planner"] = res


def data_parallel(n, out, failures, work, logs):
    """Steps 2-4 (see the module docstring)."""
    rc, summary, _ = gpu_tests("tests/test_torch_nccl_gpu.py", logs,
                               "gpu_tests")
    out["nccl_tests"] = {"rc": rc, "summary": summary}
    if rc or "skipped" in summary:
        failures.append("tests/test_torch_nccl_gpu.py")

    runs = []
    for i, zero in enumerate((True, False, True, False)):
        name = f"timed{i}_{'zero' if zero else 'plain'}"
        docs = torchrun(n, name, TIMED + ["--zero"] * zero, work, logs)
        d = docs[0]
        runs.append({"run": name, "images_per_sec": d["images_per_sec"],
                     "peak_memory_gb_rank0": d["peak_memory_gb"],
                     "final_loss": d["losses"][-1]})
        print(json.dumps(runs[-1]), flush=True)
        if not all(map(math.isfinite, d["losses"])):
            failures.append(f"{name}: losses {d['losses']}")
    out["timed"] = runs

    straight = torchrun(n, "straight", RESUME + [
        "--iterations", "12", "--train-size", str(32 * n * 5),
        "--checkpoint", os.path.join(work, "straight")], work, logs)
    part = os.path.join(work, "part")
    first = torchrun(n, "first", RESUME + [
        "--iterations", "6", "--train-size", str(32 * n * 5),
        "--checkpoint", part], work, logs)
    resumed = torchrun(n, "resumed", RESUME + [
        "--iterations", "12", "--train-size", str(32 * n * 5),
        "--checkpoint", part], work, logs)
    equal = [a["digest"] == b["digest"]
             for a, b in zip(straight, resumed)]
    out["resume"] = {
        "resumed_from": resumed[0]["resumed_from"],
        "iterations": resumed[0]["iterations"],
        "epochs_logged": straight[0]["epochs"],
        "equal_by_rank": equal,
        "same_losses": resumed[0]["losses"] == straight[0]["losses"][6:],
        "images_per_sec": straight[0]["images_per_sec"],
        "save_ms_rank0": [round(1e3 * t, 1)
                          for t in straight[0]["save_seconds"]],
        "peak_memory_gb_rank0": straight[0]["peak_memory_gb"]}
    print(json.dumps(out["resume"]), flush=True)
    if not all(equal) or resumed[0]["resumed_from"] != 6 or \
            first[0]["iterations"] != 6 or straight[0]["epochs"] != 2:
        failures.append("resume")
    if not all(math.isfinite(v) for d in straight + resumed
               for v in d["losses"]):
        failures.append("resume: losses not finite")


OBS_MNIST = ["--epoch", "1", "--unit", "1000", "--batchsize", "100",
             "--communicator", "xla", "--allreduce-grad-dtype", "float16",
             "--double-buffering", "--prefetch", "0", "--observability"]


def obs_worker(out_prefix, flags):
    """One rank under ``torchrun``: the object ops on the plane
    ``flags[0]`` (``socket`` or ``gloo``), then the MNIST example with
    observability on that plane; the results, the collective call counts
    and a digest of the parameters."""
    import torch
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch import (create_communicator, get_control_plane,
                                     init_distributed)
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.examples import train_mnist
    from chainermn_tpu_torch.runtime.control_plane import reset_control_plane
    plane = flags[0]
    torch.backends.cudnn.deterministic = True
    init_distributed()
    kw = {"control_plane": get_control_plane()} if plane == "socket" else {}
    comm = create_communicator("naive", **kw)
    r, n = comm.rank, comm.size
    objs = [comm.bcast_obj({"s": 7} if r == 0 else None),
            comm.gather_obj(r * 3),
            comm.scatter_obj([f"i{i}" for i in range(n)] if r == 0
                             else None),
            comm.allgather_obj((r, "x")),
            comm.allreduce_obj({"a": r + 1, "b": [r]}),
            comm.split(r % 2, r).allgather_obj(r)]
    comm.barrier()
    kinds = [type(comm._cp).__name__,
             type(getattr(comm._cp, "_tp", None)).__name__]
    # the example on an xla communicator on the same object plane
    args = train_mnist.parse_args(OBS_MNIST + ["--out", f"{out_prefix}_out"])
    obs.enable()
    res = train_mnist.train(args, create_communicator(
        args.communicator, allreduce_grad_dtype=args.allreduce_grad_dtype,
        **kw))
    reset_control_plane()
    calls = sorted([sorted(x["labels"].items()), x["value"]]
                   for x in obs.get_registry().snapshot()
                   if x["name"] == "comm_collective_calls")
    h = hashlib.sha256()
    for name, t in sorted(res["model"].state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().reshape(-1).contiguous().cpu()
                 .view(torch.uint8).numpy().tobytes())
    with open(f"{out_prefix}.rank{r}.json", "w") as f:
        json.dump({"objs": objs, "plane": kinds, "calls": calls,
                   "digest": h.hexdigest(),
                   "iterations": res["log"][-1]["iteration"]}, f,
                  default=lambda o: o.item())


OBS2_FSDP = {"layers": 4, "width": 4096, "batch": 256, "buckets": 2,
             "prefetch": 1}
OBS2_A2A = (1 << 16, 256)   # the all-to-all's rows, their width
OBS2_SLOW = (0.01, 0.05)    # fleet: a step's host time, the last rank's


def obs2_worker(out_prefix, flags):
    """One rank under ``torchrun`` on the socket control plane (native):
    a contention report of one FSDP step with a plan's all-to-all hops in
    its window, a fleet document with the last rank slowed on purpose, and
    an online tuner armed on rank 0 only swapping on every rank."""
    import torch
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch import (create_communicator, get_control_plane,
                                     init_distributed)
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.benchmarks.bench_fsdp_overlap import tanh_mlp
    from chainermn_tpu_torch.parallel.fsdp import (
        fsdp_init, make_fsdp_train_step)
    from chainermn_tpu_torch.planner import alltoall_plans, execute_alltoall
    from chainermn_tpu_torch.planner.online import (
        OnlineTuner, active_plan_table_meta)
    from chainermn_tpu_torch.runtime.control_plane import reset_control_plane
    init_distributed()
    cp = get_control_plane()
    comm = create_communicator("xla", intra_size=2, control_plane=cp)
    r, n = comm.rank, comm.size
    dev = comm.device
    out = {"plane": [type(cp).__name__, type(cp._tp).__name__]}
    obs.enable()
    fr = obs.install_flight_recorder()
    agg = obs.TelemetryAggregator(comm)
    # contention: one FSDP step, then a hierarchical all-to-all, in one
    # step window (warmed once outside it)
    cfg = OBS2_FSDP
    g = torch.Generator().manual_seed(22 + r)
    xs, ys = (torch.randn(cfg["batch"], cfg["width"], generator=g).to(dev)
              for _ in range(2))
    model = tanh_mlp(cfg["layers"], cfg["width"], 0, dev)
    state, meta = fsdp_init(comm, model, torch.optim.Adam(
        model.parameters(), lr=1e-3), num_buckets=cfg["buckets"])
    step = make_fsdp_train_step(
        comm, lambda b: torch.mean((model(b[0]) - b[1]) ** 2), state, meta,
        prefetch=cfg["prefetch"])
    plan = next(p for p in alltoall_plans(comm.plan_topology())
                if p.name == "alltoall_hierarchical")
    buf = torch.randn(n, OBS2_A2A[0] // n, OBS2_A2A[1], device=dev)
    step((xs, ys))
    execute_alltoall(plan, comm, buf)
    torch.cuda.synchronize()
    pobs = obs.get_plan_obs(comm)
    t0 = time.time()
    step((xs, ys))
    execute_alltoall(plan, comm, buf, pobs=pobs)
    torch.cuda.synchronize()
    fr.record_step(time.time() - t0, 1)
    off = obs.clock_handshake(comm)["offset_s"]
    got = comm.gather_obj((r, off, fr.snapshot()))
    if r == 0:
        evs = {rr: e for rr, _, e in got}
        rep = obs.contention_report(evs, offsets={rr: o for rr, o, _ in got})
        out["contention"] = {k: rep[k] for k in (
            "schema", "n_ranks", "n_steps", "links", "overlap", "rates",
            "consistency_ok")}
        out["contention"]["owners"] = {
            link: sorted(owners) for link, owners in rep["timelines"].items()}
    # fleet: six steps a rank, the last rank's five times longer (the
    # window before them shipped first)
    agg.collect(1)
    for k in range(6):
        t0 = time.perf_counter()
        time.sleep(OBS2_SLOW[r == n - 1])
        fr.record_step(time.perf_counter() - t0, 2 + k)
    fleet = agg.collect(8)
    out["fleet_plane"] = agg._plane is cp
    if r == 0:
        out["fleet"] = {k: fleet[k] for k in (
            "schema", "n_ranks", "step_time", "stragglers", "overlap")}
    # online tune: rank 0 alone observes the slow inter-node link
    auto = create_communicator("auto", intra_size=2, control_plane=cp)
    rec = obs.FlightRecorder(capacity=256)
    tuner = OnlineTuner(comm=auto, flight=rec, min_samples=1)
    if r == 0:
        events, t = [], 0.0
        for _ in range(8):
            for pl, link, nbytes, gbps in (("flat", "ib", 8 << 20, 0.5),
                                           ("hierarchical", "nvlink",
                                            1 << 20, 16.0)):
                dur = nbytes / (gbps * 1e9)
                base = dict(plan=pl, stage=0, op="all_reduce",
                            scope="intra" if link == "nvlink" else "inter",
                            link=link, nbytes=nbytes)
                events += [dict(kind="plan_stage_begin", ts=t, **base),
                           dict(kind="plan_stage_end", ts=t + dur, **base)]
                t += dur
            t += 0.01
        tuner.ingest(events)
        tuner.on_regression([{"bucket": "dcn_comm", "ratio": 4.0}])
    d = tuner.maybe_swap(step=11)
    out["swap"] = {
        "step": d["step"] if d else None,
        "table_hash": d["table_hash"] if d else None,
        "best_speedup": d["best_speedup"] if d else None,
        "pin": active_plan_table_meta(),
        "events": sum(e["kind"] == "plan_table_swap"
                      for e in rec.events_since(-1)),
        "plan_8mib": auto.plan_for(8 << 20, "float32").name}
    comm.barrier()
    reset_control_plane()
    with open(f"{out_prefix}.rank{r}.json", "w") as f:
        json.dump(out, f)


DESYNC_SKIP = 3      # the iteration whose allreduce_grad the last rank skips
DESYNC_STEPS = 6


def desync_worker(out_prefix, flags):
    """One rank of the hang: an instrumented ``non_cuda_aware`` communicator
    (its mean staged through the host on gloo: a blocking call, an open
    span) on the socket plane, the watchdog on; the last rank skips
    iteration ``DESYNC_SKIP``'s ``allreduce_grad``, so the others block in
    their last one while it goes idle.  Every rank's dump lands in
    ``{out_prefix}_dumps``; the harness ends the world."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch import (create_communicator, get_control_plane,
                                     init_distributed)
    from chainermn_tpu_torch import observability as obs
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    # a short group timeout: the harness ends the world well inside it
    dist.init_process_group(
        "nccl", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
        f"{os.environ['MASTER_PORT']}", rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=180))
    init_distributed()
    cp = get_control_plane()
    obs.enable()
    fr = obs.install_flight_recorder()
    comm = obs.instrument_communicator(create_communicator(
        "non_cuda_aware", control_plane=cp))
    out_dir = f"{out_prefix}_dumps"
    obs.start_watchdog(control_plane=cp, out_dir=out_dir, rank=rank,
                       deadline_s=2.0, step_stall_factor=8.0,
                       poll_interval_s=0.1, collect_window_s=3.0,
                       heartbeat_interval_s=0.5, heartbeat_timeout_s=60.0,
                       max_dumps=1)
    grads = {"g": torch.full((1 << 20,), float(rank), device=comm.device)}
    for it in range(DESYNC_STEPS):
        t0 = time.time()
        if not (rank == size - 1 and it == DESYNC_SKIP):
            comm.allreduce_grad(grads)
        torch.cuda.synchronize()
        fr.record_step(time.time() - t0, it + 1)
    # the last rank never enters its partners' last all-reduce: idle here
    # until the harness ends the world
    while True:
        time.sleep(1.0)


def desync(n, work, logs, res, failures):
    """The hang: ``n`` ranks of :func:`desync_worker` under ``torchrun`` in
    a session of their own; once every rank's dump is written (or 120 s),
    SIGTERM to the session, SIGKILL after 10 s, then the cards must hold
    no process."""
    import signal
    prefix = os.path.join(work, "desync")
    dumps = f"{prefix}_dumps"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__), "--worker",
           "desync", prefix]
    path = os.path.join(logs, "desync.log")
    t0 = time.time()
    with open(path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        want = [os.path.join(dumps, f"flight_{r}.json") for r in range(n)]
        while time.time() - t0 < 120 and proc.poll() is None and not all(
                os.path.exists(p) for p in want):
            time.sleep(0.5)
        time.sleep(1.0)  # a dump renamed into place is whole
        docs = {r: json.load(open(p)) for r, p in enumerate(want)
                if os.path.exists(p)}
        res["dumped_s"] = round(time.time() - t0, 1)
        res["exited_early"] = proc.poll()
        for sig, grace in ((signal.SIGTERM, 10), (signal.SIGKILL, 10)):
            if proc.poll() is not None:
                break
            try:
                os.killpg(proc.pid, sig)
            except ProcessLookupError:
                break
            try:
                proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                pass
    res["ended_s"] = round(time.time() - t0, 1)
    busy = None
    for _ in range(30):
        busy = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.split()
        if not busy:
            break
        time.sleep(1.0)
    res["cards_free"] = not busy
    res["ranks_dumped"] = sorted(docs)
    d0 = docs.get(0, {})
    an = d0.get("analysis") or {}
    res["reasons"] = {str(r): d["reason"] for r, d in docs.items()}
    res["desynced_ranks"] = an.get("desynced_ranks")
    res["stalled"] = an.get("stalled_collectives")
    res["incidents"] = sorted({d.get("incident") for d in docs.values()},
                              key=str)
    if res["ranks_dumped"] != list(range(n)):
        failures.append(f"obs desync: dumps of ranks {res['ranks_dumped']}")
    if res["desynced_ranks"] != [n - 1]:
        failures.append(f"obs desync: rank 0's dump names "
                        f"{res['desynced_ranks']}")
    if not res["cards_free"]:
        failures.append(f"obs desync: processes left on the cards {busy}")


def observability(n, out, failures, work, logs):
    """Part obs (see the module docstring)."""
    runs = {plane: torchrun(n, f"obs_{plane}", [plane], work, logs,
                            kind="obs") for plane in ("socket", "gloo")}
    res = {}
    for plane, docs in runs.items():
        res[plane] = {"plane": docs[0]["plane"],
                      "calls_equal": all(d["calls"] == docs[0]["calls"]
                                         for d in docs),
                      "calls": docs[0]["calls"]}
        if not res[plane]["calls_equal"]:
            failures.append(f"obs {plane}: ranks' collective calls differ")
    sock, gloo = runs["socket"], runs["gloo"]
    res["objs_equal"] = all(a["objs"] == b["objs"]
                            for a, b in zip(sock, gloo))
    res["params_equal"] = all(a["digest"] == b["digest"]
                              for a, b in zip(sock, gloo))
    if sock[0]["plane"] != ["SocketControlPlane", "NativeTransport"]:
        failures.append(f"obs: socket run on {sock[0]['plane']}")
    if not res["objs_equal"]:
        failures.append("obs: object ops socket != gloo")
    if not res["params_equal"]:
        failures.append("obs: parameters socket != gloo")
    recs = [json.loads(ln) for ln in open(os.path.join(
        work, "obs_socket_out", "metrics.jsonl"))]
    strag = [x for x in recs if x.get("kind") == "straggler_report"]
    res["straggler_ranks"] = strag[-1]["n_ranks"] if strag else None
    if res["straggler_ranks"] != n:
        failures.append(f"obs: straggler report over "
                        f"{res['straggler_ranks']} ranks")
    # the second slice: contention, the fleet, the swap; then the hang
    docs = torchrun(n, "obs2", [], work, logs, kind="obs2")
    d0 = docs[0]
    res["contention"] = d0["contention"]
    res["fleet"] = d0["fleet"]
    res["swap"] = [d["swap"] for d in docs]
    if not d0["contention"]["consistency_ok"] or \
            d0["contention"]["n_ranks"] != n:
        failures.append("obs contention: consistency")
    if d0["fleet"]["stragglers"] != [n - 1] or not all(
            d["fleet_plane"] for d in docs):
        failures.append(f"obs fleet: stragglers "
                        f"{d0['fleet']['stragglers']}")
    sw = res["swap"]
    if not (all(s["step"] == 11 and s["events"] == 1 for s in sw)
            and len({(s["table_hash"], s["plan_8mib"],
                      json.dumps(s["pin"])) for s in sw}) == 1
            and sw[0]["plan_8mib"] != "flat"):
        failures.append("obs swap: not the same swap on every rank")
    res["desync"] = {}
    desync(n, work, logs, res["desync"], failures)
    print(json.dumps({"obs": res}), flush=True)
    out["obs"] = res

ELASTIC = {"vocab": 32768, "d_model": 2048, "layers": 2, "heads": 16,
           "seq": 2048, "buckets": 2, "lr": 1e-3, "steps": 5, "kill_step": 3}
#: the device of the elastic part's ranks: None is one card a rank
ELASTIC_DEVICE = None

_ELASTIC_WORKER = r"""
import json, os, signal, sys, time
os.environ["CHAINERMN_TPU_OBSERVABILITY"] = "1"
sys.path.insert(0, os.environ["CHAINERMN_TPU_REPO"])
import numpy as np
import torch

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.elastic import resume_resized
from chainermn_tpu_torch.examples.train_lm import lm_loss, make_motif_task
from chainermn_tpu_torch.extensions.checkpoint import \
    create_multi_node_checkpointer
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.observability import start_watchdog
from chainermn_tpu_torch.optim import init_optimizer_state
from chainermn_tpu_torch.parallel.fsdp import (
    fsdp_init, make_fsdp_meta, make_fsdp_train_step)
from chainermn_tpu_torch.runtime.control_plane import get_control_plane
from chainermn_tpu_torch.utils.compare import no_tf32
from chainermn_tpu_torch.utils.proc_world import worker_device

t_start = time.time()
cfg = json.loads(os.environ["ELASTIC_CFG"])
attempt = int(os.environ.get("CHAINERMN_TPU_ELASTIC_ATTEMPT", "0"))
direct = os.environ.get("ELASTIC_DIRECT")
torch.set_num_threads(1)
topo = cmn.init_distributed(device=worker_device())
comm = cmn.create_communicator("flat", device=worker_device())
dev = comm.device
wd = None if direct else start_watchdog(
    control_plane=get_control_plane(), rank=comm.rank,
    out_dir=os.environ["CHAINERMN_TPU_FLIGHT_DIR"])


def new_model():
    return TransformerLM(vocab=cfg["vocab"], d_model=cfg["d_model"],
                         n_layers=cfg["layers"], n_heads=cfg["heads"],
                         max_len=cfg["seq"], attention_impl="flash",
                         device=dev, generator=torch.Generator(
                             device=dev).manual_seed(0))


def batch(t):
    # the same 4 sequences a step for every world: rank r's share of them
    toks = make_motif_task(4, cfg["seq"], cfg["vocab"], seed=100 + t)
    n = 4 // comm.size
    return toks[comm.rank * n:(comm.rank + 1) * n].to(dev)


def files(path, gen, world):
    return [dict(np.load(os.path.join(path, "lm.%d.rank%d.npz" % (gen, r))))
            for r in range(world)]


with no_tf32():
    model = new_model()
    if direct:
        # the half world started directly from the consolidated generation:
        # parameters and Adam moments cut into this world's shards by hand
        gen, old = int(direct), int(cfg["old_world"])
        saved = files(cfg["ckpt"], gen, old)
        meta_old = make_fsdp_meta(model, old, cfg["buckets"])
        names = [n for n, _ in model.named_parameters()]
        full = {}
        for b, bl in enumerate(meta_old.buckets):
            buf = np.concatenate([f["fsdp/shards/%d/0" % b] for f in saved])
            off = 0
            for n in names[bl.start:bl.stop]:
                p = dict(model.named_parameters())[n]
                full[n] = torch.from_numpy(
                    buf[off:off + p.numel()].reshape(p.shape).copy())
                off += p.numel()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(full[n])
    state, meta = fsdp_init(comm, model, torch.optim.Adam(
        model.parameters(), lr=cfg["lr"]), num_buckets=cfg["buckets"])
    step = make_fsdp_train_step(comm, lambda toks: lm_loss(model, toks),
                                state, meta)
    out = {"rank": comm.rank, "world": comm.size, "attempt": attempt,
           "start_s": time.time() - t_start}
    if direct:
        init_optimizer_state(state.inner)
        shards = state.flat_shards()
        for i, (bl, p) in enumerate(zip(meta.buckets, shards)):
            st = state.inner.state[p]
            for key in ("exp_avg", "exp_avg_sq"):
                v = np.concatenate([f["fsdp/inner/%d/%s" % (i, key)]
                                    for f in saved])[:bl.orig_lens[0]]
                n = bl.shard_lens[0]
                v = np.concatenate([v, np.zeros(n * comm.size - v.size,
                                                v.dtype)])
                st[key].copy_(torch.from_numpy(
                    v[comm.rank * n:(comm.rank + 1) * n]))
            st["step"].copy_(torch.from_numpy(
                saved[0]["fsdp/inner/%d/step" % i]))
        out["loss"] = float(step(batch(gen + 1)))
        create_multi_node_checkpointer(comm, cfg["direct_out"], "lm",
                                       keep=0).save({"fsdp": state}, gen + 1)
    elif attempt == 0:
        ckpt = create_multi_node_checkpointer(comm, cfg["ckpt"], "lm",
                                              keep=0, backend="async")
        for t in range(cfg["steps"]):
            loss = float(step(batch(t)))
            if t == cfg["kill_step"] and comm.rank == comm.size - 1:
                # the preemption, once this rank's earlier snapshots are
                # on disk (a generation of every rank exists to resume)
                ckpt.drain()
                os.kill(os.getpid(), signal.SIGKILL)
            ckpt.save({"fsdp": state}, t)
        ckpt.finalize()
    else:
        init_optimizer_state(state.inner)
        t0 = time.time()
        src = create_multi_node_checkpointer(comm, cfg["ckpt"], "lm", keep=0)
        tree, gen, report = resume_resized(src, {"fsdp": state}, comm)
        out["resume_s"] = time.time() - t0
        out.update(gen=gen, report={k: v for k, v in report.items()
                                    if k != "plan_table"})
        create_multi_node_checkpointer(comm, cfg["resumed"], "lm",
                                       keep=0).save({"fsdp": state}, gen)
        out["loss"] = float(step(batch(gen + 1)))
        create_multi_node_checkpointer(comm, cfg["next"], "lm",
                                       keep=0).save({"fsdp": state}, gen + 1)
if wd is not None:
    wd.stop()
print("RESULT " + json.dumps(out), flush=True)
comm.barrier()
torch.distributed.destroy_process_group()
"""


def _lm_consolidated(path, gen, world, orig):
    """``{leaf: array}``: a generation's sharded leaves, every rank's slice
    concatenated and the pad cut (``orig``: each bucket's length)."""
    import numpy as np
    parts = [dict(np.load(os.path.join(path, f"lm.{gen}.rank{r}.npz")))
             for r in range(world)]
    out = {}
    for k in parts[0]:
        if not k.startswith("fsdp/"):
            continue
        if k.endswith("/step"):
            out[k] = parts[0][k]
            out[k + "@same"] = np.array(all(
                (p[k] == parts[0][k]).all() for p in parts))
            continue
        out[k] = np.concatenate([p[k] for p in parts])[
            :orig[int(k.split("/")[2])]]
    return out


def elastic(n, out, failures, work, logs):
    """Part elastic (see the module docstring)."""
    import numpy as np
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.elastic import Supervisor, SupervisorConfig
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel.fsdp import make_fsdp_meta
    from chainermn_tpu_torch.utils.proc_world import spawn_world
    half = n // 2
    d = {k: os.path.join(work, f"elastic_{k}") for k in (
        "ckpt", "resumed", "next", "direct", "dumps", "out")}
    for v in d.values():
        os.makedirs(v, exist_ok=True)
    cfg = dict(ELASTIC, ckpt=d["ckpt"], resumed=d["resumed"],
               next=d["next"], direct_out=d["direct"], old_world=n)
    # NCCL survivors block in the next gather: their watchdogs find the
    # heartbeat lost (1.5 s), ask the peers for their states (0.5 s; the
    # dead one never answers) and probe the clocks before they dump
    env = {"ELASTIC_CFG": json.dumps(cfg),
           "CHAINERMN_TPU_WATCHDOG_HEARTBEAT": "0.2",
           "CHAINERMN_TPU_WATCHDOG_HB_TIMEOUT": "1.5",
           "CHAINERMN_TPU_WATCHDOG_POLL": "0.1",
           "CHAINERMN_TPU_WATCHDOG_COLLECT": "0.5"}
    sup = Supervisor(_ELASTIC_WORKER, SupervisorConfig(
        n_procs=n, device=ELASTIC_DEVICE, max_restarts=1,
        attempt_timeout_s=900, dump_dir=d["dumps"], out_dir=d["out"],
        ckpt_path=d["ckpt"], ckpt_name="lm", resize_schedule=[n, half],
        env=env, dump_grace_s=30.0, log_dir=os.path.join(logs, "elastic")))
    t0 = time.time()
    try:
        outcome = sup.run()
    except RuntimeError as e:
        failures.append(f"elastic: supervisor {e}"[:2000])
        out["elastic"] = {"attempts": sup.attempts}
        return
    res = {"seconds": round(time.time() - t0, 1),
           "attempts": [{k: a[k] for k in ("attempt", "world",
                                           "resume_generation",
                                           "duration_s")}
                        for a in outcome["attempts"]]}
    results = outcome["results"]
    gen = results[0]["gen"]
    res["generation"] = gen
    res["report"] = results[0]["report"]
    res["resume_s"] = max(r["resume_s"] for r in results.values())
    res["relaunch_start_s"] = max(r["start_s"] for r in results.values())
    man = json.load(open(outcome["manifests"][0]))
    res["manifest"] = {"reason": man["reason"],
                       "dumps": sorted(man["flight_dumps"]),
                       "dump_reasons": {r: x.get("reason") for r, x in
                                        man["flight_dumps"].items()},
                       "exit_codes": man["exit_codes"]}
    if res["manifest"]["dumps"] != [str(r) for r in range(n - 1)]:
        failures.append(f"elastic: the manifest holds dumps "
                        f"{res['manifest']['dumps']}, not every survivor's")
    model = TransformerLM(vocab=ELASTIC["vocab"], d_model=ELASTIC["d_model"],
                          n_layers=ELASTIC["layers"],
                          n_heads=ELASTIC["heads"], max_len=ELASTIC["seq"],
                          device="meta")
    orig = [bl.orig_lens[0] for bl in make_fsdp_meta(
        model, n, ELASTIC["buckets"]).buckets]
    saved = _lm_consolidated(d["ckpt"], gen, n, orig)
    back = _lm_consolidated(d["resumed"], gen, half, orig)
    res["leaves"] = len(saved)
    res["resharded_bytes"] = sum(int(v.nbytes) for k, v in saved.items()
                                 if "@" not in k)
    res["resumed_equal"] = set(saved) == set(back) and all(
        saved[k].dtype == back[k].dtype and np.array_equal(saved[k], back[k])
        for k in saved)
    if not res["resumed_equal"]:
        failures.append("elastic: the resumed state is not the saved one")
    # a half world from the consolidated state, directly
    direct = spawn_world(_ELASTIC_WORKER, n_procs=half,
                         device=ELASTIC_DEVICE, timeout=900,
                         log_dir=os.path.join(logs, "elastic_direct"),
                         env={"ELASTIC_CFG": json.dumps(cfg),
                              "ELASTIC_DIRECT": str(gen)})
    res["losses"] = {"resumed": results[0]["loss"],
                     "direct": direct[0]["loss"]}
    res["next_step_equal"] = res["losses"]["resumed"] == \
        res["losses"]["direct"] and all(
        {k: v.tobytes() for k, v in np.load(os.path.join(
            d["next"], f"lm.{gen + 1}.rank{r}.npz")).items()
         if k.startswith("fsdp/")} == {
            k: v.tobytes() for k, v in np.load(os.path.join(
                d["direct"], f"lm.{gen + 1}.rank{r}.npz")).items()
            if k.startswith("fsdp/")} for r in range(half))
    if not res["next_step_equal"]:
        failures.append(f"elastic: the next step differs {res['losses']}")
    busy = None
    for _ in range(30):
        busy = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.split()
        if not busy:
            break
        time.sleep(1.0)
    res["cards_free"] = not busy
    if busy:
        failures.append(f"elastic: processes left on the cards {busy}")
    # the attribution smoke on every card
    rc = subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.attribution_smoke",
         "--n-procs", str(n), "--out", os.path.join(logs,
                                                     "ATTRIBUTION.json"),
         "--dump-dir", os.path.join(work, "attr_dumps")]
        + (["--device", "cpu"] if ELASTIC_DEVICE == "cpu" else []),
        cwd=HERE, capture_output=True, text=True, timeout=600)
    res["attribution_smoke"] = {"rc": rc.returncode,
                                "tail": rc.stdout.strip().splitlines()[-4:]}
    if rc.returncode:
        failures.append(f"elastic: attribution_smoke rc {rc.returncode}: "
                        f"{rc.stderr[-1500:]}")
    print(json.dumps({"elastic": res}), flush=True)
    out["elastic"] = res


LINT_FLAVORS = ("naive", "flat", "hierarchical", "two_dimensional",
                "single_node", "non_cuda_aware", "xla")
LINT_DEVICE = None   # "cpu" runs the lint part's ranks on gloo


def lint_worker(out_prefix, flags):
    """One rank under ``torchrun``: each flavor's recorded
    ``allreduce_grad`` over the real groups, in census kinds, beside its
    plan's issued kinds, and the census-drift rule's findings."""
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch import create_communicator, init_distributed
    from chainermn_tpu_torch.analysis import (
        allreduce_schedule, census_schedule, lint_step)
    from chainermn_tpu_torch.planner.compiler import issued_census_kinds
    from chainermn_tpu_torch.planner.plans import flavor_plan
    topo = init_distributed(device=LINT_DEVICE)
    res = {"rank": topo.rank, "flavors": {}}
    for flavor in LINT_FLAVORS:
        kw = {"intra_size": 2} if flavor in ("hierarchical",
                                             "two_dimensional") else {}
        comm = create_communicator(flavor, device=LINT_DEVICE, **kw)
        sched = allreduce_schedule(comm)
        got = census_schedule(sched).kinds()
        want = issued_census_kinds(flavor_plan(flavor), comm.plan_topology())
        rep = lint_step(None, comm=comm, census=sched, name=flavor,
                        rules=["census-drift"], raise_on_error=False)
        res["flavors"][flavor] = {
            "census": list(got), "issued": list(want),
            "groups": [[op.kind, list(op.axes or ()), op.dtype]
                       for op in sched],
            "findings": [f.as_dict() for f in rep.findings]}
    comm = create_communicator("xla", device=LINT_DEVICE,
                               allreduce_grad_dtype="float16")
    res["wire"] = [[op.kind, op.dtype]
                   for op in allreduce_schedule(comm)]
    json.dump(res, open(f"{out_prefix}.rank{topo.rank}.json", "w"))


def static_analysis(n, out, failures, work, logs):
    """Part lint (see the module docstring)."""
    res = {}
    docs = torchrun(n, "lint", [], work, logs, kind="lint")
    for flavor in LINT_FLAVORS:
        rows = [d["flavors"][flavor] for d in docs]
        res[flavor] = {"census": rows[0]["census"],
                       "issued": rows[0]["issued"]}
        for r, row in enumerate(rows):
            if row["census"] != row["issued"] or row["findings"]:
                failures.append(f"lint: {flavor} rank {r} recorded "
                                f"{row['census']}, issued kinds "
                                f"{row['issued']}, findings "
                                f"{row['findings']}")
        if any(row["census"] != rows[0]["census"] for row in rows):
            failures.append(f"lint: {flavor}: the ranks recorded different "
                            "schedules")
    res["wire"] = docs[0]["wire"]
    if ["all-reduce", "f16"] not in docs[0]["wire"]:
        failures.append(f"lint: the float16 wire recorded {docs[0]['wire']}")
    overlap = os.path.join(logs, "DB_OVERLAP.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), "-m",
           "chainermn_tpu_torch.tools.check_db_overlap", "--out", overlap]
    if LINT_DEVICE is not None:
        cmd += ["--device", LINT_DEVICE]
    with open(os.path.join(logs, "db_overlap.log"), "w") as log:
        rc = subprocess.run(cmd, cwd=HERE, stdout=log,
                            stderr=subprocess.STDOUT, timeout=600).returncode
    doc = json.load(open(overlap)) if os.path.exists(overlap) else {}
    res["db_overlap"] = {"rc": rc, "verdict": doc.get("verdict"),
                         "n_all_reduce": doc.get("n_all_reduce"),
                         "pending_overlap_us": doc.get("pending_overlap_us"),
                         "names": doc.get("all_reduce_names")}
    if rc or not doc.get("ok") or not str(doc.get("verdict")).startswith(
            "split"):
        failures.append(f"lint: check_db_overlap rc {rc}: "
                        f"{doc.get('verdict')}")
    cont = os.path.join(logs, "CONTENTION.json")
    proc = subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.contention_smoke",
         "--n-procs", "2", "--device", LINT_DEVICE or "cuda", "--out", cont,
         "--dump-dir", os.path.join(work, "cont_dumps")],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    res["contention_smoke"] = {"rc": proc.returncode,
                               "tail": proc.stdout.strip().splitlines()[-7:]}
    if proc.returncode:
        failures.append(f"lint: contention_smoke rc {proc.returncode}: "
                        f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    print(json.dumps({"lint": res}), flush=True)
    out["lint"] = res


COLL_ELEMS = 553_897_984   # phase 11's LM's gradients (bf16: 1.108 GB)
COLL_WARMUP, COLL_ITERS = 3, 20
COLL_KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
              "broadcast")


def bus_factor(kind: str, n: int) -> float:
    """NCCL's bus-bandwidth factor of ``kind`` on ``n`` ranks (nccl-tests'
    convention: bytes = the whole buffer a rank holds)."""
    return {"all_reduce": 2 * (n - 1) / n, "broadcast": 1.0}.get(
        kind, (n - 1) / n)


def coll_worker(out_prefix, flags):
    """One rank under ``torchrun``: each collective of ``COLL_KINDS`` over
    ``elems`` bf16 elements, ``COLL_WARMUP`` + ``COLL_ITERS`` calls, each
    after a barrier and a device sync; per timed call this rank's
    CUDA-event ms (host ms on the CPU) and its host issue time; whether
    the last result equals the plain reference."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch import init_distributed
    elems = int(flags[flags.index("--elems") + 1]) if "--elems" in flags \
        else COLL_ELEMS
    iters = int(flags[flags.index("--iters") + 1]) if "--iters" in flags \
        else COLL_ITERS
    device = flags[flags.index("--device") + 1] if "--device" in flags \
        else None
    topo = init_distributed(device=device)
    dev, r, n = topo.device, topo.rank, dist.get_world_size()
    cuda = dev.type == "cuda"
    dt = torch.bfloat16
    part = elems // n
    # small integers: every sum of n of them is exact in bf16
    base = (torch.arange(elems, device=dev) % 7).to(dt)
    mine = (base + r).to(dt)
    res = {"rank": r, "world": n, "elems": elems, "kinds": {}}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for kind in COLL_KINDS:
        if kind == "all_reduce":
            buf = torch.empty_like(mine)
            prep, call = (lambda: buf.copy_(mine)), (
                lambda: dist.all_reduce(buf))
            want = lambda: (base * n + n * (n - 1) // 2).to(dt)  # noqa
            got = lambda: buf  # noqa: E731
        elif kind == "reduce_scatter":
            outb = torch.empty(part, dtype=dt, device=dev)
            prep, call = (lambda: None), (
                lambda: dist.reduce_scatter_tensor(outb, mine))
            want = lambda: (base[r * part:(r + 1) * part] * n  # noqa
                            + n * (n - 1) // 2).to(dt)
            got = lambda: outb  # noqa: E731
        elif kind == "all_gather":
            outb = torch.empty(part * n, dtype=dt, device=dev)
            src = mine[r * part:(r + 1) * part]
            prep, call = (lambda: None), (
                lambda: dist.all_gather_into_tensor(outb, src))
            want = lambda: torch.cat([(base[i * part:(i + 1) * part]  # noqa
                                       + i).to(dt) for i in range(n)])
            got = lambda: outb  # noqa: E731
        elif kind == "all_to_all":
            outb = torch.empty_like(mine)
            prep, call = (lambda: None), (
                lambda: dist.all_to_all_single(outb, mine))
            want = lambda: torch.cat([(base[r * part:(r + 1) * part]  # noqa
                                       + i).to(dt) for i in range(n)])
            got = lambda: outb  # noqa: E731
        else:
            buf = torch.empty_like(mine)
            prep, call = (lambda: buf.copy_(mine)), (
                lambda: dist.broadcast(buf, 0))
            want = lambda: base  # noqa: E731
            got = lambda: buf  # noqa: E731
        ms, issued = [], []
        for i in range(COLL_WARMUP + iters):
            prep()
            sync()
            dist.barrier()
            sync()
            t_issue = time.time()
            if cuda:
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                call()
                b.record()
                b.synchronize()
                t = a.elapsed_time(b)
            else:
                t0 = time.perf_counter()
                call()
                t = (time.perf_counter() - t0) * 1e3
            if i >= COLL_WARMUP:
                ms.append(t)
                issued.append(t_issue)
        sync()
        ok = bool(torch.equal(got(), want()))
        res["kinds"][kind] = {"ms": ms, "issued": issued, "ok": ok}
        del prep, call, got, want
        if cuda:
            torch.cuda.empty_cache()
    json.dump(res, open(f"{out_prefix}.rank{r}.json", "w"))
    dist.barrier()
    dist.destroy_process_group()


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2


def collectives(n, out, failures, work, logs, flags=()):
    """Part collectives (see the module docstring)."""
    try:
        smi = subprocess.run(["nvidia-smi", "nvlink", "-s"],
                             capture_output=True, text=True)
        with open(os.path.join(logs, "nvlink.txt"), "w") as f:
            f.write(smi.stdout + smi.stderr)
    except OSError as e:  # no nvidia-smi: a CPU rehearsal
        print(f"collectives: nvidia-smi nvlink -s: {e}", flush=True)
    res = {}
    for world in sorted({2, n}):
        docs = torchrun(world, f"coll{world}", list(flags), work, logs,
                        kind="coll")
        nbytes = docs[0]["elems"] * 2
        rows = {}
        for kind in COLL_KINDS:
            per = [d["kinds"][kind] for d in docs]
            slowest = [max(c) for c in zip(*(p["ms"] for p in per))]
            skew = [(max(c) - min(c)) * 1e3
                    for c in zip(*(p["issued"] for p in per))]
            med = _median(slowest)
            algbw = nbytes / (med / 1e3) / 1e9
            rows[kind] = {
                "ms_median": med, "ms_min": min(slowest), "ms": slowest,
                "algbw_GBps": algbw,
                "busbw_GBps": algbw * bus_factor(kind, world),
                "skew_ms_median": _median(skew), "skew_ms_max": max(skew),
                "exact": all(p["ok"] for p in per)}
            if not rows[kind]["exact"]:
                failures.append(f"collectives: {kind} on {world} ranks "
                                "differs from its reference")
            print(f"collectives world {world} {kind} over {nbytes} bytes: "
                  f"{med:.4f} ms median ({min(slowest):.4f} least), algbw "
                  f"{algbw:.1f} GB/s, busbw {rows[kind]['busbw_GBps']:.1f} "
                  f"GB/s; arrival skew median "
                  f"{rows[kind]['skew_ms_median']:.4f} ms, largest "
                  f"{rows[kind]['skew_ms_max']:.4f} ms", flush=True)
        res[str(world)] = {"bytes": nbytes, "kinds": rows}
    out["collectives"] = res


if __name__ == "__main__":
    _late_workers()
    if len(sys.argv) > 3 and sys.argv[1] == "--worker":
        WORKERS[sys.argv[2]](sys.argv[3], sys.argv[4:])
    else:
        sys.exit(main())
