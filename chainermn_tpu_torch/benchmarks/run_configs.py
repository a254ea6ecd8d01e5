"""The five BASELINE.json configs on GPUs, one JSON line each.

Counterpart of ``benchmarks/run_configs.py`` (BASELINE.json configs,
SURVEY.md section 6), in its names and order:

  1. mnist_mlp       -- MNIST MLP data-parallel, naive communicator, CPU
  2. resnet50_xla    -- ResNet-50 ImageNet, xla (pure_nccl), one node
  3. vgg16_cifar_db  -- VGG-16/CIFAR-10, double-buffered allreduce
  4. seq2seq_mp      -- seq2seq model-parallel (MultiNodeChainList), 2 ranks
  5. resnet50_hier   -- ResNet-50 on 4 ranks, hierarchical communicator

One process drives one GPU.  The card rows run the JAX TPU branch's full
shapes: ResNet-50 at 224 pixels, 128 a GPU; VGG-16 at 32 pixels, 256 a
GPU (both on the bfloat16 wire, double-buffered, SGD momentum 0.9); seq2seq
batch 128, length 16, vocabulary 32, hidden 128, two stages (Adam 2e-3);
ResNet-50 hierarchical with ``intra_size = n // 2`` (double-buffered).
Each is timed over ``--repeats`` windows of 20 steps after 5 of warm-up
(CUDA events; the median, its spread, and the device's own ms a step from
``utils.trace.device_time``).  ``mnist_mlp`` is by definition the naive
communicator on the CPU: from a card it runs on a gloo world of
``CPU_RANKS`` (8) CPU processes (the JAX package's 8-device CPU mesh),
which rank 0 starts, and its row says so.  ``seq2seq_mp`` needs 2 ranks and
``resnet50_hier`` 4: with fewer they raise, naming ``torchrun``.

``--device cpu`` runs the JAX CPU branch's smoke shapes (a two-stage
ResNet of 8 filters and a two-conv VGG at 32 pixels, batch 8, 5 steps
after 2, one window; metric names ending in ``_cpu_smoke``) on a gloo
world, and marks every row ``smoke: true``.  Without it and without a
card, it raises.  Every row carries the card's name and power limit
(``card``, None on the CPU) and ``wall_s``; rank 0 prints the rows (and
writes ``--out``), every rank returns them.

    python -m chainermn_tpu_torch.benchmarks.run_configs \\
        --configs resnet50_xla,vgg16_cifar_db,mnist_mlp
    torchrun --nproc_per_node 4 -m chainermn_tpu_torch.benchmarks.run_configs
    python -m chainermn_tpu_torch.benchmarks.run_configs --device cpu \\
        --configs mnist_mlp,resnet50_xla,vgg16_cifar_db

``--tune-remat`` sweeps JAX's remat policies over the ResNet configs
instead (:func:`tune_remat`), printing a ``remat_tune/v1`` document with
each policy's step time and peak device memory, and the selected one.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = ("mnist_mlp", "resnet50_xla", "vgg16_cifar_db", "seq2seq_mp",
           "resnet50_hier")
# processes of mnist_mlp's gloo world when run from a card: the JAX
# package's 8-device CPU mesh
CPU_RANKS = 8
TIMED_KEYS = ("repeats", "wall_ms_per_step_median", "wall_spread_pct",
              "device_ms_per_step")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _window(step, batch, steps, on_gpu):
    """``(seconds, loss)`` of ``steps`` calls: between CUDA events on the
    card (the device's end), on the host's clock on the CPU."""
    if on_gpu:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(batch)
    if on_gpu:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, float(loss)
    return time.perf_counter() - t0, float(loss)


def _timed(step, batch, *, steps, warmup, repeats, on_gpu):
    """Warm up, then ``repeats`` windows of ``steps`` calls: the median
    window, its spread and (on the card) the device's ms a step."""
    if warmup:
        _window(step, batch, warmup, on_gpu)
    runs = [_window(step, batch, steps, on_gpu) for _ in range(repeats)]
    dts = [dt for dt, _ in runs]
    out = {"seconds": float(np.median(dts)), "final_loss": runs[-1][1]}
    if repeats > 1:
        out.update(repeats=repeats,
                   wall_ms_per_step_median=out["seconds"] / steps * 1e3,
                   wall_spread_pct=100 * (max(dts) - min(dts))
                   / out["seconds"])
    if on_gpu:
        from chainermn_tpu_torch.utils.trace import device_time
        out["device_ms_per_step"] = device_time(step, (batch,), steps=5,
                                                warmup=1)
    return out


def _dp_image_bench(model, comm, *, image, n_classes, per_gpu_batch,
                    steps, warmup, repeats):
    """The data-parallel image step of configs 2, 3 and 5: SGD momentum
    0.9 at lr 0.1 through the double-buffered multi-node optimizer, on the
    JAX harness's data (``RandomState(0)``, NHWC, this rank's rows).
    Returns :func:`_timed`'s dict with images/sec per GPU."""
    import chainermn_tpu_torch as cmn
    dev = comm.device
    comm.bcast_data(model)
    optimizer = cmn.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm,
        double_buffering=True)
    step = cmn.make_train_step(
        comm, lambda b: F.cross_entropy(model(b[0]), b[1]), optimizer)
    model.train()
    rng = np.random.RandomState(0)
    n = per_gpu_batch * comm.size
    x = rng.randn(n, image, image, 3).astype(np.float32)
    y = (rng.rand(n) * n_classes).astype(np.int64)
    rows = slice(comm.rank * per_gpu_batch, (comm.rank + 1) * per_gpu_batch)
    batch = (torch.from_numpy(x[rows]).permute(0, 3, 1, 2).contiguous()
             .to(dev), torch.from_numpy(y[rows]).to(dev))
    out = _timed(step, batch, steps=steps, warmup=warmup, repeats=repeats,
                 on_gpu=dev.type == "cuda")
    step.finalize()
    out["per_gpu"] = per_gpu_batch * steps / out["seconds"]
    return out


def _image_row(config, metric, comm, communicator, r):
    return {"config": config, "metric": metric, "value": r["per_gpu"],
            "unit": "images/sec/GPU" if comm.device.type == "cuda"
            else "images/sec/process", "devices": comm.size,
            "communicator": communicator, "final_loss": r["final_loss"],
            **{k: r[k] for k in TIMED_KEYS if k in r}}


# --------------------------------------------------------------------------
# 1. MNIST MLP, naive communicator, CPU
# --------------------------------------------------------------------------
def bench_mnist_mlp(args, dev):
    if dev.type == "cuda":
        row = None
        if dist.get_rank() == 0:
            row = spawn_cpu_world(CPU_RANKS)
            row.pop("smoke")  # the config's own shape, CPU by definition
        box = [row]
        dist.broadcast_object_list(box, src=0)
        return box[0]
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import MLP
    comm = cmn.create_communicator("naive", device=dev)
    model = MLP(1000, 10, device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
    comm.bcast_data(model)
    optimizer = cmn.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm)
    step = cmn.make_train_step(
        comm, lambda b: F.cross_entropy(model(b[0]), b[1]), optimizer)
    rng = np.random.RandomState(0)
    n = 100 * comm.size
    x = rng.randn(n, 784).astype(np.float32)
    y = (rng.rand(n) * 10).astype(np.int64)
    rows = slice(comm.rank * 100, (comm.rank + 1) * 100)
    batch = (torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    r = _timed(step, batch, steps=50, warmup=5, repeats=1, on_gpu=False)
    return {"config": "mnist_mlp",
            "metric": "mnist_mlp_naive_cpu_train_throughput",
            "value": n * 50 / r["seconds"], "unit": "images/sec",
            "devices": comm.size, "communicator": "naive",
            "final_loss": r["final_loss"],
            "world": f"gloo, {comm.size} CPU processes"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_cpu_world(ranks: int, timeout: float = 600.0) -> dict:
    """``mnist_mlp`` on a gloo world of ``ranks`` CPU processes started
    here (one thread each, no card in sight): rank 0's row."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                        "ROLE_RANK", "ROLE_WORLD_SIZE")}
    env.update(WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [HERE] + [p for p in [env.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "chainermn_tpu_torch.benchmarks.run_configs",
           "--configs", "mnist_mlp", "--device", "cpu"]
    procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r)}, cwd=HERE,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(ranks)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise RuntimeError(f"mnist_mlp's CPU world: rank {r} exited "
                               f"{p.returncode}:\n{out[-3000:]}")
    lines = [l for l in outs[0].splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


# --------------------------------------------------------------------------
# 2. ResNet-50, xla communicator (pure_nccl), one node
# --------------------------------------------------------------------------
def bench_resnet50_xla(args, dev):
    import chainermn_tpu_torch as cmn
    on_gpu = dev.type == "cuda"
    comm = cmn.create_communicator(
        "xla", allreduce_grad_dtype="bfloat16" if on_gpu else None,
        device=dev)
    model, kw = _resnet(on_gpu, dev, args.repeats)
    r = _dp_image_bench(model, comm, **kw)
    return _image_row("resnet50_xla", "resnet50_xla_train_throughput"
                      if on_gpu else "resnet50_xla_cpu_smoke", comm,
                      "xla(bf16)" if on_gpu else "xla", r)


def _resnet(on_gpu, dev, repeats):
    from chainermn_tpu_torch.models import ResNet, ResNet50
    from chainermn_tpu_torch.models.resnet import BasicBlock
    gen = torch.Generator(device=dev).manual_seed(0)
    if on_gpu:
        return (ResNet50(num_classes=1000, dtype=torch.bfloat16, device=dev,
                         generator=gen),
                dict(image=224, n_classes=1000, per_gpu_batch=128,
                     steps=20, warmup=5, repeats=repeats))
    return (ResNet(stage_sizes=(1, 1), block_cls=BasicBlock, num_filters=8,
                   num_classes=10, device=dev, generator=gen),
            dict(image=32, n_classes=10, per_gpu_batch=8, steps=5, warmup=2,
                 repeats=1))


# --------------------------------------------------------------------------
# 3. VGG-16 / CIFAR-10, double-buffered allreduce
# --------------------------------------------------------------------------
def bench_vgg16_cifar_db(args, dev):
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import VGG, VGG16
    on_gpu = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    if on_gpu:
        model = VGG16(num_classes=10, dtype=torch.bfloat16, device=dev,
                      generator=gen)
        kw = dict(image=32, n_classes=10, per_gpu_batch=256, steps=20,
                  warmup=5, repeats=args.repeats)
    else:
        model = VGG(cfg=(16, "M", 32, "M"), hidden=64, num_classes=10,
                    device=dev, generator=gen)
        kw = dict(image=32, n_classes=10, per_gpu_batch=8, steps=5,
                  warmup=2, repeats=1)
    model.dropout_generator.manual_seed(1)  # the JAX harness's dropout key
    comm = cmn.create_communicator(
        "xla", allreduce_grad_dtype="bfloat16" if on_gpu else None,
        device=dev)
    r = _dp_image_bench(model, comm, **kw)
    return _image_row(
        "vgg16_cifar_db",
        "vgg16_cifar10_double_buffered_train_throughput" if on_gpu
        else "vgg16_cifar10_db_cpu_smoke", comm,
        "xla(bf16)+double_buffering" if on_gpu else "xla+double_buffering",
        r)


# --------------------------------------------------------------------------
# 4. seq2seq model-parallel over send/recv
# --------------------------------------------------------------------------
def _need_ranks(config, n):
    size = dist.get_world_size()
    if size < n:
        raise RuntimeError(
            f"{config} needs {n} ranks, and this world has {size}: run it "
            f"under torchrun --nproc_per_node {n} (one process per GPU)")


def bench_seq2seq_mp(args, dev):
    _need_ranks("seq2seq_mp", 2)
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.examples.seq2seq import build_model
    from chainermn_tpu_torch.links import pseudo_loss
    from chainermn_tpu_torch.models.seq2seq import make_copy_reverse_task
    from chainermn_tpu_torch.optimizers import create_per_stage_optimizer
    batch, seq_len, vocab, hidden, steps, warmup = 128, 16, 32, 128, 20, 3
    on_gpu = dev.type == "cuda"
    comm = create_communicator("xla", device=dev)
    # encoder on rank 0, decoder on rank 1 (the other ranks idle)
    model = build_model(comm, vocab, vocab, 64, hidden)
    opt = create_per_stage_optimizer(
        lambda ps: torch.optim.Adam(ps, lr=2e-3))
    opt.init(model)
    src, tgt_in, tgt = (torch.from_numpy(a).long().to(dev)
                        for a in make_copy_reverse_task(batch, seq_len,
                                                        vocab))

    def step(_):
        opt.zero_grad()
        out = model(src, stage_inputs={1: (tgt_in,)})
        loss = (F.cross_entropy(out.flatten(0, 1), tgt.flatten())
                if model.owns_output else pseudo_loss(out))
        loss.backward()
        opt.step()
        return loss.detach()

    r = _timed(step, None, steps=steps, warmup=warmup,
               repeats=args.repeats if on_gpu else 1, on_gpu=on_gpu)
    box = [{**r, "value": batch * 2 * seq_len * steps / r["seconds"]}]
    dist.broadcast_object_list(box, src=model.stage_owner(1))
    r = box[0]  # the decoder's rank, which holds the loss
    return {"config": "seq2seq_mp",
            "metric": "seq2seq_model_parallel_throughput" if on_gpu
            else "seq2seq_model_parallel_cpu_smoke",
            "value": r["value"], "unit": "tokens/sec",
            "devices": comm.size,
            "communicator": "xla send/recv (MultiNodeChainList, 2 stages)",
            "final_loss": r["final_loss"],
            **{k: r[k] for k in TIMED_KEYS if k in r}}


# --------------------------------------------------------------------------
# 5. ResNet-50 on several nodes, hierarchical communicator
# --------------------------------------------------------------------------
def bench_resnet50_hier(args, dev):
    _need_ranks("resnet50_hier", 4)
    import chainermn_tpu_torch as cmn
    on_gpu = dev.type == "cuda"
    n = dist.get_world_size()
    comm = cmn.create_communicator("hierarchical", intra_size=n // 2,
                                   device=dev)
    model, kw = _resnet(on_gpu, dev, args.repeats)
    r = _dp_image_bench(model, comm, **kw)
    return _image_row(
        "resnet50_hier", "resnet50_hierarchical_multigpu_train_throughput"
        if on_gpu else "resnet50_hierarchical_cpu_smoke", comm,
        f"hierarchical (inter={comm.inter_size} x intra={comm.intra_size})",
        r)


# --------------------------------------------------------------------------
# --tune-remat: the remat policies over the ResNet configs
# --------------------------------------------------------------------------
def tune_remat(args, dev, card) -> dict:
    """Sweep :data:`~chainermn_tpu_torch.models.resnet.REMAT_POLICIES`
    (none / every residual block recomputed / only the norm tails
    recomputed) over ``resnet50_xla``, and over ``resnet50_hier`` on a
    world of four ranks or more, with the fused BatchNorm kernels at every
    boundary; pick each config's policy by its measured step time.  Returns
    the ``remat_tune/v1`` document (JAX's keys, plus each row's peak device
    memory and ``card``).  The card rows are ResNet-50 at 224 pixels, 128 a
    GPU, 10 steps after 3 of warm-up in ``--repeats`` windows; the CPU rows
    the smoke ResNet (batch 8, 3 steps after 1, one window)."""
    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import ResNet, ResNet50
    from chainermn_tpu_torch.models.resnet import REMAT_POLICIES, BasicBlock
    on_gpu = dev.type == "cuda"
    n = dist.get_world_size()

    def model_kw(policy):
        gen = torch.Generator(device=dev).manual_seed(0)
        if on_gpu:
            return (ResNet50(num_classes=1000, dtype=torch.bfloat16,
                             remat_policy=policy, device=dev, generator=gen),
                    dict(image=224, n_classes=1000, per_gpu_batch=128,
                         steps=10, warmup=3, repeats=args.repeats))
        return (ResNet(stage_sizes=(1, 1), block_cls=BasicBlock,
                       num_filters=8, num_classes=10, remat_policy=policy,
                       device=dev, generator=gen),
                dict(image=32, n_classes=10, per_gpu_batch=8, steps=3,
                     warmup=1, repeats=1))

    comms = {"resnet50_xla": lambda: cmn.create_communicator(
        "xla", allreduce_grad_dtype="bfloat16" if on_gpu else None,
        device=dev)}
    if n >= 4:
        comms["resnet50_hier"] = lambda: cmn.create_communicator(
            "hierarchical", intra_size=n // 2, device=dev)
    sweeps = {}
    for config, mk_comm in comms.items():
        rows = {}
        for policy in REMAT_POLICIES:
            model, kw = model_kw(policy)
            comm = mk_comm()
            if dist.get_rank() == 0:
                log(f"tune-remat {config}/{policy}: starting (device {dev}, "
                    f"world {comm.size})")
            if on_gpu:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            r = _dp_image_bench(model, comm, **kw)
            rows[policy] = {
                "ms_per_step": r["seconds"] / kw["steps"] * 1e3,
                "images_per_sec_per_gpu": r["per_gpu"],
                "final_loss": r["final_loss"],
                "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9
                if on_gpu else None,
                **{k: r[k] for k in TIMED_KEYS if k in r}}
            del model
            if on_gpu:
                torch.cuda.empty_cache()
            if dist.get_rank() == 0:
                log(f"tune-remat {config}/{policy}: "
                    f"{rows[policy]['ms_per_step']:.3f} ms/step, peak "
                    f"{rows[policy]['peak_memory_gb']} GB")
        selected = min(rows, key=lambda p: rows[p]["ms_per_step"])
        sweeps[config] = {"rows": rows, "selected": selected,
                          "selected_ms_per_step":
                              rows[selected]["ms_per_step"]}
    return {"schema": "remat_tune/v1", "backend": dev.type,
            # a CPU run exercises the path; the card's run selects
            "smoke": not on_gpu, "fused_norm": True,
            "policies": list(REMAT_POLICIES),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "card": card, "configs": sweeps}


BENCHES = {"mnist_mlp": bench_mnist_mlp, "resnet50_xla": bench_resnet50_xla,
           "vgg16_cifar_db": bench_vgg16_cifar_db,
           "seq2seq_mp": bench_seq2seq_mp,
           "resnet50_hier": bench_resnet50_hier}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--configs", default=None,
                   help="comma-separated subset (default: all five)")
    p.add_argument("--out", default=None,
                   help="also write the rows to this JSON file (rank 0)")
    p.add_argument("--repeats", type=int, default=5,
                   help="timed windows per card row (median reported with "
                        "its spread; default 5)")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU "
                        "smoke shapes)")
    p.add_argument("--tune-remat", action="store_true",
                   help="instead of the configs, sweep the remat policies "
                        "(none/block/norm) over the ResNet configs with the "
                        "fused norm kernels and select each config's by "
                        "step time (remat_tune/v1 document)")
    args = p.parse_args(argv)
    if args.tune_remat and args.configs:
        p.error("--tune-remat sweeps the ResNet configs (resnet50_xla, and "
                "resnet50_hier on four ranks); --configs does not apply")
    if args.repeats < 1:
        p.error("--repeats must be >= 1")
    wanted = args.configs.split(",") if args.configs else list(CONFIGS)
    unknown = set(wanted) - set(CONFIGS)
    if unknown:
        p.error(f"unknown configs: {sorted(unknown)}; available: "
                f"{list(CONFIGS)}")
    args.wanted = [c for c in CONFIGS if c in wanted]
    return args


def main(argv=None):
    """Run the configs asked for; returns their rows (every rank), or the
    ``remat_tune/v1`` document with ``--tune-remat``."""
    from chainermn_tpu_torch.runtime.bootstrap import init_distributed
    from chainermn_tpu_torch.utils.gpu_info import smi_line
    args = parse_args(argv)
    topo = init_distributed(args.device)
    dev = topo.device
    card = smi_line(dev.index or 0) if dev.type == "cuda" else None
    if args.tune_remat:
        doc = tune_remat(args, dev, card)
        if topo.rank == 0:
            payload = json.dumps(doc, indent=2)
            print(payload, flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    f.write(payload + "\n")
                log(f"wrote {args.out}")
        return doc
    rows = []
    for name in args.wanted:
        if topo.rank == 0:
            log(f"config {name}: starting (device {dev}, world "
                f"{dist.get_world_size()})")
        t0 = time.perf_counter()
        row = BENCHES[name](args, dev)
        row["wall_s"] = time.perf_counter() - t0
        row["card"] = card
        if dev.type != "cuda":
            # a CPU run exercises the path; its numbers are no evidence of
            # the card's
            row["smoke"] = True
        rows.append(row)
        if topo.rank == 0:
            print(json.dumps(row), flush=True)
    if args.out and topo.rank == 0:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
        log(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
