"""Data-parallel ImageNet training on GPUs, ChainerMN style.

Counterpart of ``examples/imagenet/train_imagenet.py``: create a
communicator, scatter the dataset, wrap the optimizer so every step
averages the gradients, and train.  One process drives one GPU; launch
several with ``torchrun`` (or set ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT``/``LOCAL_RANK`` yourself).  The data is synthetic by default
(class-dependent channel means, so the loss can fall; the JAX example's
images from the same seed, transposed to NCHW), or real:

* ``--data DIR``: an ImageFolder (``DIR/<class>/<image>``) decoded at short
  side ``round(image * 256 / 224)``, ``--n-classes`` taken from the folder,
  each sample augmented on the host (random-sized crop and flip,
  ``Augment(train=True, seed)``);
* ``--train-root FILE.npz``: ``x``/``y`` (or ``x_train``/``y_train``) NHWC
  arrays; uint8 images of another size than ``--image-size`` are augmented
  the same way;
* ``--val-data DIR``: an ImageFolder evaluated every epoch through the
  center-crop transform (without it, a synthetic validation set only
  beside synthetic training data).

The host decodes and augments in uint8 on ``--loader-workers`` threads,
``--prefetch`` batches ahead of the step (:class:`PrefetchIterator`;
``--prefetch 0`` runs without the loader thread, for collatable data
only); uint8 batches travel pinned and asynchronously, become NCHW
``channels_last`` views on the device and are normalized at the head of
the loss (:func:`normalize_image`); labels are cast on the device.  The
architectures are the reference's ``alex``, ``googlenet``,
``googlenetbn``, ``nin`` and ``resnet50``, and the JAX example's
``vit_s16`` and ``vit_b16`` (plain attention, as there).  The BatchNorm
archs (ResNet-50, GoogLeNetBN) run the fused BatchNorm(+ReLU) kernels.
``--accum-steps K`` splits each GPU's batch into K microbatches whose
gradients are averaged before the one all-reduce of the step (ghost-batch
BatchNorm, as in JAX).  ``--aux-loss`` trains GoogLeNet's auxiliary heads
(``loss3 + 0.3 loss1 + 0.3 loss2``).  Dropout masks come from the model's
generator, reseeded every step from (seed, iteration, rank), and under
``--accum-steps K`` every microbatch from (seed, K iteration + microbatch,
rank), as JAX's seed stamp gives each its own.  The fork's "ImageNet in 15
minutes" configuration is the float16 wire with double buffering:

    python -m chainermn_tpu_torch.examples.train_imagenet --arch resnet50 \\
        --communicator xla --batchsize 32 --iterations 20 \\
        --allreduce-grad-dtype float16 --double-buffering

The JAX example's training flags are here too: ``--zero`` (ZeRO-1
optimizer-state sharding), ``--optimizer momentum|lars|adam``,
``--warmup-epochs`` (linear warmup, then cosine decay, as optax's
``warmup_cosine_decay_schedule``), ``--val-size`` (a synthetic validation
set through the multi-node evaluator), ``--intra-size`` and
``--checkpoint DIR`` with auto-resume: snapshots every epoch (or every
``--checkpoint-freq`` iterations) hold the model's parameters and
BatchNorm buffers, the optimizer's state (this rank's shards under
``--zero``), the pending gradient mean of ``--double-buffering``, the
iterator's position (after the last batch a step consumed, whatever the
loader drew ahead) and the iteration; a run started on a directory that
holds a generation every rank can read resumes from the newest such one,
and then trains as the uninterrupted run would have.
``AllreducePersistent`` averages the BatchNorm running statistics over the
world at every epoch end.  ``--communicator auto --plan-table FILE`` runs
each gradient mean through the plan the tuned table picks for its size
(:mod:`chainermn_tpu_torch.planner`).

``--fsdp`` trains with ZeRO-3 (:mod:`chainermn_tpu_torch.parallel.fsdp`):
the parameters and the optimizer's state live as 1/size flat shards per
rank and are gathered inside the step, in ``--fsdp-buckets`` buckets under
the step's default prefetch window (one gather ahead of the bucket in use);
``--allreduce-grad-dtype`` is then the wire of both collectives.  A snapshot holds the shards and their
optimizer state (the FSDP state is the parameters) beside the BatchNorm
buffers; the evaluator runs on the gathered parameters, and at the end of
training the module holds them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.datasets import (
    Augment, ImageFolderDataset, NpzImageDataset, PrefetchIterator,
    TransformDataset, TupleDataset, normalize_image)
from chainermn_tpu_torch.extensions import (
    AllreducePersistent, create_multi_node_checkpointer,
    create_multi_node_evaluator, make_eval_fn)
from chainermn_tpu_torch.extensions.allreduce_persistent import (
    persistent_buffers)
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import (
    NIN, AlexNet, GoogLeNet, GoogLeNetBN, ResNet50, ViT_B16, ViT_S16)
from chainermn_tpu_torch.models.layers import dropout_seed
from chainermn_tpu_torch.optim import (
    LARS, init_optimizer_state, load_optimizer_state_tree,
    optimizer_state_tree, warmup_cosine_decay_schedule)
from chainermn_tpu_torch.parallel.fsdp import (
    fsdp_full_params, fsdp_init, fsdp_module_params, load_module_params,
    make_fsdp_train_step)
from chainermn_tpu_torch.training import (
    FsdpStatefulUpdater, FsdpUpdater, StatefulUpdater, Trainer, extensions)
from chainermn_tpu_torch.utils.trace import KERNEL_CATEGORIES, kernel_category

ARCHS = {"alex": AlexNet, "googlenet": GoogLeNet,
         "googlenetbn": GoogLeNetBN, "nin": NIN, "resnet50": ResNet50,
         "vit_s16": ViT_S16, "vit_b16": ViT_B16}
AUX_ARCHS = ("googlenet", "googlenetbn")
OPTIMIZERS = {
    "momentum": lambda ps, lr: torch.optim.SGD(ps, lr=lr, momentum=0.9),
    "lars": lambda ps, lr: LARS(ps, lr=lr, momentum=0.9),
    "adam": lambda ps, lr: torch.optim.Adam(ps, lr=lr),
}


def make_synthetic_imagenet(n, image, n_classes, seed):
    """The JAX example's synthetic set (the same ``RandomState`` draws:
    labels, then NHWC images whose channel means depend on the class),
    transposed to NCHW float32."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) * n_classes).astype(np.int64)
    x = rng.randn(n, image, image, 3).astype(np.float32)
    x += (y % 8).reshape(-1, 1, 1, 1) * 0.3
    return TupleDataset(np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y)


def build_model(args, device, generator):
    """``--arch`` at ``--n-classes``, ``--dtype`` and ``--image-size`` on
    ``device`` (ResNet-50 at ``--width``; GoogLeNet with its aux heads
    under ``--aux-loss``)."""
    kw = dict(num_classes=args.n_classes, dtype=getattr(torch, args.dtype),
              device=device, generator=generator)
    if args.arch == "resnet50":
        kw["num_filters"] = args.width
    elif args.arch in ("alex", "vit_s16", "vit_b16"):
        kw["image_size"] = args.image_size
    elif args.arch in AUX_ARCHS:
        kw.update(image_size=args.image_size, aux_heads=args.aux_loss)
    return ARCHS[args.arch](**kw)


def objective(out, y):
    """``(loss, logits)`` of a model's training output: the cross-entropy
    of the logits, plus 0.3 x each aux head's when the model returns
    ``(logits, aux)`` (GoogLeNet's recipe, ``--aux-loss``)."""
    logits, aux = out if isinstance(out, tuple) else (out, ())
    loss = F.cross_entropy(logits, y)
    for a in aux:
        loss = loss + 0.3 * F.cross_entropy(a, y)
    return loss, logits


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="chainermn_tpu_torch ImageNet "
                                "example")
    p.add_argument("--arch", "-a", default="resnet50", choices=sorted(ARCHS))
    p.add_argument("--width", type=int, default=64,
                   help="the ResNet's base width (64: the published one; "
                        "resnet50 only)")
    p.add_argument("--batchsize", "-B", type=int, default=32,
                   help="per-GPU minibatch size")
    p.add_argument("--epoch", "-E", type=int, default=1)
    p.add_argument("--iterations", type=int, default=None,
                   help="stop after this many steps (overrides --epoch)")
    p.add_argument("--communicator", default="xla")
    p.add_argument("--plan-table", default=None,
                   help="the auto communicator's plan table (a JSON file "
                        "from planner.autotune_from_rows over "
                        "bench_allreduce --sweep rows)")
    p.add_argument("--intra-size", type=int, default=None,
                   help="ranks per node (default: LOCAL_WORLD_SIZE)")
    p.add_argument("--allreduce-grad-dtype", default=None,
                   help="communication dtype (xla communicator only), "
                        "e.g. float16")
    p.add_argument("--double-buffering", action="store_true",
                   help="overlap gradient allreduce with compute "
                        "(1-step-stale gradients)")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 optimizer-state sharding (exclusive with "
                        "--double-buffering)")
    p.add_argument("--optimizer", default="momentum",
                   choices=sorted(OPTIMIZERS),
                   help="momentum = the reference's MomentumSGD; lars = "
                        "layer-wise trust-ratio scaling; adam")
    p.add_argument("--warmup-epochs", type=float, default=0.0,
                   help="linear LR warmup over this many epochs, then "
                        "cosine decay to 0 at the end of --epoch epochs "
                        "(0 = constant LR)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--n-classes", type=int, default=1000)
    p.add_argument("--train-size", type=int, default=1024,
                   help="synthetic examples in all (scattered over ranks; "
                        "no --data/--train-root)")
    p.add_argument("--val-size", type=int, default=512,
                   help="synthetic validation examples in all, evaluated "
                        "at every epoch end over the world (0: none; only "
                        "beside synthetic training data)")
    p.add_argument("--train-root", default=None, metavar="FILE",
                   help="npz with x/y (or x_train/y_train) NHWC arrays")
    p.add_argument("--data", default=None, metavar="DIR",
                   help="ImageFolder root (DIR/<class>/<img>); images are "
                        "decoded, augmented (random-sized crop + flip) and "
                        "prefetched on the host, shipped uint8, normalized "
                        "on the device")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches prepared ahead by the loader thread (0: "
                        "no loader thread; collatable data only)")
    p.add_argument("--loader-workers", type=int, default=4,
                   help="host threads decoding and augmenting samples")
    p.add_argument("--val-data", default=None, metavar="DIR",
                   help="ImageFolder root for validation (center-crop "
                        "transform; evaluated over the world every epoch)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each GPU's batch into "
                        "this many microbatches (~1/K activation memory; "
                        "exact for BN-free archs, ghost-batch BatchNorm for "
                        "the others)")
    p.add_argument("--lr", type=float, default=0.1,
                   help="(peak) learning rate")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="multi-node snapshots into DIR, with auto-resume "
                        "from the newest generation every rank holds")
    p.add_argument("--checkpoint-freq", type=int, default=None, metavar="N",
                   help="snapshot every N iterations (default: every "
                        "epoch)")
    p.add_argument("--checkpoint-keep", type=int, default=2)
    p.add_argument("--out", "-o", default=None,
                   help="directory for rank 0's per-epoch log (default: no "
                        "files)")
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
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3/FSDP: parameters AND optimizer state "
                        "sharded per GPU, gathered inside the step "
                        "(exclusive with --zero/--double-buffering)")
    p.add_argument("--fsdp-buckets", type=int, default=1,
                   help="--fsdp: parameter buckets, each gathered and "
                        "reduce-scattered on its own")
    p.add_argument("--aux-loss", action="store_true",
                   help="googlenet/googlenetbn only: train with the "
                        "auxiliary classifier heads (loss1*0.3 + loss2*0.3 "
                        "+ loss3, the reference recipe)")
    args = p.parse_args(argv)
    if args.aux_loss and args.arch not in AUX_ARCHS:
        p.error("--aux-loss only applies to googlenet/googlenetbn")
    if args.arch != "resnet50" and args.width != p.get_default("width"):
        p.error("--width sets the ResNet's base width; --arch "
                f"{args.arch} has no such option")
    if args.zero and args.double_buffering:
        p.error("--zero and --double-buffering are mutually exclusive")
    if args.plan_table and args.communicator != "auto":
        p.error("--plan-table is the auto communicator's")
    if args.fsdp and (args.zero or args.double_buffering):
        p.error("--fsdp already shards params+grads+state; --zero and "
                "--double-buffering do not compose with it")
    if (args.zero or args.fsdp) and args.optimizer == "lars":
        p.error("--zero/--fsdp flatten parameters into per-rank shards, "
                "which destroys LARS's per-layer trust ratios -- use "
                "--optimizer momentum/adam")
    if args.accum_steps < 1 or args.batchsize % args.accum_steps:
        p.error("--accum-steps must divide --batchsize")
    return args


def profile_steps(updater, steps: int, device,
                  categories=KERNEL_CATEGORIES) -> dict:
    """Run ``steps`` more steps under ``torch.profiler``; returns wall ms
    per step, device kernel ms per step by category (``(name, kernel-name
    fragments)`` pairs, first match wins), and the device's busy share
    (kernel time over wall time; streams assumed not to overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            updater.update()
        updater.finalize()
        torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_cat: dict = {}
    by_kernel = []
    for e in prof.key_averages():
        # device-side kernels only; a user annotation (such as
        # "Optimizer.step#SGD.step") spans kernels counted on their own
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or "#" in e.key:
            continue
        ms = e.self_device_time_total / 1e3 / steps
        cat = kernel_category(e.key, categories)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        by_kernel.append((ms, e.key[:80]))
    busy = sum(by_cat.values())
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "device_ms_by_category": by_cat,
            "top_kernels": [[k, ms] for ms, k in sorted(by_kernel)[::-1][:10]]}


def main(argv=None) -> dict:
    """Train; returns ``{"losses", "images_per_sec", "iterations",
    "world", "log", "resumed_from", "save_seconds", "peak_memory_gb",
    "model", "optimizer", "fsdp_state", "fsdp_meta", "step_stats"}``
    (images/sec over this run's steps after ``--warmup-steps``, summed
    over the world; ``resumed_from`` the
    iteration of the snapshot it resumed from, or None; ``save_seconds``
    each snapshot's; the run's peak device memory, None on the CPU;
    under ``--fsdp`` the FsdpState, its meta and the last step's
    collective counts), plus ``"profile"`` with ``--profile-steps``."""
    args = parse_args(argv)
    comm = cmn.create_communicator(
        args.communicator, allreduce_grad_dtype=args.allreduce_grad_dtype,
        intra_size=args.intra_size, device=args.device,
        **({"plan_table": args.plan_table} if args.plan_table else {}))
    device = comm.device
    if comm.rank == 0:
        print(f"==========================================\n"
              f"Num processes (GPUs): {comm.size} (intra {comm.intra_size})\n"
              f"Using {args.communicator} communicator, arch {args.arch}, "
              f"optimizer {args.optimizer}"
              f"{' (ZeRO-1)' if args.zero else ''}"
              f"{f' (FSDP, {args.fsdp_buckets} buckets)' if args.fsdp else ''}"
              f"\n"
              f"Minibatch/GPU: {args.batchsize}, dtype: {args.dtype}, "
              f"device: {device}\n"
              f"==========================================", flush=True)

    train, augment = load_train(args)
    train = cmn.scatter_dataset(train, comm, shuffle=True, seed=args.seed)
    # examples uncollated when a per-sample transform runs: the loader
    # decodes, augments and collates ahead of the step
    base_iter = SerialIterator(train, args.batchsize, shuffle=True,
                               seed=args.seed, collate=augment is None)
    if args.prefetch <= 0 and augment is not None:
        raise SystemExit("--prefetch 0 requires collatable data "
                         "(no --data folder / augmentation)")
    # the real-image datasets are NHWC (and uint8 but for a float npz)
    nhwc = bool(args.data or args.train_root)
    val = load_val(args)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(args, device, gen)
    comm.bcast_data(model)
    # the LR schedule, sized in updates from the scattered dataset over
    # --epoch epochs (--iterations may stop the run before or after)
    iters_per_epoch = max(1, len(train) // args.batchsize)
    schedule = None
    if args.warmup_epochs > 0:
        warmup = max(1, int(args.warmup_epochs * iters_per_epoch))
        schedule = warmup_cosine_decay_schedule(
            0.0, args.lr, warmup,
            max(args.epoch * iters_per_epoch, warmup + 1))
    base = OPTIMIZERS[args.optimizer](model.parameters(), args.lr)
    fsdp_state = meta = optimizer = None
    if args.fsdp:
        # ZeRO-3: the gather/scatter collectives are the multi-node
        # integration, and the state's inner optimizer steps the shards
        fsdp_state, meta = fsdp_init(comm, model, base,
                                     num_buckets=args.fsdp_buckets)
        local_opt = fsdp_state.inner
    else:
        optimizer = cmn.create_multi_node_optimizer(
            base, comm, double_buffering=args.double_buffering,
            zero=args.zero)
        local_opt = optimizer.local_optimizer

    dropout_gen = getattr(model, "dropout_generator", None)
    micro = [0]  # microbatches of this step so far

    def loss_fn(batch):
        x, y = batch
        if dropout_gen is not None:
            # JAX's seed stamp: step * K + microbatch
            dropout_gen.manual_seed(dropout_seed(
                args.seed, updater.iteration * args.accum_steps + micro[0],
                comm.rank))
            micro[0] += 1
        y = y.long()
        loss, logits = objective(model(model_input(x, nhwc)), y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, {"accuracy": acc}

    if args.fsdp:
        train_step = make_fsdp_train_step(
            comm, loss_fn, fsdp_state, meta, has_aux=True,
            wire_dtype=args.allreduce_grad_dtype,
            accum_steps=args.accum_steps)
    else:
        train_step = cmn.make_train_step(comm, loss_fn, optimizer,
                                         has_aux=True,
                                         accum_steps=args.accum_steps)

    def step(batch):
        if schedule is not None:
            lr = schedule(updater.iteration)  # updates so far, as optax
            for g in local_opt.param_groups:
                g["lr"] = lr
        micro[0] = 0
        return train_step(batch)

    step.finalize = train_step.finalize
    model.train()
    if not args.fsdp:
        updater = StatefulUpdater(base_iter, step, model, comm)
    elif persistent_buffers(model):  # BatchNorm: rank-local buffers
        updater = FsdpStatefulUpdater(base_iter, step, fsdp_state, meta,
                                      model, comm)
    else:
        updater = FsdpUpdater(base_iter, step, fsdp_state, meta, comm)
    state_of = lambda it, i: checkpoint_state(  # noqa: E731
        model, local_opt, it, i, fsdp_state, getattr(optimizer,
                                                     "pending_grads", None))

    ckpt = resumed = None
    if args.checkpoint:
        ckpt = create_multi_node_checkpointer(
            comm, args.checkpoint, name=f"imagenet-{args.arch}",
            keep=args.checkpoint_keep)
        resumed = resume(ckpt, model, local_opt, optimizer, fsdp_state,
                         base_iter, updater)
        if resumed is not None and comm.rank == 0:
            print(f"resumed from snapshot at iteration {resumed} (epoch "
                  f"{base_iter.epoch})", flush=True)
    # the loader starts after a resume, from the restored position
    train_iter = base_iter
    if args.prefetch > 0:
        train_iter = PrefetchIterator(base_iter, transform=augment,
                                      prefetch=args.prefetch,
                                      workers=args.loader_workers)
        updater.iterator = train_iter

    stop = ((args.iterations, "iteration") if args.iterations
            else (args.epoch, "epoch"))
    trainer = Trainer(updater, stop,
                      log_trigger=(args.log_interval, "iteration"),
                      out=args.out)
    timer = extensions.StepTimer(device)
    trainer.extend(timer)
    if persistent_buffers(model):  # the BatchNorm archs
        trainer.extend(AllreducePersistent(comm, model))
    if ckpt is not None:
        trainer.extend(extensions.Snapshot(
            ckpt, lambda t: state_of(train_iter, t.updater.iteration),
            trigger=((args.checkpoint_freq, "iteration")
                     if args.checkpoint_freq else (1, "epoch"))))
    if val is not None:
        evaluator = create_multi_node_evaluator(
            make_evaluator(args, comm, model, val, nhwc), comm)
        if args.fsdp:
            evaluator = FullParamsExtension(
                evaluator, lambda: fsdp_module_params(fsdp_state, meta, comm))
        trainer.extend(evaluator)
    log = extensions.LogReport(filename="log" if comm.rank == 0 else None)
    trainer.extend(log)
    timer.start()
    try:
        trainer.run()
        if args.fsdp:  # the trained parameters, whole, in the module
            load_module_params(model, fsdp_full_params(fsdp_state, meta,
                                                       comm))
        w = args.warmup_steps
        losses, ips, peak_gb = timer.result(args.batchsize * comm.size, w)
        result = {"losses": losses, "images_per_sec": ips,
                  "iterations": updater.iteration, "world": comm.size,
                  "log": log.log, "resumed_from": resumed,
                  "save_seconds": ckpt.save_seconds if ckpt else [],
                  "peak_memory_gb": peak_gb, "model": model,
                  "optimizer": optimizer, "fsdp_state": fsdp_state,
                  "fsdp_meta": meta, "step_stats": getattr(train_step, "stats", None)}
        if comm.rank == 0:
            ips_s = f"{ips:.1f}" if ips is not None else "n/a"
            final = f"{losses[-1]:.4f}" if losses else "n/a"
            mem = f"{peak_gb:.2f} GB" if peak_gb is not None else "n/a"
            print(f"final loss {final}; images/sec (all GPUs, steps "
                  f"{w + 1}..{len(losses)} of this run): {ips_s}; peak device "
                  f"memory of rank 0 {mem}; epoch log "
                  f"{log.log[-1] if log.log else {}}", flush=True)
        if args.profile_steps:
            if device.type != "cuda":
                raise ValueError("--profile-steps profiles the GPU")
            result["profile"] = profile_steps(updater, args.profile_steps,
                                              device)
            if comm.rank == 0:
                print(f"profile: {result['profile']}", flush=True)
    finally:
        # the loader's threads stop with the run, also when it fails
        close_loader(train_iter)
    return result


def image_resize(args) -> int:
    """The short side real images are decoded at (JAX's 256/224 rule)."""
    return max(args.image_size, round(args.image_size * 256 / 224))


def load_train(args):
    """``(dataset, augment)``: the training set of ``--data``,
    ``--train-root`` or the synthetic set, and its per-sample transform
    (None: collatable as it is).  ``--data`` sets ``args.n_classes`` from
    the folder."""
    if args.data:
        train = ImageFolderDataset(args.data, resize=image_resize(args))
        args.n_classes = len(train.classes)
        return train, Augment(args.image_size, train=True, seed=args.seed)
    if args.train_root:
        train = NpzImageDataset(args.train_root)
        if train.x.dtype == np.uint8 and \
                train.x.shape[1] != args.image_size:
            return train, Augment(args.image_size, train=True,
                                  seed=args.seed)
        return train, None
    return make_synthetic_imagenet(args.train_size, args.image_size,
                                   args.n_classes, args.seed), None


def load_val(args):
    """The validation set: ``--val-data`` through the eval transform, the
    synthetic one (seed + 1, ``--val-size``) beside synthetic training
    data, else None."""
    if args.val_data:
        return TransformDataset(
            ImageFolderDataset(args.val_data, resize=image_resize(args)),
            Augment(args.image_size, train=False))
    if not args.data and not args.train_root and args.val_size:
        return make_synthetic_imagenet(args.val_size, args.image_size,
                                       args.n_classes, args.seed + 1)
    return None


def model_input(x, nhwc: bool):
    """A batch on the device as the models take it: an NHWC batch as an
    NCHW (``channels_last``) view, uint8 normalized to float32 (the head
    of the loss, as JAX's ``normalize_image``)."""
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if x.dtype == torch.uint8:
        x = normalize_image(x, channel_dim=1)
    return x


def close_loader(it) -> None:
    """Stop a :class:`PrefetchIterator`'s threads (no-op otherwise)."""
    if isinstance(it, PrefetchIterator):
        it.close()


def make_evaluator(args, comm, model, val, nhwc: bool):
    """The validation set ``val``, scattered without shuffling, evaluated
    in eval mode (running statistics)."""
    val = cmn.scatter_dataset(val, comm, shuffle=False)
    val_iter = SerialIterator(val, args.batchsize, repeat=False,
                              shuffle=False)

    def metrics(batch):
        x, y = batch
        y = y.long()
        model.eval()
        try:
            logits = model(model_input(x, nhwc))
        finally:
            model.train()
        return {"loss": F.cross_entropy(logits, y),
                "accuracy": (logits.argmax(-1) == y).float().mean()}

    return extensions.Evaluator(val_iter, make_eval_fn(comm, metrics), comm)


class FullParamsExtension:
    """A trainer extension (an evaluator) run inside ``context()``: under
    ``--fsdp`` the module holds its gathered parameters there, as JAX
    passes its evaluator ``updater.params``."""

    def __init__(self, extension, context):
        self.extension, self.context = extension, context
        for k in ("trigger", "priority", "name"):
            if hasattr(extension, k):
                setattr(self, k, getattr(extension, k))

    def __call__(self, trainer):
        with self.context():
            return self.extension(trainer)


def checkpoint_state(model, local_opt, train_iter, iteration,
                     fsdp_state=None, pending=None) -> dict:
    """What a snapshot holds: the model's parameters and buffers, the
    optimizer's state (this rank's shards under ZeRO-1), the gradient mean
    a double-buffered optimizer applies next (``pending()``), the iterator
    and the iteration.  Under ``--fsdp`` the FsdpState (the parameter
    shards and their optimizer's state) stands for the parameters and the
    optimizer, and the model gives its buffers only."""
    if fsdp_state is not None:
        state = {"model": dict(model.named_buffers()),
                 "optimizer": fsdp_state}
    else:
        state = {"model": dict(model.state_dict()),
                 "optimizer": optimizer_state_tree(local_opt)}
    state.update(iterator=train_iter.state_dict(),
                 iteration=np.int64(iteration))
    if pending is not None:
        state["pending"] = pending()
    return state


def resume(ckpt, model, local_opt, optimizer, fsdp_state, train_iter,
           updater):
    """Restore the newest generation every rank holds, if any; returns its
    iteration (None: a fresh start, nothing changed).  An FsdpState is
    restored in place."""
    if ckpt.latest_consistent_generation() is None:
        return None
    # the live state that the snapshot must match: a torch optimizer has
    # no state before its first step, so take one that changes nothing
    init_optimizer_state(local_opt)
    pending = getattr(optimizer, "pending_grads", None)
    like = checkpoint_state(model, local_opt, train_iter, 0, fsdp_state,
                            pending)
    if "pending" in like:
        like["pending"] = [torch.zeros_like(p) for p in model.parameters()]
    restored, gen = ckpt.resume(like)
    if fsdp_state is None:
        model.load_state_dict(restored["model"])
        load_optimizer_state_tree(local_opt, restored["optimizer"])
    else:
        with torch.no_grad():
            for name, buf in model.named_buffers():
                buf.copy_(restored["model"][name])
    if "pending" in restored:
        optimizer.set_pending_grads(restored["pending"])
    train_iter.load_state_dict(restored["iterator"])
    updater.iteration = int(restored["iteration"])
    return gen


if __name__ == "__main__":
    main()
    torch.distributed.destroy_process_group()
