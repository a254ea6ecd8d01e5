"""The card's evidence suite: one command, one JSON document per run.

Counterpart of ``tools/tpu_smoke.py`` (named as ``utils/gpu_info.py``
stands for ``tpu_info.py``), with its nine checks under JAX's names:

* ``flash_parity_T8k``: the flash kernels at T 8192 (bf16, causal, B 1, H
  4, D 128): the forward against an independent float32 O(T^2) oracle
  (:func:`..parallel.sequence.attention` on float32 copies), the backward
  against the plain version's autograd (``flash_forward_plain``; JAX holds
  it against its blockwise backward, which the port keeps for CPU tensors
  only: ROADMAP Queue C 9);
* ``flash_gqa_rectangular``: Tq 2048 against Tkv 8192, 8 q / 2 kv heads,
  D 64, non-causal: the forward against the oracle (JAX's max-abs gate),
  and out, dq, dk and dv (dk/dv summed over each q-head group) against
  the plain version's autograd within :data:`FLASH_TOL` relative L2;
* ``flash_throughput_T32k``: the forward kernel at T 32768 (ms, TFLOP/s,
  bound, SDPA's forward);
* ``flash_bwd_T32k``: the forward and backward through autograd at T
  32768, and the dK/dV and dQ kernels alone, with their bounds and SDPA's
  backward; then the probe's window check at that length;
* ``flash_train_T64k`` / ``flash_train_T256k``: the forward's time, the
  training-shaped step and the window check of
  :mod:`..benchmarks.bench_flash_64k` at T 65536 and 262144 (the latter
  on a card only; T 262144 is the first length whose T^2 passes 2^32);
* ``cast_scale``: the cast kernel against ``(x * scale).to(bf16)``;
* ``train_step_flavors``: a bf16 double-buffered ResNet step (two
  BasicBlock stages, 16 filters) through each of the seven communicator
  flavors, 3 steps, finite losses;
* ``fsdp_vit_step``: a bf16 ViT (width 64, 2 layers) through the port's
  FSDP, 5 Adam steps on the float32 and the bf16 wire, the loss falling and
  the parameters moved.

Each check is retried on transient failures (:mod:`..utils.retry`) and
recorded with ``ok``, its seconds and its figures; a failure is recorded
and the rest run.  A check that holds a kernel against its plain version
records the launches that comparison made as ``compare_launches``.  ``--only`` takes a comma-separated subset and refuses an
unknown name; it merges into an existing ``--out`` written on the same
device kind.  A run with no check is not green.  The document is stamped
``gpu_smoke/v1``, printed as one line and written to ``--out``; exit 0
only when it is green.

Without a card the tool refuses unless ``--device cpu`` is given, and a
CPU document says ``on_gpu: false``.  On the CPU a flash check whose plain
version would hold more than :data:`CPU_SCORE_BYTES` of scores is recorded
as skipped.

    python -m chainermn_tpu_torch.tools.gpu_smoke --out EVIDENCE.json
    python -m chainermn_tpu_torch.tools.gpu_smoke --only cast_scale \\
        --device cpu
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

CPU_SCORE_BYTES = 1 << 30   # float32 [H, Tq, Tk]: the most the CPU runs
PARITY_FWD_TOL, PARITY_BWD_TOL = 0.13, 0.25   # JAX's max-abs gates (bf16)
FLASH_TOL = 1e-2   # relative L2 at bf16 (chip_smoke's FLASH_TOL)
CAST_TOL = 2e-2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _fa():
    return importlib.import_module("chainermn_tpu_torch.ops.flash_attention")


def _probe():
    from chainermn_tpu_torch.benchmarks import bench_flash_64k
    return bench_flash_64k


def _card(dev):
    from chainermn_tpu_torch.utils.gpu_info import card_info
    return card_info(dev)[0] if dev.type == "cuda" else None


def _cpu_skip(dev, h, tq, tk):
    """A skipped row when the CPU's plain version would hold too much."""
    if dev.type == "cpu" and h * tq * tk * 4 >= CPU_SCORE_BYTES:
        return {"skipped": f"card only: the CPU's plain version would hold "
                           f"{h * tq * tk * 4} bytes of scores"}
    return None


def _host(rng, shape, dev):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16)


def _ref_attention(q, k, v, causal):
    """The float32 O(T^2) oracle: kv heads repeated, the tested plain
    attention of :mod:`..parallel.sequence` on float32 copies, the causal
    mask aligned for rectangular shapes (q offset Tkv - Tq)."""
    from chainermn_tpu_torch.parallel.sequence import attention
    group = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    return attention(q.float(), kf, vf, causal=causal,
                     q_offset=k.shape[1] - q.shape[1])


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_flash_parity(dev, T=8192, causal=True):
    skip = _cpu_skip(dev, 4, T, T)
    if skip:
        return skip
    fa = _fa()
    B, H, D = 1, 4, 128
    rng = np.random.RandomState(0)
    q, k, v, g = (_host(rng, (B, T, H, D), dev) for _ in range(4))
    with torch.no_grad():
        ref = _ref_attention(q, k, v, causal)
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qs, ks, vs, causal=causal)
    got = torch.autograd.grad((out.float() * g.float()).sum(), (qs, ks, vs))
    fwd_err = _max_abs(out.detach(), ref)
    del ref
    qp, kp, vp = (x.clone().requires_grad_() for x in (q, k, v))
    out_p, _ = fa.flash_forward_plain(qp, kp, vp, causal)
    want = torch.autograd.grad((out_p.float() * g.float()).sum(),
                               (qp, kp, vp))
    bwd_err = max(_max_abs(a, b) for a, b in zip(got, want))
    bwd_rel = max(_probe()._rel(a, b) for a, b in zip(got, want))
    if not fwd_err <= PARITY_FWD_TOL:
        raise AssertionError(f"fwd mismatch {fwd_err}")
    if not bwd_err <= PARITY_BWD_TOL:
        raise AssertionError(f"bwd mismatch {bwd_err}")
    return {"T": T, "fwd_max_err": fwd_err, "bwd_max_err": bwd_err,
            "bwd_rel_l2": bwd_rel,
            "fwd_vs": "float32 O(T^2) oracle (parallel.sequence.attention)",
            "bwd_vs": "autograd of the plain forward (flash_forward_plain)"}


def check_gqa_rectangular(dev, Tq=2048, Tkv=8192):
    skip = _cpu_skip(dev, 8, Tq, Tkv)
    if skip:
        return skip
    fa, probe = _fa(), _probe()
    B, H, Hkv, D = 1, 8, 2, 64
    rng = np.random.RandomState(1)
    q = _host(rng, (B, Tq, H, D), dev)
    k = _host(rng, (B, Tkv, Hkv, D), dev)
    v = _host(rng, (B, Tkv, Hkv, D), dev)
    g = _host(rng, (B, Tq, H, D), dev)
    before = fa.launch_counts()
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qs, ks, vs, causal=False)
    loss = (out.float() * g.float()).sum()
    got = (out.detach(),) + torch.autograd.grad(loss, (qs, ks, vs))
    launches = probe._launches(before)
    with torch.no_grad():
        err = _max_abs(got[0], _ref_attention(q, k, v, False))
    qp, kp, vp = (x.clone().requires_grad_() for x in (q, k, v))
    out_p, _ = fa.flash_forward_plain(qp, kp, vp, False)
    want = (out_p.detach(),) + torch.autograd.grad(
        (out_p.float() * g.float()).sum(), (qp, kp, vp))
    rel = {n: probe._rel(a, b)
           for n, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    if not err <= PARITY_FWD_TOL:
        raise AssertionError(f"gqa/rect fwd mismatch {err}")
    over = {n: e for n, e in rel.items() if not e <= FLASH_TOL}
    if over:
        raise AssertionError(f"gqa/rect over {FLASH_TOL} relative L2: "
                             f"{over}")
    return {"Tq": Tq, "Tkv": Tkv, "heads": f"{H}q/{Hkv}kv",
            "fwd_max_err": err, "rel_l2": rel, "tol": FLASH_TOL,
            "vs": "autograd of the plain forward (flash_forward_plain)",
            "loss": float(loss.detach()), "compare_launches": launches}


def check_flash_throughput(dev, T=32768):
    skip = _cpu_skip(dev, 4, T, T)
    if skip:
        return skip
    B, H, D = 1, 4, 128
    rng = np.random.RandomState(2)
    q, k, v = (_host(rng, (B, T, H, D), dev) for _ in range(3))
    return {"T": T, **_probe().forward_stage(q, k, v, True, _card(dev))}


def check_flash_bwd_throughput(dev, T=32768):
    skip = _cpu_skip(dev, 4, T, T)
    if skip:
        return skip
    fa, probe = _fa(), _probe()
    B, H, D = 1, 4, 128
    q, k, v, g = probe.operands(dev, (B, T, H, D), 4, seed=3)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def fwd_bwd():
        o = fa.flash_attention(qs, ks, vs, causal=True)
        return torch.autograd.grad((o.float() * g.float()).sum(),
                                   (qs, ks, vs))

    before = fa.launch_counts()
    ms = probe.elapsed_ms(fwd_bwd, dev)
    launches = {w: n - before[w] for w, n in fa.launch_counts().items()}
    flops = sum(fa.flash_attention_flops(B, T, T, H, D, True, kind)
                for kind in ("fwd", "bwd_dkv", "bwd_dq"))
    res = {"T": T, "flop_accounting": "the kernels' products: 2 forward + "
           "4 dK/dV + 3 dQ, 2 D per allowed (q, k) pair each",
           "fwd_bwd_launches": launches}
    res["device_ms" if dev.type == "cuda" else "host_ms"] = ms
    if dev.type == "cuda":
        res["tflops_fwd_plus_bwd"] = flops / ms / 1e9
        res["kernels"] = probe.forward_backward_stage(q, k, v, g, True,
                                                      _card(dev))
    res["window"] = probe.window_check(
        *probe.operands(dev, (B, T, H, D), 4, seed=4))
    res["compare_launches"] = res["window"]["launches"]
    return res


def check_flash_train_T64k(dev, T=65536):
    skip = _cpu_skip(dev, 4, T, T)
    if skip:
        return skip
    probe = _probe()
    B, H, D = 1, 4, 128
    q, k, v = probe.operands(dev, (B, T, H, D), 3, seed=0)
    fwd = probe.forward_stage(q, k, v, True, _card(dev))
    del q, k, v
    step = probe.train_step_stage(dev, B, T, H, D)
    window = probe.window_check(*probe.operands(dev, (B, T, H, D), 4,
                                                seed=4))
    return {"T": T, "forward": fwd, "train_losses": step["losses"],
            "weight_delta_norm": step["weight_delta_norm"],
            "master_dtype": step["master_dtype"],
            "train_launches": step["launches"], "window": window,
            "compare_launches": window["launches"]}


def check_flash_train_T256k(dev):
    if dev.type != "cuda":
        return {"skipped": "card only: O(T^2) at T 262144 is impractical on "
                           "the CPU"}
    return check_flash_train_T64k(dev, T=262144)


def check_cast_scale(dev):
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(1 << 20) * 100).astype(np.float32)).to(dev)
    out = cs.cast_scale(x, torch.bfloat16, 0.125)
    ref = (x * 0.125).to(torch.bfloat16)
    if out.dtype != torch.bfloat16:
        raise AssertionError(f"cast_scale gave {out.dtype}")
    err = _max_abs(out, ref)
    if not err <= CAST_TOL:
        raise AssertionError(f"cast_scale mismatch {err}")
    return {"n": x.numel(), "max_err": err,
            "bit_exact": bool(torch.equal(out, ref))}


FLAVORS = ("naive", "flat", "hierarchical", "two_dimensional", "single_node",
           "non_cuda_aware", "xla")


def check_train_step_flavors(dev):
    import torch.nn.functional as F

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models.resnet import BasicBlock, ResNet
    rows = {}
    for flavor in FLAVORS:
        comm = cmn.create_communicator(
            flavor, allreduce_grad_dtype="bfloat16" if flavor == "xla"
            else None, device=dev)
        model = ResNet(stage_sizes=(1, 1), block_cls=BasicBlock,
                       num_filters=16, num_classes=10, dtype=torch.bfloat16,
                       device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
        comm.bcast_data(model)
        optimizer = cmn.create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm,
            double_buffering=True)
        step = cmn.make_train_step(
            comm, lambda b, m=model: F.cross_entropy(m(b[0]), b[1]),
            optimizer)
        rng = np.random.RandomState(0)
        n = 8 * comm.size
        x = rng.randn(n, 64, 64, 3).astype(np.float32)
        y = (rng.rand(n) * 10).astype(np.int64)
        rows_ = slice(comm.rank * 8, (comm.rank + 1) * 8)
        batch = (torch.from_numpy(x[rows_]).permute(0, 3, 1, 2).contiguous()
                 .to(dev), torch.from_numpy(y[rows_]).to(dev))
        model.train()
        losses = [float(step(batch)) for _ in range(3)]
        step.finalize()
        if not all(np.isfinite(losses)):
            raise AssertionError((flavor, losses))
        rows[flavor] = losses[-1]
    return {"flavors": rows, "world": comm.size,
            "note": "bf16 double-buffered step; losses finite after 3 steps "
                    "each. On a world of one every flavor's collectives "
                    "reduce over one rank: this check gates building and "
                    "running each flavor on the card; the flavors' several "
                    "decompositions are held on gloo worlds of 2-4 ranks "
                    "(tests/test_torch_collectives.py) and on four cards "
                    "(multi_gpu_check.py)."}


def check_fsdp_vit_step(dev):
    import torch.nn.functional as F

    import chainermn_tpu_torch as cmn
    from chainermn_tpu_torch.models import ViT
    from chainermn_tpu_torch.parallel.fsdp import (
        fsdp_full_params, fsdp_init, make_fsdp_train_step)
    comm = cmn.create_communicator("xla", device=dev)
    rng = np.random.RandomState(0)
    n = 8 * comm.size
    x = rng.randn(n, 32, 32, 3).astype(np.float32)
    y = (np.arange(n) % 10).astype(np.int64)
    x += y.reshape(-1, 1, 1, 1) * 0.4
    rows_ = slice(comm.rank * 8, (comm.rank + 1) * 8)
    batch = (torch.from_numpy(x[rows_]).permute(0, 3, 1, 2).contiguous()
             .to(dev), torch.from_numpy(y[rows_]).to(dev))
    rows = {}
    for wire in (None, "bfloat16"):
        model = ViT(num_classes=10, patch=8, d_model=64, n_layers=2,
                    n_heads=4, dtype=torch.bfloat16, image_size=32,
                    device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        state, meta = fsdp_init(comm, model, torch.optim.Adam(
            model.parameters(), lr=1e-3))
        step = make_fsdp_train_step(
            comm, lambda b, m=model: F.cross_entropy(m(b[0]), b[1]), state,
            meta, wire_dtype=wire)
        model.train()
        losses = [float(step(batch)) for _ in range(5)]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError((wire, losses))
        full = fsdp_full_params(state, meta, comm)
        delta = sum(float((full[k].float() - init[k].float()).abs().sum())
                    for k in init)
        if not (np.isfinite(delta) and delta > 0):
            raise AssertionError((wire, delta))
        rows["f32_wire" if wire is None else "bf16_wire"] = losses
    return {"losses": rows, "world": comm.size,
            "note": "one-card gate: building and running the FSDP gather/"
                    "scatter step of a bf16 ViT on the float32 and the bf16 "
                    "wire; the sharded decomposition is held on a 4-rank "
                    "gloo world (tests/test_torch_fsdp.py) and on four "
                    "cards (multi_gpu_check.py --parts fsdp)."}


CHECKS = [
    ("flash_parity_T8k", check_flash_parity),
    ("flash_gqa_rectangular", check_gqa_rectangular),
    ("flash_throughput_T32k", check_flash_throughput),
    ("flash_bwd_T32k", check_flash_bwd_throughput),
    ("flash_train_T64k", check_flash_train_T64k),
    ("flash_train_T256k", check_flash_train_T256k),
    ("cast_scale", check_cast_scale),
    ("train_step_flavors", check_train_step_flavors),
    ("fsdp_vit_step", check_fsdp_vit_step),
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="write the JSON document here")
    p.add_argument("--attempts", type=int, default=3)
    p.add_argument("--only", default=None,
                   help="comma-separated subset of check names")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    return p.parse_args(argv)


def select(only) -> list:
    """The names ``--only`` selects (all without it); an unknown name
    exits naming the known ones."""
    known = [n for n, _ in CHECKS]
    if only is None:
        return known
    chosen = {n for n in only.split(",") if n}
    unknown = chosen - set(known)
    if unknown:
        # a typo must not produce an empty-but-green document
        raise SystemExit(f"unknown check(s) {sorted(unknown)}; available: "
                         f"{sorted(known)}")
    return [n for n in known if n in chosen]


def main(argv=None) -> int:
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    from chainermn_tpu_torch.parallel.topology import env_int, resolve_device
    from chainermn_tpu_torch.utils.retry import retry_transient
    args = parse_args(argv)
    selected = select(args.only)
    dev = resolve_device(args.device, env_int("LOCAL_RANK") or 0)
    on_gpu = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if on_gpu else "cpu"
    doc = {"suite": "gpu_smoke", "backend": dev.type, "device_kind": kind,
           "on_gpu": on_gpu,
           "n_devices": torch.cuda.device_count() if on_gpu else 1,
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "checks": {}}
    if args.only is not None and args.out and os.path.exists(args.out):
        # --only re-runs merge into the document of the same device kind
        try:
            with open(args.out) as f:
                prev = json.load(f)
            if prev.get("device_kind") == kind:
                doc["checks"] = prev.get("checks", {})
        except (OSError, ValueError):
            pass
    if not on_gpu:
        log("gpu_smoke: running on the CPU as asked (document marked "
            "on_gpu: false)")
    fns = dict(CHECKS)
    for name in selected:
        log(f"gpu_smoke: running {name} ...")
        t0 = time.perf_counter()
        try:
            metrics = retry_transient(lambda: fns[name](dev),
                                      attempts=args.attempts, label=name)
            doc["checks"][name] = {"ok": True,
                                   "wall_s": time.perf_counter() - t0,
                                   **metrics}
            log(f"gpu_smoke: {name} OK {metrics}")
        except Exception as e:  # noqa: BLE001 -- recorded, the suite goes on
            doc["checks"][name] = {"ok": False,
                                   "wall_s": time.perf_counter() - t0,
                                   "error": f"{type(e).__name__}: {e}"}
            log(f"gpu_smoke: {name} FAILED: {type(e).__name__}: {e}")
        if on_gpu:
            torch.cuda.empty_cache()
    doc["ok"] = bool(doc["checks"]) and all(
        c.get("ok") for c in doc["checks"].values())
    stamp_envelope(doc, "gpu_smoke/v1")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    print(json.dumps(doc), flush=True)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    rc = main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    sys.exit(rc)
