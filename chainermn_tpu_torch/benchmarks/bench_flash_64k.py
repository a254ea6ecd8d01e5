"""The flash kernels at T 65536 on one card: forward, backward and a
training-shaped step, each recorded as a stage.

Counterpart of ``benchmarks/bench_flash_64k.py``, with its stages and
defaults (B 1, T 65536, H 4, D 128, bf16, causal):

1. ``alloc_on_device``: q, k, v drawn on the device (``torch.randn`` with a
   device generator: the operands never exist on the host);
2. ``forward``: ``flash_attention`` forward, then the forward kernel timed
   (CUDA events around back-to-back launches) with its TFLOP/s and bound
   (:func:`..ops.flash_attention.flash_attention_flops` / ``_bytes`` over
   the card's rates, :mod:`..utils.gpu_info`) and SDPA's forward on the
   same inputs;
3. ``forward_backward``: the gradients of ``sum(out^2)`` through autograd,
   finite; then the dK/dV and dQ kernels timed alone with their bounds, and
   SDPA's backward;
4. ``train_step``: a float32 master ``w`` [D, D], the loss LINEAR in the
   flash output (``sum(flash(q @ w, k, v) * g) / T``: the gradient of ``w``
   flows only through the flash backward), 3 SGD steps of 0.1; the weight
   delta must be non-zero and each step's loss must differ from the last;
5. ``window`` (the port's own): the keys in the last W positions (W 256)
   are seen only by the queries in the last W rows, so the plain version
   (``flash_forward_plain`` with offsets (T - W, 0), through autograd) on
   those W queries against the whole K/V gives the kernels' ``out``,
   ``lse`` and ``dq`` rows and their ``dk``/``dv`` rows of the last W keys
   exactly; each is held to :data:`WINDOW_TOL` (relative L2, the bf16
   tolerance ``chip_smoke.py`` holds the kernels to).

A failing stage is recorded (``ok: false`` with its error) and the rest
run; the exit code is 1 unless every stage passed.  The document is
stamped ``flash_64k_probe/v1``, printed as one line and written to
``--out``.  Each stage also records the flash launches it made (the
wrappers' counts; the CPU runs the plain versions and counts none).

    python -m chainermn_tpu_torch.benchmarks.bench_flash_64k
    python -m chainermn_tpu_torch.benchmarks.bench_flash_64k --device cpu \\
        --T 512
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

WINDOW = 256
WINDOW_TOL = 1e-2      # relative L2 at bf16 (chip_smoke's FLASH_TOL)
CPU_MAX_T = 4096       # the plain forward holds [H, T, T] float32 scores
TIMED_REPS = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _fa():
    return importlib.import_module("chainermn_tpu_torch.ops.flash_attention")


def operands(dev, shape, n, seed, scale=1.0, dtype=torch.bfloat16):
    """``n`` tensors of ``shape`` drawn on ``dev`` from ``seed`` (a device
    generator), times ``scale``, in ``dtype``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple((torch.randn(shape, generator=gen, device=dev) * scale)
                 .to(dtype) for _ in range(n))


def elapsed_ms(fn, dev, reps=TIMED_REPS, warmup=1) -> float:
    """Milliseconds a call of ``fn``: CUDA events around ``reps``
    back-to-back calls after ``warmup`` on a card, the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(dev)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(kind, q, k, causal, card) -> dict:
    """The least time the card could take for one kernel of ``kind`` on
    q/k's shapes: the larger of its bytes over the memory rate and its
    operations over the bf16 (float32: CUDA-core) peak."""
    fa = _fa()
    b, tq, h, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    ops = fa.flash_attention_flops(b, tq, tk, h, d, causal, kind)
    nbytes = fa.flash_attention_bytes(b, tq, tk, h, hk, d, q.dtype, kind)
    peak = card.f32_tflops if q.dtype == torch.float32 else card.peak_tflops
    ops_ms = ops / (peak * 1e12) * 1e3
    bytes_ms = nbytes / card.hbm_bytes_per_s * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _launches(before: dict) -> dict:
    return {w: n - before[w] for w, n in _fa().launch_counts().items()}


def forward_stage(q, k, v, causal=True, card=None) -> dict:
    """The forward through ``flash_attention``, finite; on a card the
    forward kernel's ms, TFLOP/s and bound, and SDPA's forward."""
    fa = _fa()
    dev = q.device
    before = fa.launch_counts()
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, causal=causal)
        finite = bool(torch.isfinite(out.float()).all())
    if not finite:
        raise AssertionError("forward: output not finite")
    res = {"finite": finite}
    with torch.no_grad():
        ms = elapsed_ms(lambda: fa.flash_fwd(q, k, v, causal), dev)
    if dev.type != "cuda":
        res.update(host_ms=ms, launches=_launches(before))
        return res
    import torch.nn.functional as F
    bd = bound("fwd", q, k, causal, card)
    q3, k3, v3 = (x.transpose(1, 2) for x in (q, k, v))
    with torch.no_grad():
        sdpa = elapsed_ms(lambda: F.scaled_dot_product_attention(
            q3, k3, v3, is_causal=causal), dev)
    res.update(device_ms=ms, tflops_fwd=bd["ops"] / ms / 1e9,
               bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
               sdpa_ms=sdpa, launches=_launches(before))
    return res


def forward_backward_stage(q, k, v, g, causal=True, card=None) -> dict:
    """The gradients of ``sum(out^2)`` through autograd, finite; on a card
    the dK/dV and dQ kernels timed alone (from the forward's lse) with
    their bounds, and SDPA's autograd backward on the same inputs."""
    fa = _fa()
    dev = q.device
    before = fa.launch_counts()
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qs, ks, vs, causal=causal)
    grads = torch.autograd.grad(out.float().square().sum(), (qs, ks, vs))
    finite = all(bool(torch.isfinite(x.float()).all()) for x in grads)
    if not finite:
        raise AssertionError("forward_backward: gradients not finite")
    res = {"grads_finite": finite}
    del out, grads, qs, ks, vs
    if dev.type != "cuda":
        res["launches"] = _launches(before)
        return res
    import torch.nn.functional as F
    with torch.no_grad():
        out, lse = fa.flash_fwd(q, k, v, causal)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
    bwd = (q, k, v, g, lse, delta, None, causal)
    for w, kind in (("flash_bwd_dkv", "bwd_dkv"), ("flash_bwd_dq", "bwd_dq")):
        ms = elapsed_ms(lambda: getattr(fa, w)(*bwd), dev)
        bd = bound(kind, q, k, causal, card)
        res[w] = {"device_ms": ms, "tflops": bd["ops"] / ms / 1e9,
                  "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"]}
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2)
    res["sdpa_bwd_ms"] = elapsed_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), gt, retain_graph=True), dev)
    res["launches"] = _launches(before)
    return res


def train_step_stage(dev, b, t, h, d, steps=3) -> dict:
    """JAX's training-shaped step: float32 master ``w``, the loss linear in
    the flash output, ``steps`` SGD steps of 0.1; raises unless the weight
    moved and every step's loss differs from the one before."""
    fa = _fa()
    before = fa.launch_counts()
    q, k, v, g = operands(dev, (b, t, h, d), 4, seed=2)
    (w0,) = operands(dev, (d, d), 1, seed=1, scale=0.05, dtype=torch.float32)
    w, losses = w0.clone(), []
    for _ in range(steps):
        wg = w.detach().requires_grad_()
        o = fa.flash_attention(q @ wg.to(q.dtype), k, v, causal=True)
        loss = (o.float() * g.float()).sum() / t
        (gw,) = torch.autograd.grad(loss, (wg,))
        w = w - 0.1 * gw
        losses.append(float(loss.detach()))
    delta = float((w - w0).norm())
    finite = all(map(lambda x: x == x and abs(x) != float("inf"), losses))
    if not finite:
        raise AssertionError(f"train_step: losses not finite: {losses}")
    if not delta > 0.0:
        raise AssertionError("zero weight update: broken backward")
    if not all(a != b_ for a, b_ in zip(losses, losses[1:])):
        raise AssertionError(f"loss did not move: {losses}")
    return {"losses": losses, "weight_delta_norm": delta,
            "master_dtype": "float32", "finite": finite,
            "launches": _launches(before)}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def window_check(q, k, v, g, window=WINDOW, tol=WINDOW_TOL) -> dict:
    """The last ``window`` rows of the kernels' out, lse and dq and rows of
    dk/dv against the plain version on those queries alone (offsets (T -
    W, 0), autograd through ``flash_forward_plain``); relative L2 errors,
    raises over ``tol``."""
    fa = _fa()
    t = q.shape[1]
    before = fa.launch_counts()
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention(qs, ks, vs, causal=True, return_lse=True)
    dq, dk, dv = torch.autograd.grad((out.float() * g.float()).sum(),
                                     (qs, ks, vs))
    got = {"out": out[:, -window:].detach(), "lse": lse[..., -window:]
           .detach(), "dq": dq[:, -window:], "dk": dk[:, -window:],
           "dv": dv[:, -window:]}
    del out, lse, dq, dk, dv, qs, ks, vs
    qw = q[:, -window:].detach().requires_grad_()
    kp, vp = (x.detach().requires_grad_() for x in (k, v))
    offs = torch.tensor([[t - window, 0]], device=q.device,
                        dtype=torch.int32).expand(q.shape[0], 2)
    out_p, lse_p = fa.flash_forward_plain(qw, kp, vp, True, offs=offs)
    dq_p, dk_p, dv_p = torch.autograd.grad(
        (out_p.float() * g[:, -window:].float()).sum(), (qw, kp, vp))
    want = {"out": out_p.detach(), "lse": lse_p.detach(), "dq": dq_p,
            "dk": dk_p[:, -window:], "dv": dv_p[:, -window:]}
    errs = {n: _rel(got[n], want[n]) for n in got}
    res = {"window": window, "tol": tol, "rel_l2": errs,
           "max_abs": {n: float((got[n].float() - want[n].float()).abs()
                                .max()) for n in got},
           "launches": _launches(before)}
    over = {n: e for n, e in errs.items() if not e <= tol}
    if over:
        raise AssertionError(f"window check over {tol}: {over}")
    return res


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--T", type=int, default=65536)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU, "
                        f"at T <= {CPU_MAX_T})")
    return p.parse_args(argv)


def run(args) -> dict:
    """Every stage in turn; returns the (unstamped) document."""
    from chainermn_tpu_torch.parallel.topology import env_int, resolve_device
    from chainermn_tpu_torch.utils.gpu_info import card_info
    from chainermn_tpu_torch.utils.retry import retry_transient
    dev = resolve_device(args.device, env_int("LOCAL_RANK") or 0)
    b, t, h, d = 1, args.T, args.heads, args.dim
    if dev.type != "cuda" and t > CPU_MAX_T:
        raise SystemExit(f"bench_flash_64k: T {t} on the CPU (the plain "
                         f"versions hold [H, T, T] scores); use --T <= "
                         f"{CPU_MAX_T}")
    card = card_info(dev)[0] if dev.type == "cuda" else None
    doc = {"suite": "flash_64k_probe", "B": b, "T": t, "H": h, "D": d,
           "dtype": "bfloat16", "causal": True,
           "backend": dev.type,
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "stages": {}}
    if card is not None:
        doc["device_kind"] = torch.cuda.get_device_name(dev)

    def record(name, fn):
        t0 = time.perf_counter()
        try:
            metrics = retry_transient(fn, attempts=2, label=name)
            doc["stages"][name] = {
                "ok": True, "wall_s": time.perf_counter() - t0,
                **(metrics or {})}
            log(f"64k probe: {name} OK {metrics}")
            return True
        except Exception as e:  # noqa: BLE001 -- recorded, the rest run
            doc["stages"][name] = {
                "ok": False, "wall_s": time.perf_counter() - t0,
                "error": f"{type(e).__name__}: {str(e)[:500]}"}
            log(f"64k probe: {name} FAILED {type(e).__name__}: "
                f"{str(e)[:300]}")
            return False

    state = {}

    def alloc():
        state["qkv"] = operands(dev, (b, t, h, d), 3, seed=0, scale=0.1)
        state["g"] = operands(dev, (b, t, h, d), 1, seed=3)[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return {"bytes_per_tensor": state["qkv"][0].numel()
                * state["qkv"][0].element_size()}

    if record("alloc_on_device", alloc):
        q, k, v = state["qkv"]
        record("forward", lambda: forward_stage(q, k, v, True, card))
        record("forward_backward", lambda: forward_backward_stage(
            q, k, v, state["g"], True, card))
        record("train_step", lambda: train_step_stage(dev, b, t, h, d))
        record("window", lambda: window_check(
            *operands(dev, (b, t, h, d), 4, seed=4)))
    state.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    doc["ok"] = bool(doc["stages"]) and all(
        s.get("ok") for s in doc["stages"].values())
    return doc


def main(argv=None) -> int:
    """Run, stamp, print and write the document; 0 when every stage
    passed."""
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    args = parse_args(argv)
    doc = stamp_envelope(run(args), "flash_64k_probe/v1")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    print(json.dumps(doc), flush=True)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
