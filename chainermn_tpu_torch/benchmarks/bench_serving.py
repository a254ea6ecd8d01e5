"""Serving benchmark: continuous batching, prefix caching, speculative
decoding and the multi-replica fleet -- one document.

Counterpart of ``benchmarks/bench_serving.py``, with its four sections,
seeded traces, checks and JSON keys:

* ``continuous`` / ``static`` -- ONE open-loop trace replayed through both
  admission policies; the run fails unless continuous beats static on
  throughput (the other sections print their figures beside JAX's
  budgets, :func:`check`);
* ``prefix`` -- a burst whose prompts share ``--prefix-share`` of their
  tokens, replayed with the prefix cache off, then on (``prefix.speedup``);
* ``spec`` -- a decode-heavy burst through the draft+verify step
  (``--spec-k``; the draft is the target's bottom layer,
  :func:`truncated_draft`); ``spec.accept_tokens_per_step`` is the tokens
  landed per verify pass;
* ``fleet`` -- ``--replicas`` engines behind the session-affine
  :class:`~chainermn_tpu_torch.serving.Router` (TTFT percentiles and the
  affinity check).

Beside JAX's keys, each policy carries ``requests_per_sec``,
``mean_active`` (occupied slots over the steps that ran a forward),
``passes`` (forward passes of the target and the draft: on the card each
launches the flash forward kernel once a layer), ``free_pages`` after the
drain, and on the card ``peak_gb`` and ``busy``, the device's busy share
over ``PROFILE_STEPS`` steps of a full batch (:func:`busy_share`).  Wall
time is host time.  The model is the port's
:class:`~chainermn_tpu_torch.models.TransformerLM` with random weights from
``--seed``; its position table is ``--max-len`` (default: the cache's reach
plus a step's padded tail, which the engine needs).

``--tp N`` shards the model over N ranks, one process a GPU under
``torchrun --nproc_per_node N`` (:class:`~chainermn_tpu_torch.serving.
InferenceEngine` over their communicator): rank 0 drives every section
(its engines' steps name the engine to the other ranks, which step it in
lockstep) and prints the report; rates are per ``N`` GPUs.

    python -m chainermn_tpu_torch.benchmarks.bench_serving --device cpu \\
        --requests 16 --spec-k 2 --replicas 2 --out serving.json
    torchrun --nproc_per_node 2 -m chainermn_tpu_torch.benchmarks.\\
bench_serving --tp 2
    python -m chainermn_tpu_torch.benchmarks.bench_serving  # on the card
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

PROFILE_STEPS = 5    # steps of each policy's busy-share profile (card only)
# kernel-name fragments -> category of a serving step's device time (first
# match wins; the rest is "other": layer norms, GELU, argmax, embeddings)
SERVE_CATEGORIES = (
    ("flash forward (CUDA)", ("fwd_wgmma", "fwd_tc", "fwd_f32")),
    ("page gather / write", ("index", "gather", "scatter")),
    ("gemm", ("gemm", "sm90_", "cutlass", "xmma", "nvjet")),
    ("copies / casts", ("copy", "memcpy", "memset")),
)


def build_trace(args):
    """The shared request trace: (arrival_offset_s, prompt, max_new)."""
    rng = np.random.default_rng(args.seed)
    gaps = rng.exponential(1.0 / args.rate, size=args.requests)
    arrivals = np.cumsum(gaps)
    trace = []
    for t in arrivals:
        n = int(rng.integers(args.min_prompt, args.max_prompt + 1))
        prompt = list(map(int, rng.integers(1, args.vocab, size=n)))
        # decode lengths vary per request: continuous batching exploits the
        # spread, a static batch drains at the pace of its longest member
        max_new = int(rng.integers(1, args.max_new + 1))
        trace.append((float(t), prompt, max_new))
    return trace


def _pct(a, q):
    return float(np.percentile(a, q)) if len(a) else None


def _latency_block(comps):
    ttfts = [c.ttft for c in comps if c.token_times]
    per_token = []
    for c in comps:
        per_token.extend(np.diff(c.token_times))
    return {
        "ttft_s": {"mean": float(np.mean(ttfts)) if ttfts else None,
                   "p50": _pct(ttfts, 50), "p99": _pct(ttfts, 99)},
        "per_token_s": {"mean": float(np.mean(per_token))
                        if per_token else None,
                        "p50": _pct(per_token, 50),
                        "p99": _pct(per_token, 99)},
    }


def _config(args, **kw):
    from chainermn_tpu_torch.serving import ServingConfig
    return ServingConfig(page_size=args.page_size, num_pages=args.num_pages,
                         max_seqs=args.max_seqs,
                         chunk_tokens=args.chunk_tokens,
                         max_pages_per_seq=args.max_pages_per_seq,
                         cache_dtype=getattr(torch, args.dtype), **kw)


def _engine(model, args, draft_model=None, **kw):
    """An engine of the flags' configuration; with ``--tp`` over the
    ranks' communicator (``args.comm``)."""
    from chainermn_tpu_torch.serving import InferenceEngine
    return InferenceEngine(model, _config(args, tp_size=args.tp, **kw),
                           draft_model=draft_model,
                           comm=getattr(args, "comm", None))


def _lead(args, *engines, release: bool = False) -> bool:
    """With ``--tp``, rank 0 drives each section and the other ranks step
    the same engines in the same order: on rank 0 each engine's ``step``
    first names the engine to the others (True is returned); the others
    step the engines so named until rank 0 ends the section with
    ``release=True`` (:func:`_release`; False is returned to them).
    Both sides of this broadcast protocol sit under the one rank guard
    below.  Without ``--tp``: True."""
    comm = getattr(args, "comm", None)
    if comm is None:
        return True
    if comm.rank == 0:
        if release:
            comm.bcast_obj(None, root=0)
            return True
        for i, eng in enumerate(engines):
            def announced(step=eng.step, i=i):
                comm.bcast_obj(i, root=0)
                return step()
            eng.step = announced
        return True
    if release:  # the other ranks left the section on its end message
        return False
    while True:
        i = comm.bcast_obj(None, root=0)
        if i is None:
            return False
        engines[i].step()


def _release(args) -> None:
    """Rank 0: the section is over (the other ranks leave :func:`_lead`)."""
    _lead(args, release=True)


def _cuda(args) -> bool:
    return torch.device(args.device).type == "cuda"


def _sync(args):
    if _cuda(args):
        torch.cuda.synchronize()


def _warm(eng, prompt):
    """One request through the engine before its timed window (cuBLAS and
    the kernels' first builds and launches)."""
    eng.submit(prompt, max_new_tokens=1)
    eng.run_until_idle()
    eng.completions.clear()


def busy_share(eng, trace, args):
    """The device's busy share over ``PROFILE_STEPS`` steps of a full
    batch: the first ``2 * max_seqs`` requests of ``trace`` are submitted,
    8 steps run, then that many steps are timed on the host (between two
    synchronisations) and that many more are profiled
    (:func:`chainermn_tpu_torch.utils.trace.device_time`; their device
    time also by ``SERVE_CATEGORIES``); the engine is drained after.  Card
    only."""
    import tempfile

    from chainermn_tpu_torch.utils.trace import (OTHER_CATEGORY,
                                                 device_op_times,
                                                 device_time,
                                                 kernel_category)
    n = PROFILE_STEPS
    for _, prompt, _max_new in trace[:2 * args.max_seqs]:
        eng.submit(prompt, max_new_tokens=args.max_new)
    for _ in range(8):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with tempfile.TemporaryDirectory() as tmp:
        dev_ms = device_time(eng.step, (), steps=n, warmup=0, trace_dir=tmp)
        cats = {}
        for name, (ms, _) in device_op_times(tmp).items():
            if "spin_kernel" not in name:   # the capture's markers
                c = kernel_category(name, SERVE_CATEGORIES)
                c = "other" if c == OTHER_CATEGORY else c
                cats[c] = cats.get(c, 0.0) + ms / n
    eng.run_until_idle()
    eng.completions.clear()
    return {"steps": n, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": dev_ms, "busy_share": dev_ms / wall_ms,
            "device_ms_by_category": cats}


def run_policy(policy, model, trace, args):
    eng = _engine(model, args, policy=policy)
    if not _lead(args, eng):
        return None
    _warm(eng, trace[0][1])
    _sync(args)
    if _cuda(args):
        torch.cuda.reset_peak_memory_stats()
    # span seam (--metrics runs have observability on, so the engine
    # records serving_step/serving_forward spans): where the ring stands,
    # so the summary covers only the timed window
    from chainermn_tpu_torch.observability import flight_recorder as _flight
    fr = _flight.get_flight_recorder()
    seq0 = -1
    if fr is not None:
        evs = fr.snapshot()
        seq0 = evs[-1]["seq"] if evs else -1
    t0 = time.perf_counter()
    pending = list(trace)
    steps = 0
    active = []
    while pending or not eng.idle():
        now = time.perf_counter() - t0
        while pending and pending[0][0] <= now:
            off, prompt, max_new = pending.pop(0)
            eng.submit(prompt, max_new_tokens=max_new, arrival=t0 + off)
        if eng.idle():
            time.sleep(0.001)   # open loop: wait for the next arrival
            continue
        res = eng.step()
        if res.ran_forward:
            active.append(int((res.n_new > 0).sum()))
        steps += 1
        if steps > args.max_steps:
            raise RuntimeError(
                f"[{policy}] still busy after {args.max_steps} steps")
    wall = time.perf_counter() - t0

    comps = list(eng.completions)
    n_tokens = sum(len(c.tokens) for c in comps)
    spans = None
    if fr is not None:
        from chainermn_tpu_torch.observability import span_summary
        spans = span_summary(fr.events_since(seq0), rank=0, k=3)
    out = {
        "policy": policy,
        **({"span_summary": spans} if spans else {}),
        "requests": len(comps),
        "generated_tokens": n_tokens,
        "steps": steps,
        "wall_s": wall,
        "tokens_per_sec": n_tokens / wall,
        "requests_per_sec": len(comps) / wall,
        "mean_active": float(np.mean(active)) if active else 0.0,
        "free_pages": eng.scheduler.allocator.num_free,
        "num_pages": eng.scheduler.num_pages,
        **_latency_block(comps),
    }
    if _cuda(args):
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["busy"] = busy_share(eng, trace, args)
    out["passes"] = dict(eng.passes)
    _release(args)
    return out


# ---- prefix caching ---------------------------------------------------------

def build_prefix_trace(args):
    """System-prompt-heavy burst: every prompt = shared prefix + unique
    tail (``--prefix-share`` of ``--prefix-prompt`` tokens shared)."""
    rng = np.random.default_rng(args.seed + 1)
    sys_len = int(args.prefix_share * args.prefix_prompt)
    sys_prompt = list(map(int, rng.integers(1, args.vocab, size=sys_len)))
    trace = []
    for _ in range(args.requests):
        tail = list(map(int, rng.integers(
            1, args.vocab, size=args.prefix_prompt - sys_len)))
        trace.append((sys_prompt + tail, args.prefix_max_new))
    return trace, sys_len


def _drain_burst(eng, trace, max_steps, args):
    """Closed loop: submit the whole burst at t0, drain, time it."""
    _sync(args)
    t0 = time.perf_counter()
    for prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new, arrival=t0)
    steps = 0
    while not eng.idle():
        eng.step()
        steps += 1
        if steps > max_steps:
            raise RuntimeError(f"still busy after {max_steps} steps")
    wall = time.perf_counter() - t0
    n_tokens = sum(len(c.tokens) for c in eng.completions)
    return wall, steps, n_tokens


def _add_passes(total, eng):
    for k, v in eng.passes.items():
        total[k] = total.get(k, 0) + v


def run_prefix(model, args):
    """The prefix-cache A/B: the same burst, cache off, then on."""
    trace, sys_len = build_prefix_trace(args)
    warm_rng = np.random.default_rng(args.seed + 1000)
    warm = list(map(int, warm_rng.integers(1, args.vocab,
                                           size=args.prefix_prompt)))
    out = {}
    passes = {}
    for label, cached in (("uncached", False), ("cached", True)):
        eng = _engine(model, args, prefix_cache=cached)
        if not _lead(args, eng):
            continue
        # warm-up with a DISJOINT prompt, so the cached run's first request
        # still pays its own cold prefill
        _warm(eng, warm)
        wall, steps, n_tokens = _drain_burst(eng, trace, args.max_steps,
                                             args)
        out[label] = {"wall_s": wall, "steps": steps,
                      "generated_tokens": n_tokens,
                      "tokens_per_sec": n_tokens / wall,
                      **({"stats": eng.scheduler.prefix_stats()}
                         if cached else {})}
        _add_passes(passes, eng)
        _release(args)
        del eng
    if not out:
        return None
    out["shared_prefix_tokens"] = sys_len
    out["speedup"] = (out["cached"]["tokens_per_sec"]
                      / out["uncached"]["tokens_per_sec"])
    out["passes"] = passes
    return out


# ---- speculative decoding ---------------------------------------------------

def truncated_draft(model, n_draft_layers=1):
    """The bench's draft model: the target's bottom ``n_draft_layers``
    blocks with its embeddings, final norm and head (the same modules, not
    copies): correlated with the target at a fraction of a step's cost,
    with no training of its own."""
    from torch import nn

    from chainermn_tpu_torch.models.transformer import TransformerLM

    dev = next(model.parameters()).device
    dm = TransformerLM(model.vocab, model.d_model, n_draft_layers,
                       model.n_heads, model.max_len, "xla",
                       dtype=model.dtype, n_kv_heads=model.n_kv_heads,
                       device=dev, generator=torch.Generator(dev))
    dm.tok_emb, dm.pos_emb = model.tok_emb, model.pos_emb
    dm.ln_f, dm.head = model.ln_f, model.head
    dm.blocks = nn.ModuleList(list(model.blocks)[:n_draft_layers])
    return dm


def build_spec_trace(args):
    """Decode-heavy burst: short prompts, long fixed generations."""
    rng = np.random.default_rng(args.seed + 2)
    trace = []
    for _ in range(args.requests):
        n = int(rng.integers(args.min_prompt, args.max_prompt + 1))
        prompt = list(map(int, rng.integers(1, args.vocab, size=n)))
        trace.append((prompt, args.spec_max_new))
    return trace


def run_spec(model, args):
    """Vanilla vs draft+verify over the same decode-heavy burst."""
    trace = build_spec_trace(args)
    dmodel = truncated_draft(model)
    out = {}
    passes = {}
    eng = _engine(model, args)
    if not _lead(args, eng):
        eng = _engine(model, args, spec_k=args.spec_k, draft_model=dmodel)
        _lead(args, eng)
        return None
    _warm(eng, trace[0][0])
    wall, steps, n_tokens = _drain_burst(eng, trace, args.max_steps, args)
    out["vanilla"] = {"wall_s": wall, "steps": steps,
                      "generated_tokens": n_tokens,
                      "tokens_per_sec": n_tokens / wall}
    _add_passes(passes, eng)
    _release(args)
    del eng
    eng = _engine(model, args, spec_k=args.spec_k, draft_model=dmodel)
    _lead(args, eng)
    _warm(eng, trace[0][0])
    _sync(args)
    t0 = time.perf_counter()
    for prompt, max_new in trace:
        eng.submit(prompt, max_new_tokens=max_new, arrival=t0)
    steps = rows = proposed = accepted = out_tokens = 0
    while not eng.idle():
        res = eng.step()
        steps += 1
        if res.spec is not None:
            rows += res.spec["rows"]
            proposed += res.spec["proposed"]
            accepted += res.spec["accepted"]
            out_tokens += res.spec["out_tokens"]
        if steps > args.max_steps:
            raise RuntimeError(f"spec still busy after {steps} steps")
    wall = time.perf_counter() - t0
    _release(args)
    n_tokens = sum(len(c.tokens) for c in eng.completions)
    out["spec"] = {"wall_s": wall, "steps": steps,
                   "generated_tokens": n_tokens,
                   "tokens_per_sec": n_tokens / wall,
                   "verify_rows": rows, "proposed_tokens": proposed,
                   "accepted_tokens": accepted,
                   "out_tokens": out_tokens}
    _add_passes(passes, eng)
    out["k"] = args.spec_k
    out["draft_layers"] = 1
    out["acceptance_rate"] = accepted / proposed if proposed else None
    # tokens landed per verify pass (a + 1 a row); > 1.0 means speculation
    # beats one-token-per-step decode
    out["accept_tokens_per_step"] = out_tokens / rows if rows else None
    out["speedup"] = (out["spec"]["tokens_per_sec"]
                      / out["vanilla"]["tokens_per_sec"])
    out["passes"] = passes
    out["completions"] = {c.rid: c.tokens for c in eng.completions}
    return out


# ---- multi-replica fleet ----------------------------------------------------

def run_fleet(model, trace, args):
    """Open-loop sessionful trace over ``--replicas`` engines (prefix cache
    on) behind the session-affine router; every turn of a session opens
    with that session's own two-page system prefix."""
    from chainermn_tpu_torch.serving import Router

    engines = [_engine(model, args, prefix_cache=True)
               for _ in range(args.replicas)]
    if not _lead(args, *engines):
        return None
    for eng in engines:
        _warm(eng, trace[0][1])
    router = Router(engines)
    n_sessions = args.sessions or max(1, args.requests // 3)
    rng = np.random.default_rng(args.seed + 3)
    sys_len = 2 * args.page_size        # two full shared pages / session
    sys_prompts = [list(map(int, rng.integers(1, args.vocab,
                                              size=sys_len)))
                   for _ in range(n_sessions)]

    _sync(args)
    t0 = time.perf_counter()
    pending = [(off, sys_prompts[i % n_sessions] + prompt, max_new,
                f"s{i % n_sessions}")
               for i, (off, prompt, max_new) in enumerate(trace)]
    steps = 0
    while pending or not router.idle():
        now = time.perf_counter() - t0
        while pending and pending[0][0] <= now:
            off, prompt, max_new, sess = pending.pop(0)
            router.submit(prompt, max_new, session=sess, arrival=t0 + off)
        if router.idle():
            time.sleep(0.001)
            continue
        router.step()
        steps += 1
        if steps > args.max_steps:
            raise RuntimeError(f"fleet still busy after {steps} steps")
    wall = time.perf_counter() - t0
    _release(args)

    comps = [c for _, _, c in router.completions]
    n_tokens = sum(len(c.tokens) for c in comps)
    by_sess = {}
    per_replica = [0] * args.replicas
    for rid, sess, rep in router.dispatch_log:
        by_sess.setdefault(sess, set()).add(rep)
        per_replica[rep] += 1
    passes = {}
    for eng in engines:
        _add_passes(passes, eng)
    return {
        "replicas": args.replicas,
        "sessions": n_sessions,
        "requests": len(comps),
        "generated_tokens": n_tokens,
        "steps": steps,
        "wall_s": wall,
        "tokens_per_sec": n_tokens / wall,
        "requests_per_replica": per_replica,
        "session_affinity_ok": all(len(r) == 1 for r in by_sess.values()),
        "prefix_hits": sum(e.scheduler.prefix_stats()["hits"]
                           for e in engines),
        "free_pages": [e.scheduler.allocator.num_free for e in engines],
        "passes": passes,
        **_latency_block(comps),
    }


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="the card by default; 'cpu' runs the plain "
                        "attention")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16", "float16"),
                   help="the model's compute dtype and the cache's")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--rate", type=float, default=200.0,
                   help="open-loop arrival rate (requests/sec)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-prompt", type=int, default=4)
    p.add_argument("--max-prompt", type=int, default=24)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--max-len", type=int, default=None,
                   help="position table (default: cache reach + "
                        "chunk_tokens + spec_k)")
    p.add_argument("--max-seqs", type=int, default=4)
    p.add_argument("--chunk-tokens", type=int, default=8)
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--num-pages", type=int, default=64)
    p.add_argument("--max-pages-per-seq", type=int, default=8)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways: one process a rank under "
                        "torchrun (--nproc_per_node = --tp); rank 0 "
                        "reports")
    p.add_argument("--prefix-share", type=float, default=0.9,
                   help="fraction of each prefix-section prompt that is "
                        "the shared system prefix (0 skips the section)")
    p.add_argument("--prefix-prompt", type=int, default=48)
    p.add_argument("--prefix-max-new", type=int, default=4)
    p.add_argument("--spec-k", type=int, default=0,
                   help="draft tokens per decode step (0 skips the spec "
                        "section)")
    p.add_argument("--spec-max-new", type=int, default=16)
    p.add_argument("--replicas", type=int, default=1,
                   help="router fleet size (>1 adds the fleet section)")
    p.add_argument("--sessions", type=int, default=None,
                   help="fleet sessions (default requests // 3)")
    p.add_argument("--max-steps", type=int, default=100000)
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the bench_serving/v2 JSON document")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="turn observability on and append the sections' "
                        "records and a registry snapshot to this metrics "
                        "JSONL (JAX's kinds)")
    return p


def build_model(args):
    from chainermn_tpu_torch.models.transformer import TransformerLM
    dev = torch.device(args.device)
    max_ctx = args.max_pages_per_seq * args.page_size
    max_len = args.max_len or max_ctx + args.chunk_tokens + args.spec_k
    return TransformerLM(args.vocab, args.d_model, args.n_layers,
                         args.n_heads, max_len, "xla",
                         dtype=getattr(torch, args.dtype),
                         device=dev,
                         generator=torch.Generator(dev).manual_seed(
                             args.seed))


def run(args, model=None):
    """Every section the flags ask for: the report (its JSON keys are
    JAX's, plus the port's named in the module note).  With ``--tp`` every
    rank of the world runs it and rank 0 returns the report, the others
    None."""
    args.comm = None
    if args.tp > 1:
        from chainermn_tpu_torch.communicators import create_communicator
        args.comm = create_communicator("naive", device=args.device)
        if args.comm.size != args.tp:
            raise ValueError(
                f"--tp {args.tp} runs one process a rank: start "
                f"{args.tp} ranks (torchrun --nproc_per_node {args.tp}), "
                f"not {args.comm.size}")
        args.device = str(args.comm.device)
    model = model if model is not None else build_model(args)
    if args.comm is not None:
        args.comm.bcast_data(model)   # one set of weights on every rank
    trace = build_trace(args)
    results = {p: run_policy(p, model, trace, args)
               for p in ("continuous", "static")}
    sections = {}
    if args.prefix_share > 0:
        sections["prefix"] = run_prefix(model, args)
    if args.spec_k > 0:
        sections["spec"] = run_spec(model, args)
    if args.replicas > 1:
        sections["fleet"] = run_fleet(model, trace, args)
    if results["continuous"] is None:   # a rank that followed rank 0
        return None
    speedup = (results["continuous"]["tokens_per_sec"]
               / results["static"]["tokens_per_sec"])
    report = {
        "schema": "bench_serving/v2",
        "config": {k: v for k, v in vars(args).items()
                   if k not in ("out", "metrics", "comm")},
        "devices": args.tp,
        "continuous": results["continuous"],
        "static": results["static"],
        "speedup": speedup,
        **sections,
    }
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    stamp_envelope(report, n_devices=args.tp, backend=torch.device(
        args.device).type)
    return report


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    max_ctx = args.max_pages_per_seq * args.page_size
    if args.prefix_share > 0 and \
            args.prefix_prompt + args.prefix_max_new > max_ctx:
        p.error(f"--prefix-prompt + --prefix-max-new exceeds the cache "
                f"reach ({max_ctx} tokens)")
    if args.metrics:
        from chainermn_tpu_torch import observability as obs
        obs.enable()
    report = run(args)
    if report is None:      # --tp: a rank other than 0
        return 0
    if "spec" in report:
        report["spec"].pop("completions")
    if args.metrics:
        write_metrics(args.metrics, report)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return check(report)


def write_metrics(path: str, report: dict) -> None:
    """JAX's ``--metrics`` records: one ``bench_serving`` record a policy,
    the prefix, spec and fleet sections, then a registry snapshot."""
    from chainermn_tpu_torch.observability import (
        append_jsonl, get_registry, write_snapshot_jsonl)
    for policy in ("continuous", "static"):
        append_jsonl(path, {"kind": "bench_serving", **report[policy]})
    for section in ("prefix", "spec", "fleet"):
        if section in report:
            append_jsonl(path, {"kind": f"bench_serving_{section}",
                                **report[section]})
    write_snapshot_jsonl(path, get_registry().snapshot())


def check(report) -> int:
    """JAX's verdict: 1 unless continuous beats static on throughput.  The
    prefix speedup, the spec tokens per verify pass and the fleet's
    affinity are printed beside their budgets (>= 1.3, > 1.0, ok)."""
    rc = 0
    c, s = report["continuous"], report["static"]
    if report["speedup"] <= 1.0:
        print(f"FAIL: continuous batching did not beat static "
              f"({c['tokens_per_sec']:.1f} vs {s['tokens_per_sec']:.1f} "
              f"tok/s)", file=sys.stderr)
        rc = 1
    else:
        print(f"continuous beats static: {report['speedup']:.2f}x "
              f"({c['tokens_per_sec']:.1f} vs {s['tokens_per_sec']:.1f} "
              f"tok/s)")
    if "prefix" in report:
        pr = report["prefix"]
        print(f"prefix cache: {pr['speedup']:.2f}x "
              f"({pr['cached']['tokens_per_sec']:.1f} vs "
              f"{pr['uncached']['tokens_per_sec']:.1f} tok/s; budget "
              f">= 1.3)")
    if "spec" in report:
        sp = report["spec"]
        print(f"spec decode k={sp['k']}: "
              f"{sp['accept_tokens_per_step']:.2f} tokens/verify pass "
              f"(acceptance {sp['acceptance_rate']:.2f}; budget > 1.0)")
    if "fleet" in report:
        f = report["fleet"]
        print(f"fleet x{f['replicas']}: {f['tokens_per_sec']:.1f} tok/s, "
              f"ttft p50={f['ttft_s']['p50']:.3f}s "
              f"p99={f['ttft_s']['p99']:.3f}s, affinity "
              f"{'ok' if f['session_affinity_ok'] else 'VIOLATED'}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
