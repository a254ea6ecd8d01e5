"""The port's serving engine against JAX's, on the CPU.

A tiny LM (vocab 256, d_model 64, 2 layers, 4 heads, 2 kv heads) is
initialised by flax (seeded, every constant leaf moved by noise) and
carried into the port with ``chainermn_tpu_torch.weights``.  Both engines
take the same requests and are stepped side by side; at every step:

* the plans (admissions, retirements, evictions) are equal;
* every active slot's kept logits are within 1e-4 (absolute and relative)
  of JAX's while its request's tokens so far agree;
* the emitted tokens -- and with ``spec_k`` the accept decisions -- are
  equal, except where JAX's top-two logit gap at the first differing
  position is at most 1e-3 (a float32 near-tie); that request is then no
  longer compared.

At the end the completions, step counts and free pages are equal.  The
``attend=`` hook is held to JAX's; a 2-process gloo world runs the
engine in lockstep over the communicator's object plane.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JLM
from chainermn_tpu.ops.flash_attention import flash_attention as jflash
from chainermn_tpu.serving import InferenceEngine as JEngine
from chainermn_tpu.serving import ServingConfig as JConfig
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.benchmarks.bench_serving import truncated_draft
from chainermn_tpu_torch.models.transformer import TransformerLM
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.serving import InferenceEngine, ServingConfig

from torch_dist_worker import launch
from torch_flax_parity import perturbed_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LM = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, max_len=128,
          n_kv_heads=2)
LOGIT_TOL = 1e-4   # absolute and relative, kept logits
GAP = 1e-3         # tokens compared where JAX's top-two gap exceeds this


@pytest.fixture(scope="module")
def lm():
    jm = JLM(attention_impl="xla", **LM)
    variables = perturbed_variables(jm, np.zeros((1, 4), np.int32))
    tm = TransformerLM(LM["vocab"], LM["d_model"], LM["n_layers"],
                       LM["n_heads"], LM["max_len"], "xla",
                       n_kv_heads=LM["n_kv_heads"], device="cpu")
    weights.load_flax_variables(tm, variables)
    return jm, variables, tm


def _jax_draft(jm, variables):
    """JAX's bench draft: block 0 with the embeddings, norm and head."""
    dm = JLM(vocab=jm.vocab, d_model=jm.d_model, n_layers=1,
             n_heads=jm.n_heads, max_len=jm.max_len, attention_impl="xla",
             n_kv_heads=jm.n_kv_heads)
    p = variables["params"]
    return dm, {"params": {k: p[k] for k in ("tok_emb", "pos_emb",
                                             "block_0", "ln_f", "head")}}


def _prompts(sizes, seed=0, stem=()):
    rng = np.random.default_rng(seed)
    return [list(stem) + list(map(int, rng.integers(1, LM["vocab"], size=n)))
            for n in sizes]


def _gap(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


def side_by_side(lm, cfg, prompts, max_new, spec_k=0):
    """Both engines over ``prompts``, stepped together and compared as the
    module note says; returns the statistics of the run."""
    jm, variables, tm = lm
    jkw, tkw = {}, {}
    models = [(jm, variables)]
    if spec_k:
        jd, jdp = _jax_draft(jm, variables)
        jkw = dict(draft_model=jd, draft_params=jdp)
        tkw = dict(draft_model=truncated_draft(tm))
        models.append((jd, jdp))
    jeng = JEngine(jm, variables, JConfig(**cfg, keep_logits=True,
                                          spec_k=spec_k), **jkw)
    teng = InferenceEngine(tm, ServingConfig(**cfg, keep_logits=True,
                                             spec_k=spec_k), **tkw)
    ctx = {}
    for p, n in zip(prompts, max_new):
        rid = jeng.submit(p, n)
        assert teng.submit(p, n) == rid
        ctx[rid] = list(p)
    diverged = set()
    stats = dict(steps=0, compared_rows=0, tokens=0, near_ties=0,
                 decisions=0, accepted=0, multi_chunk=set())
    while not (jeng.idle() and teng.idle()):
        jr, tr = jeng.step(), teng.step()
        stats["steps"] += 1
        assert tr.plan == jr.plan, f"step {stats['steps']}"
        np.testing.assert_array_equal(tr.n_new, jr.n_new)
        if not jr.ran_forward:
            continue
        slot_of = {s.rid: i for i, s in enumerate(teng.scheduler.slots)
                   if s is not None}
        for rid, i in slot_of.items():
            if tr.n_new[i] == cfg["chunk_tokens"]:
                stats["multi_chunk"].add(rid)
            if rid in diverged or tr.n_new[i] == 0:
                continue
            np.testing.assert_allclose(tr.last_logits[i], jr.last_logits[i],
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
            stats["compared_rows"] += 1
        jt, tt = {}, {}
        for rid, tok, _ in jr.emitted:
            jt.setdefault(rid, []).append(tok)
        for rid, tok, _ in tr.emitted:
            tt.setdefault(rid, []).append(tok)
        assert set(tt) == set(jt)
        for rid, toks in jt.items():
            if rid in diverged:
                continue
            mine = tt[rid]
            if mine == toks:
                ctx[rid].extend(toks)
                stats["tokens"] += len(toks)
                continue
            k = next((j for j, (a, b) in enumerate(zip(mine, toks))
                      if a != b), min(len(mine), len(toks)))
            # a near-tie of the target (or, with spec_k, of the draft, whose
            # proposals set how many tokens a verify pass lands) explains it
            seq = jnp.asarray([ctx[rid] + toks[:k]], jnp.int32)
            gap = min(_gap(m.apply(v, seq)[0, -1]) for m, v in models)
            assert gap <= GAP, (
                f"rid {rid}: tokens {mine} vs JAX {toks} at a top-two gap "
                f"of {gap}")
            stats["near_ties"] += 1
            diverged.add(rid)
        if spec_k:
            assert (tr.spec is None) == (jr.spec is None)
            if tr.spec is not None:
                td = {d[0]: d for d in teng._last_spec[1]}
                for d in jeng._last_spec[1]:
                    rid = teng.scheduler.slots[d[0]].rid
                    if rid not in diverged:
                        assert td[d[0]] == d
                        stats["decisions"] += 1
                        stats["accepted"] += d[1] - 1
        assert stats["steps"] < 500
    jc = {c.rid: c.tokens for c in jeng.completions}
    tc = {c.rid: c.tokens for c in teng.completions}
    assert set(tc) == set(jc)
    for rid in jc:
        if rid not in diverged:
            assert tc[rid] == jc[rid]
    free = teng.scheduler.allocator.num_free
    assert free == jeng.scheduler.allocator.num_free
    # every page back but those the prefix trie keeps
    assert free + len(teng.scheduler.prefix or ()) == cfg["num_pages"]
    assert (teng.scheduler.page_table == cfg["num_pages"]).all()
    assert teng.scheduler.prefix_stats() == jeng.scheduler.prefix_stats()
    stats["completions"] = tc
    stats["prefix"] = teng.scheduler.prefix_stats()
    return stats


BASE = dict(page_size=4, num_pages=32, max_seqs=3, chunk_tokens=4,
            max_pages_per_seq=8)


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_matches_jax(lm, policy):
    prompts = _prompts((5, 3, 9, 11, 2, 7))
    st = side_by_side(lm, dict(BASE, policy=policy), prompts,
                      (4, 8, 3, 5, 6, 2))
    assert len(st["completions"]) == 6
    assert st["tokens"] + st["near_ties"] > 0 and st["compared_rows"] > 20
    assert len(st["multi_chunk"]) >= 2   # 9 and 11 prefill over 3 steps


def test_chunked_prefill_matches_jax(lm):
    """One slot: an 11-token prompt prefills over three 4-token chunks."""
    st = side_by_side(lm, dict(BASE, max_seqs=1), _prompts((11,), seed=4),
                      (6,))
    assert st["multi_chunk"] == {0} and len(st["completions"][0]) == 6


def test_prefix_hits_match_jax(lm):
    """A shared 8-token stem (two pages) across prompts, few pages: hits,
    and evictions under page pressure, the same as JAX's."""
    stem = _prompts((8,), seed=9)[0]
    prompts = _prompts((3, 6, 2, 9, 5, 4), seed=5, stem=stem)
    st = side_by_side(lm, dict(BASE, num_pages=8, prefix_cache=True),
                      prompts, (3, 2, 4, 2, 3, 2))
    assert len(st["completions"]) == 6
    assert st["prefix"]["hits"] >= 3 and st["prefix"]["evictions"] > 0


def test_spec_decode_matches_jax(lm):
    """spec_k 2 with the one-layer draft: equal accept decisions."""
    prompts = _prompts((5, 3, 9, 6), seed=2)
    st = side_by_side(lm, dict(BASE, chunk_tokens=4), prompts,
                      (8, 8, 6, 7), spec_k=2)
    # real accepts and real rejects
    assert st["decisions"] > 5 and 0 < st["accepted"] < 2 * st["decisions"]


def test_attend_hook_matches_jax(lm):
    """``attend(layer, q, k, v)`` sees block ``layer``'s unrepeated GQA
    heads; a flash attention at per-row offsets through it gives JAX's
    logits."""
    jm, variables, tm = lm
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, LM["vocab"], size=(2, 8)).astype(np.int32)
    pos = np.array([0, 5], np.int32)
    seen = {"jax": [], "port": []}

    def jattend(layer, q, k, v):
        seen["jax"].append((layer, q.shape, k.shape, v.shape))
        return jflash(q, k, v, causal=True)

    def tattend(layer, q, k, v):
        seen["port"].append((layer, tuple(q.shape), tuple(k.shape),
                             tuple(v.shape)))
        return flash_attention(q, k, v, causal=True)

    want = jm.apply(variables, jnp.asarray(tokens), pos_offset=jnp.asarray(
        pos), attend=jattend)
    with torch.no_grad():
        got = tm(torch.tensor(tokens), pos_offset=torch.tensor(pos),
                 attend=tattend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert seen["port"] == [tuple(s) for s in seen["jax"]] == [
        (i, (2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16)) for i in range(2)]


def test_engine_refusals():
    tm = TransformerLM(37, 16, 1, 2, 64, device="cpu")
    cfg = dict(page_size=4, num_pages=8, max_seqs=2, chunk_tokens=4,
               max_pages_per_seq=4)
    # tensor-parallel decode is ported (A12): two ways over no communicator
    # are more ways than ranks, JAX's refusal of more ways than devices
    with pytest.raises(ValueError, match="exceeds the 1 ranks"):
        InferenceEngine(tm, ServingConfig(**cfg, tp_size=2))
    with pytest.raises(ValueError, match="requires a draft_model"):
        InferenceEngine(tm, ServingConfig(**cfg, spec_k=2))
    with pytest.raises(ValueError, match="chunk_tokens >= spec_k"):
        InferenceEngine(tm, ServingConfig(**cfg, spec_k=4),
                        draft_model=tm)
    with pytest.raises(ValueError, match="past the model's max_len"):
        InferenceEngine(tm, ServingConfig(**dict(cfg, max_pages_per_seq=16)))


def test_two_process_lockstep(tmp_path):
    """Two gloo ranks drive the engine in lockstep: only rank 0 submits,
    plans ride ``bcast_obj``; vanilla and spec_k 2 give equal completion
    digests on both ranks, the single-process engine's tokens, and every
    page freed; with spec the accept decisions were checked each step."""
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, 37, size=n))) for n in (5, 3, 6)]
    outs = launch("serve", {"parts": np.asarray("lockstep"),
                            "prompts": np.asarray(json.dumps(prompts)),
                            "steps": np.asarray(30)}, 2, tmp_path)
    model = TransformerLM(37, 16, 2, 2, 64, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, ServingConfig(
        page_size=4, num_pages=16, max_seqs=2, chunk_tokens=4,
        max_pages_per_seq=4))
    for p in prompts:
        eng.submit(p, 4)
    alone = sorted([c.rid, c.tokens] for c in eng.run_until_idle())
    for label in ("vanilla", "spec"):
        digests = [json.loads(str(o[f"{label}/digest"])) for o in outs]
        assert digests[0] == digests[1] and len(digests[0]) == 3
        assert [int(o[f"{label}/free"]) for o in outs] == [16, 16]
        if label == "vanilla":
            assert digests[0] == alone
    assert min(int(o["spec/pickups"]) for o in outs) > 3
