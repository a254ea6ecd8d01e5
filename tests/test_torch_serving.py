"""The port's serving host logic and cache functions against JAX's.

The page allocator, the prefix trie and the admission scheduler are host
Python in both packages: driven by the same seeded operations they must
give equal results exactly (plans, page tables, batches, emitted tokens,
errors).  ``write_kv``/``gather_kv`` must place the same values exactly
(every page but the trash page, which padded rows may hit several times);
``paged_attention`` must agree with JAX's at float32 within 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainermn_tpu.serving import kv_cache as jkv
from chainermn_tpu.serving import scheduler as jsched
from chainermn_tpu_torch.serving import kv_cache as tkv
from chainermn_tpu_torch.serving import scheduler as tsched
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _outcome(fn):
    """``fn()``'s value, or its error's type name and message."""
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


# ---- page allocator -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax(seed):
    rng = np.random.default_rng(seed)
    j, t = jkv.PageAllocator(12), tkv.PageAllocator(12)
    held = []
    for _ in range(200):
        op = rng.integers(5)
        pages = ([int(rng.choice(held))] if held and rng.random() < 0.9
                 else [int(rng.integers(-1, 14))])
        if op == 0:
            n = int(rng.integers(0, 5))
            calls = [lambda a=a: a.alloc(n) for a in (j, t)]
        elif op == 1:
            calls = [lambda a=a: a.free(pages) for a in (j, t)]
        elif op == 2:
            calls = [lambda a=a: a.retain(pages) for a in (j, t)]
        elif op == 3:
            calls = [lambda a=a: a.would_free(held[:3] + held[:1])
                     for a in (j, t)]
        else:
            calls = [lambda a=a: a.refcount(pages[0]) for a in (j, t)]
        got_j, got_t = _outcome(calls[0]), _outcome(calls[1])
        assert got_t == got_j
        if op == 0 and got_j[0] == "ok" and got_j[1]:
            held.extend(got_j[1])
        if op == 1 and got_j[0] == "ok" and pages[0] in held:
            held.remove(pages[0])
        assert t.num_free == j.num_free
        assert t._refs == j._refs and t._free == j._free


# ---- prefix trie ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_cache_matches_jax(seed):
    rng = np.random.default_rng(seed)
    page = 4
    caches = []
    for mod in (jkv, tkv):
        alloc = mod.PageAllocator(40)
        caches.append((alloc, mod.PrefixCache(page, alloc)))
    stems = [list(map(int, rng.integers(1, 9, size=8))) for _ in range(3)]
    for _ in range(60):
        prompt = (stems[int(rng.integers(3))][:int(rng.integers(0, 9))]
                  + list(map(int, rng.integers(1, 9, size=int(
                      rng.integers(1, 10))))))
        op, n_evict = rng.integers(4), int(rng.integers(0, 4))
        res = []
        for alloc, pc in caches:
            if op == 0:
                n_full = len(prompt) // page
                pages = alloc.alloc(n_full) or []
                r = _outcome(lambda: pc.insert(prompt, pages, len(pages)))
                alloc.free(pages)
            elif op == 1:
                got, _ = pc.lookup(prompt)
                r = (pc.lookup(prompt), _outcome(
                    lambda: pc.touch(prompt, len(got))))
            elif op == 2:
                r = _outcome(lambda: pc.plan_evictions(n_evict))
            else:
                plan = pc.plan_evictions(1)
                r = (plan, _outcome(lambda: pc.evict_pages(plan)))
            res.append((r, len(pc), pc.evictions, alloc.num_free,
                        dict(alloc._refs)))
        assert res[1] == res[0]


# ---- write_kv / gather_kv / paged_attention ---------------------------------

def _kv_case(seed, h=2, d=3, page=4, n_pages=9, b=4, s=5, m=4):
    rng = np.random.default_rng(seed)
    cache = rng.normal(size=(n_pages + 1, page, h, d)).astype(np.float32)
    perm = rng.permutation(n_pages)
    table = np.full((b, m), n_pages, np.int32)
    table[0, :3] = perm[:3]          # a prefill row
    table[1, :2] = perm[3:5]         # a decode row
    table[2, :4] = perm[5:9]         # a row holding every table entry
    pos0 = np.array([0, 6, 14, 0], np.int32)
    n_new = np.array([5, 1, 4, 0], np.int32)   # row 2 runs past its reach;
    new = rng.normal(size=(b, s, h, d)).astype(np.float32)  # row 3 idle
    return cache, table, pos0, n_new, new


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_and_gather_match_jax(seed):
    cache, table, pos0, n_new, new = _kv_case(seed)
    want = np.asarray(jkv.write_kv(jnp.asarray(cache), jnp.asarray(table),
                                   jnp.asarray(pos0), jnp.asarray(n_new),
                                   jnp.asarray(new)))
    mine = torch.tensor(cache)
    got = tkv.write_kv(mine, torch.tensor(table), torch.tensor(pos0),
                       torch.tensor(n_new), torch.tensor(new))
    assert got is mine  # in place
    np.testing.assert_array_equal(got[:-1].numpy(), want[:-1])
    for tbl in (table, table[:, ::-1].copy()):
        np.testing.assert_array_equal(
            tkv.gather_kv(got, torch.tensor(tbl)).numpy(),
            np.asarray(jkv.gather_kv(jnp.asarray(got.numpy()),
                                     jnp.asarray(tbl))))


def test_idle_rows_write_only_trash():
    cache = tkv.init_kv_cache(1, num_pages=2, page_size=2, n_kv_heads=1,
                              head_dim=1)
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    k = tkv.write_kv(cache.k[0], table, torch.tensor([0]), torch.tensor([0]),
                     torch.full((1, 2, 1, 1), 7.0))
    assert not k[:2].any() and k[2].any()
    assert (cache.num_pages, cache.page_size) == (2, 2)


def test_paged_attention_matches_jax():
    """float32, GQA 4/2, per-row offsets (a prefill chunk, two decode rows,
    an idle row at offset 0) over a shuffled page table: within 1e-5."""
    rng = np.random.default_rng(3)
    b, s, h, hk, d, page, n_pages, m = 4, 4, 4, 2, 8, 4, 16, 4
    k_all = rng.normal(size=(n_pages + 1, page, hk, d)).astype(np.float32)
    v_all = rng.normal(size=(n_pages + 1, page, hk, d)).astype(np.float32)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    table = rng.permutation(n_pages)[:b * m].reshape(b, m).astype(np.int32)
    table[3] = n_pages
    pos0 = np.array([4, 9, 15, 0], np.int32)
    want = np.asarray(jkv.paged_attention(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
        jnp.asarray(table), jnp.asarray(pos0)))
    got = tkv.paged_attention(torch.tensor(q), torch.tensor(k_all),
                              torch.tensor(v_all), torch.tensor(table),
                              torch.tensor(pos0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---- scheduler -------------------------------------------------------------

def _drive(mod, seed, policy, prefix, spec):
    """A seeded workload through one package's scheduler: submits over
    time, plan/apply, batches, sampled tokens (from the seed, not a model);
    returns everything each step showed."""
    rng = np.random.default_rng(seed)
    stems = [list(map(int, rng.integers(1, 30, size=12))) for _ in range(2)]
    sch = mod.AdmissionScheduler(max_seqs=3, page_size=4, num_pages=14,
                                 max_pages_per_seq=6, chunk_tokens=5,
                                 eos_id=7, policy=policy,
                                 prefix_cache=prefix)
    log = []
    for step in range(60):
        for _ in range(int(rng.integers(0, 2))):
            stem = stems[int(rng.integers(2))][:int(rng.integers(0, 13))]
            prompt = stem + list(map(int, rng.integers(
                1, 30, size=int(rng.integers(1, 6)))))
            log.append(("submit", _outcome(lambda: sch.submit(
                prompt, int(rng.integers(1, 8))))))
        plan = sch.build_plan()
        retired = sch.apply_plan(json.loads(json.dumps(plan)))
        batch = sch.step_batch()
        n_new = batch["n_new"]
        if spec:
            n_out = rng.integers(1, 4, size=3).astype(np.int32)
            out = rng.integers(1, 30, size=(3, 3)).astype(np.int32)
            emitted = sch.note_sampled_spec(n_new, out, n_out)
        else:
            emitted = sch.note_sampled(
                n_new, rng.integers(1, 30, size=3).astype(np.int32))
        log.append((plan, [(i, s.rid, s.generated) for i, s in retired],
                    {k: v.tolist() for k, v in batch.items()}, emitted,
                    sch.page_table.tolist(), sch.allocator.num_free,
                    sch.queue_depth, sch.active_count, sch.prefix_stats()))
    return log


@pytest.mark.parametrize("policy,prefix,spec", [
    ("continuous", False, False), ("static", False, False),
    ("continuous", True, False), ("continuous", True, True)])
def test_scheduler_matches_jax(policy, prefix, spec):
    for seed in (0, 1):
        want = _drive(jsched, seed, policy, prefix, spec)
        got = _drive(tsched, seed, policy, prefix, spec)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"seed {seed}, entry {i}"


def test_scheduler_refusals_match_jax():
    for mod in (jsched, tsched):
        with pytest.raises(ValueError, match="policy must be one of"):
            mod.AdmissionScheduler(max_seqs=1, page_size=4, num_pages=4,
                                   max_pages_per_seq=2, chunk_tokens=4,
                                   policy="fifo")
    msgs = []
    for mod in (jsched, tsched):
        s = mod.AdmissionScheduler(max_seqs=1, page_size=4, num_pages=4,
                                   max_pages_per_seq=2, chunk_tokens=4)
        msgs.append([_outcome(lambda: s.submit([], 1)),
                     _outcome(lambda: s.submit([1], 0)),
                     _outcome(lambda: s.submit([1] * 8, 4)),
                     _outcome(lambda: s.apply_plan(
                         {"retire": [[0, 3]], "admit": []}))])
    assert msgs[1] == msgs[0]
