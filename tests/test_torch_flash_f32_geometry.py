"""The float32 flash kernels' tiles and schedules, on the CPU.

``fwd_f32_kernel``, ``dkv_f32_kernel`` and ``dq_f32_kernel`` in
``chainermn_tpu_torch/csrc/flash_attention.cu`` are register-blocked
CUDA-core kernels whose tiles follow from the constants of their header
section.  Checked here:

* the constants, read from the source, against the statement of them below
  (``FWD``, ``DKV``, ``DQ``), and the tiles and shared-memory bytes that
  follow at every head dim the dispatch takes (within the 232,448 bytes a
  block may use), with the row pitches that keep a warp's reads and writes
  on distinct banks;
* the causal schedule: every (q tile, k tile) pair that the mask allows
  is visited exactly once, by the forward's and dQ's blocks (heaviest
  first) and by dK/dV's (over each GQA group), and no other pair;
* a Python mirror of the kernels' float32 order -- the online softmax over
  64-key tiles, dK/dV summed over 64-row q tiles and the GQA group, and dQ
  summed over 64-key tiles, in the kernels' order -- against
  ``flash_forward_plain`` and ``flash_backward_plain`` within the kernels'
  1e-5 gate, and the dQ mirror at one small case against the JAX
  package's dq (its Pallas backward in interpret mode).
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu_torch.ops import _build

fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
jfa = importlib.import_module("chainermn_tpu.ops.flash_attention")

SRC = (_build.CSRC / "flash_attention.cu").read_text()
THREADS = 256
PAD = 4          # floats past D in a staged Q, K, V or dO row
# the forward: 256 threads in row groups of 16 lanes; a thread 8 q rows x 4
# keys of S; two K/V stages
FWD = {"kF32FwdThreads": 256, "kF32FwdLanes": 16, "kF32FwdRows": 8,
       "kF32FwdKeys": 4, "kF32FwdStages": 2}
# dK/dV: 256 threads, 16 key groups x 16 q groups; a thread 4 keys x 4 q
# rows of S^T and dP^T; two Q/dO stages
DKV = {"kF32DkvThreads": 256, "kF32DkvKeys": 4, "kF32DkvRows": 4,
       "kF32DkvStages": 2}
# dQ: 256 threads, 16 q groups x 16 key groups; a thread 4 q rows x 4 keys
# of S and dP; two K/V stages
DQ = {"kF32DqThreads": 256, "kF32DqKeyGroups": 16, "kF32DqRows": 4,
      "kF32DqKeys": 4, "kF32DqStages": 2}
SMEM = 232_448   # shared memory a block may use on an H100
HEAD_DIMS = (16, 32, 64, 128)


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _al(x):
    return (x + 127) // 128 * 128


def fwd_tiles(d):
    nt, ns, tx = FWD["kF32FwdThreads"], FWD["kF32FwdStages"], \
        FWD["kF32FwdLanes"]
    ty = nt // tx
    bq, bk = ty * FWD["kF32FwdRows"], tx * FWD["kF32FwdKeys"]
    ldt, ldp = d + PAD, bk + tx
    kst = _al(4 * max(bk * ldt, bq * ldp)) // 4
    vst = _al(4 * bk * ldt) // 4
    nbytes = (_al(4 * bq * ldt) + 4 * ns * kst + 4 * ns * vst + _al(4 * bq)
              + _al(4 * ns * bk))
    return dict(tx=tx, ty=ty, bq=bq, bk=bk, ldt=ldt, ldp=ldp, dn=d // tx,
                bytes=nbytes)


def dkv_tiles(d):
    nt, ns = DKV["kF32DkvThreads"], DKV["kF32DkvStages"]
    tk = nt // 16
    bk, bq = tk * DKV["kF32DkvKeys"], 16 * DKV["kF32DkvRows"]
    ldt, ldp = d + PAD, bq + 8
    qst = _al(4 * bq * ldt) // 4
    nbytes = (2 * _al(4 * bk * ldt) + 8 * ns * qst + _al(4 * bk * ldp)
              + 4 * _al(4 * ns * bq) + _al(4 * bk))
    return dict(bk=bk, bq=bq, ldt=ldt, ldp=ldp, dn=d // 16, bytes=nbytes)


def dq_tiles(d):
    nt, ns, tk = DQ["kF32DqThreads"], DQ["kF32DqStages"], \
        DQ["kF32DqKeyGroups"]
    tq = nt // tk
    bq, bk = tq * DQ["kF32DqRows"], tk * DQ["kF32DqKeys"]
    ldt, ldp = d + PAD, bk + 8
    kst = _al(4 * bk * ldt) // 4
    nbytes = (2 * _al(4 * bq * ldt) + 8 * ns * kst + _al(4 * bq * ldp)
              + 4 * _al(4 * bq) + _al(4 * ns * bk))
    return dict(tk=tk, bq=bq, bk=bk, ldt=ldt, ldp=ldp, dn=d // tk,
                bytes=nbytes)


def test_constants_match_the_kernels():
    assert _constant("kThreads") == THREADS
    assert _constant("kF32Pad") == PAD
    for name, value in {**FWD, **DKV}.items():
        assert _constant(name) == value, name
    # the byte counts mirrored above are the kernels' own
    for text in (
            "static constexpr int LDP = BK + TX;",
            "al(4 * (BK * LDT > BQ * LDP ? BK * LDT : BQ * LDP)) / 4);",
            "static constexpr size_t bytes = al(4 * BQ * LDT) + 4 * NS * "
            "size_t(KST) +\n                                  4 * NS * "
            "size_t(VST) + al(4 * BQ) +\n                                  "
            "al(4 * NS * BK);",
            "static constexpr int TK = NT / TQ;",
            "static constexpr int LDP = BQ + 8;",
            "static constexpr size_t bytes = 2 * al(4 * BK * LDT) +\n"
            "                                  8 * NS * size_t(QST) + al(4 * "
            "BK * LDP) +\n                                  4 * al(4 * NS * "
            "BQ) + al(4 * BK);"):
        assert text in SRC, text


def test_dq_constants_match_the_kernel():
    for name, value in DQ.items():
        assert _constant(name) == value, name
    for text in (
            "static constexpr int TQ = NT / TK;     // q groups",
            "static constexpr int LDP = BK + 8;     // dS: [q][key]",
            "static constexpr int KST = static_cast<int>(al(4 * BK * LDT) / "
            "4);",
            "static constexpr size_t bytes = 2 * al(4 * BQ * LDT) +\n"
            "                                  8 * NS * size_t(KST) + al(4 * "
            "BQ * LDP) +\n                                  4 * al(4 * BQ) + "
            "al(4 * NS * BK);"):
        assert text in SRC, text
    # the launch takes the layout's threads and bytes
    assert ("dim3((a.Tq + L::BQ - 1) / L::BQ, bh), L::NT,\n"
            "                           L::bytes, s, device, done, a);") in SRC


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tiles_fit_and_keep_reads_on_distinct_banks(d):
    f, k = fwd_tiles(d), dkv_tiles(d)
    assert (f["bq"], f["bk"]) == (128, 64)
    assert (k["bk"], k["bq"]) == (64, 64)
    assert f["bytes"] <= SMEM and k["bytes"] <= SMEM
    assert d % f["tx"] == 0 and d % 16 == 0 and 32 % f["tx"] == 0
    for ldt in (f["ldt"], k["ldt"]):
        # 16-byte rows for cp.async and float4 reads; eight consecutive
        # rows (a quarter warp's K, Q or dO reads) on eight bank quads
        assert (4 * ldt) % 16 == 0
        assert len({(r * ldt) % 32 // 4 for r in range(8)}) == 8
    # a warp writes P (forward: 32 / TX rows of TX lanes) and P^T (dK/dV: 4
    # key rows of 8 q lanes) on 32 distinct banks
    rows = 32 // f["tx"]
    assert len({(r * f["ldp"] + c) % 32 for r in range(rows)
                for c in range(f["tx"])}) == 32
    assert len({(r * k["ldp"] + c) % 32 for r in range(4)
                for c in range(8)}) == 32
    assert (4 * f["ldp"]) % 16 == 0 and (4 * k["ldp"]) % 16 == 0


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_dq_tiles_fit_and_keep_reads_on_distinct_banks(d):
    t = dq_tiles(d)
    assert (t["bq"], t["bk"]) == (64, 64)
    assert t["bytes"] <= SMEM
    if d == 128:  # Q and dO, two K/V stages, dS, the row and key vectors
        assert t["bytes"] == 67_584 + 135_168 + 18_432 + 1_024 + 512
    # 16-byte staged rows; a quarter warp's eight K or V rows (one per key
    # group) on eight bank quads, its Q and dO reads one broadcast row
    assert (4 * t["ldt"]) % 16 == 0
    assert len({(r * t["ldt"]) % 32 // 4 for r in range(8)}) == 8
    # a warp writes dS (4 q rows of 8 key lanes) on 32 distinct banks and
    # reads its rows 128 bits at a time along the keys
    assert len({(r * t["ldp"] + c) % 32 for r in range(4)
                for c in range(8)}) == 32
    assert (4 * t["ldp"]) % 16 == 0 and t["bk"] % 4 == 0
    # dS K: a quarter warp's eight key groups read eight consecutive
    # float4 of one K row (VW = 4 floats each) once D >= 64
    assert d % t["tk"] == 0 and t["tk"] % 8 == 0


def _causal_tiles(q_last, goff, tile, n):
    j = 0
    while j < n and q_last >= goff + j * tile:
        j += 1
    return j


def _allowed(tq, tk, gq, gk, causal, bq, bk):
    """(q tile, k tile) pairs holding at least one (q, k) the mask allows."""
    pairs = set()
    for qt in range(-(-tq // bq)):
        q_last = gq + min((qt + 1) * bq, tq) - 1
        for kt in range(-(-tk // bk)):
            if not causal or q_last >= gk + kt * bk:
                pairs.add((qt, kt))
    return pairs


SCHEDULES = [(8192, 8192, 0, 0), (1000, 1000, 0, 0), (200, 200, 0, 0),
             (96, 128, 7, 5), (1, 4096, 4095, 0), (2048, 2048, 2048, 0),
             (2048, 2048, 0, 6144), (130, 77, 3, 90)]


def _q_tile_walk(t, tq, tk, gq, gk, causal):
    """The (q tile, k tile) pairs that blocks owning q tiles visit in
    launch order (heavy_first, then K/V tiles up to the causal end), and
    each block's count of K/V tiles."""
    bq, bk = t["bq"], t["bk"]
    blocks = -(-tq // bq)
    n_kt = -(-tk // bk)
    visits, work = [], []
    for bx in range(blocks):       # launch order
        qt = blocks - 1 - bx if causal else bx  # heavy_first
        q_valid = min(bq, tq - qt * bq)
        end = (_causal_tiles(gq + qt * bq + q_valid - 1, gk, bk, n_kt)
               if causal else n_kt)
        visits += [(qt, kt) for kt in range(end)]
        work.append(end)
    return visits, work


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk,gq,gk", SCHEDULES)
def test_forward_visits_each_allowed_pair_once_heaviest_first(tq, tk, gq, gk,
                                                            causal):
    t = fwd_tiles(128)
    visits, work = _q_tile_walk(t, tq, tk, gq, gk, causal)
    assert len(visits) == len(set(visits))
    assert set(visits) == _allowed(tq, tk, gq, gk, causal, t["bq"], t["bk"])
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk,gq,gk", SCHEDULES)
def test_dq_visits_each_allowed_pair_once_heaviest_first(tq, tk, gq, gk,
                                                       causal):
    t = dq_tiles(128)
    visits, work = _q_tile_walk(t, tq, tk, gq, gk, causal)
    assert len(visits) == len(set(visits))
    assert set(visits) == _allowed(tq, tk, gq, gk, causal, t["bq"], t["bk"])
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("grp", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk,gq,gk", SCHEDULES)
def test_dkv_visits_each_allowed_pair_once_per_head(tq, tk, gq, gk, causal,
                                                   grp):
    t = dkv_tiles(128)
    bq, bk = t["bq"], t["bk"]
    n_qt = -(-tq // bq)
    visits, work = [], []
    for kt in range(-(-tk // bk)):  # launch order: one block a k tile
        qt0 = 0
        if causal:
            while (qt0 < n_qt
                   and gq + min((qt0 + 1) * bq, tq) - 1 < gk + kt * bk):
                qt0 += 1
        nq = n_qt - qt0
        for it in range(grp * nq):  # the group's heads outer, q tiles inner
            visits.append((it // nq, qt0 + it % nq, kt))
        work.append(grp * nq)
    assert len(visits) == len(set(visits))
    want = {(gi, qt, kt) for gi in range(grp)
            for qt, kt in _allowed(tq, tk, gq, gk, causal, bq, bk)}
    assert set(visits) == want
    if causal and gq <= gk:  # k tile 0 has the most q tiles: heaviest first
        assert work == sorted(work, reverse=True)


def _mask(causal, qpos, kpos, qseg, kseg):
    """[B, 1, Tq', Tk'] allow-mask of one tile pair (qpos/kpos [B, n])."""
    m = torch.ones(qpos.shape[0], 1, qpos.shape[1], kpos.shape[1],
                   dtype=torch.bool)
    if causal:
        m &= (qpos[:, None, :, None] >= kpos[:, None, None, :])
    if qseg is not None:
        m &= qseg[:, None, :, None] == kseg[:, None, None, :]
    return m


def mirror_forward(q, k, v, causal, qseg, kseg, offs, seed, rate):
    """fwd_f32_kernel's float32 order: per q tile, an online softmax over
    the K/V tiles of BK keys up to the causal end."""
    t = fwd_tiles(q.shape[3])
    bq, bk = t["bq"], t["bk"]
    b, tq, h, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    grp = h // hk
    scale = d ** -0.5
    Q = q.permute(0, 2, 1, 3)
    K = k.permute(0, 2, 1, 3).repeat_interleave(grp, 1)
    V = v.permute(0, 2, 1, 3).repeat_interleave(grp, 1)
    bh = torch.arange(b * h).view(b, h, 1, 1)
    out = torch.zeros(b, h, tq, d)
    lse = torch.zeros(b, h, tq)
    inv = 1.0 / (1.0 - rate) if rate else 1.0
    n_kt = -(-tk // bk)
    for q0 in range(0, tq, bq):
        q1 = min(q0 + bq, tq)
        qpos = offs[:, :1] + torch.arange(q0, q1)
        end = (_causal_tiles(int(offs[:, 0].max()) + q1 - 1,
                             int(offs[:, 1].min()), bk, n_kt)
               if causal else n_kt)
        m = torch.full((b, h, q1 - q0, 1), -1e30)
        l = torch.zeros(b, h, q1 - q0, 1)
        o = torch.zeros(b, h, q1 - q0, d)
        for kt in range(end):
            k0, k1 = kt * bk, min(kt * bk + bk, tk)
            kpos = offs[:, 1:] + torch.arange(k0, k1)
            allow = _mask(causal, qpos, kpos,
                          None if qseg is None else qseg[:, q0:q1],
                          None if kseg is None else kseg[:, k0:k1])
            s = torch.where(allow, Q[:, :, q0:q1] @ K[:, :, k0:k1]
                            .transpose(-1, -2) * scale, -1e30)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - mn)
            p = torch.where(allow, torch.exp(s - mn), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            m = mn
            if rate:
                keep = fa._keep_mask(seed, bh, qpos[:, None, :, None],
                                     kpos[:, None, None, :], rate)
                p = torch.where(keep, p * inv, 0.0)
            o = o * alpha + p @ V[:, :, k0:k1]
        empty = l == 0
        out[:, :, q0:q1] = o / torch.where(empty, 1.0, l)
        lse[:, :, q0:q1] = torch.where(
            empty, 1e30, m + torch.log(torch.where(empty, 1.0, l)))[..., 0]
    return out.permute(0, 2, 1, 3), lse


def mirror_dkv(q, k, v, g, lse, delta, glse, causal, qseg, kseg, offs, seed,
               rate):
    """dkv_f32_kernel's float32 order: per k tile of BK keys, dK and dV
    summed over the group's heads (outer) and the q tiles of BQ rows from
    the causal start (inner)."""
    t = dkv_tiles(q.shape[3])
    bq, bk = t["bq"], t["bk"]
    b, tq, h, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    grp = h // hk
    scale = d ** -0.5
    inv = 1.0 / (1.0 - rate) if rate else 1.0
    dk = torch.zeros(b, hk, tk, d)
    dv = torch.zeros(b, hk, tk, d)
    n_qt = -(-tq // bq)
    gq, gk = int(offs[:, 0].max()), int(offs[:, 1].min())
    for k0 in range(0, tk, bk):
        k1 = min(k0 + bk, tk)
        kpos = offs[:, 1:] + torch.arange(k0, k1)
        qt0 = 0
        while (causal and qt0 < n_qt
               and gq + min((qt0 + 1) * bq, tq) - 1 < gk + k0):
            qt0 += 1
        for hh in range(hk):
            Kt = k[:, k0:k1, hh]
            Vt = v[:, k0:k1, hh]
            for gi in range(grp):
                head = hh * grp + gi
                for qt in range(qt0, n_qt):
                    q0, q1 = qt * bq, min(qt * bq + bq, tq)
                    qpos = offs[:, :1] + torch.arange(q0, q1)
                    allow = _mask(causal, qpos, kpos,
                                  None if qseg is None else qseg[:, q0:q1],
                                  None if kseg is None
                                  else kseg[:, k0:k1])[:, 0]
                    Qt, Gt = q[:, q0:q1, head], g[:, q0:q1, head]
                    lt = lse[:, head, q0:q1, None]
                    st = Qt @ Kt.transpose(-1, -2)
                    a = torch.where(allow, torch.exp(st * scale - lt), 0.0)
                    dp = Gt @ Vt.transpose(-1, -2)
                    if rate:
                        keep = fa._keep_mask(
                            seed, torch.arange(b).view(b, 1, 1) * h + head,
                            qpos[:, :, None], kpos[:, None, :], rate)
                        a_drop = torch.where(keep, a * inv, 0.0)
                        dp = torch.where(keep, dp * inv, 0.0)
                    else:
                        a_drop = a
                    ds = a * (dp - delta[:, head, q0:q1, None]) * scale
                    if glse is not None:
                        ds = ds + a * glse[:, head, q0:q1, None] * scale
                    dv[:, hh, k0:k1] += a_drop.transpose(-1, -2) @ Gt
                    dk[:, hh, k0:k1] += ds.transpose(-1, -2) @ Qt
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def mirror_dq(q, k, v, g, lse, delta, glse, causal, qseg, kseg, offs, seed,
              rate):
    """dq_f32_kernel's float32 order: per head and q tile of BQ rows, dQ
    summed over the K/V tiles of BK keys (of the head's kv head) up to the
    causal end."""
    t = dq_tiles(q.shape[3])
    bq, bk = t["bq"], t["bk"]
    b, tq, h, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    grp = h // hk
    scale = d ** -0.5
    inv = 1.0 / (1.0 - rate) if rate else 1.0
    dq = torch.zeros(b, tq, h, d)
    n_kt = -(-tk // bk)
    for head in range(h):
        kh, vh = k[:, :, head // grp], v[:, :, head // grp]
        for q0 in range(0, tq, bq):
            q1 = min(q0 + bq, tq)
            qpos = offs[:, :1] + torch.arange(q0, q1)
            end = (_causal_tiles(int(offs[:, 0].max()) + q1 - 1,
                                 int(offs[:, 1].min()), bk, n_kt)
                   if causal else n_kt)
            Qt, Gt = q[:, q0:q1, head], g[:, q0:q1, head]
            lt = lse[:, head, q0:q1, None]
            dl = delta[:, head, q0:q1, None]
            acc = torch.zeros(b, q1 - q0, d)
            for kt in range(end):
                k0, k1 = kt * bk, min(kt * bk + bk, tk)
                kpos = offs[:, 1:] + torch.arange(k0, k1)
                allow = _mask(causal, qpos, kpos,
                              None if qseg is None else qseg[:, q0:q1],
                              None if kseg is None else kseg[:, k0:k1])[:, 0]
                Kt, Vt = kh[:, k0:k1], vh[:, k0:k1]
                a = torch.where(allow, torch.exp(
                    Qt @ Kt.transpose(-1, -2) * scale - lt), 0.0)
                dp = Gt @ Vt.transpose(-1, -2)
                if rate:
                    keep = fa._keep_mask(
                        seed, torch.arange(b).view(b, 1, 1) * h + head,
                        qpos[:, :, None], kpos[:, None, :], rate)
                    dp = torch.where(keep, dp * inv, 0.0)
                ds = a * (dp - dl) * scale
                if glse is not None:
                    ds = ds + a * glse[:, head, q0:q1, None] * scale
                acc = acc + ds @ Kt
            dq[:, q0:q1, head] = acc
    return dq


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


MIRROR_CASES = {
    # name: (B, Tq, Tk, H, Hk, D, causal, segments, rate, offsets, glse)
    "causal_gqa_d32": (2, 200, 200, 4, 2, 32, True, False, 0.0, False, False),
    "cross_d16": (1, 96, 150, 2, 2, 16, False, False, 0.0, False, False),
    "everything_d64": (2, 130, 130, 4, 1, 64, True, True, 0.2, True, True),
}


def _mirror_inputs(name):
    """MIRROR_CASES[name] from numpy seed 5: ``(q, k, v, dO, the lse
    cotangent or None, causal)``, the plain versions' keyword arguments and
    the mirrors' (the [B, 2] offsets always given)."""
    b, tq, tk, h, hk, d, causal, seg, rate, offs, glse = MIRROR_CASES[name]
    rng = np.random.RandomState(5)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa
    q, k, v, g = mk(b, tq, h, d) * 0.5, mk(b, tk, hk, d) * 0.5, \
        mk(b, tk, hk, d), mk(b, tq, h, d)
    kw = dict(seed=77, rate=rate)
    if seg:
        kw["qseg"] = torch.from_numpy(rng.randint(0, 3, (b, tq))).int()
        kw["kseg"] = torch.from_numpy(rng.randint(0, 3, (b, tk))).int()
        kw["qseg"][0, :7] = 9  # rows that match no key: output 0, lse 1e30
    off = (torch.tensor([[5 * i, 3 * i] for i in range(b)], dtype=torch.int32)
           if offs else torch.zeros(b, 2, dtype=torch.int32))
    if offs:
        kw["offs"] = off
    gl = mk(b, h, tq) if glse else None
    mirror = dict(qseg=kw.get("qseg"), kseg=kw.get("kseg"), offs=off,
                  seed=77, rate=rate)
    return (q, k, v, g, gl, causal), kw, mirror


@pytest.mark.parametrize("name", sorted(MIRROR_CASES))
def test_mirror_of_the_kernels_order_matches_the_plain_versions(name):
    (q, k, v, g, gl, causal), kw, mirror = _mirror_inputs(name)
    out_p, lse_p = fa.flash_forward_plain(q, k, v, causal, **kw)
    out_m, lse_m = mirror_forward(q, k, v, causal, **mirror)
    empty = lse_p >= 1e30
    assert torch.equal(lse_m >= 1e30, empty)
    assert _rel(out_m, out_p) <= 1e-5
    assert _rel(lse_m[~empty], lse_p[~empty]) <= 1e-5
    delta = (g * out_p).sum(-1).transpose(1, 2).contiguous()
    _, dk_p, dv_p = fa.flash_backward_plain(q, k, v, g, lse_p, delta, gl,
                                            causal, block_k=1024, **kw)
    dk_m, dv_m = mirror_dkv(q, k, v, g, lse_p, delta, gl, causal, **mirror)
    assert _rel(dk_m, dk_p) <= 1e-5
    assert _rel(dv_m, dv_p) <= 1e-5


@pytest.mark.parametrize("name", sorted(MIRROR_CASES))
def test_mirror_of_dq_order_matches_the_plain_version(name):
    (q, k, v, g, gl, causal), kw, mirror = _mirror_inputs(name)
    out, lse = fa.flash_forward_plain(q, k, v, causal, **kw)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    dq_p = fa.flash_backward_plain(q, k, v, g, lse, delta, gl, causal,
                                   block_k=1024, **kw)[0]
    dq_m = mirror_dq(q, k, v, g, lse, delta, gl, causal, **mirror)
    assert _rel(dq_m, dq_p) <= 1e-5


def test_mirror_of_dq_order_matches_jax():
    """One small case with every option (GQA, segments, dropout, vector
    offsets, the lse cotangent; three 32-row Pallas tiles a side): the dQ
    mirror against the JAX package's dq from ``jax.vjp`` of its
    ``flash_attention`` (the Pallas backward in interpret mode)."""
    b, t, h, hk, d = 2, 96, 4, 2, 32
    rng = np.random.RandomState(8)
    x = {"q": rng.randn(b, t, h, d).astype(np.float32) * 0.5,
         "k": rng.randn(b, t, hk, d).astype(np.float32) * 0.5,
         "v": rng.randn(b, t, hk, d).astype(np.float32),
         "g": rng.randn(b, t, h, d).astype(np.float32),
         "glse": rng.randn(b, h, t).astype(np.float32)}
    qs = rng.randint(0, 3, (b, t)).astype(np.int32)
    qs[0, :5] = 7  # rows that attend to nothing
    ks = rng.randint(0, 3, (b, t)).astype(np.int32)
    qo, ko = np.array([0, 7], np.int32), np.array([3, 0], np.int32)

    def f(q, k, v):
        return jfa.flash_attention(
            q, k, v, True, return_lse=True, bwd_impl="pallas", block_q=32,
            block_k=32, q_segment_ids=jnp.asarray(qs),
            kv_segment_ids=jnp.asarray(ks), dropout_rate=0.2,
            dropout_seed=99, q_offset=jnp.asarray(qo),
            kv_offset=jnp.asarray(ko))

    _, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in "qkv"))
    want = torch.tensor(np.asarray(vjp((jnp.asarray(x["g"]),
                                        jnp.asarray(x["glse"])))[0]))
    q, k, v, g, gl = (torch.from_numpy(x[n]) for n in
                      ("q", "k", "v", "g", "glse"))
    kw = dict(qseg=torch.from_numpy(qs), kseg=torch.from_numpy(ks),
              offs=torch.from_numpy(np.stack([qo, ko], 1)), seed=99,
              rate=0.2)
    out, lse = fa.flash_forward_plain(q, k, v, True, **kw)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    got = mirror_dq(q, k, v, g, lse, delta, gl, True, **kw)
    assert _rel(got, want) <= 1e-5
