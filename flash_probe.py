#!/usr/bin/env python3
"""Where the time of the wgmma kernels goes, on one GPU.

    python3 flash_probe.py          # the flash-attention kernels
    python3 flash_probe.py f32      # their float32 forward, dK/dV and dQ
    python3 flash_probe.py f32-turns as_is unroll4   # f32 builds in turns
    python3 flash_probe.py probe    # the stage-1 probe GEMMs
    python3 flash_probe.py stats    # the BatchNorm statistics kernel

Builds ``chainermn_tpu_torch/csrc/flash_attention.cu`` (or
``probe_matmul.cu``, or ``fused_norm.cu``) as it is and in a few variants
made by editing its text (into ``build/flash_probe/``, never over the
source), one nvcc each with ``-Xptxas -v``, all started together.  For
each build it prints the registers and spills of the kernels it is about,
then times them by CUDA-graph replay between CUDA events: the flash
kernels at the LM's attention shape (bf16, B 1, T 8192, H 16, D 128, q/k/v
views of one qkv projection) -- the forward (causal and not), dK/dV and
dQ; the float32 forward, dK/dV and dQ (the CUDA-core ``fwd_f32_kernel``,
``dkv_f32_kernel`` and ``dq_f32_kernel``) at the same shape in float32,
causal; the probe
kernels at the probe's M = 802,816 -- wgrad, dgrad and
fwd1x1, beside ``torch.mm``, and for the kernels as they are also by the
profiler's kernel durations (``utils.trace.device_time``, what the probe's
document reports); the statistics kernel (``cmn_bn_stats``, called
through its C entry) over the 53 BatchNorm boundaries of a ResNet-50 step
in bf16 at batch 32 and at batch 256.

The variants leave out one part of the work, so they compute wrong results
and only say what that part costs:

* ``as_is``: the kernels as they are (checked against the plain versions);
* ``no_softmax``: the forward's online softmax skipped (P = raw scores);
* ``no_elementwise``: the dK/dV step between the products skipped (P and
  dS = raw S^T and dP^T), and dQ's (dS = raw S);
* ``no_products``: every wgmma product skipped (TMA ring, barriers and the
  elementwise work, or the probe's epilogues, only);
* ``no_stores`` (probe): rowblock without its TMA stores (loads, products
  and the staging of the output tile only).

For the float32 kernels (``f32``), the parts left out (``no_softmax``,
``no_elementwise``: the dK/dV and the dQ element step, dQ's replaced by dS
= S + dP so that S stays live, ``no_products``: every register-blocked
product of the three), then the tile choices the design weighed (right
results, checked like ``as_is``):

* ``fwd_lanes8``: the forward's row groups of 8 lanes, a thread 4 rows x 8
  keys of S and 4 rows x D/8 dims of O (the same 128 x 64 tiles);
* ``fwd_rows4``: 4 q rows a thread, so 64-row blocks (4 x 4 of S, 4 x 8 of
  O at D 128);
* ``dkv_rows2``: dK/dV over Q/dO tiles of 32 rows (4 keys x 2 rows of S^T
  and dP^T a thread);
* ``dkv_keys2``: dK/dV blocks of 32 keys (2 keys a thread);
* ``dq_rows8_keys2``: dQ blocks of 128 q rows over K/V tiles of 32 keys
  (8 rows x 2 keys of S and dP, 8 rows x D/16 dims of dQ a thread);
* ``dq_keys2``: dQ over K/V tiles of 32 keys (4 x 2 of S and dP);
* ``dq_keygroups8``: dQ threads as 32 q groups x 8 key groups, so blocks
  of 128 q rows over K/V tiles of 32 keys with 4 x 4 of S and dP and 4
  rows x D/8 dims of dQ a thread (half the K/V reads of 64-row blocks);
* ``fwd_2cta``, ``dkv_2cta``, ``dq_2cta``: blocks of 128 threads with one
  K/V (Q/dO) stage and the largest shared-memory carveout, two blocks an
  SM (64-row forward blocks, 32-key dK/dV blocks, 32-row dQ blocks);
* ``unroll1``, ``unroll2``, ``unroll4``: the products' loops unrolled
  once, twice or four times instead of eight times;
* ``dkv_apart``, ``dq_apart``: S^T and dP^T (S and dP) in two loops over
  D instead of one.

The SM clock and power draw (``nvidia-smi``, sampled every 100 ms over ~3
s of each kernel as it is) are printed beside their times.  ``f32-turns``
builds only the ``f32`` builds it is given (default: as it is and
``unroll4``), holds each to the plain versions, then times the three
float32 kernels of each in turns (six rounds, the order reversed every
other round) and prints each kernel's median and range: the way to
compare two choices whose difference is within the spread between calls.

For the statistics (``stats``), the parts left out and the alternatives:

* ``no_finalize``: the grid barrier and the finalize left out (the
  launch, the copies and the partials only);
* ``barrier_only``: the finalize left out, the grid barrier kept;
* ``no_stream``: no copies and no sums (the launch, zero partials, the
  barrier and the finalize): the fixed cost of a launch;
* ``ticket`` (right results): the finalize of the backward reduction
  instead of the barrier -- a plain launch after a memset of a counter,
  each block fences its partial and takes a ticket, and the last block
  adds every channel's partials alone;
* ``cp_async`` (right results): every thread copies 16-byte pieces of
  each stage with ``cp.async`` instead of one thread's bulk copy, a
  ``cp.async.wait_group`` and a block barrier instead of the mbarrier;
* ``stages_4``, ``stages_8`` (right results): a ring of 4 or 8 stages
  instead of 6 (8 leaves room for one block an SM only).

For the probe it also builds the alternatives its design chose against
(right results, checked like ``as_is``): ``contiguous_rows`` (rowblock's
blocks on contiguous spans of tiles), ``box_stores`` (each output tile
stored as 64-column 2-D boxes), ``stores_normal`` (no evict-first policy
on rowblock's stores), ``dgrad_loads_first`` (evict-first A loads for
dgrad too), ``wgrad_no_promotion`` (no 256-byte L2 promotion of wgrad's
loads), ``wgrad_loads_normal`` (no evict-first policy on them).

Needs one CUDA card and nvcc; prints the card's name and power limit last.
"""

import ctypes
import importlib
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "flash_probe")


def _cut(src, old, new):
    if old not in src:
        raise SystemExit(f"flash_probe: the source no longer has {old[:60]!r}"
                         "; update the variant")
    return src.replace(old, new)


def flash_variants(src):
    """``{name: source}`` of ``flash_attention.cu``."""
    no_softmax = _cut(
        _cut(src, "      softmax(0, alpha);  // O is still 0: nothing to "
             "rescale\n", "      alpha[0] = alpha[1] = 1.0f;\n"),
        "        softmax(kt, alpha);\n", "        alpha[0] = alpha[1] = 1.0f;\n")
    no_elementwise = src
    for old in ("        if (full_tile && !p.dropout) {\n",
                "        } else {\n#pragma unroll\n          for (int nt = 0; "
                "nt < BQ / 8; ++nt)\n#pragma unroll\n            for (int j = "
                "0; j < 4; ++j) {\n              const int ri = j >> 1, c = "
                "nt * 8 + 2 * t + (j & 1);\n              const int qpos"):
        no_elementwise = _cut(no_elementwise, old, old.replace(
            "if (full_tile && !p.dropout)", "if (false)").replace(
            "} else {", "} else if (false) {"))
    for old in ("      element(0);\n", "        element(kt);\n"):
        no_elementwise = _cut(no_elementwise, old, "")
    no_products = src
    for old in (
            "        Wg<T>::ss(sc, kmajor<BQ>(qa, 0, kk), kmajor<BK>(ka, 0, "
            "kk), kk > 0);\n",
            "        Wg<T>::rs(o, pa[kc], mnmajor<BK>(va, kc), 1);\n",
            "          Wg<T>::ss(st, kmajor<BK>(ka, cw * 64, kk), "
            "kmajor<BQ>(qa, 0, kk),\n                    kk > 0);\n",
            "          Wg<T>::ss(dpt, kmajor<BK>(va, cw * 64, kk), "
            "kmajor<BQ>(ga, 0, kk),\n                    kk > 0);\n",
            "          Wg<T>::rs(dv, pa[kc], mnmajor<BQ>(ga, kc), 1);\n",
            "          Wg<T>::rs(dk, sa[kc], mnmajor<BQ>(qa, kc), 1);\n",
            "        Wg<T>::ss(dp, kmajor<BQ>(ga, 0, kk), kmajor<BK>(va, 0, "
            "kk), kk > 0);\n",
            "        Wg<T>::rs(dq, sa[kc], mnmajor<BK>(ka, kc), 1);\n"):
        no_products = _cut(no_products, old, "")
    return {"as_is": src, "no_softmax": no_softmax,
            "no_elementwise": no_elementwise, "no_products": no_products}


# the largest shared-memory carveout, so that two blocks of ~110 KB fit an SM
CARVEOUT = {"      static_cast<int>(bytes));\n  if (err == cudaSuccess) done":
            "      static_cast<int>(bytes));\n  if (err == cudaSuccess)\n"
            "    err = cudaFuncSetAttribute(\n        kernel, cudaFuncAttribute"
            "PreferredSharedMemoryCarveout,\n        "
            "cudaSharedmemCarveoutMaxShared);\n  if (err == cudaSuccess) done"}
F32_TILES = {"fwd_lanes8": {"kF32FwdLanes = 16;": "kF32FwdLanes = 8;",
                            "kF32FwdRows = 8;": "kF32FwdRows = 4;",
                            "kF32FwdKeys = 4;": "kF32FwdKeys = 8;"},
             "fwd_rows4": {"kF32FwdRows = 8;": "kF32FwdRows = 4;"},
             "dkv_rows2": {"kF32DkvRows = 4;": "kF32DkvRows = 2;"},
             "dkv_keys2": {"kF32DkvKeys = 4;": "kF32DkvKeys = 2;"},
             "dq_rows8_keys2": {"kF32DqRows = 4;": "kF32DqRows = 8;",
                                "kF32DqKeys = 4;": "kF32DqKeys = 2;"},
             "dq_keys2": {"kF32DqKeys = 4;": "kF32DqKeys = 2;"},
             "dq_keygroups8": {"kF32DqKeyGroups = 16;":
                               "kF32DqKeyGroups = 8;"},
             "fwd_2cta": {"kF32FwdThreads = 256;": "kF32FwdThreads = 128;",
                          "kF32FwdStages = 2;": "kF32FwdStages = 1;",
                          **CARVEOUT},
             "dkv_2cta": {"kF32DkvThreads = 256;": "kF32DkvThreads = 128;",
                          "kF32DkvStages = 2;": "kF32DkvStages = 1;",
                          **CARVEOUT},
             "dq_2cta": {"kF32DqThreads = 256;": "kF32DqThreads = 128;",
                         "kF32DqStages = 2;": "kF32DqStages = 1;",
                         **CARVEOUT}}
# dQ's S and dP in one loop over D (as it is), and in two (dq_apart)
DQ_SDP = ("    f32_abt2<RQ, CK, D, TQ * LDT, TK * LDT>(s, dp, Qs + qy * LDT,\n"
          "                                            Gs + qy * LDT, K + kx "
          "* LDT,\n                                            V + kx * LDT"
          ");\n")
DQ_APART = ("    f32_abt<RQ, CK, D, TQ * LDT, TK * LDT>(s, Qs + qy * LDT, K + "
            "kx * LDT);\n    f32_abt<RQ, CK, D, TQ * LDT, TK * LDT>(dp, Gs + "
            "qy * LDT, V + kx * LDT);\n")


def f32_variants(src):
    """``{name: source}`` of ``flash_attention.cu`` for the float32
    forward, dK/dV and dQ: the parts left out, then the tile choices."""
    no_softmax = _cut(src, "    softmax(s, kt * BK, kseg_s + buf * BK);\n",
                      "    for (int i = 0; i < RM; ++i) alpha[i] = 1.0f;\n")
    no_elementwise = _cut(_cut(src, "    element(st, dpt, (qt0 + it % nq) * "
                               "BQ, b * H + hk * grp + it / nq, buf);\n", ""),
                          "    element(s, dp, kt * BK, buf);\n",
                          "    for (int i = 0; i < RQ; ++i)\n"
                          "      for (int j = 0; j < CK; ++j) dp[i][j] += "
                          "s[i][j];\n")
    no_products = src
    for old in (
            "    f32_abt<RM, CN, D, TY * LDT, TX * LDT>(s, Qs + ty * LDT, "
            "K + tx * LDT);\n",
            "    f32_ab<RM, DN, VW, BK, TY * LDP, LDT, TX * VW>(o, K + ty * "
            "LDP,\n                                                   V + "
            "VW * tx);\n",
            "    f32_abt2<RK, CQ, D, TK * LDT, TQ * LDT>(st, dpt, Ks + ky * "
            "LDT,\n                                            Vs + ky * LDT, "
            "Q + qx * LDT,\n                                            G + "
            "qx * LDT);\n",
            "    f32_ab<RK, DN, VW, BQ, TK * LDP, LDT, TQ * VW>(dv, Pt + ky * "
            "LDP,\n                                                   G + "
            "VW * qx);\n",
            "    f32_ab<RK, DN, VW, BQ, TK * LDP, LDT, TQ * VW>(dk, Pt + ky * "
            "LDP,\n                                                   Q + "
            "VW * qx);\n",
            DQ_SDP,
            "    f32_ab<RQ, DN, VW, BK, TQ * LDP, LDT, TK * VW>(dq, dS + qy * "
            "LDP,\n                                                   K + "
            "VW * kx);\n"):
        no_products = _cut(no_products, old, "")
    out = {"as_is": src, "no_softmax": no_softmax,
           "no_elementwise": no_elementwise, "no_products": no_products}
    for name, cuts in F32_TILES.items():
        var = src
        for old, new in cuts.items():
            var = _cut(var, old, new)
        out[name] = var
    # the products' loops over D and over keys (q rows) unrolled once (no
    # operand prefetch), twice or four times instead of eight times
    for n in (1, 2, 4):
        var = src
        for loop in ("  for (int d = 0; d < D; d += 4) {\n",
                     "  for (int k = 0; k < K; k += 4) {\n"):
            var = _cut(var, "#pragma unroll 8\n" + loop,
                       f"#pragma unroll {n}\n" + loop)
        out[f"unroll{n}"] = var
    # S^T and dP^T in two loops over D, one product each
    out["dkv_apart"] = _cut(
        src, "    f32_abt2<RK, CQ, D, TK * LDT, TQ * LDT>(st, dpt, Ks + ky * "
        "LDT,\n                                            Vs + ky * LDT, "
        "Q + qx * LDT,\n                                            G + qx "
        "* LDT);\n",
        "    f32_abt<RK, CQ, D, TK * LDT, TQ * LDT>(st, Ks + ky * LDT, Q + qx"
        " * LDT);\n    f32_abt<RK, CQ, D, TK * LDT, TQ * LDT>(dpt, Vs + ky "
        "* LDT, G + qx * LDT);\n")
    out["dq_apart"] = _cut(src, DQ_SDP, DQ_APART)
    return out


def probe_variants(src):
    """``{name: source}`` of ``probe_matmul.cu``: the parts left out, then
    the design's alternatives (which compute right results)."""
    no_products = src
    for old in (
            "        wg_mma(d[mi], kmajor<kWgradM>(a, cw * 128 + mi * 64, "
            "kk),\n               mnmajor<kTile>(b, kk), kk > 0);\n",
            "      wg_mma(acc, kmajor<kTile>(a, 0, kk), mnmajor<K>(b, kk), "
            "kk > 0);\n"):
        no_products = _cut(no_products, old, "")
    store = ("      tma_store(&tm_c, cs, static_cast<int>(sp.strided(t) * "
             "kTile),\n                evict_first());\n")
    no_stores = _cut(src, store, "")
    # rowblock's blocks on contiguous spans, as wgrad's
    contiguous = _cut(src, "sp.strided(t)", "sp.span(t)")
    # the output tile stored as four 2-D boxes of 64 columns
    box_stores = _cut(_cut(_cut(
        src, "        const int line = (warp * 16 + g + 8 * h) * (N / 64) "
        "+ j / 8;\n",
        "        const int line = (j / 8) * kTile + warp * 16 + g + 8 * h;\n"),
        "  if (err == cudaSuccess) err = tile_map(&mc, c, m_total, N);\n",
        "  if (err == cudaSuccess)\n"
        "    err = tensor_map(&mc, c, m_total, N, kTile, 64, promo);\n"),
        store,
        "      for (int j = 0; j < N / 64; ++j)\n"
        "        asm volatile(\n"
        "            \"cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
        ".L2::cache_hint \"\n"
        "            \"[%0, {%2, %3}], [%1], %4;\\n\" ::\"l\"("
        "reinterpret_cast<uint64_t>(&tm_c)),\n"
        "            \"r\"(smem_addr(cs + j * kTile * 128)), \"r\"(64 * j),\n"
        "            \"r\"(static_cast<int>(sp.strided(t) * kTile)),\n"
        "            \"l\"(evict_first()) : \"memory\");\n")
    stores_normal = _cut(src, "kTile),\n                evict_first());",
                         "kTile),\n                evict_normal());")
    dgrad_loads_first = _cut(
        src, "K == 256 ? evict_first() : evict_normal()", "evict_first()")
    wgrad_no_promotion = _cut(
        src, "  constexpr CUtensorMapL2promotion promo = "
        "CU_TENSOR_MAP_L2_PROMOTION_L2_256B;\n  CUtensorMap ma, mb;",
        "  constexpr CUtensorMapL2promotion promo = "
        "CU_TENSOR_MAP_L2_PROMOTION_NONE;\n  CUtensorMap ma, mb;")
    wgrad_loads_normal = _cut(
        src, "      const uint64_t pol = evict_first();\n      unsigned char*",
        "      const uint64_t pol = evict_normal();\n      unsigned char*")
    return {"as_is": src, "no_products": no_products, "no_stores": no_stores,
            "contiguous_rows": contiguous, "box_stores": box_stores,
            "stores_normal": stores_normal,
            "dgrad_loads_first": dgrad_loads_first,
            "wgrad_no_promotion": wgrad_no_promotion,
            "wgrad_loads_normal": wgrad_loads_normal}


def stats_variants(src):
    """``{name: source}`` of ``fused_norm.cu``: the statistics kernel's
    parts left out, then its design's alternatives (right results)."""
    finish = ("  cooperative_groups::this_grid().sync();\n"
              "  stats_finalize<VEC>(ws, mean, var, geo, blockIdx.y * "
              "gridDim.x + blockIdx.x,\n"
              "                      gridDim.x * gridDim.y);\n")
    no_finalize = _cut(src, finish, "")
    barrier_only = _cut(src, finish,
                        "  cooperative_groups::this_grid().sync();\n")
    no_stream = _cut(src, "      const int n_st = static_cast<int>(\n"
                     "          (r_hi - r_lo + geo.stage_rows - 1) / "
                     "geo.stage_rows);\n", "      const int n_st = 0;\n")
    # the backward reduction's finish: a memset counter after the partials
    # (ws has room for it past [spans, 2, C]), the last block finalizes
    ticket = _cut(_cut(_cut(
        src, finish,
        "  __shared__ int last;\n"
        "  __threadfence();\n"
        "  __syncthreads();\n"
        "  if (tid == 0)\n"
        "    last = atomicAdd(reinterpret_cast<int*>(\n"
        "               ws + static_cast<int64_t>(gridDim.x) * 2 * C), 1) ==\n"
        "           static_cast<int>(gridDim.x * gridDim.y) - 1;\n"
        "  __syncthreads();\n"
        "  if (!last) return;\n"
        "  __threadfence();\n"
        "  stats_finalize<VEC>(ws, mean, var, geo, 0, 1);\n"),
        "  attr[0].val.cooperative = 1;\n",
        "  attr[0].val.cooperative = 0;\n"),
        "  const int ns = static_cast<int>(spans);\n",
        "  const int ns = static_cast<int>(spans);\n"
        "  err = cudaMemsetAsync(ws + spans * 2 * C, 0, sizeof(int), s);\n"
        "  if (err != cudaSuccess) return err;\n")
    cp_async = _cut(_cut(
        src,
        "        if (tid != 0 || st >= n_st) return;\n"
        "        const int slot = static_cast<int>((job + st) % kStatsStages);"
        "\n        const int rows = rows_of(st);\n"
        "        unsigned char* dst = ring + static_cast<size_t>(slot) * "
        "kStageBytes;\n",
        "        if (st >= n_st) {\n"
        "          cp_async_commit();  // one group a stage, empty or not\n"
        "          return;\n"
        "        }\n"
        "        const int slot = static_cast<int>((job + st) % kStatsStages);"
        "\n        const int rows = rows_of(st);\n"
        "        unsigned char* dst = ring + static_cast<size_t>(slot) * "
        "kStageBytes;\n"
        "        const int pieces = row_bytes / 16;\n"
        "        for (int i = tid; i < rows * pieces; i += kThreads) {\n"
        "          const int rr = i / pieces, pc = i % pieces;\n"
        "          cp_async16(dst + (static_cast<size_t>(rr) * tile_c * "
        "sizeof(T) + pc * 16),\n"
        "                     reinterpret_cast<const unsigned char*>(\n"
        "                         x + (r_lo + static_cast<int64_t>(st) * "
        "geo.stage_rows + rr) * C + c_lo) + pc * 16, true);\n"
        "        }\n"
        "        cp_async_commit();\n"
        "        if (true) return;\n"),
        "        bar_wait(full + slot,\n"
        "                 static_cast<int>(((job + st) / kStatsStages) & 1));"
        "\n",
        "        cp_async_wait<kStatsStages - 1>();\n"
        "        __syncthreads();\n")
    stages = "constexpr int kStatsStages = 6;"
    return {"as_is": src, "no_finalize": no_finalize,
            "barrier_only": barrier_only, "no_stream": no_stream,
            "ticket": ticket, "cp_async": cp_async,
            "stages_4": _cut(src, stages, stages.replace("6", "4")),
            "stages_8": _cut(src, stages, stages.replace("6", "8"))}


def build(build_mod, name, src):
    """Compile one variant; returns (name, library path, ptxas lines)."""
    cu = os.path.join(OUT, f"{name}.cu")
    so = os.path.join(OUT, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([build_mod.nvcc(), *build_mod.NVCC_FLAGS,
                           "-o", so, cu],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"flash_probe: {name} did not build:\n"
                         f"{proc.stdout}{proc.stderr}")
    return name, so, (proc.stdout + proc.stderr).splitlines()


def build_all(build_mod, source, variants, names=None):
    """Every variant of ``csrc/{source}.cu`` (or those in ``names``),
    built in parallel."""
    os.makedirs(OUT, exist_ok=True)
    src = (build_mod.CSRC / f"{source}.cu").read_text()
    chosen = [(n, v) for n, v in variants(src).items()
              if names is None or n in names]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        built = list(ex.map(lambda kv: build(build_mod, f"{source}_{kv[0]}",
                                             kv[1]),
                            chosen))
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)
    return built


def print_registers(smoke, source, name, lines):
    print(f"{name}: registers, spill store / load bytes: "
          + ", ".join(f"{kern} {r}/{s}/{l}" for kern, (r, s, l)
                      in smoke.ptxas_registers(
                          lines, smoke.PTXAS_KERNELS[source]).items()),
          flush=True)


def flash(torch, build_mod, smoke):
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    built = build_all(build_mod, "flash_attention", flash_variants)
    dev = torch.device("cuda", 0)
    b, t, h, d = 1, smoke.LM_T, smoke.LM["n_heads"], \
        smoke.LM["d_model"] // smoke.LM["n_heads"]
    gen = torch.Generator(device=dev).manual_seed(9)
    qkv = (torch.randn(b, t, 3 * h * d, device=dev, generator=gen)
           * 0.5).to(torch.bfloat16)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d)
               for i in range(3))
    g = torch.randn(b, t, h, d, device=dev, generator=gen).to(torch.bfloat16)
    lse = delta = None
    for name, so, lines in built:
        build_mod._LIBS["flash_attention"] = ctypes.CDLL(so)
        if name.endswith("as_is"):
            res = smoke.flash_case(fa, torch, dev, torch.bfloat16, 2, 1000,
                                   1000, 16, 2, 128, True, seed=3)
            worst = max(r for _, r in res.values())
            if not worst <= smoke.FLASH_TOL["bfloat16"]:
                raise SystemExit(f"flash_probe: as_is disagrees with the "
                                 f"plain versions ({worst:.3g})")
            out, lse = fa.flash_fwd(q, k, v, True)
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
        ms = {
            "fwd causal": smoke._time(
                torch, lambda: fa.flash_fwd(q, k, v, True), 10, graph=True),
            "fwd non-causal": smoke._time(
                torch, lambda: fa.flash_fwd(q, k, v, False), 5, graph=True),
            "dkv causal": smoke._time(
                torch, lambda: fa.flash_bwd_dkv(q, k, v, g, lse, delta, None,
                                                True), 10, graph=True),
            "dq causal": smoke._time(
                torch, lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, None,
                                               True), 10, graph=True)}
        print(f"{name}: " + ", ".join(f"{w} {x:.4f} ms"
                                      for w, x in ms.items()), flush=True)
        print_registers(smoke, "flash_attention", name, lines)


def _sample_clocks():
    """Start sampling the SM clock and power draw every 100 ms."""
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _stop_clocks(proc):
    """Stop the sampler; the median and range of the SM clock and of the
    power draw over its samples."""
    proc.terminate()
    out = proc.communicate(timeout=30)[0]
    rows = [tuple(float(x) for x in line.split(",")) for line in
            out.splitlines() if line.count(",") == 1]
    if not rows:
        return "SM clock not sampled"
    mhz = sorted(r[0] for r in rows)
    watts = sorted(r[1] for r in rows)
    return (f"SM clock {mhz[len(mhz) // 2]:.0f} MHz ({mhz[0]:.0f}-"
            f"{mhz[-1]:.0f}), power {watts[len(watts) // 2]:.0f} W "
            f"({watts[0]:.0f}-{watts[-1]:.0f}) over {len(rows)} samples")


def _f32_setup(torch, smoke, fa):
    """The float32 kernels at phase 13's shape (q/k/v views of one qkv
    projection, causal): ``{label: launch}`` of the forward, dK/dV, dQ."""
    dev = torch.device("cuda", 0)
    b, t, h, d = 1, smoke.LM_T, smoke.LM["n_heads"], \
        smoke.LM["d_model"] // smoke.LM["n_heads"]
    gen = torch.Generator(device=dev).manual_seed(13)
    qkv = torch.randn(b, t, 3 * h * d, device=dev, generator=gen) * 0.5
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d)
               for i in range(3))
    g = torch.randn(b, t, h, d, device=dev, generator=gen)
    out, lse = fa.flash_forward_plain(q, k, v, True)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, g, lse, delta, None, True)
    return {"fwd causal": lambda: fa.flash_fwd(q, k, v, True),
            "dkv causal": lambda: fa.flash_bwd_dkv(*bwd),
            "dq causal": lambda: fa.flash_bwd_dq(*bwd)}


def _f32_check(torch, smoke, fa, name):
    """Raise unless build ``name`` agrees with the plain versions on four
    float32 cases (D 16-128, segments, dropout, offsets, glse, GQA)."""
    dev = torch.device("cuda", 0)
    for case in (("d128_all", 1, 300, 300, 8, 2, 128, True,
                  dict(seg=True, rate=0.2, glse=True, offs="vector")),
                 ("d32_gqa", 2, 200, 200, 8, 1, 32, True, {}),
                 ("d64_cross", 2, 96, 128, 4, 4, 64, False, {}),
                 ("d16", 2, 130, 130, 4, 4, 16, True, {})):
        res = smoke.flash_case(fa, torch, dev, torch.float32, *case[1:8],
                               **case[8])
        worst = max(r for _, r in res.values())
        if not worst <= smoke.FLASH_TOL["float32"]:
            raise SystemExit(f"flash_probe: {name} {case[0]} disagrees "
                             f"with the plain versions ({res})")


def f32(torch, build_mod, smoke):
    from chainermn_tpu_torch.utils.compare import no_tf32
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    built = build_all(build_mod, "flash_attention", f32_variants)
    kerns = ("fwd_f32_kernel", "dkv_f32_kernel", "dq_f32_kernel")
    with no_tf32():
        kern = _f32_setup(torch, smoke, fa)
        for name, so, lines in built:
            build_mod._LIBS["flash_attention"] = ctypes.CDLL(so)
            right = not name.split("_", 2)[-1].startswith("no_")
            if right:  # every tile choice against the plain versions
                _f32_check(torch, smoke, fa, name)
            ms = {w: smoke._time(torch, fn, 5, graph=True)
                  for w, fn in kern.items()}
            clocks = ""
            if name.endswith("as_is"):  # ~3 s of each kernel, sampled
                for w, fn in kern.items():
                    proc = _sample_clocks()
                    time.sleep(1.0)  # nvidia-smi's start
                    t_end = time.perf_counter() + 3.0
                    while time.perf_counter() < t_end:
                        for _ in range(20):
                            fn()
                        torch.cuda.synchronize()
                    clocks += f"; {w}: {_stop_clocks(proc)}"
            print(f"{name}{'' if right else ' (wrong results)'}: "
                  + ", ".join(f"{w} {x:.4f} ms" for w, x in ms.items())
                  + clocks, flush=True)
            print(f"{name}: registers, spill store / load bytes: "
                  + ", ".join(f"{kern} {r}/{st}/{ld}" for kern, (r, st, ld)
                              in smoke.ptxas_registers(lines, kerns).items()),
                  flush=True)


def f32_turns(torch, build_mod, smoke, names, rounds=6):
    """The float32 kernels of the ``f32`` builds ``names`` (each first
    held to the plain versions) timed in turns: ``rounds`` rounds, each
    build once a round, the order reversed every other round; each
    kernel's median and range of CUDA-graph ms by build."""
    from chainermn_tpu_torch.utils.compare import no_tf32
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    built = build_all(build_mod, "flash_attention", f32_variants, names)
    libs = {name.split("_", 2)[-1]: ctypes.CDLL(so) for name, so, _ in built}
    if set(names) - set(libs):
        raise SystemExit(f"flash_probe: no f32 build named "
                         f"{sorted(set(names) - set(libs))}")
    ms = {n: {} for n in libs}
    with no_tf32():
        kern = _f32_setup(torch, smoke, fa)
        for n, lib in libs.items():
            build_mod._LIBS["flash_attention"] = lib
            _f32_check(torch, smoke, fa, n)
        for r in range(rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                build_mod._LIBS["flash_attention"] = libs[n]
                for w, fn in kern.items():
                    ms[n].setdefault(w, []).append(
                        smoke._time(torch, fn, 5, graph=True))
    for n in names:
        print(f"{n}, {rounds} turns: " + ", ".join(
            f"{w} median {sorted(x)[len(x) // 2]:.4f} ms ({min(x):.4f}-"
            f"{max(x):.4f})" for w, x in ms[n].items()), flush=True)


def probe(torch, build_mod, smoke):
    pm = importlib.import_module("chainermn_tpu_torch.ops.probe_matmul")
    from chainermn_tpu_torch.benchmarks import bench_conv_probe as bcp
    from chainermn_tpu_torch.utils.trace import device_time
    built = build_all(build_mod, "probe_matmul", probe_variants)
    dev = torch.device("cuda", 0)
    cases = {name: (bcp.operands(dev, sa, sb), kern, out_dtype)
             for name, (sa, sb, kern, out_dtype)
             in bcp.probe_cases(smoke.PROBE_M).items()}
    for name, so, lines in built:
        build_mod._LIBS["probe_matmul"] = ctypes.CDLL(so)
        ms = {}
        for case, ((a, b), kern, out_dtype) in cases.items():
            fn = getattr(pm, kern)

            def lib():
                return bcp.library_product(a, b, out_dtype)

            def kernel():
                return fn(a, b, 1024)
            if not name.startswith("probe_matmul_no_"):  # right results
                pm.agreement(kern, a, b, kernel(),
                             getattr(pm, f"{kern}_plain")(a, b, 1024))
            if name.endswith("as_is"):
                ms[f"{case} torch.mm"] = smoke._time(torch, lib, 20,
                                                     graph=True)
                # the same two by the profiler's kernel durations
                ms[f"{case} torch.mm (profiler)"] = device_time(lib, ())
                ms[f"{case} (profiler)"] = device_time(kernel, ())
            ms[case] = smoke._time(torch, kernel, 20, graph=True)
        print(f"{name}: " + ", ".join(f"{w} {x:.4f} ms"
                                      for w, x in ms.items()), flush=True)
        print_registers(smoke, "probe_matmul", name, lines)


def stats(torch, build_mod, smoke):
    fn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")
    built = build_all(build_mod, "fused_norm", stats_variants)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(11)
    sets = {}
    for batch in (smoke.BATCH, smoke.BENCH_BATCH):
        cases = []
        for _, (n, h, w, c), _ in fn.resnet_bn_boundaries(batch):
            x = torch.randn((n * h * w, c), device=dev, generator=gen) \
                .to(torch.bfloat16)
            geo = fn.stats_geometry(n * h * w, c, 2, True, sms)
            # [spans, 2, C] partials and the ticket variant's counter
            ws = torch.empty(geo.spans * 2 * c + 4, device=dev)
            cases.append((x, geo, ws, torch.empty(c, device=dev),
                          torch.empty(c, device=dev)))
        sets[batch] = cases
    for name, so, lines in built:
        entry = fn.declare_entries(ctypes.CDLL(so)).cmn_bn_stats

        def run(cases):
            for x, geo, ws, mean, var in cases:
                r, c = x.shape
                err = entry(x.data_ptr(), mean.data_ptr(), var.data_ptr(),
                            ws.data_ptr(), r, c, geo.span_rows, geo.gpr,
                            geo.rpi, geo.stage_rows, geo.tile_blocks, 1, 1,
                            0, torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise SystemExit(f"flash_probe: {name} failed to "
                                     f"launch (CUDA error {err})")
        right = not name.split("_", 2)[-1].startswith(
            ("no_", "barrier_only"))
        if right:
            for batch, cases in sets.items():
                run(cases)
                for x, _, _, mean, var in cases:
                    for got, want in zip((mean, var), fn.stats_plain(x)):
                        torch.testing.assert_close(got, want, rtol=1e-4,
                                                   atol=1e-4)
        ms = {f"batch {b}": smoke._time(torch, lambda: run(cases), 20,
                                        graph=True)
              for b, cases in sets.items()}
        print(f"{name}{'' if right else ' (wrong results)'}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + " over 53 boundaries", flush=True)
        print_registers(smoke, "fused_norm", name, lines)


def main(argv=None):
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    build_mod = importlib.import_module("chainermn_tpu_torch.ops._build")
    smoke = importlib.import_module("chip_smoke")
    mode = argv[0] if argv else None
    if mode == "f32-turns":
        f32_turns(torch, build_mod, smoke, argv[1:] or ["as_is", "unroll4"])
    else:
        {"f32": f32, "probe": probe, "stats": stats}.get(mode, flash)(
            torch, build_mod, smoke)
    print(smoke.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
