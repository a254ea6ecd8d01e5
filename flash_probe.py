#!/usr/bin/env python3
"""Where the time of the wgmma flash-attention kernels goes, on one GPU.

    python3 flash_probe.py

Builds ``chainermn_tpu_torch/csrc/flash_attention.cu`` as it is and in a
few variants made by editing its text (into ``build/flash_probe/``, never
over the source), one nvcc each with ``-Xptxas -v``, all started together.
For each build it prints the registers and spills of the bf16/fp16 wgmma
kernels, then times, at the LM's attention shape (bf16, B 1, T 8192, H 16,
D 128, q/k/v views of one qkv projection), the forward (causal and not),
dK/dV and dQ by CUDA-graph replay between CUDA events.

The variants leave out one part of the work, so they compute wrong results
and only say what that part costs:

* ``as_is``: the kernels as they are (checked against the plain versions);
* ``no_softmax``: the forward's online softmax skipped (P = raw scores);
* ``no_elementwise``: the dK/dV step between the products skipped (P and
  dS = raw S^T and dP^T), and dQ's (dS = raw S);
* ``no_products``: every wgmma product skipped (TMA ring, barriers and the
  elementwise work only).

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


def variants(src):
    """``{name: source}``."""
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    build_mod = importlib.import_module("chainermn_tpu_torch.ops._build")
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    smoke = importlib.import_module("chip_smoke")
    os.makedirs(OUT, exist_ok=True)
    src = (build_mod.CSRC / "flash_attention.cu").read_text()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        built = list(ex.map(lambda kv: build(build_mod, *kv),
                            variants(src).items()))
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)

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
        if name == "as_is":
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
        print(f"{name}: registers, spill store / load bytes: "
              + ", ".join(f"{kern} {r}/{s}/{l}" for kern, (r, s, l)
                          in smoke.ptxas_registers(
                              lines, smoke.PTXAS_KERNELS["flash_attention"])
                          .items()), flush=True)
    print(smoke.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
