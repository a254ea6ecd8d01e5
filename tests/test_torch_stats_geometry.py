"""The CUDA BatchNorm statistics' launch geometry and CPU path, on the CPU.

``fused_norm.stats_geometry`` chooses how ``cmn_bn_stats``
(``csrc/fused_norm.cu``) cuts an ``[R, C]`` activation: threads a row of a
channel tile, rows a step, blocks over spans of rows and channel tiles,
rows a ring stage.  The kernel is one cooperative launch, so every block
must be resident at once; its bulk copies need 16-byte aligned addresses
and sizes; its entry refuses a geometry that breaks its rules.  Checked
here for every distinct ``[R, C]`` of ResNet-50's BatchNorm boundaries at
batch 32 and 256 and for ragged shapes, on both paths and at both element
sizes, with the H100's 132 SMs: the spans cover ``[0, R)`` exactly once,
the blocks and their shared memory fit the card (two blocks an SM), bulk
copies fall only on 16-byte aligned runs, and the finalize's slices cover
the channels once.  Then the wrapper on the CPU (``stats_plain``'s bits,
no launch counted, agreement with the JAX package's Pallas kernel in
interpret mode), the profile category of the new kernel's name, and the
Triton statistics pair being gone from the module.
"""

import importlib
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu_torch.ops import _build
from chainermn_tpu_torch.utils import trace

jfn = importlib.import_module("chainermn_tpu.ops.fused_norm")
tfn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")

SMS = 132
SMEM_BLOCK = 227 * 1024       # shared memory a block may use (H100)
SMEM_SM = 228 * 1024          # an SM's, of which each block reserves 1 KB
RESNET = sorted({(n * h * w, c) for batch in (32, 256)
                 for _, (n, h, w, c), _ in tfn.resnet_bn_boundaries(batch)})
RAGGED = [(1, 1), (7, 13), (1001, 64), (96, 2048), (300, 4104), (5, 100000)]
CASES = [(shape, vec, size) for shape in RESNET + RAGGED
         for vec in (True, False) for size in (2, 4)
         if not vec or shape[1] % 8 == 0]


def _cu_constant(name):
    src = (_build.CSRC / "fused_norm.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_constants_match_the_kernel():
    assert tfn._STATS_STAGES == _cu_constant("kStatsStages") == 6
    assert tfn._STAGE_BYTES == _cu_constant("kStageBytes") == 16384
    assert tfn._THREADS == _cu_constant("kThreads") == 256
    assert _cu_constant("kVec") == 8 and _cu_constant("kGroup") == 4


def test_resnet_shapes_are_the_boundaries():
    assert len(RESNET) == 24  # 12 distinct [R, C] at each batch
    assert (3211264, 64) in RESNET and (1568, 2048) in RESNET


def _spans(geo, r):
    return [(s * geo.span_rows, min((s + 1) * geo.span_rows, r))
            for s in range(geo.spans)]


@pytest.mark.parametrize("shape,vec,size", CASES, ids=[
    f"{r}x{c}-{'vector' if v else 'scalar'}-{8 * s}bit"
    for (r, c), v, s in CASES])
def test_geometry_keeps_the_kernels_rules(shape, vec, size):
    r, c = shape
    geo = tfn.stats_geometry(r, c, size, vec, SMS)
    epc = 8 if vec else 1
    assert geo.vec == vec and geo.tile_c == geo.gpr * epc
    # the entry point's rules (cmn_bn_stats)
    assert 1 <= geo.gpr * geo.rpi <= 256 and geo.tile_c <= c
    assert geo.tile_c * geo.rpi <= 8 * 256  # the block sums' shared memory
    assert geo.span_rows % geo.rpi == 0 and geo.stage_rows % geo.rpi == 0
    assert 1 <= geo.tile_blocks <= geo.tiles
    # whole tiles of up to 2048 channels (256 on the scalar path) cover C
    assert geo.tile_c == min(c // epc if vec else c, 256) * epc
    assert (geo.tiles - 1) * geo.tile_c < c <= geo.tiles * geo.tile_c
    # the spans cover [0, R) exactly once, in order, none empty
    spans = _spans(geo, r)
    assert spans[0][0] == 0 and spans[-1][1] == r
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # one block an SM at most, so that the cooperative grid is resident
    # at once even beside another kernel; two blocks fit an SM
    blocks = geo.spans * geo.tile_blocks
    assert 1 <= blocks <= SMS
    assert geo.smem_bytes <= SMEM_BLOCK
    assert 2 * (geo.smem_bytes + 1024) <= SMEM_SM
    # as many spans as fit beside the tile blocks, each at least one row
    # step, cut evenly: a span holds less than an even split plus one step
    want = min(SMS // geo.tile_blocks, -(-r // geo.rpi))
    assert geo.span_rows < r / want + geo.rpi
    if vec:
        # bulk copies: 16-byte aligned runs of 16-byte multiples, a stage
        # within the ring's stage size, whole rows of the tile
        assert geo.smem_bytes == 6 * (16384 + 8) + 16384
        row = geo.tile_c * size
        assert row % 16 == 0 and (c * size) % 16 == 0
        assert geo.stage_rows * row <= 16384
        for lo, hi in spans:
            for r0 in range(lo, hi, geo.stage_rows):
                rows = min(geo.stage_rows, hi - r0)
                for t in range(geo.tiles):
                    start = (r0 * c + t * geo.tile_c) * size
                    nc = min(geo.tile_c, c - t * geo.tile_c)
                    assert start % 16 == 0 and (rows * nc * size) % 16 == 0
            if r > 10 ** 5:
                break  # one span's stages show the pattern at large R
    else:
        assert geo.stage_rows == geo.rpi and geo.smem_bytes == 16384


@pytest.mark.parametrize("shape,vec", [(s, v) for s in RESNET + RAGGED
                                       for v in (True, False)
                                       if not v or s[1] % 8 == 0])
def test_finalize_slices_cover_every_channel_once(shape, vec):
    """Block b of the finalize takes channel groups [b ng / B, (b + 1) ng
    / B) of ng = C / G (G = 4 on the vector path), with K slices of the
    spans a group on the lanes of one warp: K a power of two that divides
    32, K * groups <= 256 threads (a pass) and K <= spans (no slice
    without a span)."""
    r, c = shape
    geo = tfn.stats_geometry(r, c, 2, vec, SMS)
    g = 4 if vec else 1
    assert c % g == 0
    ng, nb = c // g, geo.spans * geo.tile_blocks
    taken = []
    for b in range(nb):
        lo, hi = b * ng // nb, (b + 1) * ng // nb
        taken.extend(range(lo, hi))
        n = hi - lo
        if n:
            k = 1
            while 2 * k * n <= 256 and 2 * k <= geo.spans and k < 32:
                k *= 2
            assert 32 % k == 0 and k <= geo.spans
            assert k * min(n, 256 // k) <= 256
    assert taken == list(range(ng))


def test_geometry_of_a_stage_one_boundary():
    """The bench's widest boundary: [3211264, 64] bf16 -- 8 threads a row,
    32 rows a step, 132 spans, 128-row (16 KB) stages."""
    geo = tfn.stats_geometry(3211264, 64, 2, True, SMS)
    assert (geo.gpr, geo.rpi, geo.tile_c, geo.tiles) == (8, 32, 64, 1)
    assert (geo.spans, geo.tile_blocks, geo.stage_rows) == (132, 1, 128)
    assert geo.span_rows == 24352 and 131 * 24352 < 3211264


def test_geometry_of_a_tiled_width():
    """C 4104 (vector path): two full tiles of 2048 and one of 8, each
    block walking its tiles; C 100000 on the scalar path: 391 tiles of 256
    over 132 blocks."""
    geo = tfn.stats_geometry(300, 4104, 2, True, SMS)
    assert (geo.tile_c, geo.tiles, geo.tile_blocks) == (2048, 3, 3)
    assert (geo.spans, geo.span_rows, geo.stage_rows) == (43, 7, 4)
    geo = tfn.stats_geometry(5, 100000, 4, False, SMS)
    assert (geo.tile_c, geo.tiles, geo.tile_blocks, geo.spans) == (
        256, 391, 132, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(50, 12), (1, 1), (7, 13), (96, 64)])
def test_stats_takes_the_plain_version_on_the_cpu(shape, dtype):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dtype)
    before = tfn.stats_call.launches
    got = tfn.stats_call(x)
    want = tfn.stats_plain(x)
    assert all(a.dtype == torch.float32 and torch.equal(a, b)
               for a, b in zip(got, want))
    assert tfn.stats_call.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,c,block", [(48, 13, 16), (256, 64, 64)])
def test_stats_matches_pallas(r, c, block, dtype):
    """The JAX ``_stats_call`` (Pallas, interpret mode, a row tile that
    divides R) and the port's, on the same numpy inputs: float32 sums of
    the same values in another order, 1e-6 relative."""
    x = (np.random.RandomState(r + c).randn(r, c) + 1.0).astype(np.float32)
    jm, jv = jfn._stats_call(jnp.asarray(x, dtype=dtype), block, True)
    tm, tv = tfn.stats_call(torch.from_numpy(x).to(getattr(torch, dtype)))
    for got, want in ((tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want, np.float32).reshape(c),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,cat", [
    ("void (anonymous namespace)::bn_stats_kernel<__nv_bfloat16, true>"
     "(__nv_bfloat16 const*, float*, float*, float*, StatsGeo)",
     "fused_norm stats (CUDA)"),
    ("void (anonymous namespace)::bn_stats_kernel<float, false>",
     "fused_norm stats (CUDA)"),
    ("void bn_bwd_reduce_kernel<__half, true>", "fused_norm reduce (CUDA)"),
    ("triton_apply_kernel_0d1d2d", "fused_norm (Triton)"),
])
def test_stats_kernel_has_its_own_profile_category(name, cat):
    assert trace.kernel_category(name) == cat


def test_triton_statistics_pair_is_gone():
    src = inspect.getsource(tfn)
    for gone in ("def stats_kernel", "finalize_kernel", "def _chunks",
                 "def _finalize", "_WAVES", "_FINAL_BLOCK_K"):
        assert gone not in src, gone
    assert "_tile" in src and "cmn_bn_stats" in src
    assert "stats" not in inspect.getsource(tfn._kernels)
