"""The probe kernels' split of M, on the CPU.

``probe_matmul.probe_geometry`` cuts M's 64-row tiles into ``SPANS``
contiguous spans, one block of ``csrc/probe_matmul.cu`` each; the entry
points refuse any other split (``bad_split``: the span count the constant,
``base * spans + extra`` the tile count, ``0 <= extra < spans``), and the
kernels walk block ``s``'s tiles as ``span_tiles`` (wgrad) and
``strided_tiles`` (rowblock) do.  Checked here for the
probe's M (802,816), the ``gpu`` tests' M (65,536) and ragged and small M
down to one tile, fewer tiles than spans included: every tile taken once,
spans balanced within one tile (contiguous for wgrad's blocks, every
``SPANS``-th tile for rowblock's), the same for every bm.  Then a
Python mirror of the wgrad kernels' float32 sum order (64-product tile
chains added per span, the span partials summed as four groups of 33) is
held to ``wgrad_plain`` within ``WGRAD_RTOL`` at every bm.
"""

import importlib
import inspect
import re

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pm = importlib.import_module("chainermn_tpu_torch.ops.probe_matmul")
from chainermn_tpu_torch.ops import _build  # noqa: E402

TILE = 64
MS = [256 * 56 * 56, 65536, 64, 64 * 5, 64 * 131, 64 * 132, 64 * 133,
      64 * 264 + 64 * 7, 64 * 12547]


def _cu_constant(name):
    src = (_build.CSRC / "probe_matmul.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_constants_match_the_kernels():
    assert pm.SPANS == _cu_constant("kSpans") == 132
    assert pm.STEP_ROWS == _cu_constant("kTile") == TILE
    assert _cu_constant("kSumGroups") == 4 and pm.SPANS % 4 == 0


@pytest.mark.parametrize("m", MS)
def test_every_tile_is_taken_once_in_balanced_spans(m):
    geo = pm.probe_geometry(m)
    spans, base, extra = geo
    tiles = m // TILE
    # the entry points' rules (bad_split)
    assert spans == pm.SPANS
    assert base >= 0 and 0 <= extra < spans and base * spans + extra == tiles
    ranges = [pm.span_tiles(geo, s) for s in range(spans)]
    # wgrad: contiguous spans in block order, every tile once
    assert [t for r in ranges for t in r] == list(range(tiles))
    sizes = [len(r) for r in ranges]
    assert max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)
    assert sizes.count(0) == max(0, spans - tiles)
    # rowblock: the same counts, every spans-th tile, every tile once
    strided = [pm.strided_tiles(geo, s) for s in range(spans)]
    assert [len(r) for r in strided] == sizes
    assert sorted(t for r in strided for t in r) == list(range(tiles))
    assert all(list(r) == list(range(s, tiles, spans))
               for s, r in enumerate(strided))


@pytest.mark.parametrize("m", MS)
def test_split_and_workspace_are_the_same_for_every_bm(m):
    assert list(inspect.signature(pm.probe_geometry).parameters) == ["m"]
    bms = [bm for bm in (64, 128, 1024, 2048, 4096, 8192, m)
           if m % bm == 0]
    want = pm.SPANS * 256 * 64 * 4   # one float32 [256, 64] a span
    assert {pm.wgrad_workspace_bytes(m, bm) for bm in bms} == {want}
    assert want == 8_650_752          # inside the card's 50 MB L2


def _kernel_order(a, b):
    """wgrad in the kernels' float32 order: each tile's 64 products from 0,
    added to its span's partial in tile order; then the partials as
    ((g0 + g1) + g2) + g3, g_k the sum of spans 33k..33k + 32 in order."""
    geo = pm.probe_geometry(a.shape[1])
    partials = torch.zeros((pm.SPANS, 256, 64))
    for s in range(pm.SPANS):
        for t in pm.span_tiles(geo, s):
            rows = slice(t * TILE, (t + 1) * TILE)
            partials[s] += a[:, rows].float() @ b[rows].float()
    groups = []
    for part in partials.view(4, pm.SPANS // 4, 256, 64):
        acc = torch.zeros((256, 64))
        for p in part:
            acc = acc + p
        groups.append(acc)
    return ((groups[0] + groups[1]) + groups[2]) + groups[3]


@pytest.mark.parametrize("m", [64 * 5, 64 * 133, 64 * 1000])
def test_kernel_sum_order_holds_the_tolerance(m):
    rng = np.random.RandomState(m)
    a = torch.from_numpy(rng.randn(256, m).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.randn(m, 64).astype(np.float32)).bfloat16()
    got = _kernel_order(a, b)
    for bm in sorted({bm for bm in (64, 320, m) if m % bm == 0}):
        res = pm.agreement("wgrad", a, b, got, pm.wgrad_plain(a, b, bm))
        assert res["rel_l2"] <= pm.WGRAD_RTOL


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(640, 256).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.randn(256, 64).astype(np.float32)).bfloat16()
    before = pm.launch_counts()
    assert torch.equal(pm.rowblock(a, b, 128), pm.rowblock_plain(a, b, 128))
    at = a.t().contiguous()
    assert torch.equal(pm.wgrad(at, a[:, :64].contiguous(), 320),
                       pm.wgrad_plain(at, a[:, :64].contiguous(), 320))
    assert pm.launch_counts() == before
