"""The launch geometry of the CUDA BatchNorm backward reduction, on the CPU.

``fused_norm._reduce_geometry`` chooses how ``cmn_bn_bwd_reduce``
(``csrc/fused_norm.cu``) cuts an ``[R, C]`` activation: threads a row,
rows a step and rows a block.  The kernel refuses a geometry that breaks
its rules (``tpr * rpi <= 256`` threads, ``rows`` a multiple of ``rpi``,
the block's partial sums within its shared memory), and its finalize reads
every block's partial, so the choice must also keep the blocks few enough
and each block busy.  Checked here for every BatchNorm boundary of
ResNet-50 at batch 32 and 256 and for ragged shapes, on both paths, with
the H100's 132 SMs.
"""

import importlib

import pytest
import torch

tfn = importlib.import_module("chainermn_tpu_torch.ops.fused_norm")

SMS = 132
SHAPES = sorted({(n * h * w, c) for batch in (32, 256)
                 for _, (n, h, w, c), _ in tfn.resnet_bn_boundaries(batch)}
                | {(1, 1), (7, 13), (1001, 64), (333, 13), (96, 2048),
                   (300, 4104), (12547, 512), (5, 100000)})


# the vector path needs C % 8 == 0
CASES = [(shape, vec) for shape in SHAPES for vec in (True, False)
         if not vec or shape[1] % 8 == 0]


@pytest.mark.parametrize("shape,vec", CASES, ids=[
    f"{r}x{c}-{'vector' if v else 'scalar'}" for (r, c), v in CASES])
def test_reduce_geometry_keeps_the_kernels_rules(shape, vec):
    r, c = shape
    epc = 8 if vec else 1
    tpr, rpi, rows = tfn._reduce_geometry(r, c, vec, SMS)
    tile_c = tpr * epc
    assert 1 <= tpr * rpi <= 256 and tpr * epc * rpi <= 8 * 256
    assert tile_c <= 128
    assert tile_c >= min(c, 128)  # the tiles cover C with at most one ragged
    assert rows % rpi == 0 and rows >= rpi
    n_chunks = -(-r // rows)
    tiles = -(-c // tile_c)
    assert (n_chunks - 1) * rows < r <= n_chunks * rows
    # about one block an SM, fewer only where the rows run out
    assert n_chunks * tiles <= SMS + tiles
    if r >= 8 * rpi:
        assert rows >= 8 * rpi  # every block walks at least 8 row steps


def test_bwd_reduce_takes_the_plain_version_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(50, 12, generator=gen)
    g = torch.randn(50, 12, generator=gen)
    mean, var = tfn.stats_plain(x)
    invstd = torch.rsqrt(var + 1e-5)
    scale, bias = torch.rand(12, generator=gen), torch.rand(12, generator=gen)
    before = tfn.bwd_reduce_call.launches
    got = tfn.bwd_reduce_call(x, g, mean, invstd, scale, bias, True)
    want = tfn.bwd_reduce_plain(x, g, mean, invstd, scale, bias, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tfn.bwd_reduce_call.launches == before
