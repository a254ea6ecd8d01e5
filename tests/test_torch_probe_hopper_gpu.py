"""The persistent wgmma + TMA probe kernels at their edges, on the card.

``csrc/probe_matmul.cu`` runs 132 blocks, each walking one span of M's
64-row tiles (``probe_matmul.probe_geometry``): a ring of TMA loads into
``wgmma`` products, wgrad's float32 span partials summed in a fixed order,
rowblock's bf16 tiles stored by TMA.  Held here against the plain versions
where the split is ragged (M not a multiple of 132 tiles) or short (one
tile, fewer tiles than spans); on a side stream; under CUDA-graph capture
(replays read new inputs and give the eager bits); at every bm (the kernels
ignore it: the same bits); wgrad at the probe's M = 802,816 within
``WGRAD_RTOL`` at every bm of the probe's sweep; and an entry point
refusing a split that breaks its rules.  Every test is marked ``gpu`` and
skips without a card; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_probe_hopper_gpu.py

Tolerances are the probe's own (``probe_matmul.agreement``): wgrad within
a relative L2 error of 2e-5; rowblock 99% of the bf16 outputs equal bit
for bit, every one within one ulp plus the float32 sums' rounding bound.
"""

import ctypes
import importlib

import pytest
import torch

pm = importlib.import_module("chainermn_tpu_torch.ops.probe_matmul")

SHAPES = {"wgrad": lambda m: ((256, m), (m, 64)),
          "dgrad": lambda m: ((m, 64), (64, 256)),
          "fwd1x1": lambda m: ((m, 256), (256, 64))}
PROBE_M = 256 * 56 * 56
SWEEP = (1024, 2048, 4096, 8192)  # the probe's bm sweep
# one tile; fewer tiles than spans; one tile more than spans; a ragged
# split of the probe's size
EDGE_M = [64, 64 * 5, 64 * 133, 64 * 12547]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel(name):
    kern = "wgrad" if name == "wgrad" else "rowblock"
    return kern, getattr(pm, kern), getattr(pm, f"{kern}_plain")


def _operands(name, m, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=device,
                             dtype=torch.bfloat16) for s in SHAPES[name](m))


@pytest.mark.gpu
@pytest.mark.parametrize("m", EDGE_M)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_short_and_ragged_splits_match_plain(cuda, name, m):
    kern, fn, plain = _kernel(name)
    a, b = _operands(name, m, cuda)
    before = fn.launches
    got = fn(a, b, 64)
    torch.cuda.synchronize()
    assert fn.launches - before == 1
    pm.agreement(kern, a, b, got, plain(a, b, m))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_side_stream_gives_the_same_bits(cuda, name):
    _, fn, _ = _kernel(name)
    a, b = _operands(name, 65536, cuda, seed=1)
    want = fn(a, b, 1024)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = fn(a, b, 1024)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_graph_replay_gives_the_eager_bits(cuda, name):
    """Captured once, replayed on new inputs copied into the captured
    ones: the tensor maps and the split live in the graph."""
    _, fn, _ = _kernel(name)
    a, b = _operands(name, 65536, cuda, seed=2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(a, b, 1024)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(a, b, 1024)
    for seed in (3, 4):
        a2, b2 = _operands(name, 65536, cuda, seed=seed)
        a.copy_(a2)
        b.copy_(b2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn(a2, b2, 1024))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dgrad", "fwd1x1"])
def test_rowblock_bits_are_the_same_at_every_bm(cuda, name):
    a, b = _operands(name, 65536, cuda, seed=5)
    outs = [pm.rowblock(a, b, bm) for bm in (64, 1024, 8192, 65536)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    pm.agreement("rowblock", a, b, outs[0], pm.rowblock_plain(a, b, 1024))


@pytest.mark.gpu
def test_wgrad_at_the_probe_shape_within_tolerance_at_every_bm(cuda):
    a, b = _operands("wgrad", PROBE_M, cuda, seed=6)
    outs = {bm: pm.wgrad(a, b, bm) for bm in SWEEP}
    for bm, got in outs.items():
        res = pm.agreement("wgrad", a, b, got, pm.wgrad_plain(a, b, bm))
        assert res["rel_l2"] <= pm.WGRAD_RTOL
        assert torch.equal(got, outs[SWEEP[0]])


@pytest.mark.gpu
@pytest.mark.parametrize("change", ["spans", "base", "extra", "m"])
def test_entry_points_refuse_a_broken_split(cuda, change):
    m = 65536
    a, b = _operands("dgrad", m, cuda)
    out = torch.empty((m, 256), dtype=torch.bfloat16, device=cuda)
    spans, base, extra = pm.probe_geometry(m)
    bad = {"spans": (spans + 1, base, extra), "base": (spans, base + 1, extra),
           "extra": (spans, base, spans), "m": (spans, base, extra)}[change]
    lib = pm._library()
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.cmn_probe_rowblock(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        m - 32 if change == "m" else m, 64, 256, *bad, cuda.index or 0,
        ctypes.c_void_p(stream))
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        pm._raise_on(err, "rowblock")
    wa, wb = _operands("wgrad", m, cuda)
    work = torch.empty((pm.SPANS, 256, 64), device=cuda)
    wout = torch.empty((256, 64), device=cuda)
    assert lib.cmn_probe_wgrad(
        wa.data_ptr(), wb.data_ptr(), work.data_ptr(), wout.data_ptr(),
        m - 32 if change == "m" else m, *bad, cuda.index or 0,
        ctypes.c_void_p(stream)) != 0
