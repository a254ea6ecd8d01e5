"""The port's packing and communicators against the JAX package's.

``pack``/``unpack`` must lay out and restore buffers bit-exactly as
``chainermn_tpu.communicators._packing`` does.  The communicators run as
a real 2-process gloo world (``torch_dist_worker.py``) against JAX
``run_spmd`` on a 2-device CPU mesh, fed the same rank-varying inputs:
with two ranks the sum is one IEEE addition on both sides and the 1/size
scale is exact, so float32 results must be bit-identical; the float16 wire
must agree bit-exactly as well (the same casts, sum and scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu.communicators import _packing as jpack
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch.communicators import _packing as tpack
from chainermn_tpu_torch.communicators import (
    SingleNodeCommunicator, XlaCommunicator, create_communicator)
from chainermn_tpu_torch.parallel.topology import Topology
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32),
            "h": rng.randn(5).astype(np.float16),
            "n": {"z": rng.randn(2, 2).astype(np.float32)}}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("comm_dtype", [None, "float16", "float32"])
def test_pack_unpack_bit_exact_against_jax(comm_dtype):
    tree = _tree()
    jb, _ = jpack.pack(jax.tree.map(jnp.asarray, tree),
                       comm_dtype=None if comm_dtype is None
                       else jnp.dtype(comm_dtype))
    tb, meta = tpack.pack(tpack.tree_map(torch.from_numpy, tree),
                          comm_dtype=None if comm_dtype is None
                          else getattr(torch, comm_dtype))
    assert len(jb) == len(tb)
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))
    # unpack scales after the cast back, in each leaf's own dtype
    back = tpack.unpack(tb, meta, scale=0.5)
    jback = jpack.unpack(jb, jpack.pack(jax.tree.map(jnp.asarray, tree),
                                        comm_dtype=None if comm_dtype is None
                                        else jnp.dtype(comm_dtype))[1],
                         scale=0.5)
    for k in ("w", "b", "h"):
        assert back[k].dtype == getattr(torch, str(tree[k].dtype))
        np.testing.assert_array_equal(_bits(back[k].numpy()),
                                      _bits(jback[k]))
    np.testing.assert_array_equal(back["n"]["z"].numpy(), jback["n"]["z"])


@pytest.mark.parametrize("n,m", [(7, 2), (8, 4), (1, 3), (23, 8)])
def test_pad_to_multiple_matches_jax(n, m):
    buf = np.arange(1, n + 1, dtype=np.float32)
    jpad, jstrip = jpack.pad_to_multiple(jnp.asarray(buf), m)
    tpad, tstrip = tpack.pad_to_multiple(torch.from_numpy(buf), m)
    np.testing.assert_array_equal(tpad.numpy(), jpad)
    np.testing.assert_array_equal(tstrip(tpad).numpy(), jstrip(jpad))
    np.testing.assert_array_equal(tstrip(tpad).numpy(), buf)


def test_pack_of_empty_tree_round_trips():
    bufs, meta = tpack.pack({})
    assert bufs == [] and tpack.unpack(bufs, meta) == {}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    rng = np.random.RandomState(1)
    inputs = {"grad/w": rng.randn(2, 3, 4).astype(np.float32),
              "grad/b": rng.randn(2, 4).astype(np.float32) + 3.0,
              "mod/w": rng.randn(2, 2, 3).astype(np.float32),
              "mod/b": rng.randn(2, 2).astype(np.float32)}
    outs = torch_dist_worker.launch("comm", inputs, 2,
                                    tmp_path_factory.mktemp("comm"))
    return inputs, outs


def _jax_allreduce_grad(flavor, stacked, **kw):
    mesh = init_topology(devices=jax.devices()[:2]).mesh
    comm = jcreate(flavor, mesh=mesh, **kw)
    out = comm.run_spmd(lambda g: comm.allreduce_grad(g),
                        jax.tree.map(jnp.asarray, stacked))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("flavor", ["naive", "flat", "xla", "pure_nccl"])
def test_allreduce_grad_matches_jax_on_two_ranks(world2, flavor):
    inputs, outs = world2
    stacked = {"w": inputs["grad/w"], "b": inputs["grad/b"]}
    want = _jax_allreduce_grad(flavor, stacked)
    for r in range(2):
        for n in ("w", "b"):
            np.testing.assert_array_equal(outs[r][f"{flavor}/{n}"],
                                          want[n][r], err_msg=f"{n}@{r}")
            np.testing.assert_array_equal(outs[r][f"{flavor}/{n}"],
                                          stacked[n].mean(0))


def test_allreduce_grad_float16_wire_matches_jax(world2):
    inputs, outs = world2
    stacked = {"w": inputs["grad/w"], "b": inputs["grad/b"]}
    want = _jax_allreduce_grad("xla", stacked,
                               allreduce_grad_dtype=jnp.float16)
    for r in range(2):
        for n in ("w", "b"):
            got = outs[r][f"xla_f16/{n}"]
            assert got.dtype == np.float32  # the leaf dtype is restored
            np.testing.assert_array_equal(got, want[n][r])


def test_module_grads_bcast_and_allreduce_ops(world2):
    inputs, outs = world2
    for r in range(2):
        np.testing.assert_array_equal(outs[r]["mod/w"],
                                      inputs["mod/w"].mean(0))
        np.testing.assert_array_equal(outs[r]["mod/b"],
                                      inputs["mod/b"].mean(0))
        np.testing.assert_array_equal(outs[r]["bcast/module"], 0.0)
        np.testing.assert_array_equal(outs[r]["bcast/tree"],
                                      inputs["grad/b"][0])
        np.testing.assert_array_equal(outs[r]["allreduce/max"],
                                      inputs["grad/b"].max(0))
        np.testing.assert_array_equal(outs[r]["allreduce/mean"],
                                      inputs["grad/b"].mean(0))
        assert int(outs[r]["split/size"]) == 1
        assert int(outs[r]["split/rank"]) == 0


# ---------------------------------------------------------------------------
# every flavor on two-level worlds: (world, intra_size) = (2, 1), (2, 2),
# (4, 2), against JAX run_spmd on a CPU mesh of the same (inter, intra)
# ---------------------------------------------------------------------------

LEVELS = [(2, 1), (2, 2), (4, 2)]
LABELS = [label for label, _, _ in torch_dist_worker.FLAVORS]
WIRE = {"xla_f16": np.float16, "xla_bf16": jnp.bfloat16}


def _level_inputs(world, intra, seed=2):
    """Leaves of odd lengths (two_dimensional pads them); ``grad`` randn,
    ``exact`` small multiples of 1/8, whose sums every order gives
    exactly."""
    rng = np.random.RandomState(seed)
    inp = {"intra_size": np.int64(intra)}
    for name, shape in (("w", (5, 3)), ("b", (7,)), ("s", (1,))):
        inp[f"grad/{name}"] = rng.randn(world, *shape).astype(np.float32)
        inp[f"exact/{name}"] = (rng.randint(-64, 64, (world,) + shape)
                                / 8).astype(np.float32)
    inp["exact/h"] = (rng.randint(-64, 64, (world, 9)) / 8).astype(
        np.float16)
    return inp


@pytest.fixture(scope="module", params=LEVELS,
                ids=[f"world{w}-intra{i}" for w, i in LEVELS])
def level_world(request, tmp_path_factory):
    world, intra = request.param
    inputs = _level_inputs(world, intra)
    outs = torch_dist_worker.launch("comm", inputs, world,
                                    tmp_path_factory.mktemp("levels"))
    return world, intra, inputs, outs


def _jax_flavor(label, world, intra, stacked, default_route=False):
    """JAX ``allreduce_grad`` of ``stacked`` ([world, ...] leaves) for a
    worker label; the wire labels take the cast-kernel route unless
    ``default_route``."""
    _, name, kw = next(f for f in torch_dist_worker.FLAVORS
                       if f[0] == label)
    kw = dict(kw)
    if "allreduce_grad_dtype" in kw:
        kw["allreduce_grad_dtype"] = jnp.dtype(kw["allreduce_grad_dtype"])
        kw["use_pallas_cast"] = not default_route
    mesh = init_topology(devices=jax.devices()[:world],
                         intra_size=intra).mesh
    comm = jcreate(name, mesh=mesh, **kw)
    out = comm.run_spmd(lambda g: comm.allreduce_grad(g),
                        jax.tree.map(jnp.asarray, stacked))
    return jax.tree.map(np.asarray, out)


def _wire_ulp(mag, wire):
    """One unit in the last place of ``wire`` at magnitude ``mag``."""
    mant = {np.dtype(np.float16): 10, np.dtype(jnp.bfloat16): 7}[
        np.dtype(wire)]
    tiny = float(jnp.finfo(wire).smallest_subnormal)
    e = np.floor(np.log2(np.maximum(mag, tiny)))
    return np.maximum(2.0 ** (e - mant), tiny)


@pytest.mark.parametrize("label", LABELS)
def test_flavor_matches_jax_on_two_level_worlds(level_world, label):
    """Exact inputs: bit-identical.  randn inputs: a float32 sum taken in
    another order may differ by (world - 1) float32 units of the sum of
    magnitudes (plus rtol 1e-6); a wire sum by one wire unit per level of
    a log2(world)-deep reduction, at the magnitude of the partial sums."""
    world, intra, inputs, outs = level_world
    if label == "single_node" and world // intra > 1:
        for out in outs:
            assert int(out["single_node/refused"]) == 1
        with pytest.raises(ValueError, match="inter_size == 1"):
            _jax_flavor(label, world, intra, {})
        return
    for tree in ("exact", "grad"):
        stacked = {k.split("/", 1)[1]: v for k, v in inputs.items()
                   if k.startswith(f"{tree}/")}
        want = _jax_flavor(label, world, intra, stacked)
        pre = label if tree == "grad" else f"{label}/{tree}"
        for r, out in enumerate(outs):
            for n, parts in stacked.items():
                got = out[f"{pre}/{n}"]
                assert got.dtype == parts.dtype, (label, n)
                msg = f"{label} {tree}/{n} on rank {r}"
                # every sum of two is one rounding, whatever the order:
                # two-level flavors over levels of <= 2 ranks are exact
                if tree == "exact" or world == 2 or (
                        label in ("hierarchical", "two_dimensional")
                        and world // intra <= 2 and intra <= 2):
                    np.testing.assert_array_equal(_bits(got),
                                                  _bits(want[n][r]), msg)
                    continue
                mag = np.abs(parts.astype(np.float64)).sum(0)
                if label in WIRE:
                    tol = np.log2(world) * _wire_ulp(mag, WIRE[label]) / world
                else:
                    tol = (1e-6 * np.abs(want[n][r])
                           + (world - 1) * 2.0 ** -24 * mag / world)
                err = np.abs(got.astype(np.float64) - want[n][r])
                assert np.all(err <= tol), (msg, err.max())
        if tree == "exact" and label not in WIRE:
            for n, parts in stacked.items():
                np.testing.assert_array_equal(
                    outs[0][f"{pre}/{n}"],
                    (parts.astype(np.float64).sum(0) / world).astype(
                        parts.dtype))


@pytest.mark.parametrize("label", sorted(WIRE))
def test_wire_kernel_route_is_the_jax_default_route_on_float32(level_world,
                                                               label):
    """On float32 leaves the cast-kernel route and JAX's default route
    (pack in the wire dtype, psum, unpack's cast-then-scale) give the same
    bits."""
    world, intra, inputs, outs = level_world
    tree = "exact" if world > 2 else "grad"  # sums of 2 are one rounding
    stacked = {k.split("/", 1)[1]: v for k, v in inputs.items()
               if k.startswith(f"{tree}/") and v.dtype == np.float32}
    want = _jax_flavor(label, world, intra, stacked, default_route=True)
    pre = label if tree == "grad" else f"{label}/{tree}"
    for r, out in enumerate(outs):
        for n in stacked:
            np.testing.assert_array_equal(out[f"{pre}/{n}"], want[n][r])


def test_allreduce_obj_and_split_levels(level_world):
    world, intra, inputs, outs = level_world
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["allreduce_obj/sum"],
                                      np.full(2, sum(range(world))))
        assert int(out["allreduce_obj/max"]) == world - 1
        # split(color=rank % 2): members r, r + 2, ..., at most one on
        # each node, so the sub-world's levels are intra 1 x inter size
        members = list(range(r % 2, world, 2))
        size = len(members)
        assert out["split/levels"].tolist() == [size, 1, size]
        for n in ("w", "b", "s", "h"):
            parts = inputs[f"exact/{n}"][members]
            np.testing.assert_array_equal(
                out[f"split/exact/{n}"],
                (parts.astype(np.float64).sum(0) / size).astype(parts.dtype))


def test_topology_position_comes_from_the_rank(monkeypatch):
    """``torchrun --nproc_per_node 4`` with ``intra_size=2`` (one node
    standing in for two): rank 3 is the second rank of the second node,
    and keeps its own card.  The card is only named (no CUDA call)."""
    from chainermn_tpu_torch.parallel.topology import init_topology as tinit
    for k, v in (("LOCAL_RANK", "3"), ("RANK", "3"), ("WORLD_SIZE", "4"),
                 ("LOCAL_WORLD_SIZE", "4")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    topo = tinit(intra_size=2, rank=3, size=4)
    assert (topo.intra_rank, topo.intra_size) == (1, 2)
    assert (topo.inter_rank, topo.inter_size) == (1, 2)
    assert topo.device == torch.device("cuda", 3)
    # without intra_size, the launcher's node is the intra level
    topo = tinit(rank=3, size=4)
    assert (topo.intra_rank, topo.intra_size, topo.inter_rank) == (3, 4, 0)
    assert topo.device.index == 3


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def test_factory_rules(world1):
    with pytest.raises(ValueError, match="only supported by the 'xla'"):
        create_communicator("naive", allreduce_grad_dtype="float16",
                            device="cpu")
    # the planner's tuned flavor (ported): no table runs the flat plan; a
    # table that cannot be read raises
    auto = create_communicator("auto", device="cpu")
    assert auto.flavor == "auto" and auto.plan().name == "flat"
    with pytest.raises(FileNotFoundError):
        create_communicator("auto", device="cpu",
                            plan_table="/nonexistent/plan_table.json")
    with pytest.raises(ValueError, match="unknown communicator"):
        create_communicator("nope", device="cpu")
    # the default name (hierarchical) and the other reference flavors work
    assert create_communicator(device="cpu").flavor == "hierarchical"
    for name in ("two_dimensional", "single_node", "non_cuda_aware"):
        assert create_communicator(name, device="cpu").flavor == name
    # two nodes of one rank (groups given: this process is a world of one)
    with pytest.raises(ValueError, match="requires inter_size == 1"):
        SingleNodeCommunicator(topology=Topology(
            rank=0, size=2, intra_rank=0, intra_size=1,
            device=torch.device("cpu")), _groups={"intra": None,
                                                  "inter": None})
    comm = XlaCommunicator(use_pallas_cast=True, device="cpu",
                           allreduce_grad_dtype="float16")
    assert comm.use_pallas_cast and comm.allreduce_grad_dtype == torch.float16
