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

import torch_dist_worker
from chainermn_tpu.communicators import _packing as jpack
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch.communicators import _packing as tpack
from chainermn_tpu_torch.communicators import (
    XlaCommunicator, create_communicator)


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


def test_factory_rules():
    with pytest.raises(ValueError, match="only supported by the 'xla'"):
        create_communicator("naive", allreduce_grad_dtype="float16",
                            device="cpu")
    for name in ("hierarchical", "two_dimensional", "single_node",
                 "non_cuda_aware"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            create_communicator(name, device="cpu")
    with pytest.raises(ValueError, match="unknown communicator"):
        create_communicator("nope", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        XlaCommunicator(use_pallas_cast=True, device="cpu")
