"""The port's collectives, object plane, persistent-value sync and
multi-node iterators against the JAX package's.

Gloo worlds of 2 and 4 processes (``torch_dist_worker.py`` mode ``coll``,
one world of each size for the whole file) run the array collectives
(``allgather``, ``gather``, ``alltoall``, ``scatter``, ``reduce_scatter``,
``ppermute``), ``split_axes`` of a two-level world, ``allreduce_persistent``
and the object plane on rank-varying inputs; torch rank r is held to slice
r of JAX ``run_spmd`` on a CPU mesh of the same size.  Integer and
permutation results match exactly; float32 sums too on two ranks (one
rounding in any order) and within 1e-6 relative on four.  The object plane
(``send_obj``/``recv_obj`` with two tags received in the other order than
sent, ``gather_obj``, ``scatter_obj``, ``barrier``) is held to the JAX
control plane's contract, and to the JAX communicator itself on a world of
one.  The multi-node iterator's slaves see the master's batches, which are
the JAX ``SerialIterator``'s; the synchronized iterator gives every rank
the batches of the JAX one seeded the same way.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.extensions import allreduce_persistent as jpersistent
from chainermn_tpu.iterators import SerialIterator as JIter
from chainermn_tpu.iterators import create_synchronized_iterator as jsync
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLDS = {2: 1, 4: 2}  # world size -> intra_size of the two-level world


def _inputs(world, seed=0):
    rng = np.random.RandomState(seed + world)
    return {"x": rng.randn(world, 3).astype(np.float32),
            "xs": (100.0 * np.arange(world).reshape(world, 1, 1)
                   + np.arange(world).reshape(1, world, 1)
                   + np.zeros((world, world, 2))).astype(np.float32),
            "table": rng.randn(world, world, 3).astype(np.float32),
            "rs": rng.randn(world, 2 * world, 3).astype(np.float32),
            "rsi": rng.randint(-1000, 1000,
                               (world, 2 * world)).astype(np.int32),
            "intra_size": np.int64(WORLDS[world])}


@pytest.fixture(scope="module", params=sorted(WORLDS),
                ids=[f"world{w}" for w in sorted(WORLDS)])
def world(request, tmp_path_factory):
    n = request.param
    inputs = _inputs(n)
    outs = torch_dist_worker.launch("coll", inputs, n,
                                    tmp_path_factory.mktemp("coll"))
    return n, inputs, outs


def _jcomm(name, n, intra=None):
    mesh = init_topology(devices=jax.devices()[:n], intra_size=intra).mesh
    return jcreate(name, mesh=mesh)


def _spmd(comm, fn, *args):
    out = comm.run_spmd(fn, *[jax.tree.map(jnp.asarray, a) for a in args])
    return jax.tree.map(np.asarray, out)


def _close(got, want, n, msg=""):
    """Exact on two ranks (a sum of two is one rounding in any order) and
    for integers; within 1e-6 relative otherwise."""
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    if n == 2 or got.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=msg)


@pytest.mark.parametrize("op", ["allgather", "gather", "alltoall",
                                "scatter", "ppermute_ring", "ppermute_one"])
def test_data_movement_matches_jax_exactly(world, op):
    n, inp, outs = world
    c = _jcomm("naive", n)
    fns = {"allgather": (lambda x: c.allgather(x), "x"),
           "gather": (lambda x: c.gather(x, root=1), "x"),
           "alltoall": (lambda x: c.alltoall(x), "xs"),
           "scatter": (lambda x: c.scatter(x, root=n - 1), "table"),
           "ppermute_ring": (lambda x: c.ppermute(
               x, [(i, (i + 1) % n) for i in range(n)]), "x"),
           "ppermute_one": (lambda x: c.ppermute(x, [(0, n - 1)]), "x")}
    fn, key = fns[op]
    want = _spmd(c, fn, inp[key])
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[op], want[r], f"{op} rank {r}")
    if op == "ppermute_one":  # ranks that receive nothing get zeros
        for r in range(n - 1):
            np.testing.assert_array_equal(outs[r][op], 0.0)
        np.testing.assert_array_equal(outs[n - 1][op], inp["x"][0])


def test_allgather_of_a_tree(world):
    n, inp, outs = world
    c = _jcomm("naive", n)
    want = _spmd(c, lambda a, b: c.allgather({"a": a, "b": [b[:2]]}),
                 inp["x"], inp["rsi"])
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["tree/a"], want["a"][r])
        np.testing.assert_array_equal(out["tree/b"], want["b"][0][r])


@pytest.mark.parametrize("key", ["rs", "rsi"])
def test_reduce_scatter_matches_jax(world, key):
    n, inp, outs = world
    c = _jcomm("naive", n)
    want = _spmd(c, lambda x: c.reduce_scatter(x), inp[key])
    name = "reduce_scatter" + ("_int" if key == "rsi" else "")
    for r, out in enumerate(outs):
        _close(out[name], want[r], n, f"{name} rank {r}")


@pytest.mark.parametrize("axes", [("intra",), ("inter",),
                                  ("inter", "intra")])
def test_split_axes_matches_jax(world, axes):
    n, inp, outs = world
    intra = WORLDS[n]
    c = _jcomm("hierarchical", n, intra)
    sub = c.split_axes(axes)
    want = _spmd(c, lambda x: sub.allreduce(x, "sum"), inp["x"])
    grad = _spmd(c, lambda x: sub.allreduce_grad({"g": x})["g"], inp["x"])
    key = "split_axes/" + "_".join(axes)
    members = {("intra",): lambda r: [m for m in range(n)
                                      if m // intra == r // intra],
               ("inter",): lambda r: [m for m in range(n)
                                      if m % intra == r % intra],
               ("inter", "intra"): lambda r: list(range(n))}[axes]
    for r, out in enumerate(outs):
        size, rank, sub_intra = out[key + "/shape"].tolist()
        assert (size, rank) == (sub.size, members(r).index(r))
        if axes == ("intra",):
            assert sub_intra == sub.intra_size == intra
        _close(out[key], want[r], n, f"{key} rank {r}")
        _close(out[key + "/grad"], grad[r], n, f"{key} grad rank {r}")


def test_allreduce_persistent_matches_jax(world):
    n, inp, outs = world
    c = _jcomm("naive", n)
    want = jax.tree.map(np.asarray, jpersistent(
        {"mean": jnp.asarray(inp["x"]), "var": jnp.asarray(inp["x"] ** 2),
         "tree": jnp.asarray(inp["rs"])}, c))
    for r, out in enumerate(outs):
        _close(out["persistent/mean"], want["mean"][r], n)
        _close(out["persistent/var"], want["var"][r], n)
        _close(out["persistent/tree"], want["tree"][r], n)


def test_object_plane(world):
    n, _, outs = world
    for r, out in enumerate(outs):
        obj = json.loads(str(out["obj"]))
        prv = (r - 1) % n
        assert obj["tag12"] == ["second", prv]
        assert obj["tag11"] == {"first": prv}
        assert obj["loopback"] == "self"
        assert obj["gather"] == ([{"r": i} for i in range(n)] if r == 1
                                 else None)
        assert obj["scatter"] == f"s{r}"
        assert obj["bcast"] == ["from", 1]
        assert obj["allgather"] == [10 * i for i in range(n)]
        assert obj["allreduce"] == {"v": sum(range(n))}


def test_multi_node_iterator_slaves_see_the_masters_batches(world):
    n, _, outs = world
    objs = [json.loads(str(o["obj"])) for o in outs]
    want = [list(range(i, i + 4)) for i in range(0, 20, 4)]
    it = JIter(list(range(20)), 3, shuffle=True, seed=5)
    shuffled = [[int(v) for v in it.next()] for _ in range(9)]
    for obj in objs:
        assert obj["mn_batches"] == want
        assert obj["mn_epoch"] == objs[0]["mn_epoch"]
        assert obj["mn_shuffled"] == shuffled


def test_synchronized_iterator_draws_the_jax_batches(world):
    n, _, outs = world
    np.random.seed(100)  # rank 0's global draw in the worker
    it = jsync(JIter(list(range(32)), 8, shuffle=True, seed=0),
               jcreate("naive", mesh=init_topology(
                   devices=jax.devices()[:1]).mesh))
    want = [[int(v) for v in it.next()] for _ in range(5)]
    for out in outs:
        assert json.loads(str(out["obj"]))["synced"] == want


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def test_object_plane_on_a_world_of_one_matches_jax(world1):
    t = create_communicator("naive", device="cpu")
    j = _jcomm("naive", 1)
    for name, args in (("bcast_obj", ({"a": 1},)), ("allgather_obj", (5,)),
                       ("gather_obj", (5,)), ("scatter_obj", ([7],))):
        assert getattr(t, name)(*args) == getattr(j, name)(*args), name
    assert t.allreduce_obj({"x": 2.0}, op="sum") == \
        j.allreduce_obj({"x": 2.0}, op="sum")
    t.barrier()
    for c in (t, j):
        c.send_obj([1, 2, 3], dest=0, tag=5)
        c.send_obj("other", dest=0, tag=6)
    assert t.recv_obj(source=0, tag=6) == j.recv_obj(source=0, tag=6)
    assert t.recv_obj(source=0, tag=5) == j.recv_obj(source=0, tag=5)
    with pytest.raises(ValueError):
        t.recv_obj(source=0, tag=5)


def test_collectives_refuse_bad_shapes(world1):
    t = create_communicator("naive", device="cpu")
    with pytest.raises(ValueError, match="alltoall"):
        t.alltoall(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="not a permutation"):
        t.ppermute(torch.zeros(1), [(0, 0), (0, 0)])
    with pytest.raises(ValueError, match="split_axes"):
        t.split_axes(("model",))
    with pytest.raises(ValueError, match="scatter_obj"):
        t.scatter_obj([1, 2])
