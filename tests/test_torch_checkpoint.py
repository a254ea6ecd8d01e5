"""The port's multi-node checkpointer, iterator state and ``Snapshot``
against the JAX package's.

* File names and garbage collection: the same save sequences -- one rank
  keeping 2, a world of two whose ranks save out of step (keep 1), files of
  a larger earlier world in the directory, keep 0 -- written by the JAX
  ``_MultiNodeCheckpointer`` and the port's into two temporary directories
  leave the same listings after every save.
* Round trip of a state of float32, bfloat16 and integer tensors, numpy
  arrays, numbers and an iterator's state: the bits, dtypes and tree come
  back; a fresh start returns the state itself; the newest generation
  every rank can read wins (a torn file falls back to the one before);
  a leaf of another name, shape or dtype is refused before anything is
  restored, ZeRO-1 shards of another world size among them.
* ``SerialIterator.state_dict`` equals the JAX iterator's key for key
  after the same draws, and a restored iterator (from either) draws the
  batches the saved one would have.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from chainermn_tpu.extensions.checkpoint import (
    _MultiNodeCheckpointer as JCheckpointer)
from chainermn_tpu.iterators import SerialIterator as JIter
from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch.extensions import checkpoint as tck
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from chainermn_tpu_torch.training import extensions


class _Rank:
    """The part of a communicator the checkpointers read for saves and GC:
    one rank of a world of ``size`` (no collective)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


# (world size, keep, [(rank, iteration), ...]); files of "stale" ranks are
# written first, as an earlier, larger world would have left them
SEQUENCES = {
    "one_rank_keep2": (1, 2, [(0, it) for it in (10, 20, 30, 40)]),
    "one_rank_keep0": (1, 0, [(0, it) for it in (1, 2, 3)]),
    "two_ranks_out_of_step_keep1": (2, 1, [(0, 1), (1, 1), (0, 2), (0, 3),
                                           (1, 2), (1, 3), (0, 4), (1, 4)]),
    "lagging_peer_keep2": (2, 2, [(0, 5), (0, 6), (1, 5), (0, 7), (0, 8),
                                  (1, 6), (1, 7), (0, 9)]),
    "stale_larger_world": (2, 1, [("stale", 3), (0, 3), (1, 3), (0, 4),
                                  (0, 5), (1, 4), (1, 5)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_file_names_and_gc_equal_jax(tmp_path, name):
    size, keep, saves = SEQUENCES[name]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jstate = {"w": jnp.arange(3, dtype=jnp.float32)}
    tstate = {"w": torch.arange(3, dtype=torch.float32)}
    for rank, it in saves:
        if rank == "stale":  # rank 2 of an earlier world of 3
            for d in (jdir, tdir):
                (d / f"snap.{it}.rank2.npz").write_bytes(b"")
            continue
        JCheckpointer(_Rank(rank, size), str(jdir), "snap", keep).save(
            jstate, it)
        tck._MultiNodeCheckpointer(_Rank(rank, size), str(tdir), "snap",
                                   keep).save(tstate, it)
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)), \
            (rank, it)
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(tdir))


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def _state():
    it = SerialIterator(list(range(10)), 3, shuffle=True, seed=4)
    for _ in range(5):
        it.next()
    return {"model": {"w": torch.randn(3, 4), "h": torch.randn(
        5).to(torch.bfloat16), "n": torch.tensor([1, 2], dtype=torch.int64)},
        "optimizer": {"0": {"step": torch.tensor(3.0),
                            "exp_avg": torch.randn(4)}},
        "iterator": it.state_dict(), "iteration": np.int64(7),
        "pending": [torch.randn(2), torch.randn(1)]}


def _blank(state):
    return tck._rebuild(state, {k: (torch.zeros_like(v) if torch.is_tensor(v)
                                    else np.zeros_like(v))
                                for k, v in tck._leaves(state).items()})


def _assert_same(got, want):
    g, w = tck._leaves(got), tck._leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        if torch.is_tensor(w[k]):
            assert got is not want and g[k].dtype == w[k].dtype, k
            assert torch.equal(g[k].view(torch.int16) if g[k].dtype ==
                               torch.bfloat16 else g[k],
                               w[k].view(torch.int16) if w[k].dtype ==
                               torch.bfloat16 else w[k]), k
        else:
            np.testing.assert_array_equal(g[k], w[k], k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


def test_round_trip_and_fresh_start(world1, tmp_path):
    comm = create_communicator("naive", device="cpu")
    ckpt = create_multi_node_checkpointer(comm, str(tmp_path), "snap")
    state = _state()
    blank = _blank(state)
    restored, gen = ckpt.resume(blank)
    assert gen is None and restored is blank
    ckpt.save(state, 100)
    assert os.listdir(tmp_path) == ["snap.100.rank0.npz"]
    restored, gen = ckpt.resume(blank)
    assert gen == 100
    _assert_same(restored, state)
    assert isinstance(restored["pending"], list)
    assert len(ckpt.save_seconds) == 1
    ckpt.finalize()


def test_latest_consistent_skips_a_torn_file(world1, tmp_path):
    comm = create_communicator("naive", device="cpu")
    ckpt = create_multi_node_checkpointer(comm, str(tmp_path), "snap",
                                          keep=0)
    state = _state()
    ckpt.save(state, 5)
    ckpt.save(state, 9)
    assert ckpt.latest_consistent_generation() == 9
    path = tmp_path / "snap.9.rank0.npz"
    path.write_bytes(path.read_bytes()[:100])
    assert ckpt.latest_consistent_generation() == 5


@pytest.mark.parametrize("change,match", [
    (lambda s: s["model"].pop("w"), "leaves"),
    (lambda s: s["model"].update(extra=torch.zeros(1)), "leaves"),
    (lambda s: s["optimizer"]["0"].update(exp_avg=torch.zeros(2)),
     "world size"),
    (lambda s: s["model"].update(h=torch.zeros(5)), "float32"),
    (lambda s: s.update(iteration=np.int32(0)), "int32"),
])
def test_resume_refuses_a_mismatched_leaf(world1, tmp_path, change, match):
    comm = create_communicator("naive", device="cpu")
    ckpt = create_multi_node_checkpointer(comm, str(tmp_path), "snap")
    ckpt.save(_state(), 1)
    like = _blank(_state())
    change(like)
    with pytest.raises(ValueError, match=match):
        ckpt.resume(like)


def test_factory_refusals(world1, tmp_path):
    comm = create_communicator("naive", device="cpu")
    with pytest.raises(ValueError, match="keep must be >= 0"):
        create_multi_node_checkpointer(comm, str(tmp_path), keep=-1)
    # the async backend is ported: it wraps the npz checkpointer
    from chainermn_tpu_torch.elastic import AsyncCheckpointer
    ckpt = create_multi_node_checkpointer(comm, str(tmp_path),
                                          backend="async")
    assert isinstance(ckpt, AsyncCheckpointer)
    ckpt.finalize()
    with pytest.raises(NotImplementedError, match="no twin"):
        create_multi_node_checkpointer(comm, str(tmp_path), backend="orbax")
    with pytest.raises(ValueError, match="backend"):
        create_multi_node_checkpointer(comm, str(tmp_path), backend="pickle")


def test_publish_goes_through_a_temporary_file(world1, tmp_path,
                                                monkeypatch):
    comm = create_communicator("naive", device="cpu")
    ckpt = create_multi_node_checkpointer(comm, str(tmp_path), "snap")
    seen = []
    real = os.replace

    def spy(src, dst):
        seen.append((os.path.basename(src), os.path.basename(dst)))
        real(src, dst)

    monkeypatch.setattr(tck.os, "replace", spy)
    ckpt.save({"w": torch.ones(2)}, 3)
    assert seen == [("snap.3.rank0.npz.tmp.npz", "snap.3.rank0.npz")]


def test_snapshot_extension_saves_at_the_iteration(world1, tmp_path):
    comm = create_communicator("naive", device="cpu")
    ckpt = create_multi_node_checkpointer(comm, str(tmp_path), "snap")

    class _Updater:
        iteration = 12

    class _Trainer:
        updater = _Updater()

    snap = extensions.Snapshot(ckpt, lambda t: {"w": torch.ones(2)},
                               trigger=(4, "iteration"))
    assert snap.priority == 30 and snap.trigger == (4, "iteration")
    snap(_Trainer())
    assert os.listdir(tmp_path) == ["snap.12.rank0.npz"]


def _draws(it, n):
    return [np.asarray(b[0]).tolist() for b in (it.next() for _ in range(n))]


def test_iterator_state_equals_jax_and_resumes():
    ds = [(np.full((2,), i, np.int32), i) for i in range(10)]
    t, j = SerialIterator(ds, 3, seed=5), JIter(ds, 3, seed=5)
    assert _draws(t, 4) == _draws(j, 4)  # across an epoch boundary
    ts, js = t.state_dict(), j.state_dict()
    assert ts.keys() == js.keys()
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], k)
        assert np.asarray(ts[k]).dtype == np.asarray(js[k]).dtype, k
    want = _draws(j, 7)
    for state in (ts, js):
        b = SerialIterator(ds, 3, seed=99)
        b.load_state_dict(state)
        assert (b.epoch, b.iteration) == (t.epoch, t.iteration)
        assert _draws(b, 7) == want
    with pytest.raises(ValueError, match="10-example"):
        SerialIterator([ds[0]] * 4, 2).load_state_dict(ts)
