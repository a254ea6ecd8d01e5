"""The port's control plane against the JAX package's.

* ``RESERVED_TAG_BANDS`` band by band, and the derived tags.
* For worlds of 1-9 ranks and every root, each rank's sequence of
  ``(op, peer, tag)`` in the tree collectives, recorded by an in-memory
  fake plane under both packages' ``ControlPlane``, is JAX's, and so are
  the results.
* The structural reductions, the unknown-op error, and the wire budgets
  and fan-in of ``tests/test_control_plane_tree.py``.
* ``SocketControlPlane``'s ``control_plane_*`` counters and the default
  plane's selection.
"""

import math
import queue
import socket
import threading

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from chainermn_tpu.runtime import control_plane as jcp
from chainermn_tpu_torch.runtime import control_plane as pcp

JOIN_S = 30


def _world_cls(base):
    class Plane(base):
        def __init__(self, world, rank):
            self._world = world
            self.rank = rank
            self.size = world.size

        def send_obj(self, obj, dest, tag=0):
            self._world.log[self.rank].append(("send", dest, tag))
            self._world.queues[(self.rank, dest)].put((tag, obj))

        def recv_obj(self, source, tag=0):
            self._world.log[self.rank].append(("recv", source, tag))
            got_tag, obj = self._world.queues[(source, self.rank)].get(
                timeout=20)
            assert got_tag == tag, f"tag mismatch {got_tag} != {tag}"
            return obj

    return Plane


class _World:
    """``size`` planes of ``base`` wired through in-memory queues; every
    send and receive is logged per rank as ``(op, peer, tag)``."""

    def __init__(self, base, size):
        self.size = size
        self.queues = {(s, d): queue.Queue()
                       for s in range(size) for d in range(size)}
        self.log = [[] for _ in range(size)]
        cls = _world_cls(base)
        self.planes = [cls(self, r) for r in range(size)]

    @property
    def send_counts(self):
        return [sum(op == "send" for op, _, _ in lg) for lg in self.log]

    def run(self, fn):
        results = [None] * self.size
        errors = []

        def body(i):
            try:
                results[i] = fn(self.planes[i])
            except Exception as e:  # surfaced below
                errors.append((i, e))

        ts = [threading.Thread(target=body, args=(i,), daemon=True)
              for i in range(self.size)]
        [t.start() for t in ts]
        [t.join(JOIN_S) for t in ts]
        assert not any(t.is_alive() for t in ts), "collective deadlocked"
        assert not errors, f"rank errors: {errors}"
        return results


def test_reserved_tag_bands_are_jax_s():
    assert list(pcp.RESERVED_TAG_BANDS) == list(jcp.RESERVED_TAG_BANDS)
    for name, band in jcp.RESERVED_TAG_BANDS.items():
        assert pcp.RESERVED_TAG_BANDS[name].as_dict() == band.as_dict()
        assert pcp.reserved_tag(name) == jcp.reserved_tag(name)
    assert (pcp.TELEMETRY_TAG, pcp.BARRIER_TAG) == (jcp.TELEMETRY_TAG,
                                                    jcp.BARRIER_TAG)
    for tag in (0, 1, 2, 770, 771, 899, 900, 901, (1 << 20) + 5,
                (1 << 21) + 9, (1 << 28) + 7, (1 << 28) + 8):
        jb, pb = jcp.band_of(tag), pcp.band_of(tag)
        assert (jb and jb.name) == (pb and pb.name), tag
    with pytest.raises(KeyError):
        pcp.reserved_tag("nope")


def _ops(root, size):
    """The collectives every rank runs, in one sequence (tags chosen so
    that each op rides its own)."""
    def fn(p):
        r = p.rank
        return {
            "bcast": p.bcast_obj({"v": 42, "r": root} if r == root else None,
                                 root=root, tag=3),
            "gather": p.gather_obj(r * 10, root=root, tag=5),
            "scatter": p.scatter_obj(
                [f"item{i}" for i in range(size)] if r == root else None,
                root=root, tag=7),
            "allgather": p.allgather_obj((r, "x"), tag=11),
            "allreduce": p.allreduce_obj(
                {"a": r + 1, "b": [np.full(2, r), r]}, op="sum", tag=13),
            "allreduce_max": p.allreduce_obj(r, op="max", tag=17),
            "barrier": p.barrier(),
        }
    return fn


@pytest.mark.parametrize("size,root", [(n, r) for n in range(1, 10)
                                       for r in range(n)])
def test_tree_wire_sequences_are_jax_s(size, root):
    jw, pw = _World(jcp.ControlPlane, size), _World(pcp.ControlPlane, size)
    jout = jw.run(_ops(root, size))
    pout = pw.run(_ops(root, size))
    assert pw.log == jw.log
    for j, p in zip(jout, pout):
        assert j.keys() == p.keys()
        for k in j:
            if k == "allreduce":
                assert p[k]["a"] == j[k]["a"] == size * (size + 1) // 2
                np.testing.assert_array_equal(p[k]["b"][0], j[k]["b"][0])
                assert p[k]["b"][1] == j[k]["b"][1]
            else:
                assert p[k] == j[k], k
    assert pout[root]["gather"] == [r * 10 for r in range(size)]
    assert [o["scatter"] for o in pout] == [f"item{r}" for r in range(size)]


@pytest.mark.parametrize("size", [2, 3, 4, 7, 8])
@pytest.mark.parametrize("root", [0, 1])
def test_bcast_tree_correct_and_log_hops(size, root):
    w = _World(pcp.ControlPlane, size)
    out = w.run(lambda p: p.bcast_obj(
        {"v": 42} if p.rank == root else None, root=root))
    assert all(o == {"v": 42} for o in out)
    assert sum(w.send_counts) == size - 1
    assert max(w.send_counts) <= math.ceil(math.log2(size))


@pytest.mark.parametrize("size", [2, 3, 4, 7, 8])
def test_gather_tree_correct_and_log_fanin(size):
    w = _World(pcp.ControlPlane, size)
    out = w.run(lambda p: p.gather_obj(p.rank * 10, root=0))
    assert out[0] == [r * 10 for r in range(size)]
    assert all(o is None for o in out[1:])
    assert sum(w.send_counts) == size - 1
    assert max(w.send_counts) == 1


@pytest.mark.parametrize("size", [3, 8])
def test_allreduce_tree_wire_budget(size):
    w = _World(pcp.ControlPlane, size)
    out = w.run(lambda p: p.allreduce_obj(p.rank + 1))
    assert all(o == sum(range(1, size + 1)) for o in out)
    assert sum(w.send_counts) == 2 * (size - 1)


def test_allgather_total_wire():
    w = _World(pcp.ControlPlane, 8)
    out = w.run(lambda p: p.allgather_obj(p.rank))
    assert all(o == list(range(8)) for o in out)
    assert sum(w.send_counts) == 2 * 7


def test_structural_ops_callables_and_unknown_op():
    w = _World(pcp.ControlPlane, 4)
    out = w.run(lambda p: p.allreduce_obj(
        {"a": p.rank + 1, "b": (np.full(3, p.rank), p.rank)}, op="max"))
    for o in out:
        assert o["a"] == 4 and isinstance(o["b"], tuple)
        np.testing.assert_array_equal(o["b"][0], np.full(3, 3))
    w = _World(pcp.ControlPlane, 3)
    assert w.run(lambda p: p.allreduce_obj(p.rank + 2, op="prod")) == [24] * 3
    assert w.run(lambda p: p.allreduce_obj(
        {p.rank}, op=lambda a, b: a | b)) == [{0, 1, 2}] * 3
    assert w.run(lambda p: p.allreduce_obj(
        np.full(2, float(p.rank)), op="min"))[0].tolist() == [0.0, 0.0]
    for mod in (pcp, jcp):
        with pytest.raises(ValueError, match="unknown op"):
            _World(mod.ControlPlane, 2).planes[0].allreduce_obj(
                1, op="median")


def test_single_process_plane_and_loopback():
    p = pcp.SingleProcessControlPlane()
    assert (p.rank, p.size) == (0, 1)
    assert p.bcast_obj(5) == 5 and p.allgather_obj(1) == [1]
    assert p.gather_obj("x") == ["x"] and p.scatter_obj(["y"]) == "y"
    p.barrier()
    p.send_obj({"k": 1}, 0, tag=4)
    assert p.recv_obj(0, tag=4) == {"k": 1}
    with pytest.raises(ValueError):
        p.send_obj(1, 1)
    with pytest.raises(ValueError):
        p.recv_obj(0, tag=4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _socket_world(mod, tp_mod, size):
    coord = f"127.0.0.1:{_free_port()}"
    out = [None] * size

    def boot(r):
        out[r] = mod.SocketControlPlane(
            r, size, coord, transport=tp_mod.PyTransport(r, size, coord))

    ts = [threading.Thread(target=boot, args=(r,), daemon=True)
          for r in range(size)]
    [t.start() for t in ts]
    [t.join(JOIN_S) for t in ts]
    assert all(o is not None for o in out), "socket world did not start"
    return out


def _run(planes, fn):
    res = [None] * len(planes)

    def body(r):
        res[r] = fn(planes[r])

    ts = [threading.Thread(target=body, args=(r,), daemon=True)
          for r in range(len(planes))]
    [t.start() for t in ts]
    [t.join(JOIN_S) for t in ts]
    assert not any(t.is_alive() for t in ts), "collective hung"
    return res


def test_socket_plane_counters_are_jax_s():
    """With observability on, both packages' socket planes count the same
    messages and pickled bytes for the same collectives."""
    from chainermn_tpu import observability as jobs
    from chainermn_tpu.runtime import transport as jtp
    from chainermn_tpu_torch import observability as pobs
    from chainermn_tpu_torch.runtime import transport as ptp

    snaps = {}
    for name, mod, tp, obs in (("jax", jcp, jtp, jobs),
                               ("port", pcp, ptp, pobs)):
        obs.get_registry().reset()
        obs.enable()
        planes = []
        try:
            planes = _socket_world(mod, tp, 3)
            _run(planes, lambda p: (p.allreduce_obj({"n": p.rank}),
                                    p.bcast_obj(list(range(7))
                                                if p.rank == 0 else None),
                                    p.barrier()))
            snaps[name] = sorted(
                (r["name"], tuple(sorted(r["labels"].items())), r["value"])
                for r in obs.get_registry().snapshot()
                if r["name"].startswith("control_plane_"))
        finally:
            for p in planes:
                p.shutdown()
            obs.disable()
            obs.get_registry().reset()
            # the planes' instrumentation installed a process-wide flight
            # recorder that disable() leaves: later tests start from none
            obs.reset_flight_recorder()
    assert snaps["port"] == snaps["jax"] and snaps["port"]


def test_default_plane_selection(monkeypatch):
    monkeypatch.setattr(pcp, "_DEFAULT_PLANE", None)
    for k in ("CHAINERMN_TPU_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    plane = pcp.get_control_plane()
    assert isinstance(plane, pcp.SingleProcessControlPlane)
    assert pcp.get_control_plane() is plane  # memoized
    pcp.reset_control_plane()
    # the JAX env contract comes first: a socket world of one
    monkeypatch.setenv("CHAINERMN_TPU_COORDINATOR",
                       f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("CHAINERMN_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("CHAINERMN_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("CHAINERMN_TPU_PURE_PY_TRANSPORT", "1")
    plane = pcp.get_control_plane()
    try:
        assert isinstance(plane, pcp.SocketControlPlane)
        assert plane.allgather_obj("a") == ["a"]
    finally:
        pcp.reset_control_plane()
    assert pcp._DEFAULT_PLANE is None


def test_communicator_on_a_control_plane():
    """A communicator given a control plane routes every object op through
    it (tags honored), and its split gets JAX's sub-plane."""
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.communicators.mesh_communicator_base import (
        _SplitControlPlane)

    class Recording(pcp.SingleProcessControlPlane):
        def __init__(self):
            super().__init__()
            self.calls = []

        def send_obj(self, obj, dest, tag=0):
            self.calls.append(("send", dest, tag))
            super().send_obj(obj, dest, tag)

        def recv_obj(self, source, tag=0):
            self.calls.append(("recv", source, tag))
            return super().recv_obj(source, tag)

    cp = Recording()
    comm = create_communicator("naive", device="cpu", control_plane=cp)
    assert comm._cp is cp
    comm.send_obj({"x": 1}, 0, tag=9)
    assert comm.recv_obj(0, tag=9) == {"x": 1}
    assert cp.calls == [("send", 0, 9), ("recv", 0, 9)]
    assert comm.allreduce_obj({"a": 2}) == {"a": 2}
    comm.barrier()
    sub = comm.split(3, 0)
    assert isinstance(sub._cp, _SplitControlPlane)
    assert sub._cp._tag(5) == 4 * 100003 + 5
    sub.send_obj("s", 0, tag=5)
    assert sub.recv_obj(0, tag=5) == "s"
    assert cp.calls[-2:] == [("send", 0, 4 * 100003 + 5),
                             ("recv", 0, 4 * 100003 + 5)]
    with pytest.raises(ValueError, match="does not match"):
        bad = pcp.SingleProcessControlPlane()
        bad.size = 2
        create_communicator("naive", device="cpu", control_plane=bad)
