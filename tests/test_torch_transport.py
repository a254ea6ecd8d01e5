"""The port's control-plane transports against the JAX package's.

Twins of ``tests/test_transport.py`` over ``chainermn_tpu_torch.runtime``
(real sockets between ranks that are threads of this process), plus the
wire interop: a JAX ``PyTransport`` rank with a port ``PyTransport`` rank,
then with a port ``NativeTransport`` rank, exchanging frames both ways in
one world, byte for byte.  Every world is closed in a ``finally`` and
every wait has its own timeout (a thread join or a recv timeout).
"""

import socket
import threading
import time

import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from chainermn_tpu_torch.runtime import native as pnative
from chainermn_tpu_torch.runtime import transport as ptransport
from chainermn_tpu_torch.runtime.control_plane import SocketControlPlane
from chainermn_tpu_torch.runtime.native import NativeTransport
from chainermn_tpu_torch.runtime.transport import PyTransport

JOIN_S = 60


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _coord():
    return f"127.0.0.1:{_free_port()}"


def _world(factories, coordinator):
    """One transport per rank, started together (the handshake is
    collective); raises if a rank failed or hung."""
    out = [None] * len(factories)
    errs = []

    def boot(i, f):
        try:
            out[i] = f(i, len(factories), coordinator)
        except Exception as e:  # surfaced below
            errs.append((i, e))

    ts = [threading.Thread(target=boot, args=(i, f), daemon=True)
          for i, f in enumerate(factories)]
    [t.start() for t in ts]
    [t.join(JOIN_S) for t in ts]
    if errs or any(t.is_alive() for t in ts):
        for tp in out:
            _swallow(lambda tp=tp: tp and tp.close())
        raise AssertionError(f"world did not start: {errs}")
    return out


def _swallow(fn):
    try:
        fn()
    except Exception:
        pass


def _close(tps):
    for tp in tps:
        _swallow(tp.close)


def _exercise(tps):
    """p2p both ways, several tags, a payload past one write buffer, a
    self-send, and tag isolation (JAX's ``_exercise``)."""
    tps[0].send(1, 7, b"hello")
    assert tps[1].recv(0, 7, timeout=30) == b"hello"
    tps[1].send(0, 9, b"x" * (1 << 20))
    assert tps[0].recv(1, 9, timeout=30) == b"x" * (1 << 20)
    tps[0].send(0, 3, b"self")
    assert tps[0].recv(0, 3, timeout=30) == b"self"
    tps[0].send(1, 5, b"five")
    tps[0].send(1, 4, b"four")
    assert tps[1].recv(0, 4, timeout=30) == b"four"
    assert tps[1].recv(0, 5, timeout=30) == b"five"


def _py(r, s, c):
    return PyTransport(r, s, c)


def _nat(r, s, c):
    return NativeTransport(r, s, c)


@pytest.mark.parametrize("factory", [_py, _nat], ids=["py", "native"])
def test_p2p(factory):
    tps = _world([factory] * 2, _coord())
    try:
        _exercise(tps)
        assert set(tps[0].peers) == {0, 1}
    finally:
        _close(tps)


def test_bad_coordinator_raises_not_aborts():
    with pytest.raises(OSError):
        NativeTransport(1, 2, "127.0.0.1:notaport")


def test_close_while_recv_blocked():
    tps = _world([_nat] * 2, _coord())
    got = []

    def blocked():
        try:
            tps[0].recv(1, 99, timeout=30)
        except (TimeoutError, OSError) as e:
            got.append(e)

    t = threading.Thread(target=blocked, daemon=True)
    try:
        t.start()
        time.sleep(0.2)
        tps[0].close()
        t.join(10)
        assert not t.is_alive()
        assert got and isinstance(got[0], (TimeoutError, OSError))
    finally:
        _close(tps)


def test_close_races_concurrent_senders_receivers():
    tps = _world([_nat] * 3, _coord())
    stop = time.monotonic() + 1.5
    errs = []

    def hammer(rank):
        while time.monotonic() < stop:
            try:
                tps[rank].send((rank + 1) % 3, 11, b"x" * 4096)
                tps[rank].recv((rank - 1) % 3, 11, timeout=0.05)
            except (TimeoutError, OSError):
                pass  # once the transport closes under us
            except Exception as e:
                errs.append(e)
                return

    ts = [threading.Thread(target=hammer, args=(r,), daemon=True)
          for r in range(3)]
    try:
        [t.start() for t in ts]
        time.sleep(0.4)
        _close(tps)
        deadline = time.monotonic() + 30
        for t in ts:
            t.join(max(0.1, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in ts), "hammer thread hung"
        assert not errs, errs
    finally:
        _close(tps)


@pytest.mark.parametrize("factory", [_py, _nat], ids=["py", "native"])
def test_recv_timeout(factory):
    tps = _world([factory] * 2, _coord())
    try:
        with pytest.raises(TimeoutError):
            tps[0].recv(1, 42, timeout=0.2)
    finally:
        _close(tps)


@pytest.mark.parametrize("bad", ["0", "-5", "banana", ""])
def test_invalid_hwm_env_falls_back(bad, monkeypatch):
    from chainermn_tpu.runtime import transport as jtransport
    assert ptransport._DEFAULT_HWM == jtransport._DEFAULT_HWM == 1 << 30
    monkeypatch.setenv("CHAINERMN_TPU_INBOX_HWM", bad)
    assert ptransport._inbox_hwm() == ptransport._DEFAULT_HWM
    monkeypatch.setenv("CHAINERMN_TPU_INBOX_HWM", "4096")
    assert ptransport._inbox_hwm() == 4096


@pytest.mark.parametrize("factory", [_py, _nat], ids=["py", "native"])
def test_backpressure_bounds_inbox(factory, monkeypatch):
    hwm = 1 << 20
    msg = b"\xab" * (1 << 18)
    n_msgs = 32  # 8x the budget
    monkeypatch.setenv("CHAINERMN_TPU_INBOX_HWM", str(hwm))
    tps = _world([factory] * 2, _coord())
    errs = []

    def blast():
        try:
            for i in range(n_msgs):
                tps[0].send(1, 40 + i, msg)
        except Exception as e:
            errs.append(e)

    t = threading.Thread(target=blast, daemon=True)
    try:
        t.start()
        time.sleep(0.5)  # the sender runs ahead; the reader parks
        for i in range(n_msgs):
            assert tps[1].recv(0, 40 + i, timeout=60) == msg
        t.join(JOIN_S)
        assert not t.is_alive() and not errs, errs
        peak = tps[1].peak_inbox_bytes
        assert peak <= hwm + len(msg), f"inbox peaked at {peak} bytes"
    finally:
        _close(tps)


@pytest.mark.parametrize("factories", [[_nat] * 3, [_py, _nat, _py]],
                         ids=["native", "mixed"])
def test_three_rank_control_plane(factories):
    tps = _world(factories, _coord())
    planes = [SocketControlPlane(i, 3, "unused", transport=tps[i])
              for i in range(3)]
    results = [None] * 3

    def run(i):
        p = planes[i]
        got = p.bcast_obj({"seed": 42} if i == 0 else None, root=0)
        s = p.allreduce_obj(i + 1, op="sum")
        g = p.gather_obj(i * 10, root=0)
        sc = p.scatter_obj(["a", "b", "c"] if i == 0 else None, root=0)
        p.barrier()
        results[i] = (got, s, g, sc)

    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(3)]
    try:
        [t.start() for t in ts]
        [t.join(JOIN_S) for t in ts]
        assert not any(t.is_alive() for t in ts), "collective hung"
        for i in range(3):
            got, s, g, sc = results[i]
            assert got == {"seed": 42} and s == 6 and sc == "abc"[i]
        assert results[0][2] == [0, 10, 20] and results[1][2] is None
    finally:
        _close(tps)


@pytest.mark.parametrize("port_factory", [_py, _nat], ids=["py", "native"])
@pytest.mark.parametrize("jax_rank", [0, 1])
def test_wire_interop_with_the_jax_transport(port_factory, jax_rank):
    """A JAX ``PyTransport`` rank and a port rank in one world (either one
    the coordinator): frames both ways, bytes equal, and a socket control
    plane of one package over the other's transport."""
    from chainermn_tpu.runtime.control_plane import (
        SocketControlPlane as JaxPlane)
    from chainermn_tpu.runtime.transport import PyTransport as JaxPy

    def jax_factory(r, s, c):
        return JaxPy(r, s, c)

    factories = [port_factory, port_factory]
    factories[jax_rank] = jax_factory
    tps = _world(factories, _coord())
    try:
        _exercise(tps)
        blob = bytes(range(256)) * 4099
        tps[0].send(1, 12, blob)
        assert tps[1].recv(0, 12, timeout=30) == blob
        tps[1].send(0, 13, blob[::-1])
        assert tps[0].recv(1, 13, timeout=30) == blob[::-1]
        planes = [(JaxPlane if r == jax_rank else SocketControlPlane)(
            r, 2, "unused", transport=tps[r]) for r in range(2)]
        out = [None, None]

        def run(r):
            p = planes[r]
            out[r] = (p.allreduce_obj({"n": r + 1}),
                      p.bcast_obj([1, 2] if r == 0 else None),
                      p.allgather_obj(r))

        ts = [threading.Thread(target=run, args=(r,), daemon=True)
              for r in range(2)]
        [t.start() for t in ts]
        [t.join(JOIN_S) for t in ts]
        assert not any(t.is_alive() for t in ts), "collective hung"
        assert out[0] == out[1] == ({"n": 3}, [1, 2], [0, 1])
    finally:
        _close(tps)


def test_create_transport_never_falls_back_quietly(monkeypatch):
    coord = _coord()
    monkeypatch.delenv("CHAINERMN_TPU_PURE_PY_TRANSPORT", raising=False)
    monkeypatch.setenv("CHAINERMN_TPU_NATIVE_BUILD", "0")
    monkeypatch.setattr(pnative, "_lib", None)
    with pytest.raises(ImportError, match="CHAINERMN_TPU_PURE_PY_TRANSPORT"):
        ptransport.create_transport(0, 1, coord)
    # a build that fails (no compiler) raises too
    monkeypatch.setenv("CHAINERMN_TPU_NATIVE_BUILD", "1")
    monkeypatch.setattr(pnative, "library_path",
                        lambda: pnative.BUILD / "libdcn-missing.so")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(ImportError, match="building dcn_transport failed"):
        ptransport.create_transport(0, 1, coord)
    # Python asked for: a world of one on the Python transport
    monkeypatch.setenv("CHAINERMN_TPU_PURE_PY_TRANSPORT", "1")
    tp = ptransport.create_transport(0, 1, coord)
    try:
        assert isinstance(tp, PyTransport)
    finally:
        tp.close()


def test_native_library_builds_into_build_dir():
    path = pnative.library_path()
    assert path.parent.name == "native" and path.parent.parent.name == \
        "build"
    assert "chainermn_tpu_torch" not in str(path.relative_to(
        path.parents[2]))
    pnative._load()
    assert path.exists()


def test_bench_transport_smoke():
    """Both backends through the bench's two processes, at small sizes:
    the goodput and round trip come back positive (no timed ratio is
    asserted here; the bench prints it)."""
    from chainermn_tpu_torch.benchmarks import bench_transport
    for backend in ("native", "python"):
        r = bench_transport.run_sweep([1 << 10, 1 << 16], backend,
                                      reps_cap=3, latency_reps=10,
                                      timeout=120)
        assert r["rtt_us"] > 0
        assert all(v > 0 for v in r["mb_per_s"].values())


@pytest.mark.slow
@pytest.mark.parametrize("factory", [_py, _nat], ids=["py", "native"])
def test_2gib_payload(factory):
    """One message past 2 GiB (and past the 1 GiB inbox budget) arrives
    whole."""
    block = bytes(bytearray(range(256))) * (1 << 12)
    payload = block * 2048 + b"tail!"
    tps = _world([factory] * 2, _coord())
    errs = []

    def ship():
        try:
            tps[0].send(1, 77, payload)
        except Exception as e:
            errs.append(e)

    t = threading.Thread(target=ship, daemon=True)
    try:
        t.start()
        got = tps[1].recv(0, 77, timeout=600)
        t.join(600)
        assert not errs, errs
        assert got == payload
    finally:
        _close(tps)
