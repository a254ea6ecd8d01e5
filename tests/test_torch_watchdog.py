"""The port's hang watchdog and crash dumps against the JAX package's, on
the CPU.

JAX's watchdog tests (``tests/test_flight_recorder.py``) on the port:
``WatchdogConfig`` and its ``CHAINERMN_TPU_WATCHDOG_*`` variables
(equal to JAX's for the same environment); the disabled contract
(``start_watchdog`` and ``install_crash_dumps`` return ``None``, no
thread starts, a trainer run records nothing); the single-process
predicates (a stalled collective, a step stall, the dump bound, a forced
start and stop); and the two-rank world over real sockets, on the
Python and on the native transport, whose dumps must name the desynced
rank, its positions and one incident exactly as JAX's world does.  A
gloo world shows the watchdog's thread dumping while the main thread
waits in a gloo call, local-only (no socket plane).  The crash dumps
(unhandled exception, ``SIGTERM``) carry JAX's stamps.
"""

import json
import os
import signal
import sys
import threading
import time

import pytest

from chainermn_tpu import observability as jobs
from chainermn_tpu_torch import observability as pobs
from chainermn_tpu_torch.observability import (
    FlightRecorder, Watchdog, WatchdogConfig, get_flight_recorder,
    identify_desync, reset_flight_recorder, start_watchdog,
    watchdog_thread_count)
from chainermn_tpu_torch.observability.watchdog import FLIGHT_TAG
from chainermn_tpu_torch.runtime.bootstrap import install_crash_dumps
import torch_dist_worker
from torch_obs_links import socket_world
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def clean_recorder():
    """Every test starts and ends with no process-wide recorder, the
    switch off, and no leaked watchdog threads."""
    reset_flight_recorder()
    yield
    reset_flight_recorder()
    pobs.disable()
    pobs.get_registry().reset()
    deadline = time.time() + 5
    while watchdog_thread_count() and time.time() < deadline:
        time.sleep(0.02)
    assert watchdog_thread_count() == 0, "test leaked watchdog threads"


def _wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


# ---- config -----------------------------------------------------------------

ENVS = [
    {},
    {"CHAINERMN_TPU_WATCHDOG_DEADLINE": "42.5",
     "CHAINERMN_TPU_WATCHDOG_MAX_DUMPS": "9",
     "CHAINERMN_TPU_WATCHDOG_STEP_K": "not-a-number",
     "CHAINERMN_TPU_FLIGHT_DIR": "/tmp/fl"},
    {"CHAINERMN_TPU_WATCHDOG_HEARTBEAT": "0",
     "CHAINERMN_TPU_WATCHDOG_POLL": "0.05",
     "CHAINERMN_TPU_WATCHDOG_COLLECT": "",
     "CHAINERMN_TPU_WATCHDOG_HB_TIMEOUT": "3"},
]


@pytest.mark.parametrize("env", ENVS)
def test_config_from_env_equals_jax(env):
    from chainermn_tpu.observability import WatchdogConfig as JConfig
    got = WatchdogConfig.from_env(env)
    assert got.as_dict() == JConfig.from_env(env).as_dict()
    assert got.to_env() == JConfig.from_env(env).to_env()
    assert WatchdogConfig.from_env(got.to_env()) == got


def test_config_defaults_overrides_and_refusal():
    cfg = WatchdogConfig()
    assert cfg.deadline_s == 300.0 and cfg.step_stall_factor == 8.0
    assert cfg.max_dumps == 3 and cfg.out_dir == "."
    cfg = WatchdogConfig.from_env(
        {"CHAINERMN_TPU_WATCHDOG_DEADLINE": "100"}, deadline_s=7.0)
    assert cfg.deadline_s == 7.0
    cfg = WatchdogConfig.from_env(
        {}, deadline_s=12.0, heartbeat_interval_s=0.5, out_dir="x")
    assert WatchdogConfig.from_env(cfg.to_env()) == cfg
    with pytest.raises(ValueError, match="non-positive"):
        WatchdogConfig.from_env({"CHAINERMN_TPU_WATCHDOG_DEADLINE": "0"})


def test_flight_tag_is_jax_s():
    from chainermn_tpu.observability.watchdog import FLIGHT_TAG as JTAG
    assert FLIGHT_TAG == JTAG == (1 << 28) + 7


# ---- disabled contract ------------------------------------------------------

def test_disabled_starts_nothing(tmp_path):
    assert not pobs.enabled() and get_flight_recorder() is None
    assert start_watchdog(out_dir=str(tmp_path)) is None
    assert install_crash_dumps(out_dir=str(tmp_path)) is None
    assert watchdog_thread_count() == 0
    assert os.listdir(tmp_path) == []


def test_disabled_trainer_run_records_nothing(tmp_path, monkeypatch):
    """Switch off: a trainer run with ``MetricsReport(watchdog=True)``
    makes no flight-recorder call and starts no thread."""
    import torch
    from chainermn_tpu_torch import create_communicator
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.training import (StandardUpdater, Trainer,
                                              extensions)

    def boom(*a, **k):
        raise AssertionError("flight recorder touched while disabled")

    for name in ("record", "span_begin", "record_step", "record_phase"):
        monkeypatch.setattr(FlightRecorder, name, boom)
    monkeypatch.setenv("CHAINERMN_TPU_WATCHDOG", "1")
    comm = create_communicator("naive", device="cpu")
    data = [(torch.full((4,), float(i)), 0) for i in range(32)]
    it = SerialIterator(data, batch_size=16, shuffle=False)
    trainer = Trainer(StandardUpdater(it, lambda b: b[0].sum(), comm),
                      (4, "iteration"), out=str(tmp_path))
    trainer.extend(extensions.MetricsReport(watchdog=True))
    trainer.run()
    assert trainer.updater.iteration == 4
    assert watchdog_thread_count() == 0
    assert not [f for f in os.listdir(tmp_path) if f.startswith("flight_")]


# ---- single-process watchdog ------------------------------------------------

def test_stalled_collective_dumps_within_deadline(tmp_path):
    rec = FlightRecorder(capacity=64)
    cfg = WatchdogConfig(deadline_s=0.2, poll_interval_s=0.05,
                         out_dir=str(tmp_path))
    wd = Watchdog(rec, cfg).start()
    try:
        rec.collective_begin("allreduce", comm="world", nbytes=1024)
        assert _wait_for(lambda: wd.dump_paths), \
            "watchdog never fired on a stalled collective"
        doc = json.load(open(wd.dump_paths[0]))
        assert doc["kind"] == "flight_dump"
        assert doc["reason"].startswith("collective_timeout:allreduce")
        assert doc["collective_state"]["open"][0]["op"] == "allreduce"
        assert doc["threads"], "dump must carry thread stacks"
        assert doc["watchdog"]["deadline_s"] == 0.2
        assert doc["exchange"] == "local-only" and doc["world_size"] == 1
    finally:
        wd.stop()
    assert watchdog_thread_count() == 0


def test_step_stall_fires_after_quiet_period(tmp_path):
    rec = FlightRecorder(capacity=64)
    for i in range(6):  # the predicate needs >= 5 completed steps
        rec.record_step(0.001, iteration=i)
    cfg = WatchdogConfig(deadline_s=60.0, poll_interval_s=0.05,
                         step_stall_factor=2.0, out_dir=str(tmp_path))
    wd = Watchdog(rec, cfg).start()
    try:
        assert _wait_for(lambda: wd.dump_paths)
        assert json.load(open(wd.dump_paths[0]))["reason"].startswith(
            "step_stall")
    finally:
        wd.stop()


def test_no_step_stall_before_five_steps(tmp_path):
    rec = FlightRecorder(capacity=64)
    for i in range(4):
        rec.record_step(0.001, iteration=i)
    cfg = WatchdogConfig(deadline_s=60.0, poll_interval_s=0.02,
                         step_stall_factor=2.0, out_dir=str(tmp_path))
    wd = Watchdog(rec, cfg).start()
    time.sleep(0.3)
    wd.stop()
    assert wd.dump_paths == []


def test_max_dumps_bounds_artifacts(tmp_path):
    rec = FlightRecorder(capacity=16)
    cfg = WatchdogConfig(deadline_s=60.0, poll_interval_s=10.0,
                         max_dumps=1, out_dir=str(tmp_path))
    wd = Watchdog(rec, cfg)  # not started: dump_now drives it
    assert wd.dump_now("first") is not None
    assert wd.dump_now("second") is None
    assert len(wd.dump_paths) == 1
    wd.stop()


def test_start_watchdog_force_and_stop(tmp_path):
    wd = start_watchdog(force=True, out_dir=str(tmp_path), rank=3,
                        deadline_s=30.0, poll_interval_s=0.05)
    assert wd is not None and wd.rank == 3
    assert watchdog_thread_count() >= 1
    assert wd._cfg.out_dir == str(tmp_path)
    wd.stop()
    assert _wait_for(lambda: watchdog_thread_count() == 0)


# ---- two ranks over real sockets --------------------------------------------

CFG = dict(deadline_s=0.4, poll_interval_s=0.05, collect_window_s=2.0,
           heartbeat_interval_s=0.2, heartbeat_timeout_s=30.0)


def _desync_world(M, planes, out_dir):
    """JAX's scenario: both ranks complete allreduce 1..2, rank 0 opens
    seq 3 and stalls, rank 1 never joins.  ``M`` is a package's
    observability; the dumps of both ranks."""
    recs = [M.FlightRecorder(capacity=64) for _ in range(2)]
    for rec in recs:
        for _ in range(2):
            rec.collective_end(rec.collective_begin("allreduce",
                                                    comm="world"))
    cfg = M.WatchdogConfig(out_dir=out_dir, **CFG)
    wds = [M.Watchdog(recs[i], cfg, control_plane=planes[i], rank=i
                      ).start() for i in range(2)]
    try:
        recs[0].collective_begin("allreduce", comm="world")
        assert _wait_for(lambda: wds[0].dump_paths and wds[1].dump_paths,
                         timeout=15.0), (wds[0].dump_paths,
                                         wds[1].dump_paths)
    finally:
        for wd in wds:
            wd.stop()
    return [json.load(open(os.path.join(out_dir, f"flight_{r}.json")))
            for r in (0, 1)]


def _jax_world(out_dir):
    from chainermn_tpu.runtime.control_plane import SocketControlPlane
    from chainermn_tpu.runtime.transport import PyTransport
    from torch_obs_links import _free_port
    coord = f"127.0.0.1:{_free_port()}"
    tps = [None, None]

    def boot(i):
        tps[i] = PyTransport(i, 2, coord)

    ts = [threading.Thread(target=boot, args=(i,)) for i in range(2)]
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    planes = [SocketControlPlane(i, 2, "unused", transport=tps[i])
              for i in range(2)]
    try:
        return _desync_world(jobs, planes, out_dir)
    finally:
        for tp in tps:
            tp.close()


def _summary(d0, d1):
    (stall,) = d0["analysis"]["stalled_collectives"]
    return {"reasons": (d0["reason"].split(" ")[0],
                        d1["reason"].split(" ")[0]),
            "desynced": d0["analysis"]["desynced_ranks"],
            "stall": (stall["op"], stall["seq"], stall["positions"]),
            "one_incident": d0["incident"] == d1["incident"],
            "from_dumps": identify_desync(
                {d["rank"]: d["collective_state"] for d in (d0, d1)}
            )["desynced_ranks"]}


@pytest.mark.parametrize("backend", ["python", "native"])
def test_cross_rank_dump_names_the_desynced_rank_as_jax(tmp_path, backend):
    """Two ranks over real sockets: rank 0's watchdog broadcasts on the
    flight tag, collects rank 1's state and dumps an analysis naming rank
    1; rank 1 dumps too (``peer_stall``).  The same summary as JAX's
    world of the same scenario."""
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _summary(*_jax_world(str(tmp_path / "j")))
    planes = socket_world(2, backend)
    try:
        d0, d1 = _desync_world(pobs, planes, str(tmp_path / "p"))
    finally:
        for p in planes:
            p.shutdown()
    got = _summary(d0, d1)
    assert got == want
    assert got["desynced"] == [1] and got["one_incident"]
    assert got["stall"] == ("allreduce", 3, {"0": 3, "1": 2})
    assert got["reasons"] == ("collective_timeout:allreduce",
                              "peer_stall:rank0")
    assert d0["exchange"] == d1["exchange"] == "peers"
    assert d0["world_size"] == 2


def test_listen_threads_share_the_transport_with_the_main_thread():
    """The listen threads' timed recvs on the flight tag run beside the
    main thread's object ops on other tags of the same transport."""
    planes = socket_world(2, "native")
    cfg = WatchdogConfig(deadline_s=60.0, poll_interval_s=0.02,
                         heartbeat_interval_s=0.05,
                         heartbeat_timeout_s=30.0)
    wds = [Watchdog(FlightRecorder(capacity=16), cfg,
                    control_plane=planes[i], rank=i).start()
           for i in range(2)]
    try:
        from torch_obs_links import on_ranks
        for k in range(20):
            got = on_ranks(lambda r: planes[r].allgather_obj((r, k)), 2)
            assert got == [[(0, k), (1, k)]] * 2
        assert _wait_for(lambda: all(wd._hb_seen for wd in wds))
        offsets = on_ranks(lambda r: wds[r].clock_sync(rounds=2,
                                                       window_s=0.5), 2)
        assert set(offsets[0]) == {1} and set(offsets[1]) == {0}
    finally:
        for wd in wds:
            wd.stop()
        for p in planes:
            p.shutdown()
    assert all(wd.dump_paths == [] for wd in wds)


def test_gloo_wait_dumps_from_the_watchdog_thread(tmp_path):
    """Rank 0 waits in a gloo ``allgather_obj`` the last rank joins 1.5 s
    late: rank 0's watchdog dumps while its main thread is in the call,
    local-only; the op then completes."""
    outs = torch_dist_worker.launch(
        "obs", {"parts": "wdgloo", "late": 1.5, "out": str(tmp_path)}, 2,
        tmp_path)
    for o in outs:
        assert list(o["wdgloo/got"]) == [0, 1]
        assert int(o["wdgloo/threads"]) == 0
    paths = json.loads(str(outs[0]["wdgloo/dumps"]))
    # one incident a poll while the span stays open, up to max_dumps (3),
    # each rewriting rank 0's file (JAX's watchdog)
    assert set(paths) == {os.path.join(str(tmp_path), "flight_0.json")}
    assert 1 <= len(paths) <= 3
    doc = json.load(open(paths[0]))
    assert doc["reason"].startswith("collective_timeout:allgather_obj")
    assert doc["exchange"] == "local-only"
    main = [t for t in doc["threads"] if t["thread"] == "MainThread"]
    assert main and "allgather_obj" in json.dumps(main[0])


# ---- crash dumps ------------------------------------------------------------

def _crash(install, mod, tmp, how):
    rec = mod.FlightRecorder(capacity=4)
    for i in range(9):  # overflow the ring: 5 events dropped
        rec.record("noise", i=i)
    if how == "exception":
        old_hook = sys.excepthook
        sys.excepthook = lambda *a: None  # keep pytest's hook quiet
        try:
            uninstall = install(out_dir=tmp, rank=3, recorder=rec,
                                force=True)
            sys.excepthook(ValueError, ValueError("boom"), None)
            uninstall()
        finally:
            sys.excepthook = old_hook
    else:
        old = signal.signal(signal.SIGTERM, lambda *a: None)
        try:
            uninstall = install(out_dir=tmp, rank=3, recorder=rec,
                                force=True, signals=[signal.SIGTERM])
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            uninstall()
        finally:
            signal.signal(signal.SIGTERM, old)
    with open(os.path.join(tmp, "flight_3.json")) as f:
        doc = json.load(f)
    assert os.path.exists(os.path.join(tmp, "flight_3.stacks.txt"))
    return doc


@pytest.mark.parametrize("how", ["exception", "signal"])
def test_crash_dump_equals_jax(tmp_path, how):
    from chainermn_tpu.runtime.bootstrap import \
        install_crash_dumps as jinstall
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _crash(jinstall, jobs, str(tmp_path / "j"), how)
    got = _crash(install_crash_dumps, pobs, str(tmp_path / "p"), how)
    keep = ("kind", "schema", "rank", "reason", "dropped_events",
            "ring_capacity", "evidence_truncated", "crash_dump")
    assert {k: got.get(k) for k in keep} == {k: want.get(k) for k in keep}
    assert got["ring_capacity"] == 4 and got["dropped_events"] == 5
    assert got["reason"].startswith(
        "unhandled_exception:ValueError" if how == "exception"
        else "signal:SIGTERM")
    assert [e["i"] for e in got["events"]] == [e["i"]
                                               for e in want["events"]]


def test_crash_dump_rank_and_dir_from_the_environment(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("CHAINERMN_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setenv("CHAINERMN_TPU_PROCESS_ID", "2")
    rec = FlightRecorder(capacity=8)
    for env, want in (({}, 2), ({"RANK": "5"}, 5)):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        old_hook = sys.excepthook
        sys.excepthook = lambda *a: None
        try:
            uninstall = install_crash_dumps(recorder=rec, force=True,
                                            signals=[])
            sys.excepthook(KeyError, KeyError("k"), None)
            uninstall()
        finally:
            sys.excepthook = old_hook
        assert os.path.exists(tmp_path / f"flight_{want}.json")
