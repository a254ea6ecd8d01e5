"""``MetricsReport`` and ``train_mnist --observability`` against the JAX
package's, on the CPU.

* Driven by one fake trainer, the port's ``MetricsReport`` writes the
  records JAX's writes: the same kinds, each with JAX's keys.
* ``train_mnist --observability --device cpu`` on a world of one and on a
  2-process gloo world: ``metrics.jsonl`` (rank 0) holds those records,
  the ``comm_collective_*`` metrics of ``allreduce_grad`` on the float16
  wire and the step telemetry; the parameters are bit-equal to the run
  without observability, and the cast kernel (its plain version on the
  CPU) runs as often, 2 x iterations.
* The default control plane under a ``torch.distributed`` world of two is
  a socket world, and a communicator on it answers the object ops as the
  gloo plane does.
* ``watchdog=`` (and ``CHAINERMN_TPU_WATCHDOG``), ``online_tune=`` and
  ``stream_telemetry=`` build their parts while observability is on, and
  nothing while it is off; ``finalize`` stops the watchdog.
"""

import json

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
import torch_dist_worker
from chainermn_tpu_torch import observability as pobs

ARGV = ("--device cpu --epoch 1 --unit 32 --batchsize 50 --prefetch 0 "
        "--communicator xla --allreduce-grad-dtype float16 "
        "--double-buffering")


@pytest.fixture(autouse=True)
def _observability_off():
    yield
    from chainermn_tpu import observability as jobs
    for obs in (pobs, jobs):
        obs.disable()
        obs.reset_flight_recorder()
        obs.get_registry().reset()


class _Iter:
    def __init__(self):
        self.epoch, self.is_new_epoch = 0, False


class _Updater:
    def __init__(self, comm):
        self.comm, self.iteration, self.telemetry = comm, 0, None
        self._it = _Iter()

    @property
    def epoch(self):
        return self._it.epoch

    @property
    def is_new_epoch(self):
        return self._it.is_new_epoch


class _Trainer:
    def __init__(self, out, comm):
        self.out, self.elapsed_time = out, 0.0
        self.updater = _Updater(comm)


class _Comm:
    rank, size, host_size = 0, 1, 1


def _drive(ext, out, obs):
    """Three steps and an epoch end through ``ext``; the records by kind
    with their keys."""
    obs.enable()
    obs.install_flight_recorder()
    tr = _Trainer(str(out), _Comm())
    ext.initialize(tr)
    fr = obs.get_flight_recorder()
    for i in range(3):
        tr.updater.iteration = i + 1
        tr.updater._it.is_new_epoch = i == 2
        tr.updater._it.epoch = 1 if i == 2 else 0
        fr.record_phase("dispatch", i)
        tr.updater.telemetry.record_step(0.001, 0.0005, 0.002, 0.003, 8)
        fr.record_step(0.0065, iteration=i + 1)
        ext(tr)
    ext.finalize(tr)
    recs = obs.read_jsonl(str(out / "metrics.jsonl"))
    return {r.get("kind"): set(r) for r in recs}, [r.get("kind")
                                                    for r in recs]


def test_metrics_report_records_are_jax_s(tmp_path):
    from chainermn_tpu import observability as jobs
    from chainermn_tpu.training.extensions import MetricsReport as JReport
    from chainermn_tpu_torch.training.extensions import MetricsReport
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jkeys, jkinds = _drive(JReport(), tmp_path / "j", jobs)
    pkeys, pkinds = _drive(MetricsReport(), tmp_path / "p", pobs)
    assert pkinds == jkinds
    assert pkeys == jkeys
    assert {"step_report", "metric", "straggler_report",
            "step_attribution"} <= set(pkeys)


class _PlanComm(_Comm):
    def plan_topology(self):
        from chainermn_tpu_torch.planner import PlanTopology
        return PlanTopology.from_key("intra:1")


@pytest.mark.parametrize("kw", [dict(watchdog=True), dict(online_tune=True),
                                dict(stream_telemetry=True)])
def test_a13b_options_raise(kw, tmp_path):
    """Each option builds its part (the watchdog's threads, the online
    tuner on the flight recorder and the registry, the telemetry
    aggregator) with observability on, none with it off; ``finalize``
    stops the watchdog, which leaves no dump on a healthy run."""
    from chainermn_tpu_torch.training.extensions import MetricsReport
    attr = {"watchdog": "_watchdog", "online_tune": "_tuner",
            "stream_telemetry": "_stream"}[next(iter(kw))]
    pobs.disable()
    ext = MetricsReport(**kw)
    ext.initialize(_Trainer(str(tmp_path), _PlanComm()))
    assert getattr(ext, attr) is None
    assert pobs.watchdog_thread_count() == 0
    pobs.enable()
    pobs.install_flight_recorder()
    ext = MetricsReport(**kw)
    tr = _Trainer(str(tmp_path), _PlanComm())
    ext.initialize(tr)
    part = getattr(ext, attr)
    assert part is not None
    if attr == "_watchdog":
        assert pobs.watchdog_thread_count() >= 1 and part.rank == 0
    if attr == "_tuner":
        assert part._flight is pobs.get_flight_recorder()
        assert part._reg is pobs.get_registry()
    ext.finalize(tr)
    assert pobs.watchdog_thread_count() == 0
    assert not [f for f in (tmp_path).iterdir()
                if f.name.startswith("flight_")]


def test_watchdog_env_raises_only_when_set(tmp_path, monkeypatch):
    """``CHAINERMN_TPU_WATCHDOG`` starts the watchdog when ``watchdog=``
    is left at None (its dumps beside the metrics file), ``watchdog=False``
    overrides it, and the extension is inert while observability is
    off."""
    from chainermn_tpu_torch.training.extensions import MetricsReport
    monkeypatch.delenv("CHAINERMN_TPU_WATCHDOG", raising=False)
    pobs.enable()
    ext = MetricsReport()
    tr = _Trainer(str(tmp_path), _Comm())
    ext.initialize(tr)
    assert ext._watchdog is None and pobs.watchdog_thread_count() == 0
    monkeypatch.setenv("CHAINERMN_TPU_WATCHDOG", "1")
    ext = MetricsReport()
    ext.initialize(tr)
    assert ext._watchdog is not None
    assert ext._watchdog._cfg.out_dir == str(tmp_path)
    assert pobs.watchdog_thread_count() >= 1
    ext.finalize(tr)
    assert ext._watchdog is None and pobs.watchdog_thread_count() == 0
    ext = MetricsReport(watchdog=False)
    ext.initialize(tr)
    assert ext._watchdog is None
    # inert while observability is off
    pobs.disable()
    ext = MetricsReport()
    tr = _Trainer(str(tmp_path / "off"), _Comm())
    ext.initialize(tr)
    ext(tr)
    assert tr.updater.telemetry is None and ext._watchdog is None
    assert pobs.watchdog_thread_count() == 0


def _count_casts(monkeypatch):
    import importlib
    cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
    plain = cs.cast_scale_plain
    calls = [0]

    def counting(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(cs, "cast_scale_plain", counting)
    return calls


def _metric(recs, name, **labels):
    for r in recs:
        if r.get("kind") == "metric" and r["name"] == name and \
                all(r["labels"].get(k) == v for k, v in labels.items()):
            return r
    return None


def _check_metrics_file(path, iters, world):
    recs = pobs.read_jsonl(path)
    kinds = [r.get("kind") for r in recs]
    assert {"step_report", "metric", "straggler_report"} <= set(kinds)
    rep = [r for r in recs if r.get("kind") == "step_report"][-1]
    assert rep["steps"] == iters
    calls = _metric(recs, "comm_collective_calls", op="allreduce_grad")
    by = _metric(recs, "comm_collective_bytes", op="allreduce_grad")
    assert calls["value"] == iters and calls["labels"]["comm"] == \
        "XlaCommunicator"
    assert by["labels"]["dtype"] == "float16" and by["value"] > 0
    for phase in ("data_load", "host_put", "dispatch", "device_block"):
        assert _metric(recs, "step_phase_seconds", phase=phase)["count"] \
            == iters
    strag = [r for r in recs if r.get("kind") == "straggler_report"][-1]
    assert strag["n_ranks"] == world


def test_mnist_observability_world_of_one(tmp_path, monkeypatch):
    from chainermn_tpu_torch.examples import train_mnist
    calls = _count_casts(monkeypatch)
    runs = {}
    for label, extra in (("off", []), ("on", ["--observability"])):
        calls[0] = 0
        try:
            res = train_mnist.main(ARGV.split() + extra + [
                "--out", str(tmp_path / label)])
        finally:
            pobs.disable()
        runs[label] = (res, calls[0])
    (off, c_off), (on, c_on) = runs["off"], runs["on"]
    iters = on["log"][-1]["iteration"]
    assert c_on == c_off == 2 * iters
    for (k, a), b in zip(off["model"].state_dict().items(),
                         on["model"].state_dict().values()):
        assert torch.equal(a, b), k
    assert not (tmp_path / "off" / "metrics.jsonl").exists()
    _check_metrics_file(str(tmp_path / "on" / "metrics.jsonl"), iters, 1)


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    outs = torch_dist_worker.launch(
        "obs", {"parts": np.asarray("mnist,cp"), "argv": np.asarray(ARGV),
                "out": np.asarray(str(tmp))}, 2, tmp, timeout=280)
    return tmp, outs


def test_mnist_observability_gloo_world(gloo_world):
    tmp, outs = gloo_world
    for out in outs:
        iters = int(out["on/iters"])
        assert int(out["on/casts"]) == int(out["off/casts"]) == 2 * iters
        keys = sorted(k for k in out if k.startswith("off/param/"))
        assert keys
        for k in keys:
            on = out["on/param/" + k[len("off/param/"):]]
            assert on.tobytes() == out[k].tobytes(), k
    # the ranks agree, and rank 0 alone wrote the metrics
    for k in (k for k in outs[0] if "/param/" in k):
        assert outs[0][k].tobytes() == outs[1][k].tobytes()
    _check_metrics_file(str(tmp / "on" / "metrics.jsonl"),
                        int(outs[0]["on/iters"]), 2)


def test_default_control_plane_on_a_gloo_world(gloo_world):
    _, outs = gloo_world
    for r, out in enumerate(outs):
        assert str(out["cp/type"]) == "SocketControlPlane"
        assert out["cp/rank_size"].tolist() == [r, 2]
        gloo = json.loads(str(out["cp/gloo"]))
        sock = json.loads(str(out["cp/socket"]))
        assert gloo[-1] == "NoneType" and sock[-1] == "_SplitControlPlane"
        assert sock[:-1] == gloo[:-1]
