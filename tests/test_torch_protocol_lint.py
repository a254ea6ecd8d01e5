"""The port's control-plane protocol lint against the JAX package's.

``chainermn_tpu_torch.analysis.protocol`` is JAX's AST extractor with the
port's registry and default tree:

* extracted over the JAX tree it gives JAX's ``extract_protocol()``
  model, JSON for JSON (``root`` aside);
* each broken fixture under ``tests/data/protocol_fixtures/`` gives JAX's
  rule IDs and details;
* the port's own tree is clean: zero findings, zero skips;
* replay of recorded object-plane sequences (the port's instrumented
  communicator and flight recorder, the committed flight dumps, an
  elastic restart manifest) against the port's model.

Two findings the lint made on the port's tree are pinned here: the
extractor now reads an early-exit rank guard (``if rank == 0: ...;
return``) as an ``if``/``else`` (JAX's extractor did not, and flagged the
serving bench's lead/follow protocol), and the serving bench's section
end is broadcast under the same rank guard its followers receive under
(before, a rank-guarded ``bcast_obj`` in ``_release`` had its only
counterpart in another function).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from chainermn_tpu.analysis import lint_step as jlint
from chainermn_tpu.analysis.protocol import extract_protocol as jextract
from chainermn_tpu_torch.analysis import (
    ProtocolModel, extract_protocol, lint_step, load_events_by_rank,
    replay_flight)
from chainermn_tpu_torch.runtime.control_plane import (
    BARRIER_TAG, RESERVED_TAG_BANDS, TELEMETRY_TAG, band_of, reserved_tag)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "protocol_fixtures")
JAX_TREE = os.path.join(REPO, "chainermn_tpu")
PROTOCOL_RULES = ["tag-band-collision", "lockstep-divergence",
                  "unmatched-send-recv", "wrapper-surface-drift"]


def _lint(root, rules, **kw):
    return lint_step(None, protocol_root=root, rules=rules,
                     raise_on_error=False, name="protocol-test", **kw)


@pytest.fixture(scope="module")
def tree_model():
    """The protocol model of the port's package, extracted once."""
    return extract_protocol()


@pytest.fixture(scope="module")
def jax_model():
    """JAX's model of its own package, extracted once."""
    return jextract()


# ---------------------------------------------------------------------------
# the registry and the model
# ---------------------------------------------------------------------------

def test_registry_equals_jax_s():
    from chainermn_tpu.runtime import control_plane as J
    assert [b.as_dict() for b in RESERVED_TAG_BANDS.values()] == \
        [b.as_dict() for b in J.RESERVED_TAG_BANDS.values()]
    for name, band in RESERVED_TAG_BANDS.items():
        assert reserved_tag(name) == band.base
        assert band_of(band.stop - 1).name == name
    assert TELEMETRY_TAG == 770 and BARRIER_TAG == 900


def test_module_constants_ride_the_registry():
    from chainermn_tpu_torch.functions.point_to_point_communication import (
        _META_TAG)
    from chainermn_tpu_torch.observability.watchdog import FLIGHT_TAG
    assert FLIGHT_TAG == reserved_tag("flight") == (1 << 28) + 7
    assert _META_TAG == reserved_tag("p2p_meta") == 1 << 21


def test_model_of_the_jax_tree_equals_jax_s(jax_model):
    got = extract_protocol(JAX_TREE).to_json()
    want = jax_model.to_json()
    got.pop("root")
    want.pop("root")
    assert got == want


def test_port_tree_extracts(tree_model):
    assert tree_model.errors == []
    assert len(tree_model.sites) > 20
    subsystems = {s.subsystem for s in tree_model.sites}
    assert {"runtime", "observability", "communicators"} <= subsystems
    assert any(s.raw for s in tree_model.sites)          # transport
    assert any(s.collective for s in tree_model.sites)
    tele = [s for s in tree_model.sites if s.op == "gather_telemetry"]
    assert tele and all(s.tag == {"kind": "const", "value": TELEMETRY_TAG,
                                  "provenance": "named",
                                  "source": "TELEMETRY_TAG"} for s in tele)
    flight = [s for s in tree_model.sites if s.raw
              and s.tag.get("value") == reserved_tag("flight")]
    assert {"send", "recv"} <= {s.op for s in flight}
    fwd = [c for c in tree_model.class_ops
           if c.cls == "InstrumentedCommunicator" and c.forwards_to]
    assert {"bcast_obj", "gather_obj", "allgather_obj", "scatter_obj",
            "allreduce_obj", "barrier"} <= {c.op for c in fwd}
    doc = tree_model.to_json()
    assert doc["schema"] == "protocol_model/v1"
    assert ProtocolModel.from_json(doc).to_json() == doc


def test_object_op_signatures_match_the_extractor():
    """``_TAG_ARG`` / ``_ROOT_ARG`` are the port's signatures: the tag and
    root sit at those positions of every implementation."""
    import inspect
    from chainermn_tpu_torch.analysis.protocol import _ROOT_ARG, _TAG_ARG
    from chainermn_tpu_torch.communicators.mesh_communicator_base import (
        MeshCommunicator)
    from chainermn_tpu_torch.observability.instrument import (
        InstrumentedCommunicator)
    from chainermn_tpu_torch.runtime.control_plane import ControlPlane
    for cls in (MeshCommunicator, ControlPlane, InstrumentedCommunicator):
        for op, (idx, default) in _TAG_ARG.items():
            fn = getattr(cls, op, None)
            if fn is None:
                continue
            params = list(inspect.signature(fn).parameters)[1:]
            if idx is not None:
                assert params[idx] == "tag", (cls, op, params)
                assert inspect.signature(fn).parameters["tag"].default \
                    == default, (cls, op)
            root = _ROOT_ARG[op]
            if root is not None:
                assert params[root] == "root", (cls, op, params)


# ---------------------------------------------------------------------------
# the fixtures: JAX's findings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture,rule", [
    ("lockstep", "lockstep-divergence"),
    ("unmatched", "unmatched-send-recv"),
    ("tag_collision", "tag-band-collision"),
    ("wrapper_drift", "wrapper-surface-drift"),
])
def test_fixture_findings_equal_jax(fixture, rule):
    root = os.path.join(FIXTURES, fixture)
    got = _lint(root, [rule])
    want = jlint(None, protocol_root=root, rules=[rule], hlo=False,
                 raise_on_error=False, name="protocol-test")
    assert not got.ok and got.findings
    assert [(f.rule, f.severity, f.message, f.details)
            for f in got.findings] == \
        [(f.rule, f.severity, f.message, f.details) for f in want.findings]


def test_lockstep_fixture_names_both_shapes():
    msgs = [f.message for f in _lint(os.path.join(FIXTURES, "lockstep"),
                                     ["lockstep-divergence"]).findings]
    assert len(msgs) == 2
    assert any("rank guard" in m and "bcast_obj" in m for m in msgs)
    assert any("except path" in m and "barrier" in m for m in msgs)


def test_unmatched_and_wrapper_fixture_details():
    rep = _lint(os.path.join(FIXTURES, "unmatched"), ["unmatched-send-recv"])
    assert {(f.details["site"]["op"], f.details["site"]["tag"]["value"])
            for f in rep.findings} == {("send_obj", 7), ("recv_obj", 9)}
    rep = _lint(os.path.join(FIXTURES, "wrapper_drift"),
                ["wrapper-surface-drift"])
    assert {(f.details["op"], tuple(f.details["dropped"]))
            for f in rep.findings} == {(op, ("tag",)) for op in (
                "bcast_obj", "gather_obj", "allgather_obj", "scatter_obj",
                "allreduce_obj", "barrier")}


def test_the_port_tree_is_clean(tree_model):
    rep = _lint(tree_model, PROTOCOL_RULES)
    assert rep.ok and rep.findings == [] and rep.skipped == {}
    assert _lint(tree_model.to_json(), PROTOCOL_RULES).findings == []
    assert _lint(True, PROTOCOL_RULES).findings == []


def test_rules_skip_without_model():
    rep = lint_step(None, rules=["tag-band-collision"],
                    raise_on_error=False, name="no-model")
    assert "protocol_root" in rep.skipped["tag-band-collision"]


# ---------------------------------------------------------------------------
# the two findings on the port's tree
# ---------------------------------------------------------------------------

EARLY_EXIT = textwrap.dedent('''
    def lead(comm, engines):
        if comm.rank == 0:
            for i in range(len(engines)):
                comm.bcast_obj(i, root=0)
            return True
        while True:
            i = comm.bcast_obj(None, root=0)
            if i is None:
                return False
''')

OLD_RELEASE = textwrap.dedent('''
    def lead(comm, engines):
        if comm.rank == 0:
            comm.bcast_obj(0, root=0)
            return True
        while True:
            if comm.bcast_obj(None, root=0) is None:
                return False


    def release(comm):
        if comm is not None and comm.rank == 0:
            comm.bcast_obj(None, root=0)
''')


def _tree(tmp_path, name, src):
    d = tmp_path / name / "bench"
    d.mkdir(parents=True)
    (d / "serving.py").write_text(src)
    return str(tmp_path / name)


def test_early_exit_rank_guard_is_an_else(tmp_path):
    """The extractor gap: the statements after ``if rank == 0: ...;
    return`` are the other ranks' path.  JAX's extractor flags the root's
    broadcast as unmatched; the port's reads the follower loop as its
    complement."""
    root = _tree(tmp_path, "early", EARLY_EXIT)
    assert not jlint(None, protocol_root=root, hlo=False,
                     rules=["lockstep-divergence"],
                     raise_on_error=False).ok
    assert _lint(root, ["lockstep-divergence"]).findings == []
    branches = sorted(s.rank_guards[-1]["branch"]
                      for s in extract_protocol(root).sites)
    assert branches == ["body", "orelse"]


def test_a_release_apart_from_its_followers_is_a_finding(tmp_path):
    """The port fault: the serving bench's section end broadcast sat
    under a rank guard in a function of its own, its receive in another.
    That shape is flagged; the bench now keeps both under one guard."""
    root = _tree(tmp_path, "old", OLD_RELEASE)
    rep = _lint(root, ["lockstep-divergence"])
    f = [x for x in rep.findings if x.rule == "lockstep-divergence"]
    assert len(f) == 1 and "release" in f[0].details["site"]["qualname"]
    bench = [s for s in extract_protocol().sites
             if s.file.endswith("bench_serving.py")]
    assert {s.qualname for s in bench} == {"_lead", "_lead.announced"}


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _obj_events(ops, open_ops=()):
    seq: dict = {}
    evs = []
    for op in ops:
        seq[op] = seq.get(op, 0) + 1
        evs.append({"kind": "object_begin", "op": op, "op_seq": seq[op]})
        evs.append({"kind": "object_end", "op": op, "op_seq": seq[op]})
    for op in open_ops:
        seq[op] = seq.get(op, 0) + 1
        evs.append({"kind": "object_begin", "op": op, "op_seq": seq[op]})
    return evs


HEALTHY = ["bcast_obj", "allgather_obj", "barrier"]


@pytest.mark.parametrize("case", ["healthy", "divergent", "short",
                                  "straggler", "unknown"])
def test_replay_equals_jax(case, tree_model, jax_model):
    from chainermn_tpu.analysis.protocol import replay_flight as jreplay
    events = {
        "healthy": {0: _obj_events(HEALTHY), 1: _obj_events(HEALTHY)},
        "divergent": {0: _obj_events(HEALTHY),
                      1: _obj_events(["bcast_obj", "gather_obj",
                                      "barrier"])},
        "short": {0: _obj_events(HEALTHY), 1: _obj_events(HEALTHY[:1])},
        "straggler": {0: _obj_events(HEALTHY[:1], open_ops=["barrier"]),
                      1: _obj_events(HEALTHY)},
        "unknown": {0: _obj_events(["warp_obj"]),
                    1: _obj_events(["warp_obj"])},
    }[case]
    got = replay_flight(tree_model, events)
    want = jreplay(jax_model, events)
    strip = ("suspect_sites",)
    assert [{k: v for k, v in f.items() if k not in strip} for f in got] \
        == [{k: v for k, v in f.items() if k not in strip} for f in want]
    if case == "unknown":
        rep = _lint(tree_model, ["protocol-replay-desync"],
                    flight_events=events)
        assert rep.ok and [f.severity for f in rep.findings] == \
            ["info", "info"]


def test_load_events_normalizes_dump_shapes():
    evs = _obj_events(["barrier"])
    assert load_events_by_rank({0: evs, 1: evs}) == {0: evs, 1: evs}
    assert load_events_by_rank({"rank": 3, "events": evs}) == {3: evs}
    assert load_events_by_rank({0: {"rank": 0, "events": evs}}) == {0: evs}
    assert load_events_by_rank(evs) == {0: evs}


def test_recorded_instrumented_run_replays_clean(tree_model):
    """Record a healthy object-plane program through the port's
    instrumented wrapper and flight recorder, then replay it (both ranks
    ran the same program) against the port's model."""
    from chainermn_tpu_torch.observability import flight_recorder as fl
    from chainermn_tpu_torch.observability.instrument import (
        InstrumentedCommunicator)
    from chainermn_tpu_torch.observability.registry import MetricsRegistry
    from chainermn_tpu_torch.runtime.control_plane import (
        ControlPlane, SingleProcessControlPlane)
    rec = fl.FlightRecorder(capacity=256)
    fl.install_flight_recorder(rec)
    try:
        icomm = InstrumentedCommunicator(SingleProcessControlPlane(),
                                         registry=MetricsRegistry())
        assert icomm.allgather_obj({"r": 0}) == [{"r": 0}]
        assert ControlPlane.gather_telemetry(
            icomm, {"loss": 1.0}) == [{"loss": 1.0}]
        icomm.barrier()
        events = [e for e in rec.snapshot()
                  if e["kind"].startswith("object_")]
    finally:
        fl.reset_flight_recorder()
    assert events
    rep = _lint(tree_model, ["protocol-replay-desync"],
                flight_events={0: events, 1: list(events)})
    assert rep.ok and rep.findings == []


def test_committed_dumps_and_a_restart_manifest_replay(tree_model,
                                                        tmp_path):
    """The committed flight dumps (collective spans, no object ops) and
    an elastic restart manifest embedding them replay without a
    violation; the manifest's shape loads as ``{rank: events}``."""
    from chainermn_tpu_torch.elastic.manifest import build_restart_manifest
    dumps = {}
    for r in (0, 1):
        with open(os.path.join(REPO, "tests", "data",
                               f"flight_{r}.json")) as fh:
            dumps[r] = json.load(fh)
        with open(tmp_path / f"flight_{r}.json", "w") as fh:
            json.dump(dumps[r], fh)
    man = build_restart_manifest(1, "test", str(tmp_path), {0: 1, 1: -9},
                                 None, 1, 2, 2)
    by_rank = load_events_by_rank(man["flight_dumps"])
    assert sorted(by_rank) == [0, 1]
    assert by_rank[0] == dumps[0]["events"]
    assert replay_flight(tree_model, by_rank) == []


# ---------------------------------------------------------------------------
# the CLI's protocol lane
# ---------------------------------------------------------------------------

def _run_cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.cmn_lint", *argv],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_protocol_sweep_clean_and_artifact(tmp_path):
    out = tmp_path / "PROTOCOL_LINT_test.json"
    r = _run_cli("--protocol", "--json", "--out", str(out))
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout)
    assert doc["ok"] is True and doc["findings"] == []
    assert doc["schema"] == "protocol_lint/v1" and doc["suite"] == "cmn_lint"
    assert doc["protocol"]["n_sites"] > 20
    assert doc["protocol"]["parse_errors"] == []
    assert {b["name"] for b in doc["protocol"]["bands"]} == \
        set(RESERVED_TAG_BANDS)
    from chainermn_tpu_torch.observability.ledger import classify_artifact
    cls = classify_artifact(json.loads(out.read_text()), str(out))
    assert cls["schema"] == "protocol_lint/v1" and cls["legacy"] is False


def test_protocol_exit_code_on_broken_tree():
    r = _run_cli("--protocol", "--protocol-root",
                 os.path.join(FIXTURES, "lockstep"))
    assert r.returncode == 1, r.stdout
    assert "lockstep-divergence" in r.stdout
