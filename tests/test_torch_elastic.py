"""The elastic runtime's checkpoint side: the async backend and the
resharded resume.

* ``create_multi_node_checkpointer(backend="async")``: its files hold the
  bits of the synchronous backend's; a save followed by in-place optimizer
  steps still writes the save's step (the snapshot is a copy, not a view
  of the live tensors); the generation GC runs only after the newer
  generation's publish; a failed write surfaces at the next barrier and
  publishes nothing; a full queue shows as stall.
* ``_resize_stacked`` gives JAX's arrays and report on the same stacked
  buffers.
* ``resume_resized`` on gloo worlds under FSDP (two buckets, Adam):
  shrink 4 -> 2, with and without an int8 error-feedback compressor, and
  grow 2 -> 4.  The consolidated parameters and Adam moments of the
  resumed world (saved again right after the resume) are bit-equal to the
  saved generation's; EF state is re-keyed to zeros with the dropped norm
  reported; the report's counts are JAX's for the same problem (JAX's
  resize of ``tests/test_elastic.py``'s MLP at K 2, Adam), except the
  replicated count: torch's Adam keeps one step count a shard where optax
  keeps one.
"""

import json
import os
import threading
import time
import zipfile

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch.elastic import AsyncCheckpointer, resize
from chainermn_tpu_torch.extensions import checkpoint as ck
from chainermn_tpu_torch.extensions.checkpoint import \
    create_multi_node_checkpointer
from chainermn_tpu_torch.parallel.fsdp import make_fsdp_meta
from chainermn_tpu_torch.utils.proc_world import spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def comm():
    import torch.distributed as dist
    from chainermn_tpu_torch import init_distributed
    own = not dist.is_initialized()
    if own:
        init_distributed(device="cpu")
    yield create_communicator("naive", device="cpu")
    if own:
        dist.destroy_process_group()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(64, 32, generator=g),
            "h": torch.randn(7, generator=g).to(torch.bfloat16),
            "n": np.arange(5, dtype=np.int32) + seed,
            "it": np.int64(seed)}


def _members(path):
    """``{member: bytes}`` of an npz: the arrays' data bit for bit (the
    zip's own timestamps aside)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_async_files_equal_sync_files(comm, tmp_path):
    sync = create_multi_node_checkpointer(comm, str(tmp_path / "s"), "c",
                                          keep=0)
    asy = create_multi_node_checkpointer(comm, str(tmp_path / "a"), "c",
                                         keep=0, backend="async")
    assert isinstance(asy, AsyncCheckpointer)
    for g in range(3):
        sync.save(_state(g), g)
        asy.save(_state(g), g)
    assert asy.drain(timeout=30)
    for g in range(3):
        assert _members(sync._file(g)) == _members(asy._inner._file(g))
    assert asy.latest_consistent_generation() == 2
    asy.finalize()


def _model_state(model, opt):
    from chainermn_tpu_torch.optim import optimizer_state_tree
    return {"model": dict(model.state_dict()),
            "opt": optimizer_state_tree(opt)}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone() if torch.is_tensor(tree) else tree


def test_save_then_step_in_place_writes_the_saved_step(comm, tmp_path,
                                                       monkeypatch):
    """The aliasing test: the persist thread writes after the next steps
    have updated the parameters and Adam's moments in place, and the
    generation still holds the state of the save's step."""
    from chainermn_tpu_torch.optim import init_optimizer_state
    torch.manual_seed(0)
    model = torch.nn.Linear(16, 8)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    x = torch.randn(32, 16)

    def step():
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()

    step()
    asy = create_multi_node_checkpointer(comm, str(tmp_path), "al", keep=0,
                                         backend="async")
    gate = threading.Event()
    real = asy._inner._persist

    def held(arrays, it):
        gate.wait(30)  # the write waits until the live state has moved on
        real(arrays, it)

    monkeypatch.setattr(asy._inner, "_persist", held)
    want = _clone(_model_state(model, opt))
    asy.save(_model_state(model, opt), 1)
    for _ in range(3):
        step()
    moved = _model_state(model, opt)
    assert not torch.equal(moved["model"]["weight"], want["model"]["weight"])
    gate.set()
    assert asy.drain(timeout=30)
    init_optimizer_state(opt)
    restored, gen = asy.resume(_model_state(model, opt))
    assert gen == 1
    for k, v in want["model"].items():
        assert torch.equal(restored["model"][k], v), k
    for i, st in want["opt"].items():
        for k, v in st.items():
            assert torch.equal(restored["opt"][i][k], v), (i, k)
    asy.finalize()


def test_write_barrier_before_gc(comm, tmp_path, monkeypatch):
    asy = create_multi_node_checkpointer(comm, str(tmp_path), "gc", keep=2,
                                         backend="async")
    inner = asy._inner
    log = []
    real_replace, real_gc = os.replace, inner._gc

    def replace(src, dst):
        real_replace(src, dst)
        log.append(("publish", os.path.basename(dst),
                    threading.current_thread().name))

    def gc():
        log.append(("gc", tuple(inner._local_generations()),
                    threading.current_thread().name))
        real_gc()

    monkeypatch.setattr(ck.os, "replace", replace)
    monkeypatch.setattr(inner, "_gc", gc)
    for g in range(5):
        asy.save(_state(g), g)
    assert asy.drain(timeout=30)
    assert inner._local_generations() == [3, 4]
    kinds = [e[0] for e in log]
    assert kinds == ["publish", "gc"] * 5
    for g in range(5):
        pub, gc_ev = log[2 * g], log[2 * g + 1]
        assert pub[1] == f"gc.{g}.rank0.npz"
        # the collection sees the generation it follows already published
        assert g in gc_ev[1]
        assert pub[2] == gc_ev[2] == "chainermn-tpu-async-ckpt"
    asy.finalize()


def test_persist_error_surfaces_and_publishes_nothing(comm, tmp_path,
                                                      monkeypatch):
    asy = create_multi_node_checkpointer(comm, str(tmp_path), "err", keep=0,
                                         backend="async")

    def broken(file, **arrays):
        raise OSError("disk full")

    monkeypatch.setattr(ck.np, "savez", broken)
    asy.save(_state(), 3)
    with pytest.raises(RuntimeError, match="NOT published") as e:
        asy.drain(timeout=30)
    assert "disk full" in repr(e.value.__cause__)
    assert not any(f.endswith(".npz") and ".3.rank0" in f
                   and "tmp" not in f for f in os.listdir(tmp_path))
    asy.save(_state(), 4)
    deadline = time.monotonic() + 30
    while asy._q.unfinished_tasks and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="1 snapshot"):
        asy.save(_state(), 5)   # the next save raises it too
    monkeypatch.undo()
    asy.drain(timeout=30)
    asy.finalize()
    with pytest.raises(RuntimeError, match="after finalize"):
        asy.save(_state(), 6)


def test_full_queue_is_stall_and_recorded(comm, tmp_path, monkeypatch):
    from chainermn_tpu_torch import observability as obs
    inner = ck._MultiNodeCheckpointer(comm, str(tmp_path), "bp", keep=0)
    real = inner._persist

    def slow(arrays, it):
        time.sleep(0.2)
        real(arrays, it)

    monkeypatch.setattr(inner, "_persist", slow)
    obs.enable()
    fr = obs.install_flight_recorder()
    try:
        asy = AsyncCheckpointer(inner, max_pending=1)
        for g in range(3):
            asy.save(_state(g), g)
        assert asy.drain(timeout=30)
        evs = [e for e in fr.snapshot()
               if e.get("op") == "async_ckpt_snapshot"]
    finally:
        obs.disable()
        obs.reset_flight_recorder()
        obs.get_registry().reset()
    assert len(asy.stall_ms) == 3 and asy.last_stall_ms == asy.stall_ms[-1]
    # with one slot, the third save waits for the first write to finish
    assert asy.stall_ms[2] >= 100.0, asy.stall_ms
    assert len(asy.persist_ms) == 3
    assert [e["iteration"] for e in evs] == [0, 1, 2]
    assert [e["async_ckpt_stall_ms"] for e in evs] == asy.stall_ms
    asy.finalize()


# ---- _resize_stacked against JAX's ---------------------------------------------

@pytest.mark.parametrize("old,new,tail", [
    ((4, 5), (2, 10), 0.0), ((2, 10), (4, 5), 0.0), ((4, 6), (2, 11), 0.0),
    ((2, 11), (4, 6), 0.0), ((4, 6), (2, 11), 0.25), ((8, 3), (1, 24), 0.0),
    ((3, 7), (5, 5), 0.5)])
def test_resize_stacked_equals_jax(old, new, tail):
    from chainermn_tpu.elastic import resize as jr
    rng = np.random.RandomState(sum(old) + sum(new))
    saved = rng.randn(*old).astype(np.float32)
    n = min(np.prod(old), np.prod(new))
    flat = saved.reshape(-1)
    flat[n:] = tail  # the old world's pad region
    rj, rp = {}, {}
    out_j = jr._resize_stacked(saved, new, rj)
    out_p = resize._resize_stacked(saved, new, rp)
    assert out_p.dtype == out_j.dtype and out_p.shape == tuple(new)
    assert np.array_equal(out_p, np.asarray(out_j))
    assert rp == rj


# ---- resume_resized on gloo worlds ---------------------------------------------

_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["CHAINERMN_TPU_REPO"])
import numpy as np
import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmn
from chainermn_tpu_torch.elastic import resume_resized
from chainermn_tpu_torch.extensions.checkpoint import \
    create_multi_node_checkpointer
from chainermn_tpu_torch.optim import init_optimizer_state
from chainermn_tpu_torch.parallel.fsdp import fsdp_init, make_fsdp_train_step

torch.set_num_threads(1)
topo = cmn.init_distributed(device="cpu")
comm = cmn.create_communicator("flat", device="cpu")
rng = np.random.RandomState(0)
xs = rng.randn(64, 8).astype(np.float32)
ys = (xs @ rng.randn(8, 4)).astype(np.float32)
out = {}
for run in json.loads(os.environ["RESIZE_RUNS"]):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    state, meta = fsdp_init(comm, model,
                            torch.optim.Adam(model.parameters(), lr=0.01),
                            num_buckets=2, bucket_compressors=run["comp"])
    report, gen = {}, run["gen"]
    if run["load"]:
        init_optimizer_state(state.inner)
        src = create_multi_node_checkpointer(comm, run["load"], "rs", keep=0)
        tree, gen, report = resume_resized(src, {"fsdp": state}, comm)
        assert tree["fsdp"] is state and gen == run["gen"], gen
        # the resumed state as it stands, for the consolidation check
        create_multi_node_checkpointer(comm, run["resumed"], "rs",
                                       keep=0).save({"fsdp": state}, gen)
    n = 16 // comm.size
    x = torch.from_numpy(xs[comm.rank * n:(comm.rank + 1) * n])
    y = torch.from_numpy(ys[comm.rank * n:(comm.rank + 1) * n])
    step = make_fsdp_train_step(comm, lambda b: F.mse_loss(model(b[0]), b[1]),
                                state, meta)
    losses = [float(step((x, y))) for _ in range(run["steps"])]
    if run["save"]:
        create_multi_node_checkpointer(comm, run["save"], "rs", keep=0).save(
            {"fsdp": state}, gen + 1 if run["load"] else gen)
    out[run["name"]] = {"report": report, "losses": losses}
print("RESULT " + json.dumps(out), flush=True)
comm.barrier()
torch.distributed.destroy_process_group()
"""


def _world(n, runs, tmp_path, tag):
    return spawn_world(_WORKER, n_procs=n, device="cpu", timeout=240,
                       log_dir=str(tmp_path / f"logs_{tag}"),
                       env={"RESIZE_RUNS": json.dumps(runs)})[0]


def _orig_lens(world):
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    return [bl.orig_lens[0] for bl in make_fsdp_meta(model, world, 2).buckets]


def _consolidated(path, gen, world):
    """``{leaf: full array}`` of every sharded leaf of a generation: the
    rank files' slices concatenated, the pad stripped (checked zero)."""
    files = [ck._load_file(os.path.join(path, f"rs.{gen}.rank{r}.npz"))
             for r in range(world)]
    lens = _orig_lens(world)
    out = {}
    for k in files[0]:
        if k.startswith("__"):
            continue
        parts = [f[k] for f in files]
        if k.endswith("/step"):
            assert all(np.array_equal(p, parts[0]) for p in parts), k
            out[k] = parts[0]
            continue
        full = np.concatenate(parts)
        i = int(k.split("/")[2])
        n = lens[i]
        if "/comp/" not in k:
            assert not full[n:].any(), k
        out[k] = full[:n] if "/comp/" not in k else full
    return out


@pytest.fixture(scope="module")
def resized(tmp_path_factory):
    d = tmp_path_factory.mktemp("resize")
    p = {k: str(d / k) for k in ("a", "a_res", "c", "c_res", "b", "b_res")}
    _world(4, [{"name": "plain", "comp": None, "load": None, "gen": 5,
                "steps": 2, "save": p["a"]},
               {"name": "int8", "comp": "int8", "load": None, "gen": 5,
                "steps": 2, "save": p["c"]}], d, "w4")
    shrink = _world(2, [
        {"name": "plain", "comp": None, "load": p["a"], "gen": 5,
         "resumed": p["a_res"], "steps": 1, "save": p["b"]},
        {"name": "int8", "comp": "int8", "load": p["c"], "gen": 5,
         "resumed": p["c_res"], "steps": 1, "save": None}], d, "w2")
    grow = _world(4, [{"name": "plain", "comp": None, "load": p["b"],
                       "gen": 6, "resumed": p["b_res"], "steps": 1,
                       "save": None}], d, "w4b")
    return p, shrink, grow


def _assert_consolidated_equal(saved, resumed, rekeyed=False):
    assert set(saved) == set(resumed)
    for k in saved:
        if "/comp/" in k:
            assert rekeyed and not resumed[k].any(), k
            continue
        assert saved[k].dtype == resumed[k].dtype
        assert np.array_equal(saved[k], resumed[k]), k


def test_shrink_4_to_2_is_bit_exact(resized):
    p, shrink, _ = resized
    _assert_consolidated_equal(_consolidated(p["a"], 5, 4),
                               _consolidated(p["a_res"], 5, 2))
    rep = shrink["plain"]["report"]
    assert rep["resized"] and rep["from_world"] == 4 and rep["to_world"] == 2
    assert rep["generation"] == 5


def test_shrink_4_to_2_rekeys_error_feedback(resized):
    p, shrink, _ = resized
    saved = _consolidated(p["c"], 5, 4)
    _assert_consolidated_equal(saved, _consolidated(p["c_res"], 5, 2),
                               rekeyed=True)
    rep = shrink["int8"]["report"]
    # JAX's dropped norm: each EF leaf stacked over the saved world
    files = [ck._load_file(os.path.join(p["c"], f"rs.5.rank{r}.npz"))
             for r in range(4)]
    comp = [k for k in files[0] if "/comp/" in k]
    assert comp
    want = sum(float(np.linalg.norm(np.stack(
        [f[k] for f in files]).astype(np.float64).ravel())) for k in comp)
    assert rep["rekeyed_comp_states"] == 2
    assert rep["dropped_ef_norm"] == pytest.approx(want, rel=1e-12)
    assert rep["dropped_ef_norm"] > 0


def test_grow_2_to_4_is_bit_exact(resized):
    p, _, grow = resized
    _assert_consolidated_equal(_consolidated(p["b"], 6, 2),
                               _consolidated(p["b_res"], 6, 4))
    rep = grow["plain"]["report"]
    assert rep["from_world"] == 2 and rep["to_world"] == 4
    assert all(np.isfinite(grow["plain"]["losses"]))


def test_report_counts_equal_jax(resized, tmp_path):
    """JAX's resize of the same problem (an MLP 8-16-4 at K 2, Adam,
    world 4 -> 2; int8 EF on both buckets) reports the same resharded
    and re-keyed counts.  Replicated leaves: optax keeps one Adam count,
    torch one step tensor a shard (two here), both broadcast."""
    from test_elastic import _resume_into, _sub_comm, _train_and_save
    _, shrink, _ = resized
    for name, kw in (("plain", {}), ("int8", {"bucket_compressors":
                                              "int8"})):
        d = str(tmp_path / name)
        _train_and_save(_sub_comm(4), d, num_buckets=2, **kw)
        _, _, jrep = _resume_into(_sub_comm(2), d, num_buckets=2, **kw)
        prep = shrink[name]["report"]
        for key in ("resized", "from_world", "to_world", "generation",
                    "resharded_leaves", "rekeyed_comp_states"):
            assert prep.get(key) == jrep.get(key), (name, key)
        assert jrep["replicated_leaves"] == 1
        assert prep["replicated_leaves"] == 2


def test_same_world_is_the_plain_resume(resized, comm, tmp_path):
    """A world of the saved size takes ``checkpointer.resume`` (all its
    refusals intact): here a world of one over a one-rank generation."""
    sync = create_multi_node_checkpointer(comm, str(tmp_path), "one", keep=0)
    sync.save(_state(3), 3)
    restored, gen, rep = resize.resume_resized(sync, _state(0))
    assert gen == 3 and rep == {"generation": 3, "from_world": 1,
                                "to_world": 1, "resized": False}
    assert torch.equal(restored["w"], _state(3)["w"])
    assert resize.resize_report() == rep


def test_resize_refuses_another_structure(comm, tmp_path):
    """A generation saved at another world is resharded only when the
    state's structure is the same; a rank-0 file of a one-rank world is
    read for another leaf set and refused."""
    for r in range(2):
        np.savez(os.path.join(str(tmp_path), f"x.2.rank{r}.npz"),
                 **{"__dtypes__": np.array(json.dumps({"a": "torch.float32"})),
                    "a": np.zeros(3, np.float32)})
    ckpt = create_multi_node_checkpointer(comm, str(tmp_path), "x", keep=0)
    with pytest.raises(ValueError, match="does not hold the new state"):
        resize.resume_resized(ckpt, {"b": torch.zeros(3)})
    assert resize.resume_resized(
        create_multi_node_checkpointer(comm, str(tmp_path / "e"), "x"),
        {"b": torch.zeros(3)})[1] is None
