"""The port's MoE TransformerLM, its example and ``bench_moe`` against the
JAX package's, on the CPU.

Flax weights (``TransformerLM(moe_experts=4, moe_top_k=2)``, initialised
inside ``shard_map`` as JAX's example does) go through ``weights.py`` into
the port's model, each expert-parallel rank keeping its experts:

* logits at ep 1 (this process) and ep 2 (a 2-rank gloo world,
  ``torch_dist_worker.py`` mode ``moelm``) against JAX's on a mesh of as
  many devices, within 1e-4; the per-block statistics' keys and values;
* 3 Adam steps at lr 1e-3 (ROADMAP.md Queue C item 7) through the
  example's ``train_step`` against JAX's example step (its ``loss_fn``
  written out here: ``pmean`` cross entropy plus ``aux_weight`` times the
  blocks' aux loss): the losses, and every parameter within 1e-5 (the
  key bias apart: its gradient is float noise, which Adam moves by up to
  lr a step);
* the weight carry-over: every flax leaf placed (an extra one refused), an
  EP rank's slice of the expert stacks;
* the example's balanced-load run (twin of ``tests/test_examples.py``'s
  ``test_moe_lm_trains_balanced``), and ``bench_moe --out`` at 40 steps:
  the MoE's tail loss at or below the dense twin's; ``--sweep`` refused.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker
from chainermn_tpu.models import TransformerLM as JLM
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.benchmarks import bench_moe
from chainermn_tpu_torch.examples import train_moe_lm
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.models.transformer import collect_moe_stats
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, max_len=16)
E, K, B, T = 4, 2, 4, 16
LR, STEPS, AUX = 1e-3, 3, 1e-2


def _jmodel():
    return JLM(**CFG, attention_impl="xla", moe_experts=E, moe_top_k=K,
               moe_axis="ep")


def _mesh(p):
    return Mesh(np.array(jax.devices()[:p]), ("ep",))


@pytest.fixture(scope="module")
def flax_params():
    toks = np.zeros((1, T), np.int32)
    params = jax.jit(jax.shard_map(
        lambda tk: _jmodel().init(jax.random.key(0), tk), mesh=_mesh(1),
        in_specs=P(), out_specs=P(), check_vma=False))(toks)
    # init also returns the "moe_stats" it sowed; fed back into apply they
    # would come first in each sown tuple (ROADMAP.md Queue C item 9)
    return {"params": jax.tree.map(np.asarray, params["params"])}


def _toks():
    return np.asarray(train_moe_lm.make_motif_task(B, T, CFG["vocab"],
                                                   seed=3))


def _jax_run(params, p):
    """JAX on a ``p``-device mesh: logits and stats of the first forward,
    then the example's step ``STEPS`` times: (logits, stats, ces,
    params)."""
    model, mesh, toks = _jmodel(), _mesh(p), jnp.asarray(_toks())

    def fwd(pp, tk):
        logits, mut = model.apply(pp, tk, mutable=["moe_stats"])
        return logits, mut["moe_stats"]

    logits, stats = jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(P(), P("ep")), out_specs=(P("ep"), P()),
        check_vma=False))(params, toks)

    def loss_fn(p_, tk):
        def body(pp, tkk):
            lg, mut = model.apply(pp, tkk, mutable=["moe_stats"])
            ce = optax.softmax_cross_entropy_with_integer_labels(
                lg[:, :-1], tkk[:, 1:]).mean()
            ce = jax.lax.pmean(ce, "ep")
            aux = sum(d["aux_loss"][0] for d in mut["moe_stats"].values())
            return ce + AUX * aux, ce
        return jax.shard_map(body, mesh=mesh, in_specs=(P(), P("ep")),
                             out_specs=(P(), P()))(p_, tk)

    opt = optax.adam(LR)

    @jax.jit
    def step(p_, s_, tk):
        (_, ce), g = jax.value_and_grad(loss_fn, has_aux=True)(p_, tk)
        updates, s_ = opt.update(g, s_, p_)
        return optax.apply_updates(p_, updates), s_, ce

    pp, st, ces = params, opt.init(params), []
    for _ in range(STEPS):
        pp, st, ce = step(pp, st, toks)
        ces.append(float(ce))
    return (np.asarray(logits), jax.tree.map(np.asarray, stats),
            np.asarray(ces), jax.tree.map(np.asarray, pp))


@pytest.fixture(scope="module")
def runs(flax_params, tmp_path_factory):
    """JAX at ep 1 and 2; the port in this process (ep 1) and on a 2-rank
    world (ep 2)."""
    out = {p: _jax_run(flax_params, p) for p in (1, 2)}
    inputs = {f"params/{k}": v for k, v in
              torch_dist_worker.flatten(flax_params).items()}
    inputs.update(toks=_toks(), lr=np.float32(LR), steps=np.asarray(STEPS),
                  aux_weight=np.float32(AUX),
                  cfg=np.asarray([CFG["vocab"], CFG["d_model"],
                                  CFG["n_layers"], CFG["n_heads"],
                                  CFG["max_len"], E, K]))
    world = torch_dist_worker.launch("moelm", inputs, 2,
                                     tmp_path_factory.mktemp("moelm"))
    return out, world


def _port(params):
    model = TransformerLM(**CFG, moe_experts=E, moe_top_k=K, device="cpu")
    return weights.load_flax_variables(model, params)


def test_logits_and_stats_match_jax_at_ep1(flax_params, runs):
    jlogits, jstats, _, _ = runs[0][1]
    model = _port(flax_params)
    got = model(torch.from_numpy(_toks())).detach().numpy()
    np.testing.assert_allclose(got, jlogits, rtol=1e-4, atol=1e-5)
    stats = collect_moe_stats(model)
    assert stats.keys() == jstats.keys()
    for blk, d in stats.items():
        assert d.keys() == jstats[blk].keys()
        for k, v in d.items():
            np.testing.assert_allclose(v.detach().numpy(), jstats[blk][k][0],
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_logits_match_jax_at_ep2(runs):
    jlogits = runs[0][2][0]
    outs = runs[1]
    n = B // 2
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["logits"], jlogits[r * n:(r + 1) * n],
                                   rtol=1e-4, atol=1e-5)


def _held(got, want, init):
    """Every leaf within 1e-5; the key slice of each qkv bias apart (moved
    by at most lr a step on both sides, ROADMAP.md Queue C item 7)."""
    d = CFG["d_model"]
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].copy(), want[k].copy()
        if k.endswith("qkv/bias"):
            for x in (g, w):
                assert np.abs(x[d:2 * d] - init[k][d:2 * d]).max() <= \
                    STEPS * LR * 1.001
            g[d:2 * d] = w[d:2 * d]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)


def test_adam_steps_match_jax_example_at_ep1(flax_params, runs):
    _, _, jces, jparams = runs[0][1]
    model = _port(flax_params)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    toks = torch.from_numpy(_toks())
    ces = [float(train_moe_lm.train_step(model, opt, toks, AUX)[1])
           for _ in range(STEPS)]
    np.testing.assert_allclose(ces, jces, rtol=1e-5)
    flat = torch_dist_worker.flatten
    _held(flat(weights.state_dict_to_flax(model)), flat(jparams),
          flat(flax_params))


def test_adam_steps_match_jax_example_at_ep2(flax_params, runs):
    """Each rank: the replicated parameters equal JAX's, its expert rows
    JAX's rows of its experts."""
    _, _, jces, jparams = runs[0][2]
    flat = torch_dist_worker.flatten
    want, init = flat(jparams), flat(flax_params)
    for r, out in enumerate(runs[1]):
        np.testing.assert_allclose(out["ce"], jces, rtol=1e-5)
        got = {k[2:]: v for k, v in out.items() if k.startswith("p/")}
        rows = slice(r * E // 2, (r + 1) * E // 2)
        stacks = ("up_kernel", "up_bias", "down_kernel", "down_bias")
        _held(got, {k: v[rows] if k.split("/")[-1] in stacks else v
                    for k, v in want.items()},
              {k: v[rows] if k.split("/")[-1] in stacks else v
               for k, v in init.items()})


def test_weight_carry_over(flax_params):
    """Every flax leaf has a place (a leftover one is refused), the round
    trip is exact, and an EP rank's model takes its rows of the stacks."""
    model = _port(flax_params)
    flat = torch_dist_worker.flatten
    back = flat(weights.state_dict_to_flax(model))
    want = flat(flax_params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    extra = jax.tree.map(lambda v: v, flax_params)
    extra["params"]["block_0"]["moe"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="stray"):
        weights.flax_to_state_dict(extra, model)
    half = TransformerLM(**CFG, moe_experts=E, moe_top_k=K, device="cpu",
                         moe_comm=types.SimpleNamespace(rank=1, size=2))
    sd = weights.flax_to_state_dict(flax_params, half)
    half.load_state_dict(sd, strict=True)
    moe = flax_params["params"]["block_1"]["moe"]
    np.testing.assert_array_equal(sd["blocks.1.moe.up_kernel"].numpy(),
                                  moe["up_kernel"][2:])
    np.testing.assert_array_equal(sd["blocks.1.moe.router.weight"].numpy(),
                                  moe["router"]["kernel"].T)


def test_example_trains_balanced(capsys):
    """The JAX example test's flags: it converges, reports the routing
    statistics, and no expert hoards the tokens (max load below 0.5)."""
    res = train_moe_lm.main(["--device", "cpu", "--steps", "16",
                             "--batchsize", "8", "--seq-len", "128",
                             "--d-model", "64", "--layers", "1",
                             "--experts", "8", "--top-k", "2"])
    out = capsys.readouterr().out
    assert "done in" in out
    last = [ln for ln in out.splitlines() if ln.startswith("step ")][-1]
    assert float(last.rsplit("/", 1)[1]) < 0.5, last
    assert res["losses"][-1] < res["losses"][0]


def test_bench_moe_matched_loss(tmp_path):
    path = tmp_path / "moe.json"
    doc = bench_moe.main(["--device", "cpu", "--out", str(path),
                          "--steps", "40"])
    on_disk = json.loads(path.read_text())
    assert on_disk["schema"] == "moe_bench/v1"
    assert doc["moe_at_or_below_dense"], (doc["moe"]["final_loss"],
                                          doc["dense"]["final_loss"])
    assert doc["moe"]["n_params"] > doc["dense"]["n_params"]
    assert len(doc["moe"]["losses"]) == 40
    # the all-to-all plan sweep is ported (A11): its rows validate and
    # build a plan table
    from chainermn_tpu_torch.planner import (
        autotune_from_rows, validate_sweep_rows)
    sweep = tmp_path / "sweep.json"
    bench_moe.main(["--device", "cpu", "--sweep", str(sweep),
                    "--sweep-sizes-kb", "4,64", "--iters", "1",
                    "--warmup", "0"])
    rows = json.loads(sweep.read_text())["rows"]
    validate_sweep_rows(rows)
    assert {r["plan"] for r in rows} >= {"alltoall_flat"}
    table, _ = autotune_from_rows(rows)
    assert table.entries
