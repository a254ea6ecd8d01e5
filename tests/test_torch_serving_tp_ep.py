"""Tensor- and expert-parallel serving of the port against the JAX
package's, on the CPU.

The JAX engines run ``tp_size``/``ep_size`` over devices of this process's
CPU mesh; the port's run one process a rank on gloo worlds
(``torch_dist_worker.py`` mode ``tpserve``: rank 0 submits, every rank
steps in lockstep).  Twins of ``tests/test_serving.py``'s
``test_tp2_matches_tp1_tokens_exactly``,
``test_shard_params_tp_shapes_and_bias_split`` and
``test_shard_params_tp_rejects_bad_tp``, ``tests/test_serving_spec.py``'s
``test_tp2_spec_matches_tp1`` and ``tests/test_moe_plan.py``'s
``test_ep2_logits_identical_to_ep1`` and ``test_ep_config_validation``:

* tp 2 greedy tokens equal to tp 1's and to JAX's tp 2 engine's; the cache
  holds ``n_kv_heads / tp`` heads;
* ``shard_params_tp`` equal to JAX's value for value (through the weights
  map onto a ``tp_size`` model), at tp 2 and 4;
* tp 2 speculative decoding equal to tp 1's tokens and accept counts;
* a MoE LM at ep 2 bit-equal to ep 1 in every step's logits on the CPU
  (tokens and gate math are replicated over the expert ranks), ep 1
  within 1e-5 of JAX's; tp 2 x ep 2 on four ranks (rank ``r`` is ``(r //
  2, r % 2)``) within 1e-5 of ep 1;
* the refusals, in JAX's words where JAX has them.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker
from chainermn_tpu.models import TransformerLM as JLM
from chainermn_tpu.serving import (InferenceEngine as JEngine,
                                   ServingConfig as JConfig)
from chainermn_tpu.serving.weights import shard_params_tp as jshard
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.benchmarks.bench_serving import truncated_draft
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.serving import InferenceEngine, ServingConfig
from chainermn_tpu_torch.serving.weights import shard_params_tp
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DENSE = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, max_len=128,
             n_kv_heads=2)
MOE = dict(vocab=32, d_model=16, n_layers=1, n_heads=2, max_len=64,
           moe_experts=4, moe_top_k=2)
TP_CFG = dict(page_size=4, num_pages=32, max_seqs=3, chunk_tokens=4,
              max_pages_per_seq=8)
SPEC_CFG = dict(page_size=4, num_pages=32, max_seqs=2, chunk_tokens=8,
                max_pages_per_seq=16, spec_k=2)
EP_CFG = dict(page_size=4, num_pages=16, max_seqs=2, chunk_tokens=4,
              max_pages_per_seq=4, keep_logits=True)
EP_PROMPTS = [[1, 2, 3], [5, 6]]


def _prompts(sizes, vocab=61, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, size=n))) for n in sizes]


TP_PROMPTS, SPEC_PROMPTS = _prompts((5, 3, 9)), _prompts((5, 9))


@pytest.fixture(scope="module")
def dense():
    model = JLM(**DENSE, attention_impl="xla")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def moe():
    model = JLM(**MOE, attention_impl="xla", moe_axis="ep")
    params = jax.jit(jax.shard_map(
        lambda tk: model.init(jax.random.key(0), tk),
        mesh=Mesh(np.array(jax.devices()[:2]), ("ep",)), in_specs=P(),
        out_specs=P(), check_vma=False))(jnp.zeros((1, 4), jnp.int32))
    return model, {"params": jax.tree.map(np.asarray, params["params"])}


def _port(cfg, params):
    return weights.load_flax_variables(TransformerLM(**cfg, device="cpu"),
                                       params)


def _jax_draft(model, params):
    dm = JLM(**dict(DENSE, n_layers=1), attention_impl="xla")
    p = params["params"]
    return dm, {"params": {k: p[k] for k in ("tok_emb", "pos_emb",
                                              "block_0", "ln_f", "head")}}


def _drain(eng, prompts, max_new):
    rids = [eng.submit(p, max_new) for p in prompts]
    logits, accepted = [], 0
    while not eng.idle():
        res = eng.step()
        if res.last_logits is not None:
            logits.append(res.last_logits)
        if res.spec is not None:
            accepted += res.spec["accepted"]
    toks = {c.rid: c.tokens for c in eng.completions}
    return [toks[r] for r in rids], logits, accepted


def _world_tokens(out, label):
    return [t for _, t in json.loads(str(out[f"{label}/tokens"]))]


@pytest.fixture(scope="module")
def worlds(dense, moe, tmp_path_factory):
    inputs = {f"dense/{k}": v for k, v in
              torch_dist_worker.flatten(dense[1]).items()}
    inputs.update({f"moe/{k}": v for k, v in
                   torch_dist_worker.flatten(moe[1]).items()})
    for label, cfg, prompts, max_new in (
            ("tp", TP_CFG, TP_PROMPTS, 6), ("spec", SPEC_CFG, SPEC_PROMPTS,
                                            8)):
        inputs[f"{label}/cfg"] = np.asarray(json.dumps(cfg))
        inputs[f"{label}/prompts"] = np.asarray(json.dumps(prompts))
        inputs[f"{label}/max_new"] = np.asarray(max_new)
    two = torch_dist_worker.launch(
        "tpserve", dict(inputs, parts=np.asarray("tp,ep"), ep=np.asarray(2)),
        2, tmp_path_factory.mktemp("tpserve2"))
    four = torch_dist_worker.launch(
        "tpserve", dict(inputs, parts=np.asarray("ep"), ep=np.asarray(2)),
        4, tmp_path_factory.mktemp("tpserve4"))
    return two, four


def test_tp2_matches_tp1_tokens_exactly(dense, worlds):
    model, params = dense
    want, _, _ = _drain(InferenceEngine(_port(DENSE, params),
                                        ServingConfig(**TP_CFG)),
                        TP_PROMPTS, 6)
    jeng = JEngine(model, params, JConfig(**TP_CFG, tp_size=2))
    jtoks, _, _ = _drain(jeng, TP_PROMPTS, 6)
    assert want == jtoks
    for out in worlds[0]:
        assert _world_tokens(out, "tp") == want
        assert int(out["tp/kv_heads"]) == DENSE["n_kv_heads"] // 2


def test_tp2_spec_matches_tp1(dense, worlds):
    """Megatron-sliced target AND draft; the same tokens and accept
    counts as tp 1, and as JAX's tp 2 spec engine."""
    model, params = dense
    port = _port(DENSE, params)
    want, _, acc = _drain(InferenceEngine(
        port, ServingConfig(**SPEC_CFG), draft_model=truncated_draft(port)),
        SPEC_PROMPTS, 8)
    dm, dp = _jax_draft(model, params)
    jtoks, _, jacc = _drain(JEngine(model, params,
                                    JConfig(**SPEC_CFG, tp_size=2),
                                    draft_model=dm, draft_params=dp),
                            SPEC_PROMPTS, 8)
    assert (want, acc) == (jtoks, jacc)
    for out in worlds[0]:
        assert _world_tokens(out, "spec") == want
        assert int(out["spec/accepted"]) == acc


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_tp_matches_jax(tp):
    """Each shard of the port's slicing equals JAX's shard through the
    weights map, value for value (no GQA at tp 4: 4 kv heads)."""
    cfg = dict(DENSE, n_kv_heads=2 if tp == 2 else 4)
    params = JLM(**cfg, attention_impl="xla").init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))
    model = _port(cfg, params)
    got = shard_params_tp(model.state_dict(), tp, n_heads=cfg["n_heads"],
                          n_kv_heads=cfg["n_kv_heads"])
    want = jshard(params, tp, n_heads=cfg["n_heads"],
                  n_kv_heads=cfg["n_kv_heads"])
    local = TransformerLM(**cfg, tp_size=tp, device="cpu")
    for t in range(tp):
        shard = weights.flax_to_state_dict(
            jax.tree.map(lambda v: np.asarray(v[t]), want), local)
        assert shard.keys() == got.keys()
        for k, v in shard.items():
            np.testing.assert_array_equal(got[k][t].numpy(), v.numpy(),
                                          err_msg=f"{k} shard {t}")
        local.load_state_dict({k: v[t] for k, v in got.items()})
    # the row-parallel biases' shards sum to the whole bias
    torch.testing.assert_close(got["blocks.0.proj.bias"].sum(0),
                               model.state_dict()["blocks.0.proj.bias"])


def test_shard_params_tp_keeps_moe_layers_whole(moe):
    sd = _port(MOE, moe[1]).state_dict()
    got = shard_params_tp(sd, 2, n_heads=2)
    for k, v in sd.items():
        if ".moe." in k:
            assert torch.equal(got[k][0], v) and torch.equal(got[k][1], v)


def test_shard_params_tp_rejects_bad_tp(dense):
    model, params = dense
    with pytest.raises(ValueError, match="divide") as want:
        jshard(params, 3, n_heads=4, n_kv_heads=2)
    with pytest.raises(ValueError, match="divide") as got:
        shard_params_tp(_port(DENSE, params).state_dict(), 3, n_heads=4,
                        n_kv_heads=2)
    assert str(got.value) == str(want.value)


def test_ep2_logits_bit_equal_to_ep1(moe, worlds):
    model, params = moe
    toks, logits, _ = _drain(InferenceEngine(
        _port(MOE, params), ServingConfig(**EP_CFG)), EP_PROMPTS, 4)
    jtoks, jlogits, _ = _drain(JEngine(model, params, JConfig(**EP_CFG)),
                               EP_PROMPTS, 4)
    assert toks == jtoks
    np.testing.assert_allclose(np.stack(logits), np.stack(jlogits),
                               rtol=1e-5, atol=1e-5)
    for r, out in enumerate(worlds[0]):
        assert [t for _, t in json.loads(str(out["ep/tokens"]))] == toks
        assert np.array_equal(out["ep/logits"], np.stack(logits))
        assert out["ep/experts"].tolist() == [2 * r, 2 * r + 2]


def test_tp2_ep2_on_four_ranks(moe, worlds):
    """Rank r is (t, e) = (r // 2, r % 2): experts by e; the logits within
    1e-5 of ep 1 (the tensor-parallel sums round), the same tokens."""
    _, params = moe
    toks, logits, _ = _drain(InferenceEngine(
        _port(MOE, params), ServingConfig(**EP_CFG)), EP_PROMPTS, 4)
    for r, out in enumerate(worlds[1]):
        e = r % 2
        assert out["ep/experts"].tolist() == [2 * e, 2 * e + 2]
        assert [t for _, t in json.loads(str(out["ep/tokens"]))] == toks
        np.testing.assert_allclose(out["ep/logits"], np.stack(logits),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out["ep/logits"],
                                      worlds[1][0]["ep/logits"])


def test_ep_config_errors_match_jax(dense, moe):
    base = dict(page_size=4, num_pages=16, max_seqs=2, chunk_tokens=4,
                max_pages_per_seq=4)
    jdense = JLM(vocab=32, d_model=16, n_layers=1, n_heads=2, max_len=64)
    jdp = jdense.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))
    pdense = _port(dict(vocab=32, d_model=16, n_layers=1, n_heads=2,
                        max_len=64), jdp)
    jmodel, params = moe
    pmoe = _port(MOE, params)
    for (jm, jp, pm), kw in (((jdense, jdp, pdense), dict(ep_size=2)),
                             ((jmodel, params, pmoe), dict(ep_size=3))):
        with pytest.raises(ValueError) as want:
            JEngine(jm, jp, JConfig(**base, **kw))
        with pytest.raises(ValueError) as got:
            InferenceEngine(pm, ServingConfig(**base, **kw))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="spec_k"):
        InferenceEngine(pmoe, ServingConfig(**base, ep_size=2, spec_k=1),
                        draft_model=pmoe)


def test_tp_ep_refusals(dense, moe):
    port = _port(DENSE, dense[1])
    with pytest.raises(ValueError, match="exceeds the 1 ranks"):
        InferenceEngine(port, ServingConfig(**TP_CFG, tp_size=2))
    with pytest.raises(ValueError, match="must divide n_kv_heads"):
        InferenceEngine(port, ServingConfig(**TP_CFG, tp_size=4))
    # moe_plan is ported (A11): a plan that is not an exchange is refused
    from chainermn_tpu_torch.planner import PlanError, flavor_plan
    with pytest.raises(TypeError, match="must be a planner Plan"):
        InferenceEngine(_port(MOE, moe[1]),
                        ServingConfig(**EP_CFG, moe_plan=object()))
    with pytest.raises(PlanError, match="all-to-all stages only"):
        InferenceEngine(_port(MOE, moe[1]),
                        ServingConfig(**EP_CFG, moe_plan=flavor_plan("flat")))
    big = types.SimpleNamespace(size=4, rank=0)
    with pytest.raises(ValueError, match="uses 2 of the 4 ranks"):
        InferenceEngine(port, ServingConfig(**TP_CFG, tp_size=2), comm=big)
