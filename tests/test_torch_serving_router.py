"""The port's serving router and weight functions against JAX's.

JAX's ``Router`` over JAX engines and the port's over port engines (the
same tiny LM, its flax weights carried over by
``chainermn_tpu_torch.weights``) take the same sessionful trace, with a
replica drained mid-run and readmitted later: the dispatch log, the load
signals after every submit and step, the drain summaries and the
completions (replica, session, request, token count) must be equal.
``broadcast_inference_params`` must give every rank of a gloo world
root's tensors bit for bit; ``load_inference_params`` restores through the
port's checkpointer.  The JAX paths the port has not taken raise naming
their queue.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JLM
from chainermn_tpu.serving import InferenceEngine as JEngine
from chainermn_tpu.serving import Router as JRouter
from chainermn_tpu.serving import ServingConfig as JConfig
from chainermn_tpu_torch import create_communicator, weights
from chainermn_tpu_torch.extensions.checkpoint import (
    create_multi_node_checkpointer)
from chainermn_tpu_torch.models.transformer import TransformerLM
from chainermn_tpu_torch.parallel import FsdpState
from chainermn_tpu_torch.serving import (InferenceEngine, Router,
                                         ServingConfig,
                                         load_inference_params)
from chainermn_tpu_torch.serving import weights as sw

from torch_dist_worker import launch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LM = dict(vocab=61, d_model=32, n_layers=2, n_heads=4, max_len=128,
          n_kv_heads=2)
CFG = dict(page_size=4, num_pages=32, max_seqs=2, chunk_tokens=8,
           max_pages_per_seq=8, prefix_cache=True)


@pytest.fixture(scope="module")
def lm():
    jm = JLM(attention_impl="xla", **LM)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    tm = TransformerLM(LM["vocab"], LM["d_model"], LM["n_layers"],
                       LM["n_heads"], LM["max_len"], "xla",
                       n_kv_heads=LM["n_kv_heads"], device="cpu")
    weights.load_flax_variables(tm, variables)
    return jm, variables, tm


def _trace(seed=11):
    """(session or None, prompt, max_new): 3 sessions sharing a two-page
    system prompt each, and sessionless requests."""
    rng = np.random.default_rng(seed)
    sys_prompts = [list(map(int, rng.integers(1, 61, size=8)))
                   for _ in range(3)]
    out = []
    for i in range(14):
        tail = list(map(int, rng.integers(1, 61, size=int(
            rng.integers(1, 6)))))
        if i % 4 == 3:
            out.append((None, tail, int(rng.integers(1, 5))))
        else:
            s = i % 3
            out.append((f"s{s}", sys_prompts[s] + tail,
                        int(rng.integers(1, 5))))
    return out


def _status(router):
    return [(s.replica, s.queue_depth, s.active, s.free_pages, s.num_pages,
             s.load) for s in router.status()]


def _drive(router, trace):
    """Submit in waves of 3 with two fleet steps between; drain replica 1
    after the first wave's steps (before its work is done), readmit it at
    the midpoint; run to idle.  Everything observable, in order."""
    log = []
    for i, (session, prompt, max_new) in enumerate(trace):
        rid = router.submit(prompt, max_new, session=session, arrival=0.0)
        log.append(("submit", rid, router.replica_of(rid), _status(router)))
        if i % 3 == 2:
            for _ in range(2):
                log.append(("step", router.step(), _status(router)))
        if i == 2:
            log.append(("drain", router.drain_replica(1),
                        sorted(router.drained)))
        if i == len(trace) // 2:
            router.readmit_replica(1)
            log.append(("readmit", sorted(router.drained)))
    done = router.run_until_idle()
    log.append(("done", sorted((rep, str(sess), c.rid, len(c.tokens))
                               for rep, sess, c in done)))
    log.append(("dispatch", list(router.dispatch_log)))
    log.append(("all", sorted((rep, str(sess), c.rid, len(c.tokens))
                              for rep, sess, c in router.completions)))
    return log


def test_router_matches_jax(lm):
    jm, variables, tm = lm
    trace = _trace()
    want = _drive(JRouter([JEngine(jm, variables, JConfig(**CFG))
                           for _ in range(2)]), trace)
    got = _drive(Router([InferenceEngine(tm, ServingConfig(**CFG))
                         for _ in range(2)]), trace)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"entry {i}: {g} vs JAX {w}"
    drain = next(e for e in got if e[0] == "drain")[1]
    assert drain["requests_replayed"] > 0 and drain["sessions_rerouted"] > 0


def test_router_refusals(lm):
    _, _, tm = lm
    with pytest.raises(ValueError, match="at least one engine"):
        Router([])
    router = Router([InferenceEngine(tm, ServingConfig(**CFG))])
    router.drain_replica(0)
    with pytest.raises(RuntimeError, match="every replica is drained"):
        router.submit([1, 2, 3], 2)
    with pytest.raises(ValueError, match="is not drained"):
        Router([InferenceEngine(tm, ServingConfig(**CFG))]).readmit_replica(0)
    # the planner's multicast is ported (A11): a plan that is not
    # leaf-packed is refused
    from chainermn_tpu_torch.planner import flavor_plan
    with pytest.raises(ValueError, match="must use leaf packing"):
        Router.distribute_weights(create_communicator("naive", device="cpu"),
                                  {}, plan=flavor_plan("flat"))


def test_broadcast_inference_params_bit_exact(tmp_path):
    """Root's float32, bfloat16 and int64 tensors on both ranks of a gloo
    world, bit for bit (rank 1 starts from its own values)."""
    outs = launch("serve", {"parts": np.asarray("bcast")}, 2, tmp_path)
    assert not np.array_equal(outs[1]["mine/w"], outs[0]["mine/w"])
    for r in range(2):
        for k in ("w", "h", "ids"):
            got, want = outs[r][f"bcast/{k}"], outs[0][f"mine/{k}"]
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes(), (r, k)


def test_load_inference_params(lm, tmp_path):
    """A saved state dict comes back through the port's checkpointer, cast
    to bfloat16 where floating; an empty directory raises."""
    _, _, tm = lm
    comm = create_communicator("naive", device="cpu")
    ckpt = create_multi_node_checkpointer(comm, str(tmp_path / "c"),
                                          name="lm")
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    sd["step"] = torch.tensor(7)
    ckpt.save(sd, 3)
    template = {k: torch.zeros_like(v) for k, v in sd.items()}
    got = load_inference_params(template, checkpointer=ckpt,
                                dtype=torch.bfloat16)
    for k, v in sd.items():
        assert got[k].dtype == (torch.bfloat16 if v.is_floating_point()
                                else v.dtype)
        assert torch.equal(got[k], v.to(got[k].dtype))
    empty = create_multi_node_checkpointer(comm, str(tmp_path / "e"))
    with pytest.raises(FileNotFoundError, match="no consistent checkpoint"):
        load_inference_params(template, checkpointer=empty)
    plain = load_inference_params(sd)
    assert plain is sd


@pytest.mark.parametrize("call,queue", [
    # FSDP consolidation is ported (A9 b): a sharded state without its
    # metas is refused as in JAX
    (lambda: load_inference_params({"fsdp": FsdpState(
        [[torch.zeros(2)]], None, None, 1)}), None),
    (lambda: load_inference_params({}, int8_weights=True), "A10"),
    (lambda: sw.quantize_inference_params({}), "A10"),
    (lambda: sw.dequantize_inference_params({}), "A10"),
    (lambda: sw.weights_multicast_plan(), "A11"),
    (lambda: sw.broadcast_inference_params(
        create_communicator("naive", device="cpu"),
        {"w": torch.arange(6.0).reshape(2, 3)},
        plan=sw.weights_multicast_plan()), "A11"),
    (lambda: sw.shard_params_tp({"blocks.0.up.weight": torch.ones(8, 2)},
                                2, n_heads=4), "A9"),
])
def test_unported_weight_paths_raise(call, queue):
    if queue == "A10":
        # per-channel int8 weights are ported (A10): the round trip
        w = {"blocks.0.up.weight": torch.linspace(-1, 1, 12).reshape(4, 3),
             "blocks.0.up.bias": torch.ones(4)}
        q = sw.quantize_inference_params(w)
        assert q["blocks.0.up.weight"]["int8_codes"].dtype == torch.int8
        assert torch.equal(q["blocks.0.up.bias"], w["blocks.0.up.bias"])
        back = sw.dequantize_inference_params(q)
        assert (back["blocks.0.up.weight"]
                - w["blocks.0.up.weight"]).abs().max() <= 1 / 127
        loaded = load_inference_params(w, int8_weights=True)
        assert torch.equal(loaded["blocks.0.up.weight"],
                           back["blocks.0.up.weight"])
        assert call() == {}
        return
    if queue == "A9":
        # Megatron slicing is ported (A9 c): up's output rows in two shards
        assert call()["blocks.0.up.weight"].shape == (2, 4, 2)
        with pytest.raises(ValueError, match="must be >= 1 and divide"):
            sw.shard_params_tp({}, 3, n_heads=4)
        return
    if queue is None:
        with pytest.raises(ValueError, match="no FsdpMeta was given"):
            call()
        return
    if queue == "A11":
        # the planner's multicast is ported (A11): JAX's plan, and its
        # leaf chain on a world of one gives the weights back exactly
        from chainermn_tpu.serving import weights as jw
        from chainermn_tpu_torch.planner import Plan
        got = call()
        if isinstance(got, Plan):
            assert got.to_dict() == jw.weights_multicast_plan().to_dict()
        else:
            assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
        return
    with pytest.raises(NotImplementedError, match=f"Queue {queue}"):
        call()
