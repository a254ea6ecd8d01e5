"""The LM slice as a whole, port vs JAX, on the CPU.

* ``examples.train_lm``: the motif task gives the JAX example's tokens bit
  for bit; three Adam steps of the example's loop at toy width, from flax
  weights, match the same JAX steps (losses 1e-5, parameters 1e-4 relative
  to each tensor's largest value); ``--fsdp`` raises, the sequence-parallel
  attentions run on a world of one as ``flash`` does, and without
  ``--device`` the example refuses a box with no card.
* The data-parallel step of the LM benchmark (``create_communicator("xla",
  allreduce_grad_dtype=...)`` -> ``create_multi_node_optimizer(SGD momentum
  0.9, double_buffering=True)`` -> ``make_train_step``) on a 2-process gloo
  world, float32 and bfloat16 wires, against JAX ``make_train_step`` on a
  2-device mesh.  JAX's flash kernel cannot run inside ``make_train_step``'s
  ``shard_map`` on the CPU (interpret mode trips the varying-axes check,
  ROADMAP.md Queue C8), so the JAX side attends with ``"xla"`` while the
  port runs ``"flash"`` (its plain path here); the two agree in float32
  (test_torch_transformer.py).  The bfloat16 wire rounds each gradient to 8
  bits of mantissa before the mean, so its parameters are held to the float32
  wire's within lr x that rounding.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.models import TransformerLM as JLM
from chainermn_tpu.optimizers import (
    create_multi_node_optimizer as jmno, init_opt_state, make_train_step as
    jstep)
from chainermn_tpu.parallel.topology import init_topology
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.examples import train_lm
from chainermn_tpu_torch.models import TransformerLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm", os.path.join(REPO, "examples", "long_context",
                                     "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,seq,vocab,seed", [(4, 2048, 128, 0),
                                              (3, 100, 50, 1),
                                              (1, 8192, 32768, 7)])
def test_motif_tokens_identical(n, seq, vocab, seed):
    want = np.asarray(_jax_example().make_motif_task(n, seq, vocab,
                                                     seed=seed))
    got = train_lm.make_motif_task(n, seq, vocab, seed=seed).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


CFG = dict(vocab=32, d_model=32, n_layers=2, n_heads=4)
SEQ, LR, STEPS = 48, 1e-3, 3


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa2"])
def test_example_adam_steps_match_jax(kv):
    toks = train_lm.make_motif_task(2, SEQ, CFG["vocab"], seed=3)
    jmodel = JLM(**CFG, max_len=SEQ, n_kv_heads=kv, attention_impl="flash")
    params = jmodel.init(jax.random.key(0), jnp.asarray(toks[:, :16]))
    opt = optax.adam(LR)
    state = opt.init(params)
    tk = jnp.asarray(toks.numpy())

    def loss_fn(p):  # the JAX example's single-shard loss
        logits = jmodel.apply(p, tk)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], tk[:, 1:]).mean()

    want_losses = []
    p = params
    for _ in range(STEPS):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, state = opt.update(g, state, p)
        p = optax.apply_updates(p, updates)
        want_losses.append(float(loss))
    model = TransformerLM(**CFG, max_len=SEQ, n_kv_heads=kv,
                          attention_impl="flash", device="cpu")
    weights.load_flax_variables(model, jax.tree.map(np.asarray, params))
    losses = train_lm.train(model, toks, STEPS, LR, log=None)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = torch_dist_worker.flatten(jax.tree.map(np.asarray, p))
    got = torch_dist_worker.flatten(weights.state_dict_to_flax(model))
    init = torch_dist_worker.flatten(jax.tree.map(np.asarray, params))
    d_kv = CFG["d_model"] // CFG["n_heads"] * (kv or CFG["n_heads"])
    k_bias = slice(CFG["d_model"], CFG["d_model"] + d_kv)
    for k in want:
        if k.endswith("qkv/bias"):
            # the key bias adds q.b to every score of a row, which softmax
            # ignores: its gradient is 0 up to float noise, which Adam
            # scales to +-lr a step on either side (ROADMAP.md Queue C7)
            for x in (got[k], want[k]):
                assert np.abs(x[k_bias] - init[k][k_bias]).max() <= \
                    STEPS * LR * 1.001
            got[k][k_bias] = want[k][k_bias]
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_example_runs_and_learns_on_cpu(capsys):
    out = train_lm.main(["--device", "cpu", "--seq-len", "64", "--steps",
                         "12", "--attention", "flash", "--kv-heads", "2"])
    losses = out["losses"]
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0]
    assert "step 11" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--attention", "ring"],
                                  ["--attention", "ring_flash"],
                                  ["--attention", "ulysses"],
                                  ["--attention", "ring", "--fsdp"]])
def test_example_refuses_sequence_parallelism(argv):
    if "--fsdp" in argv:
        with pytest.raises(NotImplementedError, match="Queue A9"):
            train_lm.main(argv + ["--device", "cpu"])
        return
    # ring, ring_flash and ulysses are ported (A9, part): on a world of one
    # each runs the example's three Adam steps as --attention flash does
    small = ["--device", "cpu", "--seq-len", "64", "--steps", "3",
             "--kv-heads", "2", "--lr", "1e-3"]
    got = train_lm.main(argv + small)
    want = train_lm.main(["--attention", "flash"] + small)
    assert got["world"] == 1
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)


def test_example_flag_errors_as_jax():
    with pytest.raises(SystemExit):
        train_lm.parse_args(["--kv-heads", "3"])
    with pytest.raises(SystemExit):
        train_lm.parse_args(["--attention", "flash", "--fsdp"])


def test_example_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(**CFG)


# --- the data-parallel LM step on a 2-process world ------------------------

WORLD, LOCAL_B, DP_LR, DP_STEPS = 2, 2, 0.05, 3


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    rng = np.random.RandomState(11)
    toks = (rng.rand(DP_STEPS, WORLD, LOCAL_B, SEQ) * CFG["vocab"]).astype(
        np.int32)
    params = JLM(**CFG, max_len=SEQ).init(jax.random.key(4),
                                          jnp.zeros((1, SEQ), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    inputs = {f"var/{k}": v for k, v in
              torch_dist_worker.flatten(params).items()}
    inputs.update(toks=toks, lr=np.float32(DP_LR), impl=np.asarray("flash"),
                  cfg=np.asarray([CFG["vocab"], CFG["d_model"],
                                  CFG["n_layers"], CFG["n_heads"], 0, SEQ]))
    outs = torch_dist_worker.launch("lm", inputs, WORLD,
                                    tmp_path_factory.mktemp("lm"))
    return toks, params, outs


def _jax_dp(toks, params, wire):
    comm = jcreate("xla", mesh=init_topology(
        devices=jax.devices()[:WORLD]).mesh, allreduce_grad_dtype=wire)
    model = JLM(**CFG, max_len=SEQ, attention_impl="xla")
    opt = jmno(optax.sgd(DP_LR, momentum=0.9), comm, double_buffering=True)

    def loss_fn(p, batch):  # bench_lm.py's loss
        (tok,) = batch
        logits = model.apply(p, tok)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], tok[:, 1:]).mean()

    step = jstep(comm, loss_fn, opt, donate=False)
    p = comm.bcast_data(params)
    state = init_opt_state(comm, opt, p)
    losses = []
    for t in toks:
        p, state, loss = step(p, state, (jnp.asarray(t.reshape(-1, SEQ)),))
        losses.append(float(loss))
    return np.asarray(losses), torch_dist_worker.flatten(
        jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_data_parallel_lm_step_matches_jax(lm_world, wire):
    toks, params, outs = lm_world
    losses, want = _jax_dp(toks, params, None if wire == "float32"
                           else "bfloat16")
    assert np.all(np.isfinite(losses))
    # the wire rounds the gradients to bfloat16 (8 mantissa bits): a
    # parameter moves by lr * |g| per step, so it may differ by ~2**-8 of
    # that; losses follow the parameters
    tol = 1e-4 if wire == "float32" else 2e-3
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{wire}/losses"], losses, rtol=tol,
                                   err_msg=f"rank {r}")
        got = {k[len(wire) + 5:]: v for k, v in out.items()
               if k.startswith(f"{wire}/var/")}
        assert got.keys() == want.keys()
        for k in want:
            moved = np.abs(want[k] - torch_dist_worker.flatten(params)[k])
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=tol * np.abs(want[k]).max() + tol * moved.max(),
                err_msg=f"{k} on rank {r}")
    # both ranks hold the same parameters
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
