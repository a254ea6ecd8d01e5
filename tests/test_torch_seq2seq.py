"""The port's seq2seq model and example against the JAX package's.

* The encoder (ragged ``lengths``) and the decoder against the flax modules
  from the same weights (``weights.load_flax_variables``): the carry, the
  logits and every parameter gradient within a relative L2 error of 1e-5
  (float32: the LSTM's sums run in another order), and greedy ``decode``
  tokens equal for the seeded case.
* The example's composition on a world of one against the JAX example's
  (``examples/seq2seq/seq2seq.py:129-168``: the chain, the masked loss and
  token accuracy, the per-stage optimizer) on the same bucketed batches,
  from the same weights, with Adam at lr 1e-3 (ROADMAP.md Queue C 7):
  every step's loss and accuracy within 1e-4 relative.
* The twin of ``tests/test_multicontroller.py::
  test_seq2seq_example_two_controllers`` (``:661``) on a 2-process gloo
  world (``tests/torch_dist_worker.py``, mode ``seq2seq``): ``final:`` and
  ``val_bleu`` on rank 1 only, and rank 1's losses equal to the world-of-one
  run's (a transfer copies bits).
"""

import functools
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
from chainermn_tpu.datasets import nmt as jnmt
from chainermn_tpu.links import MultiNodeChainList as JChain
from chainermn_tpu.models import seq2seq as jseq
from chainermn_tpu.optimizers import create_per_stage_optimizer as jpso
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.examples import seq2seq as example
from chainermn_tpu_torch.models import seq2seq as tseq
from chainermn_tpu_torch.optimizers import create_per_stage_optimizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V_SRC, V_TGT, E, H = 13, 11, 8, 16


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _grads_as_torch(grads, module):
    """A flax gradient tree in the port's ``state_dict`` layout (the frozen
    zero ``bias_ih_l0`` has no gradient)."""
    sd = weights.flax_to_state_dict(grads, module)
    return {k: v for k, v in sd.items() if not k.endswith("bias_ih_l0")}


def _torch_grads(module):
    return {k: p.grad for k, p in module.named_parameters()
            if p.requires_grad}


@pytest.fixture(scope="module")
def ragged():
    rng = np.random.RandomState(0)
    src = rng.randint(2, V_SRC, size=(5, 7)).astype(np.int32)
    lengths = np.asarray([7, 3, 5, 1, 6], np.int32)
    src[np.arange(7)[None] >= lengths[:, None]] = 0
    tgt_in = rng.randint(1, V_TGT, size=(5, 6)).astype(np.int32)
    return src, lengths, tgt_in


def test_encoder_ragged_matches_flax(ragged):
    src, lengths, _ = ragged
    jenc = jseq.Seq2SeqEncoder(V_SRC, E, H)
    var = jenc.init(jax.random.key(0), src, lengths)
    w = np.random.RandomState(1).randn(2, 5, H).astype(np.float32)

    def loss(v):
        c, h = jenc.apply(v, src, lengths)
        return jnp.sum(c * w[0]) + jnp.sum(h * w[1]), (c, h)

    (_, (jc, jh)), jg = jax.value_and_grad(loss, has_aux=True)(var)
    enc = weights.load_flax_variables(tseq.Seq2SeqEncoder(V_SRC, E, H), var)
    c, h = enc(torch.from_numpy(src).long(), torch.from_numpy(lengths))
    ((c * torch.from_numpy(w[0])).sum()
     + (h * torch.from_numpy(w[1])).sum()).backward()
    assert _rel(c.detach(), jc) <= 1e-5 and _rel(h.detach(), jh) <= 1e-5
    want = _grads_as_torch(jg, enc)
    got = _torch_grads(enc)
    assert sorted(got) == sorted(want)
    for k in got:
        assert _rel(got[k], want[k]) <= 1e-5, k
    # the carry is the state at each sentence's last real token: the same
    # sentence cut at its length gives the same carry
    c1, h1 = enc(torch.from_numpy(src[1:2, :3]).long())
    assert torch.allclose(c1[0], c[1], rtol=1e-6, atol=1e-7)


def test_decoder_and_decode_match_flax(ragged):
    src, lengths, tgt_in = ragged
    jdec = jseq.Seq2SeqDecoder(V_TGT, E, H)
    rng = np.random.RandomState(2)
    carry = tuple(rng.randn(5, H).astype(np.float32) for _ in range(2))
    var = jdec.init(jax.random.key(3), carry, tgt_in)
    g = rng.randn(5, 6, V_TGT).astype(np.float32)
    jlogits = jdec.apply(var, carry, tgt_in)
    jg, jgc = jax.grad(lambda v, cc: jnp.sum(jdec.apply(v, cc, tgt_in) * g),
                       argnums=(0, 1))(var, carry)
    dec = weights.load_flax_variables(tseq.Seq2SeqDecoder(V_TGT, E, H), var)
    tc = tuple(torch.from_numpy(a).requires_grad_(True) for a in carry)
    logits = dec(tc, torch.from_numpy(tgt_in).long())
    (logits * torch.from_numpy(g)).sum().backward()
    assert _rel(logits.detach(), jlogits) <= 1e-5
    for a, b in zip(tc, jgc):
        assert _rel(a.grad, b) <= 1e-5
    want, got = _grads_as_torch(jg, dec), _torch_grads(dec)
    assert sorted(got) == sorted(want)
    for k in got:
        assert _rel(got[k], want[k]) <= 1e-5, k
    jt = jdec.apply(var, carry, 9, method="decode", bos_id=jnmt.BOS_ID)
    with torch.no_grad():
        tt = dec.decode(tuple(torch.from_numpy(a) for a in carry), 9,
                        bos_id=jnmt.BOS_ID)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_weights_round_trip():
    gen = torch.Generator().manual_seed(0)
    for m in (tseq.Seq2SeqEncoder(V_SRC, E, H, generator=gen),
              tseq.Seq2SeqDecoder(V_TGT, E, H, generator=gen)):
        back = weights.flax_to_state_dict(weights.state_dict_to_flax(m), m)
        for k, v in m.state_dict().items():
            assert torch.equal(back[k], v), k
        assert not m.lstm.bias_ih_l0.requires_grad
        assert not m.lstm.bias_ih_l0.any()


@pytest.mark.parametrize("cls", [tseq.Seq2SeqEncoder, tseq.Seq2SeqDecoder])
def test_init_does_not_depend_on_the_thread_count(cls):
    # torchrun gives each of several ranks one thread: a seed's weights
    # must be those of a one-process run with many (LAPACK's QR, behind
    # the orthogonal hidden kernels, rounds by its thread count)
    threads = torch.get_num_threads()
    try:
        sds = []
        for n in (1, 4):
            torch.set_num_threads(n)
            sds.append(cls(V_SRC, E, 64, generator=torch.Generator()
                           .manual_seed(0)).state_dict())
    finally:
        torch.set_num_threads(threads)
    for k in sds[0]:
        assert torch.equal(sds[0][k], sds[1][k]), k


def test_copy_reverse_task_matches_jax():
    for a, b in zip(tseq.make_copy_reverse_task(6, 5, 9, seed=4),
                    jseq.make_copy_reverse_task(6, 5, 9, seed=4)):
        np.testing.assert_array_equal(a, b)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_seq2seq_example",
        os.path.join(REPO, "examples", "seq2seq", "seq2seq.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_pairs_match_jax():
    assert example.synthetic_pairs(50, 9, 30, seed=2) == \
        _jax_example().synthetic_pairs(50, 9, 30, seed=2)


ARGV = ["--n-train", "256", "--batchsize", "32", "--hidden", "24",
        "--embed-dim", "16", "--seq-len", "6", "--vocab", "8",
        "--bucket-step", "2", "--seed", "0"]


def test_example_matches_jax_composition():
    args = example.parse_args(ARGV + ["--device", "cpu"])
    train, _, sv, tv = example.load_data(args)
    batches = list(jnmt.bucket_batches(train, args.batchsize,
                                       step=args.bucket_step, seed=0))
    assert len(batches) >= 4
    # the JAX example's composition (its lines 129-168), Adam at 1e-3
    jm = JChain(jcreate("naive"))
    jm.add_link(jseq.Seq2SeqEncoder(len(sv), args.embed_dim, args.hidden),
                rank_in=None, rank_out=1)
    jm.add_link(jseq.Seq2SeqDecoder(len(tv), args.embed_dim, args.hidden),
                rank_in=0, rank_out=None)
    b0 = batches[0]
    params = jm.init(jax.random.key(0), b0["src"],
                     stage_inputs={0: (b0["src_len"],), 1: (b0["tgt_in"],)})
    init = jax.device_get(list(params))
    opt = jpso(optax.adam(1e-3))
    state = opt.init(params)

    def loss_fn(ps, b):
        out = jm.apply(ps, b["src"], stage_inputs={0: (b["src_len"],),
                                                   1: (b["tgt_in"],)})
        ce = optax.softmax_cross_entropy_with_integer_labels(out,
                                                             b["tgt_out"])
        denom = jnp.maximum(b["mask"].sum(), 1.0)
        acc = ((out.argmax(-1) == b["tgt_out"]) * b["mask"]).sum() / denom
        return (ce * b["mask"]).sum() / denom, acc

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    want = []
    for b in batches:
        (loss, acc), g = grad_fn(params, b)
        params, state = opt.update(g, state, params)
        want.append((float(loss), float(acc)))

    from chainermn_tpu_torch import create_communicator
    model = example.build_model(create_communicator("naive", device="cpu"),
                                len(sv), len(tv), args.embed_dim,
                                args.hidden)
    for s, var in enumerate(init):
        weights.load_flax_variables(model.stage(s), var)
    topt = create_per_stage_optimizer(
        functools.partial(torch.optim.Adam, lr=1e-3))
    topt.init(model)
    got = [(r["loss"], r["acc"])
           for r in example.train_steps(model, topt, batches)]
    assert len(got) == len(want)
    for (gl, ga), (wl, wa) in zip(got, want):
        assert gl == pytest.approx(wl, rel=1e-4)
        assert ga == pytest.approx(wa, rel=1e-4)
    assert got[-1][0] < got[0][0]


def test_example_two_processes(tmp_path):
    argv = ARGV + ["--epoch", "2", "--device", "cpu"]
    outs = torch_dist_worker.launch("seq2seq", {"argv": " ".join(argv)}, 2,
                                    tmp_path)
    out0, out1 = (str(o["stdout"]) for o in outs)
    assert "final:" in out1 and "val_bleu" in out1, out1
    assert "final:" not in out0 and "val_bleu" not in out0
    assert not bool(outs[0]["owns_output"]) and bool(outs[1]["owns_output"])
    assert all(l == 0.0 for l in outs[0]["losses"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers' setting: the same sums
    try:
        one = example.main(argv)
    finally:
        torch.set_num_threads(threads)
    assert one["world"] == 1 and one["final"] is not None
    assert list(outs[1]["losses"]) == one["losses"]
