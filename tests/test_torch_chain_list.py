"""The port's ``MultiNodeChainList`` against the JAX package's.

Twins of ``tests/test_links.py`` on a world of one (every stage in this
process, the in-process channel): forward, placement, multi-output, stage
inputs, ``traced`` against the call, gradients against the direct
composition (bit for bit: the channel copies nothing) and against JAX's
from the same weights (1e-5 relative, float32), the seq2seq carry learning
across the boundary, and the ``process=`` pin checks.  Then the twins of
``tests/test_multicontroller.py::test_two_controller_model_parallel_training``
(``:153``), ``::test_two_controller_explicit_stage_placement`` and
``::test_four_controller_chain_fanin_repeated_pairs`` (``:592``) on gloo
worlds of 2 and 4 processes (``tests/torch_dist_worker.py``, mode
``chain``): stages carried over from the flax inits, SGD 0.1, and the exit
stage owner's losses within 2e-4 relative of the JAX single-controller
composition run here, as the JAX tests hold theirs.  The order check that
stands in for NCCL's missing tags is held on a stub communicator.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.links import MultiNodeChainList as JChain
from chainermn_tpu_torch import create_communicator
from chainermn_tpu_torch.links import MultiNodeChainList, pseudo_loss
from chainermn_tpu_torch.optimizers import create_per_stage_optimizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


class Dense(nn.Module):
    features: int
    tanh: bool = True
    scales: tuple = ()

    @nn.compact
    def __call__(self, *xs):
        h = xs[0] if not self.scales else jnp.concatenate(
            [x * s if s != 1 else x for x, s in zip(xs, self.scales)], -1)
        y = nn.Dense(self.features)(h)
        return nn.tanh(y) if self.tanh else y


class Plus(nn.Module):
    @nn.compact
    def __call__(self, h, extra):
        return nn.Dense(4)(h) + extra


class TorchPlus(torch.nn.Module):
    def __init__(self, lin):
        super().__init__()
        self.lin = lin

    def forward(self, h, extra):
        return self.lin(h) + extra


def _torch_stage(variables, tanh=True, scales=None):
    p = variables["params"]
    p = p[next(iter(p))]  # the one Dense
    return torch_dist_worker.ChainStage(np.asarray(p["kernel"]),
                                        np.asarray(p["bias"]), tanh, scales)


# (flax stage, rank_in, rank_out, process pin) of each chain
TWO = [(Dense(16), None, 1, None), (Dense(4, False), 0, None, None)]
PLACED = [(Dense(16), None, 1, 0), (Dense(16), 0, 2, 0),
          (Dense(4, False), 1, None, 1)]
FANIN = [(Dense(12), None, [1, 2, 2], None), (Dense(12), 0, 2, None),
         (Dense(12, True, (1, 2, 1)), [0, 0, 1], 3, None),
         (Dense(4, False), 2, None, None)]


def _jax_chain(stages, x, y, steps, lr=0.1):
    """The chain in one JAX controller: its init (host numpy) and the
    losses of ``steps`` SGD steps, as the JAX tests' references run it."""
    model = JChain(jcreate("naive"))
    for mod, rin, rout, _ in stages:
        model.add_link(mod, rank_in=rin, rank_out=rout)
    params = model.init(jax.random.key(0), x)
    init = jax.device_get(list(params))
    opt = optax.sgd(lr)
    state = opt.init(params)

    def loss_fn(ps):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(ps, x), y).mean()

    losses = []
    for _ in range(steps):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return init, losses


def _chain_inputs(name, stages, init, x, y, steps, lr=0.1):
    """The worker's inputs describing one chain, under ``{name}/``."""
    inp = {"n_stages": np.asarray(len(stages)), "x": x, "y": y,
           "steps": np.asarray(steps), "lr": np.asarray(lr)}

    def ranks(r):
        return np.asarray([-1] if r is None else
                          list(r) if isinstance(r, list) else [r])

    for s, ((mod, rin, rout, pin), var) in enumerate(zip(stages, init)):
        p = var["params"][next(iter(var["params"]))]
        key = f"stage/{s}/"
        inp[key + "kernel"] = np.asarray(p["kernel"])
        inp[key + "bias"] = np.asarray(p["bias"])
        inp[key + "spec"] = np.asarray([int(mod.tanh),
                                        -1 if pin is None else pin])
        inp[key + "rank_in"], inp[key + "rank_out"] = ranks(rin), ranks(rout)
        if mod.scales:
            inp[key + "scales"] = np.asarray(mod.scales, np.float32)
    return {f"{name}/{k}": v for k, v in inp.items()}


@pytest.fixture
def comm():
    return create_communicator("naive", device="cpu")


def _two_stage(comm, init):
    m = MultiNodeChainList(comm)
    m.add_link(_torch_stage(init[0]), rank_in=None, rank_out=1)
    m.add_link(_torch_stage(init[1], tanh=False), rank_in=0, rank_out=None)
    return m


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_init(stages, x, **kw):
    model = JChain(jcreate("naive"))
    for mod, rin, rout, _ in stages:
        model.add_link(mod, rank_in=rin, rank_out=rout)
    return model, model.init(jax.random.key(1), x, **kw)


class TestForward:
    def test_matches_single_process_and_jax(self, comm):
        x = _x((8, 12))
        jm, params = _jax_init(TWO, x)
        init = jax.device_get(list(params))
        m = _two_stage(comm, init)
        y = m(torch.from_numpy(x))
        assert y.shape == (8, 4)
        direct = m.stage(1)(m.stage(0)(torch.from_numpy(x)))
        assert torch.equal(y, direct)
        np.testing.assert_allclose(y.detach().numpy(),
                                   np.asarray(jm.apply(params, x)),
                                   rtol=1e-5, atol=1e-6)

    def test_stage_placement(self, comm):
        m = _two_stage(comm, jax.device_get(list(_jax_init(
            TWO, _x((8, 12)))[1])))
        assert [m.stage_owner(s) for s in range(2)] == [0, 0]
        assert m.is_local_stage(0) and m.is_local_stage(1) and m.owns_output
        assert all(p.device == comm.device for p in m.parameters())
        x = torch.ones(2, 3, dtype=torch.float64)
        placed = m.place_activation((x, np.ones(2)), 1)
        assert placed[0].device == comm.device
        assert torch.equal(placed[1], torch.ones(2, dtype=torch.float64))

    def test_multi_output(self, comm):
        x = _x((12, 12))
        stages = [(Dense(16), None, [1, 2], None),
                  (Dense(4, False), 0, None, None),
                  (Dense(4, False), 0, None, None)]
        jm, params = _jax_init(stages, x)
        init = jax.device_get(list(params))
        m = MultiNodeChainList(comm)
        for (mod, rin, rout, _), v in zip(stages, init):
            m.add_link(_torch_stage(v, mod.tanh), rank_in=rin, rank_out=rout)
        y1, y2 = m(torch.from_numpy(x))
        assert y1.shape == y2.shape == (12, 4)
        for got, want in zip((y1, y2), jm.apply(params, x)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)

    def test_stage_extra_inputs(self, comm):
        x = np.ones((4, 12), np.float32)
        extra = np.full((4, 4), 10.0, np.float32)
        jm = JChain(jcreate("naive"))
        jm.add_link(Dense(16), rank_in=None, rank_out=1)
        jm.add_link(Plus(), rank_in=0, rank_out=None)
        params = jm.init(jax.random.key(0), x, stage_inputs={1: (extra,)})
        init = jax.device_get(list(params))
        m = MultiNodeChainList(comm)
        m.add_link(_torch_stage(init[0]), rank_in=None, rank_out=1)
        m.add_link(TorchPlus(_torch_stage(init[1], tanh=False).lin),
                   rank_in=0, rank_out=None)
        y = m(torch.from_numpy(x), stage_inputs={1: (torch.from_numpy(extra),)})
        np.testing.assert_allclose(
            y.detach().numpy(),
            np.asarray(jm.apply(params, x, stage_inputs={1: (extra,)})),
            rtol=1e-5)

    def test_unconsumed_send_raises(self, comm):
        m = MultiNodeChainList(comm)
        m.add_link(torch.nn.Linear(3, 3), rank_in=None, rank_out=[1, 1])
        m.add_link(torch.nn.Linear(3, 3), rank_in=0, rank_out=None)
        with pytest.raises(RuntimeError, match="unconsumed sends"):
            m(torch.ones(2, 3))


class TestTraced:
    def test_traced_matches_call_forward_and_grads(self, comm):
        x, t = _x((8, 12)), _x((8, 4), 1)
        init = jax.device_get(list(_jax_init(TWO, x)[1]))
        m = _two_stage(comm, init)
        fn = m.traced()
        xt, tt = torch.from_numpy(x), torch.from_numpy(t)
        grads = []
        for f in (fn, m):
            for p in m.parameters():
                p.grad = None
            ((f(xt) - tt) ** 2).mean().backward()
            grads.append([p.grad.clone() for p in m.parameters()])
        assert torch.equal(fn(xt), m(xt))
        for a, b in zip(*grads):
            assert torch.equal(a, b)

    def test_traced_supports_stage_inputs(self, comm):
        m = MultiNodeChainList(comm)
        m.add_link(torch.nn.Linear(12, 16), rank_in=None, rank_out=1)
        m.add_link(TorchPlus(torch.nn.Linear(16, 4)), rank_in=0,
                   rank_out=None)
        x, extra = torch.ones(4, 12), torch.full((4, 4), 10.0)
        assert torch.equal(m.traced()(x, stage_inputs={1: (extra,)}),
                           m(x, stage_inputs={1: (extra,)}))

    def test_traced_refuses_several_ranks(self):
        m = MultiNodeChainList(_Stub(2, 0))
        with pytest.raises(ValueError, match="single-process"):
            m.traced()


class TestBackward:
    def test_grads_match_single_process_and_jax(self, comm):
        x, t = _x((8, 12)), _x((8, 4), 1)
        jm, params = _jax_init(TWO, x)
        init = jax.device_get(list(params))
        m = _two_stage(comm, init)
        xt, tt = torch.from_numpy(x), torch.from_numpy(t)
        ((m(xt) - tt) ** 2).mean().backward()
        split = [p.grad.clone() for p in m.parameters()]
        for p in m.parameters():
            p.grad = None
        ((m.stage(1)(m.stage(0)(xt)) - tt) ** 2).mean().backward()
        for a, p in zip(split, m.parameters()):
            assert torch.equal(a, p.grad)
        g = jax.grad(lambda ps: jnp.mean((jm.apply(ps, x) - t) ** 2))(params)
        want = []
        for gs in jax.device_get(g):
            d = gs["params"][next(iter(gs["params"]))]
            want += [np.asarray(d["kernel"]).T, np.asarray(d["bias"])]
        for a, w in zip(split, want):
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-7)

    def test_training_through_pipeline(self, comm):
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(32, 12).astype(np.float32))
        t = torch.tanh(x) @ torch.from_numpy(
            rng.randn(12, 4).astype(np.float32))
        torch.manual_seed(2)
        m = MultiNodeChainList(comm)
        m.add_link(torch.nn.Sequential(torch.nn.Linear(12, 16),
                                       torch.nn.Tanh()),
                   rank_in=None, rank_out=1)
        m.add_link(torch.nn.Linear(16, 4), rank_in=0, rank_out=None)
        opt = create_per_stage_optimizer(
            functools.partial(torch.optim.Adam, lr=1e-2))
        opt.init(m)
        losses = []
        for _ in range(60):
            opt.zero_grad()
            loss = ((m(x) - t) ** 2).mean()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        assert losses[-1] < 0.1 * losses[0]

    def test_per_stage_optimizer_stage_count(self, comm):
        m = MultiNodeChainList(comm)
        m.add_link(torch.nn.Linear(3, 3), rank_in=None, rank_out=None)
        opt = create_per_stage_optimizer(
            functools.partial(torch.optim.SGD, lr=0.1))
        assert len(opt.init(m)) == 1
        m.add_link(torch.nn.Linear(3, 3), rank_in=None, rank_out=None)
        with pytest.raises(ValueError, match="stage count mismatch"):
            opt.step()


class TestSeq2Seq:
    def test_cross_stage_carry_learns(self, comm):
        from chainermn_tpu_torch.models.seq2seq import (
            Seq2SeqDecoder, Seq2SeqEncoder, make_copy_reverse_task)
        vocab, L = 16, 6
        gen = torch.Generator().manual_seed(0)
        m = MultiNodeChainList(comm)
        m.add_link(Seq2SeqEncoder(vocab, 16, 32, generator=gen),
                   rank_in=None, rank_out=1)
        m.add_link(Seq2SeqDecoder(vocab, 16, 32, generator=gen),
                   rank_in=0, rank_out=None)
        src, tgt_in, tgt = (torch.from_numpy(a).long() for a in
                            make_copy_reverse_task(256, L, vocab))
        opt = create_per_stage_optimizer(
            functools.partial(torch.optim.Adam, lr=1e-2))
        opt.init(m)
        losses = []
        for _ in range(60):
            opt.zero_grad()
            logits = m(src, stage_inputs={1: (tgt_in,)})
            loss = torch.nn.functional.cross_entropy(
                logits.flatten(0, 1), tgt.flatten())
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        assert losses[-1] < 0.5 * losses[0]


class _Stub:
    """A communicator of ``size`` ranks seen from ``rank``, for what needs
    no transfer (placement, the order check)."""

    def __init__(self, size, rank):
        self.size, self.rank = size, rank
        self.device = torch.device("cpu")


class TestExplicitPlacement:
    def test_process_pin_out_of_range_rejected(self, comm):
        m = MultiNodeChainList(comm)
        with pytest.raises(ValueError, match="out of range"):
            m.add_link(torch.nn.Linear(3, 4), process=1)

    def test_process_pin_zero_is_noop_single_process(self, comm):
        m = MultiNodeChainList(comm)
        m.add_link(torch.nn.Linear(3, 8), rank_in=None, rank_out=1,
                   process=0)
        m.add_link(torch.nn.Linear(8, 4), rank_in=0, rank_out=None,
                   process=0)
        assert [m.stage_owner(s) for s in range(2)] == [0, 0]
        assert m(torch.ones(4, 3)).shape == (4, 4)

    def test_dangling_stage_reference_rejected(self, comm):
        m = MultiNodeChainList(comm)
        m.add_link(torch.nn.Linear(3, 4), rank_in=None, rank_out=None)
        with pytest.raises(ValueError, match="out of range"):
            m.stage_owner(2)

    def test_pins_override_round_robin_and_factories_build_locally(self):
        built = []

        def factory(s):
            built.append(s)
            return torch.nn.Linear(2, 2)

        m = MultiNodeChainList(_Stub(2, 1))
        m.add_link(functools.partial(factory, 0), rank_in=None, rank_out=1,
                   process=0)
        m.add_link(functools.partial(factory, 1), rank_in=0, rank_out=2,
                   process=0)
        m.add_link(functools.partial(factory, 2), rank_in=1, rank_out=None)
        assert [m.stage_owner(s) for s in range(3)] == [0, 0, 0]
        assert built == [] and m.local_stages == [None, None, None]
        m = MultiNodeChainList(_Stub(2, 1))
        m.add_link(functools.partial(factory, 0), rank_in=None, rank_out=1)
        m.add_link(functools.partial(factory, 1), rank_in=0, rank_out=None)
        assert built == [1] and m.owns_output
        assert m.stage(0) is None and m.stage(1) is not None

    def test_crossing_transfers_rejected_before_any_transfer(self):
        # rank 0 sends 0->3 before 1->2; rank 1 needs 1->2 (stage 2) first
        for rank in (0, 1):
            m = MultiNodeChainList(_Stub(2, rank))
            m.add_link(torch.nn.Linear(2, 2), rank_in=None, rank_out=[1, 3],
                       process=0)
            m.add_link(torch.nn.Linear(2, 2), rank_in=0, rank_out=2,
                       process=0)
            m.add_link(torch.nn.Linear(2, 2), rank_in=1, rank_out=3,
                       process=1)
            m.add_link(torch.nn.Linear(2, 2), rank_in=[0, 2],
                       rank_out=None, process=1)
            with pytest.raises(RuntimeError, match="different orders"):
                m(torch.ones(1, 2))

    def test_fanin_order_is_consistent(self):
        for rank in range(4):
            m = MultiNodeChainList(_Stub(4, rank))
            for _, rin, rout, _ in FANIN:
                m.add_link(lambda: None, rank_in=rin, rank_out=rout)
            m._check_order()


def test_pseudo_loss_without_a_stage_still_backpropagates():
    loss = pseudo_loss(None)
    loss.backward()
    assert float(loss.detach()) == 0.0


# -- several processes ------------------------------------------------------

# name -> (chain, steps, batch) of the twins, as the JAX tests run them
MP_CASES = {"two": (TWO, 6, 32), "placed": (PLACED, 5, 24),
            "fanin": (FANIN, 5, 16)}


def _mp_world(names, world, tmp_path_factory):
    """The JAX references of the chains ``names`` and one ``world``-rank
    launch that trains them all: ``{name: (reference losses, outputs by
    rank)}``."""
    inputs, refs = {"chains": np.asarray(",".join(names))}, {}
    for name in names:
        stages, steps, n = MP_CASES[name]
        rng = np.random.RandomState(0)
        x = rng.randn(n, 8).astype(np.float32)
        y = (rng.rand(n) * 4).astype(np.int32)
        init, refs[name] = _jax_chain(stages, x, y, steps)
        inputs.update(_chain_inputs(name, stages, init, x,
                                    y.astype(np.int64), steps))
    outs = torch_dist_worker.launch("chain", inputs, world,
                                    tmp_path_factory.mktemp("chain"))
    return {name: (refs[name], [{k[len(name) + 1:]: v for k, v in o.items()
                                 if k.startswith(name + "/")} for o in outs])
            for name in names}


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    return _mp_world(["two", "placed"], 2, tmp_path_factory)


def test_two_process_model_parallel_training(two_process):
    ref, outs = two_process["two"]
    assert not bool(outs[0]["owns_output"]) and bool(outs[1]["owns_output"])
    assert list(outs[0]["owners"]) == [0, 1]
    # rank 0 sees the pseudo-loss (0.0): its backward ran all the same
    assert all(l == 0.0 for l in outs[0]["losses"])
    losses = list(outs[1]["losses"])
    assert losses == pytest.approx(ref, rel=2e-4)
    assert losses[-1] < losses[0]


def test_two_process_explicit_stage_placement(two_process):
    ref, outs = two_process["placed"]
    for r in range(2):
        assert list(outs[r]["owners"]) == [0, 0, 1]
    assert int(outs[0]["n_local"]) == 2 and int(outs[1]["n_local"]) == 1
    assert list(outs[1]["losses"]) == pytest.approx(ref, rel=2e-4)


def test_four_process_chain_fanin_repeated_pairs(tmp_path_factory):
    ref, outs = _mp_world(["fanin"], 4, tmp_path_factory)["fanin"]
    for r in range(4):
        assert list(outs[r]["owners"]) == [0, 1, 2, 3]
        assert bool(outs[r]["owns_output"]) is (r == 3)
    losses = list(outs[3]["losses"])
    assert losses == pytest.approx(ref, rel=2e-4)
    assert losses[-1] < losses[0]
