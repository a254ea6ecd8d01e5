"""The port's LARS and warmup-cosine schedule against optax's.

* ``optim.LARS(lr, momentum=0.9)`` against ``optax.lars(lr, momentum=0.9)``
  on the same parameters and gradients (numpy, from a seed): 5 steps, with
  a zero parameter tensor and a zero gradient (the trust ratio's guard),
  at a constant lr and under the schedule; the parameters agree within
  1e-6 relative (the norms are float32 sums taken in another order).
* ``optim.warmup_cosine_decay_schedule`` against optax's at every count
  through warmup, decay and past the end, within 1e-7.
* The optimizer-state helpers of checkpoint/resume: a state restored into
  a fresh optimizer continues bit for bit, and creating the state changes
  no parameter.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu_torch.optim import (
    LARS, init_optimizer_state, load_optimizer_state_tree,
    optimizer_state_tree, warmup_cosine_decay_schedule)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCHEDULES = [(0.0, 0.1, 3, 10), (0.0, 0.4, 1, 2), (0.01, 0.1, 5, 40),
             (0.0, 0.1, 0, 7)]


@pytest.mark.parametrize("init,peak,warmup,decay", SCHEDULES)
def test_schedule_matches_optax(init, peak, warmup, decay):
    ours = warmup_cosine_decay_schedule(init, peak, warmup, decay)
    theirs = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay)
    for count in range(decay + 3):
        want = float(theirs(jnp.asarray(count, jnp.int32)))
        assert abs(ours(count) - want) <= 1e-7, count


def test_schedule_refuses_no_decay():
    with pytest.raises(ValueError, match="decay_steps"):
        warmup_cosine_decay_schedule(0.0, 0.1, 5, 5)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32),
            "z": np.zeros(2, np.float32)}


@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_lars_matches_optax(scheduled, wd):
    lr = warmup_cosine_decay_schedule(0.0, 0.1, 2, 6) if scheduled else 0.1
    params = _tree(0)
    grads = [_tree(s + 1) for s in range(5)]
    grads[1]["b"][:] = 0.0  # a zero gradient
    opt = optax.lars(
        (lambda c: jnp.float32(lr(int(c)))) if scheduled else lr,
        weight_decay=wd, momentum=0.9)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = LARS(list(tp.values()), lr=0.1, weight_decay=wd, momentum=0.9)
    for t, g in enumerate(grads):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        if scheduled:
            for group in topt.param_groups:
                group["lr"] = lr(t)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {t}")
    np.testing.assert_array_equal(tp["z"].detach().numpy(), 0.0)


def test_optimizer_state_round_trip_continues_bit_for_bit():
    def run(restore_at=None, steps=4):
        w = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
        opt = torch.optim.Adam([w], lr=0.1)
        for t in range(steps):
            if t == restore_at:
                tree = optimizer_state_tree(opt)
                kept = w.detach().clone()
                w = torch.nn.Parameter(kept)
                opt = torch.optim.Adam([w], lr=0.1)
                init_optimizer_state(opt)
                assert torch.equal(w.detach(), kept)
                assert optimizer_state_tree(opt).keys() == tree.keys()
                load_optimizer_state_tree(opt, tree)
            w.grad = torch.full((2, 3), 0.3 * (t + 1)) - w.detach()
            opt.step()
        return w.detach()

    torch.testing.assert_close(run(restore_at=2), run(), rtol=0, atol=0)


def test_init_optimizer_state_keeps_params_and_grads():
    w = torch.nn.Parameter(torch.ones(3))
    w.grad = torch.full((3,), 2.0)
    opt = LARS([w], lr=0.5)
    init_optimizer_state(opt)
    assert torch.equal(w.detach(), torch.ones(3))
    assert torch.equal(w.grad, torch.full((3,), 2.0))
    assert opt.param_groups[0]["lr"] == 0.5
    assert set(optimizer_state_tree(opt)["0"]) == {"trace"}
