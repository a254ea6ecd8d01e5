"""Parameters that one rank's backward never reaches, against the JAX step.

A 2-process gloo world trains four parameters with SGD momentum 0.9 for
3 steps through the ``naive``, ``flat`` and ``xla`` communicators, with
the plain and the double-buffered multi-node optimizer: ``w`` is used by
every rank at every step, ``a`` only by rank 0 (rank 1 skips that branch,
so its ``a.grad`` stays None), ``c`` by both ranks at step 0 and by no
rank afterwards, ``z`` never.  A parameter without a gradient counts as
zeros, as its JAX gradient is: every rank issues the same collectives (no
worker hangs or dies), and the inner step moves ``c`` on momentum after
its last use, as optax does.  The same world also reduces one backward
through ``MeshCommunicator.allreduce_grad(module)`` with ``a`` unused on
rank 1: both ranks end with the mean of their gradients, zeros for
rank 1's ``a``.  The JAX reference is
``chainermn_tpu.optimizers.make_train_step`` on a 2-device CPU mesh, where
each branch enters the loss through ``jnp.where`` on the rank's flag.
Same numpy-seeded weights and data, float32; losses and parameters agree
at rtol 1e-5, atol 1e-7 (the two frameworks sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist_worker
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.optimizers import (
    create_multi_node_optimizer as jmno, init_opt_state, make_train_step as
    jstep)
from chainermn_tpu.parallel.topology import init_topology
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD, STEPS, LOCAL_B, LR = 2, 3, 4, 0.1
RTOL, ATOL = 1e-5, 1e-7
FLAVORS = ("naive", "flat", "xla")
# use[step, rank] = (branch a, branch c)
USE = np.array([[[1, 1], [0, 1]],
                [[1, 0], [0, 0]],
                [[1, 0], [0, 0]]], dtype=np.int32)


@pytest.fixture(scope="module")
def unused_world(tmp_path_factory):
    rng = np.random.RandomState(11)
    params = {"w": rng.randn(4, 3), "a": rng.randn(3), "c": rng.randn(3),
              "z": rng.randn(3)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.randn(STEPS, WORLD, LOCAL_B, 4).astype(np.float32)
    inputs = {f"p/{k}": v for k, v in params.items()}
    inputs.update(x=x, use=USE, lr=np.float32(LR))
    outs = torch_dist_worker.launch("unused", inputs, WORLD,
                                    tmp_path_factory.mktemp("unused"),
                                    timeout=240)
    return params, x, outs


def _jax_run(flavor, db, params, x):
    comm = jcreate(flavor, mesh=init_topology(
        devices=jax.devices()[:WORLD]).mesh)
    opt = jmno(optax.sgd(LR, momentum=0.9), comm, double_buffering=db)

    def loss_fn(p, batch):
        xb, use = batch  # this rank's rows and its [1, 2] flags
        h = xb @ p["w"]
        loss = jnp.mean(h ** 2)
        loss = loss + jnp.where(use[0, 0] > 0,
                                jnp.mean(jnp.tanh(h) * p["a"]), 0.0)
        return loss + jnp.where(use[0, 1] > 0,
                                0.1 * jnp.sum(jnp.tanh(h) * p["c"]), 0.0)

    step = jstep(comm, loss_fn, opt, donate=False)
    p = comm.bcast_data({k: jnp.asarray(v) for k, v in params.items()})
    state = init_opt_state(comm, opt, p)
    losses, after = [], {k: [] for k in params}
    for xs, use in zip(x, USE):
        p, state, loss = step(p, state, (jnp.asarray(xs.reshape(-1, 4)),
                                         jnp.asarray(use)))
        losses.append(float(loss))
        for k in params:
            after[k].append(np.asarray(p[k]))
    return np.asarray(losses), {k: np.stack(v) for k, v in after.items()}


@pytest.mark.parametrize("db", [False, True], ids=["plain", "double"])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_unused_parameters_match_jax(unused_world, flavor, db):
    params, x, outs = unused_world
    losses, after = _jax_run(flavor, db, params, x)
    assert np.all(np.isfinite(losses))
    cfg = f"{flavor}_db{int(db)}"
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{cfg}/losses"], losses, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{cfg} rank {r}")
        for k, want in after.items():
            np.testing.assert_allclose(out[f"{cfg}/{k}"], want, rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{cfg} {k} on rank {r}")


def test_the_case_exercises_what_it_claims(unused_world):
    """``c`` moves on momentum alone after its last use, and ``z`` (never
    used) stays where it started: the zeros went through the inner
    step."""
    params, _, outs = unused_world
    for db in (False, True):
        cfg = f"xla_db{int(db)}"
        c = outs[0][f"{cfg}/c"]
        assert not np.array_equal(c[-2], c[-1]), cfg
        np.testing.assert_array_equal(outs[0][f"{cfg}/z"][-1], params["z"])
        # both ranks hold the same parameters
        for k in params:
            np.testing.assert_array_equal(outs[0][f"{cfg}/{k}"],
                                          outs[1][f"{cfg}/{k}"])


@pytest.mark.parametrize("flavor", FLAVORS)
def test_module_allreduce_grad_counts_a_missing_grad_as_zeros(
        unused_world, flavor):
    """``comm.allreduce_grad(module)`` where rank 1's backward never
    reaches ``a``: no rank hangs, both hold the same ``.grad``, and it is
    the mean of rank 0's gradient and rank 1's zeros."""
    _, _, outs = unused_world
    key = f"module_{flavor}"
    np.testing.assert_array_equal(outs[0][f"{key}/none"], [False, False])
    np.testing.assert_array_equal(outs[1][f"{key}/none"], [False, True])
    np.testing.assert_array_equal(outs[1][f"{key}/local/a"], 0.0)
    assert np.any(outs[0][f"{key}/local/a"] != 0.0)
    for n in ("w", "a"):
        want = (outs[0][f"{key}/local/{n}"]
                + outs[1][f"{key}/local/{n}"]) / WORLD
        for r, out in enumerate(outs):
            np.testing.assert_allclose(out[f"{key}/{n}"], want, rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{key} {n} on rank {r}")
        np.testing.assert_array_equal(outs[0][f"{key}/{n}"],
                                      outs[1][f"{key}/{n}"])
