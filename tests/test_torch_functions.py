"""The port's differentiable collectives against the JAX package's, on the CPU.

``chainermn_tpu_torch.functions`` on gloo worlds of 2 and 4 processes
(``tests/torch_dist_worker.py`` mode ``seq``) against
``chainermn_tpu.functions`` under ``run_spmd`` on a CPU mesh of the same
size, from the same numpy-seeded inputs: each collective's value and the
gradient of ``sum(w * y)`` (rank-varying ``w``) with respect to this rank's
input.  ``allreduce`` is held to the documented contract of the JAX file
(``:66-81``: the identity of the cotangent, over ``size`` for ``"mean"``),
not to the live JAX gradient, which that contract's own test shows is
``size`` times too large on this jax (ROADMAP.md Queue C1).  Values and
gradients are sums of at most four float32 products: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker
from chainermn_tpu import functions as F
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu.parallel.topology import init_topology
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-6


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    rng = np.random.RandomState(20 + n)
    x = rng.randn(n, n, 3).astype(np.float32)
    w = rng.randn(n, n, n, 3).astype(np.float32)
    outs = torch_dist_worker.launch(
        "seq", {"coll/x": x, "coll/w": w}, n,
        tmp_path_factory.mktemp(f"functions{n}"))
    comm = jcreate("xla", mesh=init_topology(
        devices=jax.devices()[:n]).mesh)
    return n, x, w, outs, comm


def _jax(comm, fn, x, w):
    """Per-rank value and gradient of ``sum(w * fn(x))`` under run_spmd."""
    def per_rank(xx, ww):
        return fn(xx), jax.grad(lambda a: jnp.sum(ww * fn(a)))(xx)

    y, g = comm.run_spmd(per_rank, jnp.asarray(x), jnp.asarray(w))
    return np.asarray(y), np.asarray(g)


def _cases(comm, n):
    """name -> (JAX function, which x, which w) as the worker runs them."""
    ring = [(i, (i + 1) % n) for i in range(n)]
    return {
        "allgather": (lambda v: F.allgather(comm, v), 0, 0),
        "gather": (lambda v: F.gather(comm, v, root=1), 0, 0),
        "alltoall": (lambda v: F.alltoall(comm, v), None, 0),
        "bcast": (lambda v: F.bcast(comm, v, root=1), 0, (0, 0)),
        "scatter": (lambda v: F.scatter(comm, v, root=n - 1), None, (0, 0)),
        "send_recv_ring": (lambda v: F.spmd_send_recv(v, comm, ring), 0,
                           (0, 0)),
        "send_recv_one": (lambda v: F.spmd_send_recv(v, comm, [(0, n - 1)]),
                          0, (0, 0)),
        "send_recv_async_pair": (
            lambda v: F.spmd_send_recv(v, comm, ring)
            + 2.0 * F.spmd_send_recv(v * v, comm, ring) + jnp.sin(v),
            0, (0, 0)),
    }


def _take(a, idx):
    if idx is None:
        return a
    idx = idx if isinstance(idx, tuple) else (idx,)
    return a[(slice(None),) + idx]


@pytest.mark.parametrize("name", ["allgather", "gather", "alltoall", "bcast",
                                  "scatter", "send_recv_ring",
                                  "send_recv_one", "send_recv_async_pair"])
def test_collective_and_its_backward_match_jax(world, name):
    n, x, w, outs, comm = world
    fn, xi, wi = _cases(comm, n)[name]
    y, g = _jax(comm, fn, _take(x, xi), _take(w, wi))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"coll/{name}/y"], y[r], rtol=RTOL,
                                   err_msg=f"{name} value, rank {r}")
        np.testing.assert_allclose(out[f"coll/{name}/g"], g[r], rtol=RTOL,
                                   atol=1e-6, err_msg=f"{name} grad, rank {r}")


def test_backward_contracts_by_hand(world):
    """The transposes written out: allgather/gather reduce-scatter, bcast
    sums onto the root, scatter gathers onto the root."""
    n, x, w, outs, _ = world
    for r, out in enumerate(outs):
        want = w[:, 0, r].sum(0)  # sum over ranks q of w_q's slot r
        for name in ("allgather", "gather"):
            np.testing.assert_allclose(out[f"coll/{name}/g"], want,
                                       rtol=1e-5, atol=1e-6)
        bc = w[:, 0, 0].sum(0) if r == 1 else np.zeros(3, np.float32)
        np.testing.assert_allclose(out["coll/bcast/g"], bc, rtol=1e-5,
                                   atol=1e-6)
        sc = w[:, 0, 0] if r == n - 1 else np.zeros((n, 3), np.float32)
        np.testing.assert_allclose(out["coll/scatter/g"], sc, rtol=RTOL)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_allreduce_backward_is_the_documented_identity(world, op):
    n, x, w, outs, comm = world
    # the value only: JAX's custom_vjp cannot be differentiated inside
    # run_spmd on this jax (its varying axes do not match)
    y = np.asarray(comm.run_spmd(lambda v: F.allreduce(comm, v, op),
                                 jnp.asarray(x[:, 0])))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"coll/allreduce_{op}/y"], y[r],
                                   rtol=RTOL)
        want = w[r, 0, 0] / (n if op == "mean" else 1)
        np.testing.assert_allclose(out[f"coll/allreduce_{op}/g"], want,
                                   rtol=RTOL)
        np.testing.assert_allclose(out["coll/allreduce_max"],
                                   x[:, 0].max(0), rtol=0)
