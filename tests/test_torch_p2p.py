"""The port's point-to-point functions: the in-process channel and the
transfers between ranks.

Twins of ``tests/test_functions.py::TestP2PChannels`` (the send/recv round
trip, a recv without its send, ``pseudo_connect`` keeping the value and the
gradient), each also run through the JAX functions on the same values.
Then ``cross_send``/``cross_recv`` on a 2-process gloo world
(``tests/torch_dist_worker.py``, mode ``p2p``): a float and an integer leaf
forward, the float leaf's cotangent back, twice on one channel (the second
with the cached handshake), the ``ValueError`` of a changed shape, and the
``RuntimeError`` naming both tags when the receiver expects another tag.
Values and gradients are exact (a transfer copies bits; the gradients are
products of exactly representable numbers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from chainermn_tpu import functions as JF
from chainermn_tpu.communicators import create_communicator as jcreate
from chainermn_tpu_torch import functions as F
from chainermn_tpu_torch.functions import point_to_point_communication as p2p
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


class _Comm:
    """What the in-process channel keeps state on (any object will do)."""


@pytest.fixture
def comm():
    return _Comm()


class TestP2PChannels:
    def test_send_recv_roundtrip(self, comm):
        x = torch.arange(6.0).reshape(2, 3)
        d = F.send(x, comm, rank=1, self_rank=0)
        assert d.shape == (0,)
        y = F.recv(comm, rank=0, self_rank=1)
        assert y is x  # the channel copies nothing
        jc = jcreate("naive")
        JF.send(jnp.asarray(x.numpy()), jc, rank=1, self_rank=0)
        np.testing.assert_array_equal(
            np.asarray(JF.recv(jc, rank=0, self_rank=1)), y.numpy())

    def test_recv_without_send_raises(self, comm):
        with pytest.raises(RuntimeError, match="recv before matching send"):
            F.recv(comm, rank=3, self_rank=0)

    def test_pseudo_connect_preserves_value_and_grad(self, comm):
        x = torch.ones(3, requires_grad=True)
        d = F.send(x * 2, comm, rank=1, self_rank=0)
        y = F.recv(comm, rank=0, self_rank=1, delegate_variable=d)
        val = (y ** 2).sum()
        assert float(val.detach()) == 12.0
        val.backward()
        np.testing.assert_array_equal(x.grad.numpy(), np.full(3, 8.0))

        jc = jcreate("naive")

        def f(xj):
            dj = JF.send(xj * 2, jc, rank=1, self_rank=0)
            return jnp.sum(JF.recv(jc, rank=0, self_rank=1,
                                   delegate_variable=dj) ** 2)

        xj = jnp.ones((3,))
        assert float(f(xj)) == float(val.detach())
        np.testing.assert_array_equal(np.asarray(jax.grad(f)(xj)),
                                      x.grad.numpy())

    def test_pseudo_connect_ties_float_leaves_only(self, comm):
        d = torch.zeros(0, requires_grad=True)
        a = torch.tensor([1.5, -2.0])
        ids = torch.tensor([3, 4])
        ta, tids = F.pseudo_connect(d, a, ids)
        assert torch.equal(ta, a) and ta.grad_fn is not None
        assert tids is ids
        tree = F.pseudo_connect(d, {"a": a, "ids": ids})
        assert torch.equal(tree["a"], a) and tree["ids"] is ids

    def test_delegate_depends_on_every_float_leaf(self, comm):
        a = torch.ones(2, requires_grad=True)
        b = torch.ones(3, requires_grad=True)
        d = F.send((a, torch.tensor([1]), b), comm, rank=1, self_rank=0)
        assert d.shape == (0,) and d.dtype == torch.float32
        F.pseudo_connect(d, torch.ones(1))[0].sum().backward()
        assert torch.equal(a.grad, torch.zeros(2))
        assert torch.equal(b.grad, torch.zeros(3))


def test_handshake_tag_names_the_band():
    # the handshake rides the object plane at the JAX "p2p_meta" band
    from chainermn_tpu.runtime.control_plane import reserved_tag
    assert p2p._META_TAG == reserved_tag("p2p_meta")


@pytest.fixture(scope="module")
def p2p_world(tmp_path_factory):
    rng = np.random.RandomState(0)
    inputs = {"x": rng.randn(4, 3).astype(np.float32),
              "w": rng.randn(4, 3).astype(np.float32),
              "ids": np.arange(5, dtype=np.int64)}
    outs = torch_dist_worker.launch("p2p", inputs, 2,
                                    tmp_path_factory.mktemp("p2p"))
    return inputs, outs


@pytest.mark.parametrize("step,scale", [(0, 2.0), (1, 3.0)])
def test_cross_send_recv_value_and_cotangent(p2p_world, step, scale):
    inputs, (r0, r1) = p2p_world
    np.testing.assert_array_equal(r1[f"y/{step}"], inputs["x"] * scale)
    np.testing.assert_array_equal(r1[f"ids/{step}"], inputs["ids"])
    assert bool(r1[f"y_requires_grad/{step}"])
    assert tuple(r0[f"delegate_shape/{step}"]) == (0,)
    # d/dx sum(w * scale x) = scale w, shipped back from rank 1
    np.testing.assert_array_equal(r0[f"dx/{step}"], inputs["w"] * scale)


def test_cross_send_changed_shape_raises(p2p_world):
    _, (r0, _) = p2p_world
    assert "different payload structure/shape" in str(r0["shape_error"])


def test_cross_recv_other_tag_raises_naming_both(p2p_world):
    _, (_, r1) = p2p_world
    msg = str(r1["tag_error"])
    assert "under tag 6" in msg and "sent under tag 5" in msg
