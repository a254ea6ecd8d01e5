"""``cross_send``/``cross_recv`` and ``MultiNodeChainList`` on NCCL worlds,
on the card.

NCCL moves contiguous device memory only and matches the transfers between
two ranks by the order both ends issue them (it has no tags); the first
transfer between two ranks creates their communicator.  A gloo world (the
CPU tests) hides all three, so these run the same calls on NCCL:

* a world of one: the chain (both stages on the card, the in-process
  channel) equals the direct composition bit for bit, loss and gradients;
* a world of two cards: a float leaf (a non-contiguous view) and an
  integer leaf (on the CPU: the function moves it) forward, the
  cotangent back, twice on one channel; a changed shape raises
  ``ValueError``; a recv under another tag than the send's raises
  ``RuntimeError`` naming both (and does not hang); the two-stage chain's
  SGD losses equal the same stages composed on one card, within 1e-5
  relative (a transfer copies bits: expect equality);
* a world of four cards: also the four-stage fan-in chain with the repeated
  ``(0, 2)`` pair (stage 2 uses its second copy doubled, so cotangents that
  reach the wrong slot change the losses) against its one-card composition,
  and the two-stage chain with ranks 2 and 3 owning no stage.

Every test is marked ``gpu`` and skips without a CUDA card; a world of n
ranks takes one card a rank and skips with fewer.  Run on the card as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_p2p_gpu.py
"""

import functools
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (an NCCL world)")
    return torch.device("cuda")


class Stage(torch.nn.Module):
    """``tanh?(Linear(cat(scale_i * x_i)))``."""

    def __init__(self, n_in, n_out, tanh, scales=None, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.weight = torch.nn.Parameter(
            torch.randn(n_out, n_in, generator=gen) / n_in ** 0.5)
        self.bias = torch.nn.Parameter(torch.randn(n_out, generator=gen)
                                       * 0.1)
        self.tanh, self.scales = tanh, scales

    def forward(self, *xs):
        h = xs[0] if self.scales is None else torch.cat(
            [x * s for x, s in zip(xs, self.scales)], -1)
        y = torch.nn.functional.linear(h, self.weight, self.bias)
        return torch.tanh(y) if self.tanh else y


# (n_in, n_out, tanh, scales, rank_in, rank_out) of each chain's stages
TWO = [(8, 16, True, None, None, 1), (16, 4, False, None, 0, None)]
FANIN = [(8, 12, True, None, None, [1, 2, 2]), (12, 12, True, None, 0, 2),
         (36, 12, True, (1.0, 2.0, 1.0), [0, 0, 1], 3),
         (12, 4, False, None, 2, None)]


def _stages(spec, dev):
    return [Stage(i, o, t, sc, seed=s).to(dev)
            for s, (i, o, t, sc, _, _) in enumerate(spec)]


def _data(dev):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(16, 8, generator=gen).to(dev)
    y = torch.randint(0, 4, (16,), generator=gen).to(dev)
    return x, y


def _train(forward, params, owns, x, y):
    """``STEPS`` SGD 0.1 steps of ``forward``; the losses (0.0 where this
    rank does not own the output) and the last step's gradients."""
    from chainermn_tpu_torch.links import pseudo_loss
    opt = torch.optim.SGD(params, lr=0.1) if params else None
    losses = []
    for _ in range(STEPS):
        for p in params:
            p.grad = None
        out = forward(x)
        loss = torch.nn.functional.cross_entropy(out, y) if owns \
            else pseudo_loss(out)
        loss.backward()
        if opt is not None:
            opt.step()
        losses.append(float(loss.detach()))
    return losses, [p.grad.clone() for p in params]


def _direct(spec, dev):
    """The stages composed on this card (no channel): the reference."""
    st = _stages(spec, dev)
    if spec is TWO:
        def fwd(x):
            return st[1](st[0](x))
    else:
        def fwd(x):
            a = st[0](x)
            return st[3](st[2](a, a, st[1](a)))
    return fwd, [p for s in st for p in s.parameters()]


def _chain(comm, spec, dev):
    from chainermn_tpu_torch.links import MultiNodeChainList
    m = MultiNodeChainList(comm)
    for s, (i, o, t, sc, rin, rout) in enumerate(spec):
        m.add_link(functools.partial(lambda *a: Stage(*a).to(dev), i, o, t,
                                     sc, s), rank_in=rin, rank_out=rout)
    return m


def check_chain(comm, spec):
    """The chain's losses (on the exit stage's owner) and, in a world of
    one, its gradients against the one-card composition."""
    dev = comm.device
    x, y = _data(dev)
    m = _chain(comm, spec, dev)
    got, got_g = _train(m, list(m.parameters()), m.owns_output, x, y)
    if not m.owns_output:
        assert all(l == 0.0 for l in got)
        return
    fwd, params = _direct(spec, dev)
    want, want_g = _train(fwd, params, True, x, y)
    if comm.size == 1:
        assert got == want, (got, want)
        for a, b in zip(got_g, want_g):
            assert torch.equal(a, b)
    else:
        torch.testing.assert_close(torch.tensor(got), torch.tensor(want),
                                   rtol=1e-5, atol=0)
    assert got[-1] < got[0]


def check_p2p(comm):
    """Ranks 0 and 1: the transfers of the module docstring."""
    from chainermn_tpu_torch import functions as F
    from chainermn_tpu_torch.links import pseudo_loss
    dev, rank = comm.device, comm.rank
    gen = torch.Generator().manual_seed(2)
    x, w = (torch.randn(64, 33, generator=gen) for _ in range(2))
    ids = torch.arange(5)
    for scale in (2.0, 3.0):
        if rank == 0:
            xv = x.to(dev, copy=True).requires_grad_(True)
            d = F.cross_send(((xv * scale).t(), ids), comm, 1, tag=3)
            assert d.shape == (0,) and d.device == dev
            pseudo_loss(d).backward()
            assert torch.equal(xv.grad.cpu(), w * scale)
        elif rank == 1:
            yt, got_ids = F.cross_recv(comm, 0, tag=3)
            assert yt.device == dev and got_ids.device == dev
            assert torch.equal(yt.detach().cpu(), (x * scale).t())
            assert torch.equal(got_ids.cpu(), ids)
            (yt * w.t().to(dev)).sum().backward()
    if rank == 0:
        with pytest.raises(ValueError, match="structure/shape"):
            F.cross_send(x[:2].to(dev), comm, 1, tag=3)
        F.cross_send(x.to(dev), comm, 1, tag=5)
    elif rank == 1:
        with pytest.raises(RuntimeError, match="sent under tag 5"):
            F.cross_recv(comm, 0, tag=6)
        # take the transfer that was sent, so that rank 0's send completes
        dist.recv(torch.empty(64, 33, device=dev), 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    comm.barrier()


def check_world():
    """Every check above on this process's NCCL world (initialized here
    from the environment if it is not yet)."""
    from chainermn_tpu_torch import create_communicator
    comm = create_communicator("naive")
    assert dist.get_backend() == "nccl"
    if comm.size >= 2:
        check_p2p(comm)
    check_chain(comm, TWO)
    if comm.size >= 4:
        check_chain(comm, FANIN)
    comm.barrier()


@pytest.mark.gpu
def test_p2p_nccl_world_of_one(cuda):
    created = not dist.is_initialized()
    try:
        check_world()
    finally:
        if created:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"an NCCL world of {n} ranks needs {n} CUDA cards (one "
                    "a rank)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
                                  f"{log[-4000:]}"


@pytest.mark.gpu
def test_p2p_nccl_world_of_two(cuda):
    _world(2)


@pytest.mark.gpu
def test_p2p_nccl_world_of_four(cuda):
    _world(4)


if __name__ == "__main__":
    # one rank of a world above
    check_world()
    dist.destroy_process_group()
