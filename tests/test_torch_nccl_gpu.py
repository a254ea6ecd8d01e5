"""The object plane, the array collectives, ZeRO-1 and the checkpointer on
an NCCL world, on the card.

NCCL moves device memory only and has no tags, so every communicator keeps
a gloo side group of the same ranks for its objects (``send_obj``,
``recv_obj``, ``gather_obj``, ``scatter_obj``, ``barrier``, the multi-node
iterator, the checkpointer's barrier) and for ``non_cuda_aware``'s staged
all-reduce.  The CPU tests run on gloo worlds, where that side group is
the world itself; these run the same calls where it is not.  Every test is
marked ``gpu`` and skips without a CUDA card; the world of several ranks
takes one card a rank and skips with fewer than two.  Run on the card as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_nccl_gpu.py

Objects, integers and sums of small integers are exact; ZeRO-1 against
the plain optimizer within 1e-5 relative and 1e-6 absolute (float32: NCCL
sums a reduce-scatter and an all-reduce in its own orders).
"""

import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (an NCCL world)")
    return torch.device("cuda")


def _object_plane(comm):
    n, rank = comm.size, comm.rank
    assert dist.get_backend(comm._obj_group) == "gloo"
    nxt, prv = (rank + 1) % n, (rank - 1) % n
    # two tags sent in one order and received in the other
    comm.send_obj({"first": rank}, nxt, tag=11)
    comm.send_obj(["second", rank], nxt, tag=12)
    assert comm.recv_obj(prv, tag=12) == ["second", prv]
    assert comm.recv_obj(prv, tag=11) == {"first": prv}
    comm.send_obj("self", rank, tag=13)
    assert comm.recv_obj(rank, tag=13) == "self"
    root = n - 1
    got = comm.gather_obj({"r": rank}, root=root, tag=3)
    assert got == ([{"r": r} for r in range(n)] if rank == root else None)
    assert comm.scatter_obj([f"s{i}" for i in range(n)] if rank == 0
                            else None, root=0, tag=4) == f"s{rank}"
    comm.barrier()
    assert comm.bcast_obj(("from", rank), root=root) == ("from", root)
    assert comm.allgather_obj(rank * 10) == [r * 10 for r in range(n)]


def _collectives(comm):
    n, rank, dev = comm.size, comm.rank, comm.device
    x = torch.arange(3.0, device=dev) + 10 * rank
    want = torch.stack([torch.arange(3.0, device=dev) + 10 * r
                        for r in range(n)])
    assert torch.equal(comm.allgather(x), want)
    xs = torch.stack([torch.full((2,), 100.0 * rank + p, device=dev)
                      for p in range(n)])
    assert torch.equal(comm.alltoall(xs), torch.stack(
        [torch.full((2,), 100.0 * q + rank, device=dev) for q in range(n)]))
    table = torch.arange(n, dtype=torch.float32, device=dev)[:, None] \
        .repeat(1, 2) * (1.5 if rank == 0 else 0.0)
    assert torch.equal(comm.scatter(table, root=0),
                       torch.full((2,), 1.5 * rank, device=dev))
    rs = torch.full((2 * n,), rank + 1.0, device=dev)
    assert torch.equal(comm.reduce_scatter(rs),
                       torch.full((2,), n * (n + 1) / 2, device=dev))
    ring = comm.ppermute(x, [(i, (i + 1) % n) for i in range(n)])
    assert torch.equal(ring, want[(rank - 1) % n])


def _non_cuda_aware(n, rank, dev):
    from chainermn_tpu_torch import create_communicator
    comm = create_communicator("non_cuda_aware")
    g = {"w": torch.full((5, 3), rank + 1.0, device=dev),
         "h": torch.full((7,), rank + 1.0, device=dev).half()}
    out = comm.allreduce_grad(g)
    for k in g:
        assert out[k].device == g[k].device and out[k].dtype == g[k].dtype
        assert torch.equal(out[k], torch.full_like(g[k], (n + 1) / 2))


def _split(n, rank):
    from chainermn_tpu_torch import create_communicator
    intra = 2 if n % 2 == 0 else 1
    sub = create_communicator("hierarchical", intra_size=intra) \
        .split_axes(("intra",))
    assert (sub.size, sub.rank) == (intra, rank % intra)
    _object_plane(sub)


def _iterator(comm):
    from chainermn_tpu_torch.iterators import (SerialIterator,
                                               create_multi_node_iterator)
    it = SerialIterator(list(range(20)), 4, shuffle=True, seed=5) \
        if comm.rank == 0 else None
    mit = create_multi_node_iterator(it, comm)
    batches = [[int(v) for v in mit.next()] for _ in range(7)]
    every = comm.allgather_obj(batches)
    assert all(b == every[0] for b in every)
    assert sorted(sum(every[0][:5], [])) == list(range(20))


def _checkpoint(comm, path):
    from chainermn_tpu_torch.extensions.checkpoint import (
        create_multi_node_checkpointer)
    dev = comm.device
    ck = create_multi_node_checkpointer(comm, path, name="nccl", keep=1)
    for it in (1, 2):
        ck.save({"w": torch.full((3,), it + comm.rank * 0.5, device=dev)},
                it)
    assert ck.latest_consistent_generation() == 2
    state, gen = ck.resume({"w": torch.zeros(3, device=dev)})
    assert gen == 2
    assert torch.equal(state["w"],
                       torch.full((3,), 2 + comm.rank * 0.5, device=dev))
    ck.finalize()
    # every rank's file of the newest generation stands after the barrier
    assert {f"nccl.2.rank{r}.npz" for r in range(comm.size)} <= \
        set(os.listdir(path))


def _zero(n, rank, dev):
    from chainermn_tpu_torch import (create_communicator,
                                     create_multi_node_optimizer)
    comm = create_communicator("xla")
    gen = torch.Generator().manual_seed(0)
    init = torch.randn(4 * n + 1, generator=gen)  # padded to n
    grads = torch.randn(3, n, 4 * n + 1, generator=gen)
    ws = []
    for zero in (True, False):
        w = torch.nn.Parameter(init.to(dev))
        opt = create_multi_node_optimizer(torch.optim.Adam([w], lr=1e-2),
                                          comm, zero=zero)
        for t in range(3):
            opt.zero_grad(set_to_none=True)
            w.grad = grads[t, rank].to(dev)
            opt.step()
        if zero:
            held = sum(v.numel() for st in opt.local_optimizer.state.values()
                       for v in st.values() if v.dim())
            assert held == 2 * ((4 * n + 1 + n - 1) // n)
        ws.append(w.detach())
    torch.testing.assert_close(ws[0], ws[1], rtol=1e-5, atol=1e-6)


def check_world(path):
    """Every check above on this process's NCCL world (initialized here
    from the environment if it is not yet)."""
    from chainermn_tpu_torch import create_communicator
    comm = create_communicator("naive")
    assert dist.get_backend() == "nccl"
    n, rank, dev = comm.size, comm.rank, comm.device
    _object_plane(comm)
    _collectives(comm)
    _non_cuda_aware(n, rank, dev)
    _split(n, rank)
    _iterator(comm)
    _checkpoint(comm, path)
    _zero(n, rank, dev)
    comm.barrier()


@pytest.mark.gpu
def test_nccl_world_of_one(cuda, tmp_path):
    created = not dist.is_initialized()
    try:
        check_world(str(tmp_path))
    finally:
        if created:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.gpu
def test_nccl_world_of_every_card(cuda, tmp_path):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("an NCCL world of several ranks needs two CUDA cards "
                    "(one a rank)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp_path)],
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


if __name__ == "__main__":
    # one rank of test_nccl_world_of_every_card
    check_world(sys.argv[1])
    dist.destroy_process_group()
