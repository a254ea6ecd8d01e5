"""One rank of a multi-process gloo world for the port's parity tests.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_worker.py {comm|train} IN.npz OUT_PREFIX

Reads the stacked per-rank inputs from ``IN.npz`` (leading axis = rank),
runs this rank's part through ``chainermn_tpu_torch`` on the CPU, and
writes ``OUT_PREFIX.<rank>.npz``.  Imports torch and the port only.
:func:`launch` starts such a world from a test.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chainermn_tpu_torch import (  # noqa: E402
    create_communicator, create_multi_node_optimizer, init_distributed,
    make_train_step)


def nest(flat: dict) -> dict:
    """{"a/b/c": v} -> {"a": {"b": {"c": v}}}."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def run_comm(inp, rank):
    names = sorted(k[5:] for k in inp if k.startswith("grad/"))
    grads = {n: torch.from_numpy(inp[f"grad/{n}"][rank]) for n in names}
    out = {}
    for flavor in ("naive", "flat", "xla", "pure_nccl"):
        comm = create_communicator(flavor, device="cpu")
        red = comm.allreduce_grad(grads)
        out.update({f"{flavor}/{n}": red[n].numpy() for n in names})
    comm = create_communicator("xla", allreduce_grad_dtype="float16",
                               device="cpu")
    red = comm.allreduce_grad(grads)
    out.update({f"xla_f16/{n}": red[n].numpy() for n in names})
    # the module form replaces .grad in place
    comm = create_communicator("xla", device="cpu")
    lin = torch.nn.Linear(3, 2)
    for p, n in zip(lin.parameters(), ("w", "b")):
        p.grad = torch.from_numpy(inp[f"mod/{n}"][rank])
    comm.allreduce_grad(lin)
    out["mod/w"], out["mod/b"] = lin.weight.grad.numpy(), lin.bias.grad.numpy()
    # bcast_data: rank 0's values everywhere, in place for a module
    with torch.no_grad():
        lin.weight.fill_(float(rank))
    comm.bcast_data(lin)
    out["bcast/module"] = lin.weight.detach().numpy()
    out["bcast/tree"] = comm.bcast_data(grads)[names[0]].numpy()
    out["allreduce/max"] = comm.allreduce(grads[names[0]], "max").numpy()
    out["allreduce/mean"] = comm.allreduce(grads[names[0]], "mean").numpy()
    sub = comm.split(color=rank % 2, key=-rank)
    out["split/size"] = np.asarray(sub.size)
    out["split/rank"] = np.asarray(sub.rank)
    return out


def run_train(inp, rank):
    from chainermn_tpu_torch import weights
    from chainermn_tpu_torch.models import ResNet

    variables = nest({k[4:]: v for k, v in inp.items()
                      if k.startswith("var/")})
    comm = create_communicator("xla", device="cpu")
    model = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                   device="cpu")
    weights.load_flax_variables(model, variables)
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=float(inp["lr"]),
                        momentum=0.9), comm)

    def loss_fn(batch):
        x, y = batch
        return torch.nn.functional.cross_entropy(model(x), y)

    step = make_train_step(comm, loss_fn, opt)
    model.train()
    losses = []
    for x, y in zip(inp["x"][:, rank], inp["y"][:, rank]):
        x = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        losses.append(float(step((x, torch.from_numpy(y).long()))))
    out = {f"var/{k}": v for k, v in flatten(
        weights.state_dict_to_flax(model)).items()}
    out["losses"] = np.asarray(losses)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(mode: str, inputs: dict, world: int, tmp_path, timeout=300):
    """Run ``world`` ranks of ``mode`` on ``inputs``; their outputs, by
    rank.  Raises with a rank's output if any rank fails."""
    inp = os.path.join(str(tmp_path), f"{mode}_in.npz")
    prefix = os.path.join(str(tmp_path), f"{mode}_out")
    np.savez(inp, **inputs)
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, inp, prefix],
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{log[-4000:]}")
    return [dict(np.load(f"{prefix}.{r}.npz")) for r in range(world)]


def main():
    mode, inp_path, out_prefix = sys.argv[1:4]
    torch.set_num_threads(1)
    topo = init_distributed(device="cpu")
    inp = dict(np.load(inp_path))
    out = {"comm": run_comm, "train": run_train}[mode](inp, topo.rank)
    np.savez(f"{out_prefix}.{topo.rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
