"""One rank of a multi-process gloo world for the port's parity tests.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_worker.py {comm|train|opt|mnist|lm} \\
            IN.npz OUT_PREFIX

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


# (label, communicator name, keyword arguments) of every flavor run_comm
# reduces with
FLAVORS = (("naive", "naive", {}), ("flat", "flat", {}), ("xla", "xla", {}),
           ("pure_nccl", "pure_nccl", {}),
           ("hierarchical", "hierarchical", {}),
           ("two_dimensional", "two_dimensional", {}),
           ("single_node", "single_node", {}),
           ("non_cuda_aware", "non_cuda_aware", {}),
           ("xla_f16", "xla", {"allreduce_grad_dtype": "float16"}),
           ("xla_bf16", "xla", {"allreduce_grad_dtype": "bfloat16",
                                "use_pallas_cast": True}))


def run_comm(inp, rank):
    """Every flavor's ``allreduce_grad`` of this rank's slice of the
    ``grad/*`` tree (keys ``{label}/{leaf}``) and of the ``exact/*`` tree
    (``{label}/exact/{leaf}``), over ``intra_size`` if given; a refused
    flavor leaves ``{label}/refused``.  With ``mod/*`` inputs, also the
    module form, bcast, allreduce ops and split."""
    intra = int(inp["intra_size"]) if "intra_size" in inp else None
    trees = {}
    for k in inp:
        if k.startswith(("grad/", "exact/")):
            tree, name = k.split("/", 1)
            trees.setdefault(tree, {})[name] = torch.from_numpy(inp[k][rank])
    out = {}
    for label, name, kw in FLAVORS:
        try:
            comm = create_communicator(name, intra_size=intra, device="cpu",
                                       **kw)
        except ValueError:
            out[f"{label}/refused"] = np.asarray(1)
            continue
        for tree, grads in trees.items():
            red = comm.allreduce_grad(grads)
            pre = label if tree == "grad" else f"{label}/{tree}"
            out.update({f"{pre}/{n}": red[n].numpy() for n in grads})
    comm = create_communicator("hierarchical", intra_size=intra,
                               device="cpu")
    out["allreduce_obj/sum"] = np.asarray(comm.allreduce_obj(
        {"a": rank + 1, "b": [np.full(2, rank)]})["b"][0])
    out["allreduce_obj/max"] = np.asarray(comm.allreduce_obj(rank, "max"))
    # a sub-world of every other rank keeps working levels
    sub = comm.split(color=rank % 2, key=rank)
    out["split/levels"] = np.asarray([sub.size, sub.intra_size,
                                      sub.inter_size])
    for n, g in sub.allreduce_grad(trees.get("exact", {})).items():
        out[f"split/exact/{n}"] = g.numpy()
    if "mod/w" not in inp:
        return out
    names = sorted(trees["grad"])
    grads = trees["grad"]
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


def run_opt(inp, rank):
    """The multi-node optimizers: the double buffer's staleness on a
    quadratic (``stale/{flavor}`` = the weights after each of 3 steps),
    then an MLP from flax weights (``var/``) for every optimizer x
    double-buffering config: ``{config}/losses`` and ``{config}/var/...``."""
    import torch.nn.functional as F
    from chainermn_tpu_torch import weights
    from chainermn_tpu_torch.models import MLP

    out = {}
    target = torch.full((3,), float(rank))
    for label, name, kw in (("xla", "xla", {}),
                            ("hierarchical", "hierarchical", {}),
                            ("xla_f16", "xla",
                             {"allreduce_grad_dtype": "float16"})):
        comm = create_communicator(name, device="cpu", **kw)
        w = torch.nn.Parameter(torch.zeros(3))
        opt = create_multi_node_optimizer(torch.optim.SGD([w], lr=1.0), comm,
                                          double_buffering=True)
        step = make_train_step(
            comm, lambda b: 0.5 * ((w - b) ** 2).sum(), opt)
        ws = []
        for _ in range(3):
            step(target)
            ws.append(w.detach().clone().numpy())
        step.finalize()
        out[f"stale/{label}"] = np.stack(ws)

    variables = nest({k[4:]: v for k, v in inp.items()
                      if k.startswith("var/")})
    comm = create_communicator("xla", device="cpu")
    for opt_name in ("adam", "momentum"):
        for db in (False, True):
            model = MLP(int(inp["unit"]), 10, device="cpu")
            weights.load_flax_variables(model, variables)
            lr = float(inp[f"lr_{opt_name}"])
            inner = (torch.optim.Adam(model.parameters(), lr=lr)
                     if opt_name == "adam" else
                     torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9))
            opt = create_multi_node_optimizer(inner, comm,
                                              double_buffering=db)
            step = make_train_step(
                comm, lambda b: F.cross_entropy(model(b[0]), b[1]), opt)
            losses = [float(step((torch.from_numpy(x),
                                  torch.from_numpy(y).long())))
                      for x, y in zip(inp["x"][:, rank], inp["y"][:, rank])]
            step.finalize()
            cfg = f"{opt_name}_db{int(db)}"
            out[f"{cfg}/losses"] = np.asarray(losses)
            out.update({f"{cfg}/var/{k}": v for k, v in flatten(
                weights.state_dict_to_flax(model)).items()})
    return out


def run_mnist(inp, rank):
    """The MNIST example's ``main`` with ``argv`` (one string in the
    inputs); its per-epoch log as ``log/{key}`` arrays."""
    from chainermn_tpu_torch.examples import train_mnist

    res = train_mnist.main(str(inp["argv"]).split())
    keys = sorted(res["log"][0])
    return {f"log/{k}": np.asarray([r[k] for r in res["log"]], np.float64)
            for k in keys}


def run_lm(inp, rank):
    """The data-parallel LM step at toy width: ``create_communicator("xla",
    allreduce_grad_dtype=wire)`` -> ``create_multi_node_optimizer(SGD
    momentum 0.9, double_buffering=True)`` -> ``make_train_step``, from flax
    weights (``var/``), on this rank's slice of ``toks`` [steps, world, b,
    T], for the float32 and the bfloat16 wire: ``{wire}/losses`` and
    ``{wire}/var/...`` after ``step.finalize()``."""
    from chainermn_tpu_torch import weights
    from chainermn_tpu_torch.examples.train_lm import lm_loss
    from chainermn_tpu_torch.models import TransformerLM

    variables = nest({k[4:]: v for k, v in inp.items()
                      if k.startswith("var/")})
    vocab, d_model, layers, heads, kv, max_len = (int(x) for x in inp["cfg"])
    out = {}
    for wire, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        comm = create_communicator("xla", allreduce_grad_dtype=dtype,
                                   device="cpu")
        model = TransformerLM(vocab, d_model, layers, heads, max_len=max_len,
                              attention_impl=str(inp["impl"]),
                              n_kv_heads=kv or None, device="cpu")
        weights.load_flax_variables(model, variables)
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=float(inp["lr"]),
                            momentum=0.9), comm, double_buffering=True)
        step = make_train_step(comm, lambda b: lm_loss(model, b), opt)
        out[f"{wire}/losses"] = np.asarray(
            [float(step(torch.from_numpy(t))) for t in inp["toks"][:, rank]])
        step.finalize()
        out.update({f"{wire}/var/{k}": v for k, v in flatten(
            weights.state_dict_to_flax(model)).items()})
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
    out = {"comm": run_comm, "train": run_train, "opt": run_opt,
           "mnist": run_mnist, "lm": run_lm}[mode](inp, topo.rank)
    np.savez(f"{out_prefix}.{topo.rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
