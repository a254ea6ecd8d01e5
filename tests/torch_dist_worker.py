"""One rank of a multi-process gloo world for the port's parity tests.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_worker.py \\
            {comm|train|opt|mnist|mnistpar|lm|unused|coll|zero|syncbn|imagenet|seq|
             p2p|chain|seq2seq|pconv|configs|serve|accum|fsdp|tpep|
             moelm|tpserve|compress|pipe|plan|planuse|obs} \\
            IN.npz OUT_PREFIX

Reads the stacked per-rank inputs from ``IN.npz`` (leading axis = rank),
runs this rank's part through ``chainermn_tpu_torch`` on the CPU, and
writes ``OUT_PREFIX.<rank>.npz``.  Imports torch and the port only.
:func:`launch` starts such a world from a test.
"""

import json
import os
import socket
import subprocess
import sys
import time

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


def run_mnistpar(inp, rank):
    """The MNIST example's ``main`` once per variant (``variants``: one
    argv string each), every run from the flax variables ``init/...``;
    each run's per-epoch log as ``{i}/{key}`` arrays."""
    from chainermn_tpu_torch.examples import train_mnist

    init = nest({k[len("init/"):]: v for k, v in inp.items()
                 if k.startswith("init/")})
    out = {}
    for i, argv in enumerate(inp["variants"]):
        res = train_mnist.main(str(argv).split(), flax_init=init)
        for k in sorted(res["log"][0]):
            out[f"{i}/{k}"] = np.asarray([r[k] for r in res["log"]],
                                         np.float64)
    return out


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


def run_unused(inp, rank):
    """Parameters that a rank's backward leaves without a gradient: ``w``
    always used, ``a`` only where ``use[step, rank, 0]``, ``c`` only where
    ``use[step, rank, 1]``, ``z`` never; SGD momentum 0.9 through each
    flavor's multi-node optimizer, plain and double-buffered.  Writes
    ``{flavor}_db{0|1}/losses`` and ``.../{name}`` ([steps, ...], the
    parameter after each step), then reduces one backward's gradients
    through ``comm.allreduce_grad(module)`` (``module_{flavor}/...``)."""
    out = {}
    for flavor in ("naive", "flat", "xla"):
        for db in (False, True):
            comm = create_communicator(flavor, device="cpu")
            params = {n: torch.nn.Parameter(torch.tensor(inp[f"p/{n}"]))
                      for n in ("w", "a", "c", "z")}
            opt = create_multi_node_optimizer(
                torch.optim.SGD(params.values(), lr=float(inp["lr"]),
                                momentum=0.9), comm, double_buffering=db)

            def loss_fn(batch):
                x, use = batch
                h = x @ params["w"]
                loss = (h ** 2).mean()
                if use[0]:
                    loss = loss + (torch.tanh(h) * params["a"]).mean()
                if use[1]:
                    loss = loss + 0.1 * (torch.tanh(h) * params["c"]).sum()
                return loss

            step = make_train_step(comm, loss_fn, opt)
            cfg = f"{flavor}_db{int(db)}"
            losses, after = [], {n: [] for n in params}
            for x, use in zip(inp["x"][:, rank], inp["use"][:, rank]):
                losses.append(float(step((torch.from_numpy(x), use))))
                for n, p in params.items():
                    after[n].append(p.detach().clone().numpy())
            step.finalize()
            out[f"{cfg}/losses"] = np.asarray(losses)
            out.update({f"{cfg}/{n}": np.stack(v) for n, v in after.items()})
        # the module form: comm.allreduce_grad(module) after one backward
        # that uses ``a`` only where ``use[0, rank, 0]``; writes
        # ``module_{flavor}/{name}`` (the reduced .grad),
        # ``.../local/{name}`` (this rank's .grad, zeros for None) and
        # ``.../none`` (which .grad backward left None)
        mod = torch.nn.Module()
        for n in ("w", "a"):
            setattr(mod, n, torch.nn.Parameter(torch.tensor(inp[f"p/{n}"])))
        h = torch.from_numpy(inp["x"][0, rank]) @ mod.w
        loss = (h ** 2).mean()
        if inp["use"][0, rank, 0]:
            loss = loss + (torch.tanh(h) * mod.a).mean()
        loss.backward()
        key = f"module_{flavor}"
        out[f"{key}/none"] = np.asarray([mod.w.grad is None,
                                         mod.a.grad is None])
        for n, p in mod.named_parameters():
            out[f"{key}/local/{n}"] = (np.zeros_like(inp[f"p/{n}"])
                                       if p.grad is None
                                       else p.grad.numpy().copy())
        assert comm.allreduce_grad(mod) is mod
        for n, p in mod.named_parameters():
            out[f"{key}/{n}"] = p.grad.numpy().copy()
    return out


def run_coll(inp, rank):
    """The array collectives, ``split_axes``, the object plane,
    ``allreduce_persistent`` and the multi-node iterators on this rank's
    slices of the inputs; object results as one JSON string ``obj``."""
    import json

    from chainermn_tpu_torch.extensions import allreduce_persistent
    from chainermn_tpu_torch.iterators import (
        SerialIterator, create_multi_node_iterator,
        create_synchronized_iterator)

    t = {k: torch.from_numpy(v[rank]) for k, v in inp.items()
         if k != "intra_size"}
    comm = create_communicator("naive", device="cpu")
    n = comm.size
    out = {"allgather": comm.allgather(t["x"]),
           "gather": comm.gather(t["x"], root=1),
           "alltoall": comm.alltoall(t["xs"]),
           "scatter": comm.scatter(t["table"], root=n - 1),
           "reduce_scatter": comm.reduce_scatter(t["rs"]),
           "reduce_scatter_int": comm.reduce_scatter(t["rsi"]),
           "ppermute_ring": comm.ppermute(
               t["x"], [(i, (i + 1) % n) for i in range(n)]),
           "ppermute_one": comm.ppermute(t["x"], [(0, n - 1)])}
    tree = comm.allgather({"a": t["x"], "b": [t["rsi"][:2]]})
    out["tree/a"], out["tree/b"] = tree["a"], tree["b"][0]
    hier = create_communicator("hierarchical", device="cpu",
                               intra_size=int(inp["intra_size"]))
    for axes in (("intra",), ("inter",), ("inter", "intra")):
        sub = hier.split_axes(axes)
        key = "split_axes/" + "_".join(axes)
        out[key] = sub.allreduce(t["x"], "sum")
        out[key + "/shape"] = torch.tensor([sub.size, sub.rank,
                                            sub.intra_size])
        out[key + "/grad"] = sub.allreduce_grad({"g": t["x"]})["g"]
    bn = torch.nn.BatchNorm1d(3)
    with torch.no_grad():
        bn.running_mean.copy_(t["x"])
        bn.running_var.copy_(t["x"] * t["x"])
    allreduce_persistent(bn, comm)
    out["persistent/mean"] = bn.running_mean
    out["persistent/var"] = bn.running_var
    out["persistent/tree"] = allreduce_persistent(
        {"bn": {"mean": t["rs"]}}, comm)["bn"]["mean"]
    out = {k: v.numpy() for k, v in out.items()}

    obj = {}
    # two tags sent in one order and received in the other
    nxt, prv = (rank + 1) % n, (rank - 1) % n
    comm.send_obj({"first": rank}, nxt, tag=11)
    comm.send_obj(["second", rank], nxt, tag=12)
    obj["tag12"] = comm.recv_obj(prv, tag=12)
    obj["tag11"] = comm.recv_obj(prv, tag=11)
    comm.send_obj("self", rank, tag=13)
    obj["loopback"] = comm.recv_obj(rank, tag=13)
    obj["gather"] = comm.gather_obj({"r": rank}, root=1, tag=3)
    obj["scatter"] = comm.scatter_obj(
        [f"s{i}" for i in range(n)] if rank == n - 1 else None,
        root=n - 1, tag=4)
    comm.barrier()
    obj["bcast"] = comm.bcast_obj(("from", rank), root=1, tag=5)
    obj["allgather"] = comm.allgather_obj(rank * 10)
    obj["allreduce"] = comm.allreduce_obj({"v": rank}, "sum")
    comm.barrier(tag=950)

    data = list(range(20))
    it = SerialIterator(data, 4, repeat=False, shuffle=False) \
        if rank == 0 else None
    mit = create_multi_node_iterator(it, comm)
    obj["mn_batches"] = [[int(v) for v in b] for b in mit]
    obj["mn_epoch"] = mit.epoch
    it = SerialIterator(data, 3, shuffle=True, seed=5) if rank == 0 else None
    mit = create_multi_node_iterator(it, comm)
    obj["mn_shuffled"] = [[int(v) for v in mit.next()] for _ in range(9)]
    np.random.seed(100 + rank)  # a different global draw on every rank
    it = create_synchronized_iterator(
        SerialIterator(list(range(32)), 8, shuffle=True, seed=rank), comm)
    obj["synced"] = [[int(v) for v in it.next()] for _ in range(5)]
    out["obj"] = np.asarray(json.dumps(obj))
    return out


def run_zero(inp, rank):
    """ZeRO-1 against the unsharded multi-node optimizer: an MLP from flax
    weights (``var/``), 4 steps on this rank's slice of ``x``/``y`` for
    Adam and AdamW, without and with ``zero``, float32 wire and the bf16
    wire: ``{cfg}/losses``, ``{cfg}/var/...`` and ``{cfg}/state_numel``.
    Then the wire leg alone on ``g`` (``wire/{dtype}/{i}``: this rank's
    shards) and the refusals."""
    import torch.nn.functional as F
    from chainermn_tpu_torch import weights
    from chainermn_tpu_torch.models import MLP

    variables = nest({k[4:]: v for k, v in inp.items()
                      if k.startswith("var/")})
    out = {}
    for wire in (None, "bfloat16"):
        comm = create_communicator("xla", device="cpu",
                                   allreduce_grad_dtype=wire)
        for name in ("adam", "adamw"):
            for zero in (False, True):
                model = MLP(int(inp["unit"]), 4, n_in=8, device="cpu")
                weights.load_flax_variables(model, variables)
                inner = (torch.optim.Adam(model.parameters(), lr=5e-2)
                         if name == "adam" else torch.optim.AdamW(
                             model.parameters(), lr=5e-2, weight_decay=1e-2))
                opt = create_multi_node_optimizer(inner, comm, zero=zero)
                step = make_train_step(
                    comm, lambda b: F.cross_entropy(model(b[0]), b[1]), opt)
                losses = [float(step((torch.from_numpy(x),
                                      torch.from_numpy(y).long())))
                          for x, y in zip(inp["x"][:, rank],
                                          inp["y"][:, rank])]
                cfg = f"{wire or 'float32'}/{name}/zero{int(zero)}"
                out[f"{cfg}/losses"] = np.asarray(losses)
                out[f"{cfg}/state_numel"] = np.asarray(sum(
                    v.numel() for st in opt.local_optimizer.state.values()
                    for k, v in st.items() if k != "step"))
                out.update({f"{cfg}/var/{k}": v for k, v in flatten(
                    weights.state_dict_to_flax(model)).items()})
        zopt = create_multi_node_optimizer(
            torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=1.0),
            comm, zero=True)
        for key in ("g", "exact"):
            shards, _, _ = zopt.reduce_scatter_grad(
                [torch.from_numpy(inp[key][rank])])
            out[f"wire/{wire or 'float32'}/{key}"] = shards[0].numpy()
    return out


def run_syncbn(inp, rank):
    """``MultiNodeBatchNormalization`` on this rank's slice of ``x`` ([N,
    C]) and ``x4`` ([N, C, H, W]) with weights ``w``/``b`` and upstream
    gradients ``gy``/``gy4``: output, running statistics after two steps,
    input gradient, and this rank's parameter gradients."""
    from chainermn_tpu_torch.links import MultiNodeBatchNormalization

    comm = create_communicator("xla", device="cpu")
    out = {}
    for key in ("x", "x4"):
        x = torch.from_numpy(inp[key][rank]).requires_grad_()
        bn = MultiNodeBatchNormalization(x.shape[1], comm)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(inp["w"]))
            bn.bias.copy_(torch.from_numpy(inp["b"]))
        y = bn(x)
        gy = torch.from_numpy(inp["gy4" if key == "x4" else "gy"][rank])
        (y * gy).sum().backward()
        out[f"{key}/y"] = y.detach().numpy()
        out[f"{key}/dx"] = x.grad.numpy()
        out[f"{key}/dw"] = bn.weight.grad.numpy()
        out[f"{key}/db"] = bn.bias.grad.numpy()
        with torch.no_grad():
            bn(x)
        out[f"{key}/running_mean"] = bn.running_mean.numpy()
        out[f"{key}/running_var"] = bn.running_var.numpy()
        bn.eval()
        out[f"{key}/eval"] = bn(x).detach().numpy()
    return out


def run_imagenet(inp, rank):
    """``main`` of the example ``example`` names (``train_imagenet`` when
    it is absent) for each ``argv{i}`` (one string each): ``{i}/losses``
    and ``{i}/model/{name}`` (parameters and buffers)."""
    import importlib
    example = importlib.import_module(
        "chainermn_tpu_torch.examples."
        + str(inp["example"] if "example" in inp else "train_imagenet"))

    out = {}
    i = 0
    while f"argv{i}" in inp:
        res = example.main(str(inp[f"argv{i}"]).split())
        out[f"{i}/losses"] = np.asarray(res["losses"])
        out.update({f"{i}/model/{k}": v.detach().cpu().numpy()
                    for k, v in res["model"].state_dict().items()})
        i += 1
    return out


def run_accum(inp, rank):
    """Gradient accumulation: for each config ``{model}-{flavor}-{K}`` in
    ``configs`` (model ``mlp`` or ``resnet``, flavor ``plain``, ``double``
    or ``zero``), the flax weights ``{model}/var/...`` trained over this
    rank's slices of ``{model}/x`` and ``{model}/y`` with
    ``make_train_step(accum_steps=K)``: ``{config}/losses``,
    ``{config}/var/...`` (parameters and running statistics, flax-named)
    and ``{config}/reductions`` (the optimizer's gradient reductions, one
    a step expected)."""
    from chainermn_tpu_torch import weights
    from chainermn_tpu_torch.models import MLP, ResNet

    out = {}
    for config in str(inp["configs"]).split(","):
        name, flavor, k = config.split("-")
        variables = nest({key[len(name) + 5:]: v for key, v in inp.items()
                          if key.startswith(f"{name}/var/")})
        comm = create_communicator("xla", device="cpu")
        model = (MLP(16, 10, n_in=48, device="cpu") if name == "mlp" else
                 ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                        device="cpu"))
        weights.load_flax_variables(model, variables)
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=float(inp["lr"]),
                            momentum=0.9), comm,
            double_buffering=flavor == "double", zero=flavor == "zero")
        # the one reduction each optimizer issues a step
        owner, attr = {"plain": (opt, "allreduce_grad"),
                       "double": (comm, "_allreduce_grad_start"),
                       "zero": (opt, "reduce_scatter_grad")}[flavor]
        calls = [0]

        def counted(*a, _f=getattr(owner, attr), **kw):
            calls[0] += 1
            return _f(*a, **kw)

        setattr(owner, attr, counted)

        def loss_fn(batch, model=model):
            x, y = batch
            return torch.nn.functional.cross_entropy(model(x), y)

        step = make_train_step(comm, loss_fn, opt, accum_steps=int(k))
        model.train()
        losses = []
        for x, y in zip(inp[f"{name}/x"][:, rank], inp[f"{name}/y"][:, rank]):
            if x.ndim == 4:
                x = x.transpose(0, 3, 1, 2)
            x = torch.from_numpy(np.ascontiguousarray(x))
            losses.append(float(step((x, torch.from_numpy(y).long()))))
        step.finalize()
        out.update({f"{config}/var/{key}": v for key, v in flatten(
            weights.state_dict_to_flax(model)).items()})
        out[f"{config}/losses"] = np.asarray(losses)
        out[f"{config}/reductions"] = np.asarray(calls[0])
    return out


def _grads_as_flax(model):
    """The model's gradients in the flax parameter layout."""
    from chainermn_tpu_torch import weights
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    return flatten(weights.state_dict_to_flax(model))


def run_seq(inp, rank):
    """The sequence-parallel slice on this rank's blocks, by section (a
    section runs when its inputs are there):

    * ``coll/*``: each differentiable collective, ``spmd_send_recv`` and
      ``spmd_send_recv_async`` on ``x`` (rank-stacked), the loss ``sum(w *
      y)``: ``{name}/y`` and ``{name}/g`` (the gradient of this rank's
      ``x``);
    * ``attn/*``: ``ring``, ``ulysses`` and ``ring_flash`` (the plain flash
      on the CPU) over the world on this rank's sequence block of q/k/v,
      causal and not, the loss ``sum(out * g)``: ``out``, ``dq``, ``dk``,
      ``dv``; ``ulysses`` with heads the world does not divide: its
      ``ValueError``; causal ``ring`` over ``split_axes(("intra",))`` of
      nodes of half the world (``sub/*``);
    * ``gqa/*``: TransformerLM with grouped k/v under ``ring_flash`` from
      flax weights: this rank's logits and the head count of every k/v
      block the ring rotated;
    * ``lm/*``: the example's ``sp_loss`` for each of ``lm/impls`` from
      flax weights, backward and ``sum_gradients``: the loss and the
      gradients in the flax layout;
    * ``example/*``: ``examples.train_lm.main`` for each impl: its losses.
    """
    from chainermn_tpu_torch import functions, weights
    from chainermn_tpu_torch.examples import train_lm
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.ops.flash_attention import flash_attention
    from chainermn_tpu_torch.parallel import sequence

    comm = create_communicator("xla", device="cpu")
    n = comm.size
    out = {}

    def grad_of(fn, x, w):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (y * w).sum().backward()
        return y.detach(), x.grad

    if "coll/x" in inp:
        x = torch.from_numpy(inp["coll/x"][rank])      # [n, 3]
        w = torch.from_numpy(inp["coll/w"][rank])      # [n, n, 3]
        ring = [(i, (i + 1) % n) for i in range(n)]

        def async_pair(v):
            # two tensors in one exchange, with work queued while it runs
            pending = functions.spmd_send_recv_async((v, v * v), comm, ring)
            mid = torch.sin(v)
            a, b = pending.wait()
            return a + 2.0 * b + mid

        cases = {
            "allgather": (x[0], lambda v: functions.allgather(comm, v),
                          w[0]),
            "gather": (x[0], lambda v: functions.gather(comm, v, root=1),
                       w[0]),
            "alltoall": (x, lambda v: functions.alltoall(comm, v), w[0]),
            "bcast": (x[0], lambda v: functions.bcast(comm, v, root=1),
                      w[0, 0]),
            "scatter": (x, lambda v: functions.scatter(comm, v, root=n - 1),
                        w[0, 0]),
            "allreduce_sum": (x[0], lambda v: functions.allreduce(comm, v),
                              w[0, 0]),
            "allreduce_mean": (x[0], lambda v: functions.allreduce(
                comm, v, "mean"), w[0, 0]),
            "send_recv_ring": (x[0], lambda v: functions.spmd_send_recv(
                v, comm, ring), w[0, 0]),
            "send_recv_one": (x[0], lambda v: functions.spmd_send_recv(
                v, comm, [(0, n - 1)]), w[0, 0]),
            "send_recv_async_pair": (x[0], lambda v: async_pair(v), w[0, 0]),
        }
        for name, (xv, fn, wv) in cases.items():
            y, g = grad_of(fn, xv, wv)
            out[f"coll/{name}/y"], out[f"coll/{name}/g"] = y, g
        out["coll/allreduce_max"] = functions.allreduce(comm, x[0], "max")

    if "attn/q" in inp:
        t_local = inp["attn/q"].shape[1] // n
        blk = slice(rank * t_local, (rank + 1) * t_local)
        q, k, v, g = (torch.from_numpy(inp[f"attn/{c}"][:, blk])
                      for c in "qkvg")
        impls = {
            "ring": lambda a, b, c, causal: sequence.ring_attention(
                a, b, c, comm, causal=causal),
            "ulysses": lambda a, b, c, causal: sequence.ulysses_attention(
                a, b, c, comm, causal=causal),
            "ring_flash": lambda a, b, c, causal: sequence.ring_attention(
                a, b, c, comm, causal=causal, attn_fn=flash_attention),
        }
        for name, fn in impls.items():
            for causal in (False, True):
                qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
                o = fn(*qkv, causal)
                (o * g).sum().backward()
                key = f"attn/{name}/{int(causal)}"
                out[f"{key}/out"] = o.detach()
                for c, t in zip("qkv", qkv):
                    out[f"{key}/d{c}"] = t.grad
        bad = torch.zeros(1, 4, n + n // 2, 8)
        try:
            sequence.ulysses_attention(bad, bad, bad, comm)
        except ValueError as e:
            out["attn/ulysses_refusal"] = np.asarray(str(e))
        sub = create_communicator("naive", intra_size=n // 2,
                                  device="cpu").split_axes(("intra",))
        t_sub = inp["attn/q"].shape[1] // sub.size
        blk = slice(sub.rank * t_sub, (sub.rank + 1) * t_sub)
        qkv = [torch.from_numpy(inp[f"attn/{c}"][:, blk])
               .requires_grad_(True) for c in "qkv"]
        o = sequence.ring_attention(*qkv, sub, causal=True)
        (o * torch.from_numpy(inp["attn/g"][:, blk])).sum().backward()
        out["sub/out"] = o.detach()
        for c, t in zip("qkv", qkv):
            out[f"sub/d{c}"] = t.grad

    if "gqa/toks" in inp:
        vocab, d_model, heads, kv, max_len = (int(c) for c in inp["gqa/cfg"])
        model = TransformerLM(vocab, d_model, 1, heads, max_len=max_len,
                              attention_impl="ring_flash", n_kv_heads=kv,
                              comm=comm, device="cpu")
        weights.load_flax_variables(model, nest(
            {k[8:]: v for k, v in inp.items() if k.startswith("gqa/var/")}))
        toks = torch.from_numpy(inp["gqa/toks"])
        t_local = toks.shape[1] // n
        rotated = []
        send_recv = functions.spmd_send_recv_async

        def spy(x, communicator, pairs):
            rotated.extend(int(t.shape[2]) for t in x)
            return send_recv(x, communicator, pairs)

        functions.spmd_send_recv_async = spy
        try:
            with torch.no_grad():
                out["gqa/logits"] = model(
                    toks[:, rank * t_local:(rank + 1) * t_local],
                    pos_offset=rank * t_local)
        finally:
            functions.spmd_send_recv_async = send_recv
        out["gqa/rotated_heads"] = np.asarray(rotated)

    if "lm/toks" in inp:
        vocab, d_model, layers, heads, max_len = (int(c)
                                                  for c in inp["lm/cfg"])
        variables = nest({k[7:]: v for k, v in inp.items()
                          if k.startswith("lm/var/")})
        toks = torch.from_numpy(inp["lm/toks"])
        t_local = toks.shape[1] // n
        for impl in str(inp["lm/impls"]).split(","):
            model = TransformerLM(vocab, d_model, layers, heads,
                                  max_len=max_len, attention_impl=impl,
                                  comm=comm, device="cpu")
            weights.load_flax_variables(model, variables)
            loss = train_lm.sp_loss(
                model, toks[:, rank * t_local:(rank + 1) * t_local], comm)
            loss.backward()
            train_lm.sum_gradients(model, comm)
            out[f"lm/{impl}/loss"] = loss.detach()
            out.update({f"lm/{impl}/grad/{k}": v
                        for k, v in _grads_as_flax(model).items()})

    if "example/argv" in inp:
        for impl in str(inp["example/impls"]).split(","):
            res = train_lm.main(str(inp["example/argv"]).split()
                                + ["--attention", impl])
            out[f"example/{impl}/losses"] = np.asarray(res["losses"])
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def run_p2p(inp, rank):
    """``cross_send``/``cross_recv`` between ranks 0 and 1 (the others
    idle): a float and an integer leaf forward, the float's cotangent back,
    twice on one channel; a changed shape; a tag the receiver does not
    expect."""
    from chainermn_tpu_torch import functions as F
    from chainermn_tpu_torch.links import pseudo_loss
    comm = create_communicator("naive", device="cpu")
    x, w = torch.from_numpy(inp["x"]), torch.from_numpy(inp["w"])
    ids = torch.from_numpy(inp["ids"])
    out = {}
    for step, scale in enumerate((2.0, 3.0)):
        if rank == 0:
            xv = x.clone().requires_grad_(True)
            d = F.cross_send((xv * scale, ids), comm, 1, tag=3)
            out[f"delegate_shape/{step}"] = np.asarray(d.shape)
            pseudo_loss(d).backward()
            out[f"dx/{step}"] = xv.grad
        elif rank == 1:
            y, got_ids = F.cross_recv(comm, 0, tag=3)
            out[f"y_requires_grad/{step}"] = np.asarray(y.requires_grad)
            (y * w).sum().backward()
            out[f"y/{step}"], out[f"ids/{step}"] = y.detach(), got_ids
    if rank == 0:
        try:
            F.cross_send(x[:2], comm, 1, tag=3)
        except ValueError as e:
            out["shape_error"] = np.asarray(str(e))
        F.cross_send(x, comm, 1, tag=5)
    elif rank == 1:
        try:
            F.cross_recv(comm, 0, tag=6)
        except RuntimeError as e:
            out["tag_error"] = np.asarray(str(e))
        # take the transfer that was sent, so that rank 0's send completes
        dist.recv(torch.empty_like(x), 0)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


class ChainStage(torch.nn.Module):
    """``tanh?(Dense(cat(scale_i * x_i)))`` from a flax Dense's
    ``kernel``/``bias``: the stages of ``tests/test_torch_chain_list.py``."""

    def __init__(self, kernel, bias, tanh, scales=None):
        super().__init__()
        self.lin = torch.nn.Linear(*kernel.shape)
        with torch.no_grad():
            self.lin.weight.copy_(torch.tensor(kernel.T))
            self.lin.bias.copy_(torch.tensor(bias))
        self.tanh, self.scales = tanh, scales

    def forward(self, *xs):
        h = xs[0] if self.scales is None else torch.cat(
            [x * s if s != 1 else x for x, s in zip(xs, self.scales)], -1)
        y = self.lin(h)
        return torch.tanh(y) if self.tanh else y


def build_chain(comm, inp, prefix=""):
    """The chain a ``chain/...`` input describes: for stage s,
    ``{prefix}stage/{s}/kernel``, ``/bias``, ``/spec`` (tanh, process pin
    or -1) and ``/rank_in``, ``/rank_out`` (-1 for None), ``/scales``."""
    from chainermn_tpu_torch.links import MultiNodeChainList
    model = MultiNodeChainList(comm)
    n = int(inp[f"{prefix}n_stages"])
    for s in range(n):
        key = f"{prefix}stage/{s}/"
        tanh, pin = (int(v) for v in inp[key + "spec"])

        def ranks(name):
            r = [int(v) for v in inp[key + name]]
            return None if r == [-1] else r[0] if len(r) == 1 else r
        scales = inp.get(key + "scales")
        model.add_link(ChainStage(inp[key + "kernel"], inp[key + "bias"],
                                  bool(tanh), None if scales is None
                                  else [float(v) for v in scales]),
                       rank_in=ranks("rank_in"), rank_out=ranks("rank_out"),
                       process=None if pin < 0 else pin)
    return model


def run_chain(inp, rank):
    """For each chain named in ``chains`` (inputs under ``{name}/``): SGD
    steps on ``x``/``y`` (cross entropy on the exit stage's owner, the
    pseudo-loss elsewhere), then this rank's losses, stage owners, whether
    it owns the output and how many stages it built."""
    import functools
    from chainermn_tpu_torch.links import pseudo_loss
    from chainermn_tpu_torch.optimizers import create_per_stage_optimizer
    comm = create_communicator("naive", device="cpu")
    out = {}
    for name in str(inp["chains"]).split(","):
        pre = f"{name}/"
        model = build_chain(comm, inp, pre)
        opt = create_per_stage_optimizer(functools.partial(
            torch.optim.SGD, lr=float(inp[pre + "lr"])))
        opt.init(model)
        x = torch.from_numpy(inp[pre + "x"])
        y = torch.from_numpy(inp[pre + "y"]).long()
        losses = []
        for _ in range(int(inp[pre + "steps"])):
            opt.zero_grad()
            o = model(x)
            loss = torch.nn.functional.cross_entropy(o, y) \
                if model.owns_output else pseudo_loss(o)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        out.update({pre + "losses": np.asarray(losses),
                    pre + "owners": np.asarray(
                        [model.stage_owner(s) for s in range(model.n_stages)]),
                    pre + "owns_output": np.asarray(model.owns_output),
                    pre + "n_local": np.asarray(
                        sum(m is not None for m in model.local_stages))})
    return out


def run_seq2seq(inp, rank):
    """``examples.seq2seq.main(argv)`` with its standard output captured:
    the output and the per-step losses."""
    import contextlib
    import io
    from chainermn_tpu_torch.examples import seq2seq
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = seq2seq.main(str(inp["argv"]).split())
    return {"stdout": np.asarray(buf.getvalue()),
            "losses": np.asarray(res["losses"]),
            "owns_output": np.asarray(res["owns_output"])}


def run_pconv(inp, rank):
    """``examples.train_parallel_conv``'s model from this rank's slice of
    the flax ``var/*`` tree, ``steps`` Adam steps (``lr``) on the example's
    batch: ``losses`` and ``var/*`` after them."""
    from chainermn_tpu_torch.examples import train_parallel_conv as pc
    comm = create_communicator("xla", device="cpu")
    model = pc.ChannelShardedCNN(comm)
    p = nest({k[4:]: v[rank] for k, v in inp.items() if k.startswith("var/")})
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    sd = {}
    for flax_name, port in (("Conv_0", "conv0"), ("Conv_1", "conv1")):
        sd[f"{port}.weight"] = t(p[flax_name]["kernel"].transpose(3, 2, 0, 1))
        sd[f"{port}.bias"] = t(p[flax_name]["bias"])
    sd["dense.weight"] = t(p["Dense_0"]["kernel"].T)
    sd["dense.bias"] = t(p["Dense_0"]["bias"])
    model.load_state_dict(sd)
    x, y = pc.make_batch(int(inp["batchsize"]), int(inp["seed"]))
    opt = torch.optim.Adam(model.parameters(), lr=float(inp["lr"]))
    losses = list(pc.train_steps(model, opt, x, y, int(inp["steps"])))
    w = {n: v.detach().numpy() for n, v in model.state_dict().items()}
    out = {"losses": np.asarray(losses)}
    for flax_name, port in (("Conv_0", "conv0"), ("Conv_1", "conv1")):
        out[f"var/{flax_name}/kernel"] = w[f"{port}.weight"].transpose(
            2, 3, 1, 0)
        out[f"var/{flax_name}/bias"] = w[f"{port}.bias"]
    out["var/Dense_0/kernel"] = w["dense.weight"].T
    out["var/Dense_0/bias"] = w["dense.bias"]
    return out


def run_configs(inp, rank):
    """``benchmarks.run_configs.main(argv)``: its rows as one JSON
    string."""
    import json
    from chainermn_tpu_torch.benchmarks import run_configs as rc
    return {"rows": np.asarray(json.dumps(rc.main(str(inp["argv"]).split())))}


def run_serve(inp, rank):
    """Serving on a gloo world (``parts``: ``lockstep`` and/or ``bcast``).
    ``lockstep``: every rank builds the same seeded LM and an engine whose
    plane is the communicator (vanilla, then ``spec_k`` 2 with a one-layer
    draft); rank 0 alone submits the prompts; every rank runs ``steps``
    steps; each rank's completion digest, free pages and spec pickups.
    ``bcast``: a state dict of this rank's own values (float32, bfloat16,
    int64) through ``broadcast_inference_params``; the result's bits."""
    import json
    from chainermn_tpu_torch.benchmarks.bench_serving import truncated_draft
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.serving import (InferenceEngine, ServingConfig,
                                             broadcast_inference_params)
    comm = create_communicator("naive", device="cpu")
    parts = str(inp["parts"]).split(",")
    out = {}
    if "lockstep" in parts:
        model = TransformerLM(37, 16, 2, 2, 64, device="cpu",
                              generator=torch.Generator().manual_seed(0))
        prompts = json.loads(str(inp["prompts"]))
        for label, k in (("vanilla", 0), ("spec", 2)):
            cfg = ServingConfig(page_size=4, num_pages=16, max_seqs=2,
                                chunk_tokens=4, max_pages_per_seq=4,
                                spec_k=k)
            eng = InferenceEngine(
                model, cfg, plane=comm,
                draft_model=truncated_draft(model) if k else None)
            if comm.rank == 0:
                for pr in prompts:
                    eng.submit(pr, max_new_tokens=4)
            for _ in range(int(inp["steps"])):
                eng.step()
            digest = sorted([c.rid, c.tokens] for c in eng.completions)
            out[f"{label}/digest"] = np.asarray(json.dumps(digest))
            out[f"{label}/free"] = np.asarray(eng.scheduler.allocator.num_free)
            out[f"{label}/pickups"] = np.asarray(eng._spec_pickups)
    if "bcast" in parts:
        gen = torch.Generator().manual_seed(100 + rank)
        sd = {"w": torch.randn(5, 7, generator=gen),
              "h": torch.randn(3, generator=gen).to(torch.bfloat16),
              "ids": torch.randint(0, 1000, (4,), generator=gen)}
        got = broadcast_inference_params(comm, sd, root=0)
        out["bcast/w"] = got["w"].numpy()
        out["bcast/h"] = got["h"].view(torch.int16).numpy()
        out["bcast/ids"] = got["ids"].numpy()
        out["mine/w"] = sd["w"].numpy()
        out["mine/h"] = sd["h"].view(torch.int16).numpy()
        out["mine/ids"] = sd["ids"].numpy()
    return out


def fsdp_mlp(inp, prefix="mlp"):
    """The JAX FSDP tests' MLP (Dense 16, relu, Dense 4) from the flax
    weights ``{prefix}/Dense_i/kernel|bias``."""
    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                            torch.nn.Linear(16, 4))
    with torch.no_grad():
        for i, lin in ((0, m[0]), (1, m[2])):
            lin.weight.copy_(torch.tensor(inp[f"{prefix}/Dense_{i}/kernel"]).T)
            lin.bias.copy_(torch.tensor(inp[f"{prefix}/Dense_{i}/bias"]))
    return m


def run_fsdp(inp, rank):
    """FSDP (``parallel/fsdp.py``) on this rank, every multi-rank check of
    ``tests/test_torch_fsdp.py`` in one world: the MLP of ``mlp/...`` on
    this rank's 8 rows of ``x``/``y`` (``{cfg}/losses``, ``{cfg}/p/...``
    the full parameters after training, ``{cfg}/stats``); the global-loss
    objective on ``gx``; a FusedBatchNormAct model against the plain
    step; accumulation; the checkpoint round trip under ``ckpt_dir`` and
    its refusals (``refuse/{what}``: the error message)."""
    import torch.nn.functional as F  # noqa: F401
    from chainermn_tpu_torch import functions
    from chainermn_tpu_torch.extensions import (
        consolidate_fsdp_checkpoint, create_multi_node_checkpointer)
    from chainermn_tpu_torch.ops.fused_norm import FusedBatchNormAct
    from chainermn_tpu_torch.optim import init_optimizer_state
    from chainermn_tpu_torch.parallel import (
        fsdp_full_params, fsdp_init, make_fsdp_train_step)

    comm = create_communicator("xla", device="cpu")
    n = comm.size
    x = torch.tensor(inp["x"][rank * 8:(rank + 1) * 8])
    y = torch.tensor(inp["y"][rank * 8:(rank + 1) * 8])
    out = {}

    def mse(model):
        return lambda b: torch.mean((model(b[0]) - b[1]) ** 2)

    def keep(cfg, losses, state, meta, step):
        out[f"{cfg}/losses"] = np.asarray(losses)
        out.update({f"{cfg}/p/{k}": v.detach().numpy() for k, v in
                    fsdp_full_params(state, meta, comm).items()})
        out[f"{cfg}/stats"] = np.asarray([step.stats[k] for k in (
            "gathers", "reduce_scatters", "casts", "max_in_flight")])

    # the JAX parity runs: Adam 1e-3, five steps on the same batch
    for cfg, k, d, wire in (("k1", 1, 1, None), ("k4d0", 4, 0, None),
                            ("k4d1", 4, 1, None), ("bf16", 2, 1, "bfloat16")):
        model = fsdp_mlp(inp)
        state, meta = fsdp_init(comm, model, torch.optim.Adam(
            model.parameters(), lr=1e-3), num_buckets=k)
        step = make_fsdp_train_step(comm, mse(model), state, meta,
                                    prefetch=d, wire_dtype=wire)
        keep(cfg, [float(step((x, y))) for _ in range(5)], state, meta, step)

    # accumulation: two microbatches against the full batch (SGD momentum)
    for cfg, k in (("accum1", 1), ("accum2", 2)):
        model = fsdp_mlp(inp)
        state, meta = fsdp_init(comm, model, torch.optim.SGD(
            model.parameters(), lr=0.05, momentum=0.9), num_buckets=2)
        step = make_fsdp_train_step(comm, mse(model), state, meta,
                                    accum_steps=k)
        keep(cfg, [float(step((x, y))) for _ in range(3)], state, meta, step)

    # global_loss: JAX's sequence-sharded objective (w[t mod D] - x)^2
    class W(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.arange(6, dtype=torch.float32))

    gx = torch.tensor(inp["gx"])
    t_loc = gx.shape[1] // n
    xb = gx[:, rank * t_loc:(rank + 1) * t_loc]
    wm = W()

    def global_loss(b):
        pos = rank * t_loc + torch.arange(t_loc)
        w = wm.w[pos % 6]
        total = functions.allreduce(comm, ((w[None, :] - b) ** 2).sum())
        count = functions.allreduce(comm, torch.tensor(float(b.numel())))
        return total / count

    state, meta = fsdp_init(comm, wm, torch.optim.SGD(wm.parameters(),
                                                      lr=0.1))
    step = make_fsdp_train_step(comm, global_loss, state, meta,
                                global_loss=True)
    keep("global", [float(step(xb)) for _ in range(4)], state, meta, step)

    # BatchNorm: buffers rank-local, against the plain data-parallel step
    def bn_model():
        torch.manual_seed(3)
        return torch.nn.Sequential(
            torch.nn.Linear(8, 16), FusedBatchNormAct(16, fuse_relu=True),
            torch.nn.Linear(16, 4))

    for cfg in ("bn_plain", "bn_fsdp"):
        model = bn_model()
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        if cfg == "bn_plain":
            step = make_train_step(comm, mse(model),
                                   create_multi_node_optimizer(opt, comm))
        else:
            state, meta = fsdp_init(comm, model, opt, num_buckets=2)
            step = make_fsdp_train_step(comm, mse(model), state, meta)
        out[f"{cfg}/losses"] = np.asarray([float(step((x, y)))
                                           for _ in range(3)])
        params = dict(model.named_parameters()) if cfg == "bn_plain" \
            else fsdp_full_params(state, meta, comm)
        out.update({f"{cfg}/p/{k}": v.detach().numpy()
                    for k, v in params.items()})
        out.update({f"{cfg}/buf/{k}": v.numpy()
                    for k, v in model.named_buffers()})

    # checkpoints: save after two steps, then the third step straight and
    # from a resumed state
    def sgd_state(c, k=2):
        model = fsdp_mlp(inp)
        st, mt = fsdp_init(c, model, torch.optim.SGD(
            model.parameters(), lr=0.05, momentum=0.9), num_buckets=k)
        return model, st, mt

    path = str(inp["ckpt_dir"])
    ckpt = create_multi_node_checkpointer(comm, path, name="fsdp")
    model, state, meta = sgd_state(comm)
    step = make_fsdp_train_step(comm, mse(model), state, meta)
    for _ in range(2):
        step((x, y))
    out.update({f"saved/p/{k}": v.detach().numpy() for k, v in
                fsdp_full_params(state, meta, comm).items()})
    ckpt.save({"fsdp": state, "iteration": np.int64(2)}, 2)
    comm.barrier()
    live = consolidate_fsdp_checkpoint({"fsdp": state}, meta, comm=comm)
    out.update({f"live/p/{k}": v.detach().numpy()
                for k, v in live["fsdp"].items()})
    keep("straight", [float(step((x, y)))], state, meta, step)
    model2, state2, meta2 = sgd_state(comm)
    init_optimizer_state(state2.inner)
    restored, gen = ckpt.resume({"fsdp": state2, "iteration": np.int64(0)})
    assert restored["fsdp"] is state2 and gen == 2
    out["resumed/iteration"] = np.asarray(restored["iteration"])
    step2 = make_fsdp_train_step(comm, mse(model2), state2, meta2)
    keep("resumed", [float(step2((x, y)))], state2, meta2, step2)

    def refusal(what, template, c=comm, name="fsdp"):
        try:
            create_multi_node_checkpointer(c, path, name=name).resume(
                template)
        except ValueError as e:
            out[f"refuse/{what}"] = np.asarray(str(e))

    _, st1, _ = sgd_state(comm, k=1)
    init_optimizer_state(st1.inner)
    refusal("buckets", {"fsdp": st1, "iteration": np.int64(0)})
    refusal("unsharded", {"fsdp": {k: v.detach().clone() for k, v in
                                   fsdp_mlp(inp).state_dict().items()},
                          "iteration": np.int64(0)})
    plain = create_multi_node_checkpointer(comm, path, name="plain")
    plain.save({"fsdp": {"w": torch.zeros(3)}}, 1)
    comm.barrier()
    refusal("sharded_target", {"fsdp": state2}, name="plain")
    sub = comm.split(color=rank // 2, key=rank)
    _, st_sub, _ = sgd_state(sub)
    init_optimizer_state(st_sub.inner)
    refusal("world", {"fsdp": st_sub, "iteration": np.int64(0)}, c=sub)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- tensor and expert parallelism ------------------------------------------

def _expert_fn(kind, we=None, wo=None):
    """The JAX tests' expert functions over this rank's ``[E/P, ...]``
    weights: "mlp" gelu(t we) wo, "id", "double"."""
    import torch.nn.functional as F
    if kind == "id":
        return lambda t: t
    if kind == "double":
        return lambda t: 2.0 * t

    def mlp(t):
        if t.dim() == 2:
            return F.gelu(t @ we[0], approximate="tanh") @ wo[0]
        return torch.bmm(F.gelu(torch.bmm(t, we), approximate="tanh"), wo)
    return mlp


def run_tpep(inp, rank):
    """Tensor- and expert-parallel layers on a gloo world of ``P`` ranks
    (the JAX references run on a ``P``-device mesh in the test).

    ``tp/*``: ColumnParallelDense -> gelu -> RowParallelDense from the
    sliced dense weights; the gathered column output and its weight
    gradient; the gradients of ``sum(allreduce(gelu(x w1) w2)^2)``;
    TensorParallelMLP's output and its divisibility error.  ``ep/{case}``:
    ``moe_apply`` on this rank's tokens with its ``[E/P]`` experts (case
    meta: capacity or -1, top_k, expert function), the routing integers of
    :func:`route`, the statistics; ``aux_grad``: the logits' gradient of
    the aux loss; ``routed``: the gradients of per-expert scales;
    ``module``: ExpertParallelMLP from flax leaves, every leaf's gradient
    of ``allreduce(sum y^2) + aux`` (the router's summed over the ranks)."""
    import torch.nn.functional as F
    from chainermn_tpu_torch import functions
    from chainermn_tpu_torch.parallel.expert import (ExpertParallelMLP,
                                                     moe_apply, route)
    from chainermn_tpu_torch.parallel.tensor import (
        ColumnParallelDense, RowParallelDense, TensorParallelMLP)
    comm = create_communicator("naive", device="cpu")
    p = comm.size
    t = lambda k: torch.tensor(inp[k])  # noqa: E731
    out = {}
    if "tp/w1" in inp:
        w1, b1, w2, b2, x = (t(f"tp/{k}") for k in ("w1", "b1", "w2", "b2",
                                                    "x"))
        h = w1.shape[1] // p
        sl = slice(rank * h, (rank + 1) * h)
        col = ColumnParallelDense(w1.shape[0], h, comm, device="cpu")
        row = RowParallelDense(h, w2.shape[1], comm, device="cpu")
        with torch.no_grad():
            col.weight.copy_(w1[:, sl].T)
            col.bias.copy_(b1[sl])
            row.weight.copy_(w2[sl].T)
            row.bias.copy_(b2)
        out["tp/mlp"] = row(F.gelu(col(x), approximate="tanh")).detach()
        gcol = ColumnParallelDense(w1.shape[0], h, comm, gather_output=True,
                                   device="cpu")
        with torch.no_grad():
            gcol.weight.copy_(w1[:, sl].T)
            gcol.bias.copy_(b1[sl])
        y = gcol(x)
        out["tp/gather"] = y.detach()
        (y ** 2).sum().backward()
        out["tp/gather_grad_w"] = gcol.weight.grad.T
        w1l = w1[:, sl].clone().requires_grad_()
        w2l = w2[sl].clone().requires_grad_()
        o = functions.allreduce(comm, F.gelu(x @ w1l, approximate="tanh")
                                @ w2l)
        (o ** 2).sum().backward()
        out["tp/g_w1"], out["tp/g_w2"] = w1l.grad, w2l.grad
        mlp = TensorParallelMLP(w1.shape[0], w1.shape[1], comm, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        out["tp/module"] = mlp(x).detach()
        try:
            TensorParallelMLP(w1.shape[0], w1.shape[1] + 1, comm,
                              device="cpu")
            out["tp/module_err"] = np.asarray("")
        except ValueError as e:
            out["tp/module_err"] = np.asarray(str(e))
    cases = sorted({k.split("/")[1] for k in inp if k.startswith("ep/")})
    for c in cases:
        pre = f"ep/{c}/"
        cap, top_k, kind = (int(v) for v in inp[pre + "meta"][:3])
        cap = None if cap < 0 else cap
        n = inp[pre + "x"].shape[0] // p
        rows = slice(rank * n, (rank + 1) * n)
        x, logits = t(pre + "x")[rows], t(pre + "logits")[rows]
        e = logits.shape[1]
        epd = e // p
        mine = slice(rank * epd, (rank + 1) * epd)
        we = t(pre + "we")[mine] if pre + "we" in inp else None
        wo = t(pre + "wo")[mine] if pre + "wo" in inp else None
        fn = _expert_fn(("mlp", "id", "double")[kind], we, wo)
        if c == "aux_grad":
            lg = logits.clone().requires_grad_()
            _, st = moe_apply(fn, lg, x, comm, capacity=cap, top_k=top_k,
                              return_stats=True)
            st["aux_loss"].backward()
            out[pre + "g_logits"] = lg.grad
            continue
        if c == "routed":
            w = t(pre + "w")[mine].clone().requires_grad_()
            fn = (lambda z: z * w[0]) if epd == 1 \
                else (lambda z: z * w[:, None, :])
            y = moe_apply(fn, logits, x, comm, capacity=cap, top_k=top_k)
            functions.allreduce(comm, (y ** 2).sum()).backward()
            out[pre + "g_w"] = w.grad
            continue
        if c == "module":
            m = ExpertParallelMLP(x.shape[1], inp[pre + "up_kernel"].shape[2],
                                  comm, num_experts=e, top_k=top_k,
                                  with_stats=True, device="cpu")
            with torch.no_grad():
                m.router.weight.copy_(t(pre + "router_kernel").T)
                m.router.bias.copy_(t(pre + "router_bias"))
                for leaf in ("up_kernel", "up_bias", "down_kernel",
                             "down_bias"):
                    getattr(m, leaf).copy_(t(pre + leaf)[mine])
            y, st = m(x)
            (functions.allreduce(comm, (y ** 2).sum())
             + st["aux_loss"]).backward()
            out[pre + "y"] = y.detach()
            for name, prm in m.named_parameters():
                g = prm.grad
                if name.startswith("router"):
                    g = comm.allreduce(g.clone())
                out[pre + "g/" + name] = g
            continue
        y, st = moe_apply(fn, logits, x, comm, capacity=cap, top_k=top_k,
                          return_stats=True)
        out[pre + "y"] = y
        gates = torch.softmax(logits.float(), dim=-1)
        c_ = cap if cap is not None else max(1, 2 * top_k * n // e)
        topi, _, slot, keep = route(gates, top_k, c_, top_k > 1)
        out[pre + "topi"], out[pre + "slot"] = topi, slot
        out[pre + "keep"] = keep
        for k, v in st.items():
            out[pre + k] = v
    return {k: v.detach().numpy() if torch.is_tensor(v) else v
            for k, v in out.items()}


def run_moelm(inp, rank):
    """The MoE TransformerLM on an expert-parallel gloo world: flax
    ``params/*`` (each rank keeps its experts), this rank's rows of
    ``toks``; ``logits``, then ``steps`` Adam steps at ``lr`` through the
    example's ``train_step``: their ``ce`` and this rank's parameters as a
    flax tree (``p/*``)."""
    from chainermn_tpu_torch import weights
    from chainermn_tpu_torch.examples import train_moe_lm
    from chainermn_tpu_torch.models import TransformerLM
    comm = create_communicator("naive", device="cpu")
    cfg = {k: int(v) for k, v in zip(
        ("vocab", "d_model", "n_layers", "n_heads", "max_len", "experts",
         "top_k"), inp["cfg"])}
    e, k = cfg.pop("experts"), cfg.pop("top_k")
    model = TransformerLM(**cfg, moe_experts=e, moe_top_k=k, moe_comm=comm,
                          device="cpu")
    weights.load_flax_variables(model, nest({
        key[len("params/"):]: v for key, v in inp.items()
        if key.startswith("params/")}))
    n = inp["toks"].shape[0] // comm.size
    toks = torch.tensor(inp["toks"][rank * n:(rank + 1) * n])
    out = {"logits": model(toks).detach().numpy()}
    opt = torch.optim.Adam(model.parameters(), lr=float(inp["lr"]))
    ces = []
    for _ in range(int(inp["steps"])):
        ces.append(float(train_moe_lm.train_step(
            model, opt, toks, float(inp["aux_weight"]), comm)[1]))
    out["ce"] = np.asarray(ces)
    for key, v in flatten(weights.state_dict_to_flax(model)).items():
        out[f"p/{key}"] = v
    return out


def drive_engine(eng, comm, prompts, max_new, keep_logits=False):
    """Rank 0 submits ``prompts``; every rank steps until rank 0's engine
    is idle (its verdict broadcast each step).  ``(tokens by rid, [kept
    logits per step], [spec stats per step])``."""
    if comm.rank == 0:
        for pr in prompts:
            eng.submit(pr, max_new)
    logits, spec = [], []
    while not comm.bcast_obj(eng.idle(), root=0):
        res = eng.step()
        if keep_logits and res.last_logits is not None:
            logits.append(res.last_logits)
        if res.spec is not None:
            spec.append(res.spec)
    return ({c.rid: c.tokens for c in eng.completions}, logits, spec)


def run_tpserve(inp, rank):
    """Tensor- and expert-parallel serving on a gloo world: the engine over
    the whole communicator (``tp x ep`` = the world size), rank 0 alone
    submitting.  ``tp``: the dense LM from flax ``dense/*`` at ``tp_size``
    = the world, vanilla and spec_k 2 (its bottom layer as the draft);
    ``ep``: the MoE LM from ``moe/*`` at ``ep_size`` (``tp_size`` =
    world / ``ep``), its kept logits a step; each part's tokens as JSON."""
    import json
    from chainermn_tpu_torch import weights
    from chainermn_tpu_torch.benchmarks.bench_serving import truncated_draft
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import InferenceEngine, ServingConfig
    comm = create_communicator("naive", device="cpu")
    parts = str(inp["parts"]).split(",")
    out = {}

    def model_from(prefix, **cfg):
        m = TransformerLM(**cfg, device="cpu")
        return weights.load_flax_variables(m, nest({
            k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}))

    if "tp" in parts:
        dense = model_from("dense/", vocab=61, d_model=32, n_layers=2,
                           n_heads=4, max_len=128, n_kv_heads=2)
        for label, k in (("tp", 0), ("spec", 2)):
            cfg = ServingConfig(**json.loads(str(inp[f"{label}/cfg"])),
                                tp_size=comm.size)
            eng = InferenceEngine(dense, cfg, comm=comm, draft_model=(
                truncated_draft(dense) if k else None))
            toks, _, spec = drive_engine(
                eng, comm, json.loads(str(inp[f"{label}/prompts"])),
                int(inp[f"{label}/max_new"]))
            out[f"{label}/tokens"] = np.asarray(json.dumps(sorted(
                toks.items())))
            out[f"{label}/accepted"] = np.asarray(
                sum(s["accepted"] for s in spec))
            out[f"{label}/kv_heads"] = np.asarray(eng.cache.k.shape[-2])
    if "ep" in parts:
        ep = int(inp["ep"])
        moe = model_from("moe/", vocab=32, d_model=16, n_layers=1,
                         n_heads=2, max_len=64, moe_experts=4, moe_top_k=2)
        cfg = ServingConfig(page_size=4, num_pages=16, max_seqs=2,
                            chunk_tokens=4, max_pages_per_seq=4,
                            ep_size=ep, tp_size=comm.size // ep,
                            keep_logits=True)
        eng = InferenceEngine(moe, cfg, comm=comm)
        toks, logits, _ = drive_engine(eng, comm, [[1, 2, 3], [5, 6]], 4,
                                       keep_logits=True)
        out["ep/tokens"] = np.asarray(json.dumps(sorted(toks.items())))
        out["ep/logits"] = np.stack(logits)
        out["ep/experts"] = np.asarray(eng.model.blocks[0].moe.expert_rows)
    return out


# ---- gradient compression --------------------------------------------------

def tanh_mlp(inp, prefix: str, n: int):
    """The JAX compression tests' MLP (``tanh(x @ w + b)`` layers) from
    ``{prefix}/layer{i}/w|b``."""
    from chainermn_tpu_torch.benchmarks.bench_fsdp_overlap import TanhLayer
    layers = []
    for i in range(n):
        layer = TanhLayer(torch.tensor(inp[f"{prefix}/layer{i}/w"]))
        with torch.no_grad():
            layer.b.copy_(torch.tensor(inp[f"{prefix}/layer{i}/b"]))
        layers.append(layer)
    return torch.nn.Sequential(*layers)


def _compress_ef(inp, rank, comm, out):
    """3 deterministic EF steps of int8 and fp8 over ``ef/*``: the codes
    and flags each rank puts on the wire, the residual, exponents, step
    and the means, per step."""
    from chainermn_tpu_torch.communicators import _packing
    from chainermn_tpu_torch.compression import (
        Fp8Compressor, Int8Compressor)
    grads = {k[3:]: torch.tensor(inp[k][rank]) for k in inp
             if k.startswith("ef/")}
    for comp in (Int8Compressor(chunk_size=256, stochastic=False),
                 Fp8Compressor(chunk_size=256, stochastic=False)):
        st = comm.init_compression_state(grads, comp)
        for step in range(3):
            buf = _packing.pack(grads, comm_dtype=torch.float32)[0][0]
            codes, _ = comp.compress(buf, st, rank=rank,
                                     world_size=comm.size)
            mean, st = comm.allreduce_grad(grads, compressor=comp, state=st)
            pre = f"ef/{comp.name}/{step}"
            out[f"{pre}/wire"] = codes.view(torch.int8).numpy()
            for k in ("ef", "scale", "step"):
                out[f"{pre}/{k}"] = getattr(st, k).numpy()
            for k, v in mean.items():
                out[f"{pre}/mean/{k}"] = v.numpy()


def _compress_contracts(inp, rank, comm, out):
    """JAX's EF contracts on this world: int8 EF decay over 64
    deterministic steps, stochastic unbiasedness over 32 rounds."""
    from chainermn_tpu_torch.compression import Int8Compressor
    grads = {k[6:]: torch.tensor(inp[k][rank]) for k in inp
             if k.startswith("decay/")}
    ref = {k: torch.tensor(inp[f"decay/{k}"]).mean(0) for k in grads}
    comp = Int8Compressor(stochastic=False)
    st = comm.init_compression_state(grads, comp)
    acc = {k: torch.zeros_like(v) for k, v in ref.items()}
    errs = []
    for t in range(1, 65):
        mean, st = comm.allreduce_grad(grads, compressor=comp, state=st)
        acc = {k: acc[k] + mean[k] for k in ref}
        if t in (1, 4, 16, 64):
            errs.append(max(float((acc[k] / t - ref[k]).abs().max())
                            for k in ref))
    out["decay/errs"] = np.asarray(errs)
    out["decay/ef_norm"] = np.asarray(float(st.ef.norm()))
    comp = Int8Compressor(stochastic=True, seed=7)
    g = {"w": torch.full((3, 4), float(rank)), "odd": torch.full((7,),
                                                                 float(rank))}
    st = comm.init_compression_state(g, comp)
    acc = torch.zeros(3, 4)
    for _ in range(32):
        mean, st = comm.allreduce_grad(g, compressor=comp, state=st)
        acc = acc + mean["w"]
    out["unbiased/err"] = np.asarray(
        float((acc / 32 - (comm.size - 1) / 2).abs().max()))


def _compress_optimizer(inp, rank, out):
    """The optimizer seam on the JAX tests' MLP problem: 12 Adam steps
    uncompressed, int8 and fp8; 6 steps of the bfloat16 knob against
    ``compression=NoCompression("bfloat16")``."""
    import warnings
    from chainermn_tpu_torch.compression import NoCompression
    x = torch.tensor(inp["opt/x"][rank * 4:(rank + 1) * 4])
    y = torch.tensor(inp["opt/y"][rank * 4:(rank + 1) * 4])
    runs = {"base": ("flat", {}, None, 12), "int8": ("flat", {}, "int8", 12),
            "fp8": ("flat", {}, "fp8", 12),
            "knob": ("xla", {"allreduce_grad_dtype": "bfloat16"}, None, 6),
            "nocomp": ("xla", {}, NoCompression("bfloat16"), 6)}
    for name, (flavor, kw, compression, steps) in runs.items():
        comm = create_communicator(flavor, device="cpu", **kw)
        model = tanh_mlp(inp, "opt", 4)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            opt = create_multi_node_optimizer(
                torch.optim.Adam(model.parameters(), lr=1e-2), comm,
                compression=compression)
        out[f"opt/{name}/warned"] = np.asarray(
            any(issubclass(w.category, DeprecationWarning) for w in caught))
        step = make_train_step(
            comm, lambda b: torch.mean((model(b[0]) - b[1]) ** 2), opt)
        out[f"opt/{name}/losses"] = np.asarray(
            [float(step((x, y))) for _ in range(steps)])
        for k, v in model.state_dict().items():
            out[f"opt/{name}/p/{k}"] = v.numpy()
        if compression in ("int8", "fp8"):
            out[f"opt/{name}/comp_step"] = opt.comp_state.step.numpy()


def _compress_fsdp(inp, rank, out):
    """FSDP's quantized buckets: int8 on 4 buckets for 12 steps (losses,
    layout, EF steps), int8 on the first of 2 buckets for 8; and one
    bucket's compressed reduce-scatter on ``rs/*`` for int8 and fp8."""
    from chainermn_tpu_torch.compression import (
        CompressionState, Fp8Compressor, Int8Compressor)
    from chainermn_tpu_torch.parallel import (
        fsdp_init, fsdp_layout, make_fsdp_train_step)
    from chainermn_tpu_torch.parallel.fsdp import compressed_scatter_encode
    comm = create_communicator("flat", device="cpu")
    x = torch.tensor(inp["opt/x"][rank * 4:(rank + 1) * 4])
    y = torch.tensor(inp["opt/y"][rank * 4:(rank + 1) * 4])
    for name, k, comps, steps in (("int8", 4, "int8", 12),
                                  ("mixed", 2, ["int8", None], 8)):
        model = tanh_mlp(inp, "opt", 4)
        state, meta = fsdp_init(comm, model, torch.optim.Adam(
            model.parameters(), lr=0.01), num_buckets=k,
            bucket_compressors=comps)
        step = make_fsdp_train_step(
            comm, lambda b: torch.mean((model(b[0]) - b[1]) ** 2), state,
            meta)
        out[f"fsdp/{name}/losses"] = np.asarray(
            [float(step((x, y))) for _ in range(steps)])
        out[f"fsdp/{name}/quantized"] = np.asarray(
            [bl.compressor is not None for bl in meta.buckets])
        out[f"fsdp/{name}/specs"] = np.asarray(
            json.dumps(fsdp_layout(state)["compression"]["specs"]))
        out[f"fsdp/{name}/ef_steps"] = np.asarray(
            [float(c.step[0]) for c in state.comp if c is not None])
        out[f"fsdp/{name}/scatter_bytes"] = np.asarray(
            step.stats["scatter_bytes"])
    for comp in (Int8Compressor(stochastic=False),
                 Fp8Compressor(stochastic=False)):
        cs = CompressionState(
            ef=torch.tensor(inp["rs/ef"][rank]),
            scale=torch.tensor(inp["rs/scale"][rank:rank + 1]),
            step=torch.zeros(1), spec=comp.spec)
        e_vec = comm.allgather(cs.scale)[:, 0]
        send, fold = compressed_scatter_encode(
            comm, comp, cs, torch.tensor(inp["rs/ct"][rank]), e_vec)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        pre = f"rs/{comp.name}"
        out[f"{pre}/gshard"] = fold(recv).numpy()
        for key in ("ef", "scale", "step"):
            out[f"{pre}/{key}"] = getattr(cs, key).numpy()


def _compress_mnist(inp, rank, comm, out):
    """JAX's two-process MNIST contract on this world: MLP(64, 10) on
    MNIST-shaped blobs, each rank its half, 20 Adam steps uncompressed
    and with int8 (losses, this rank's EF norm); then the example's
    ``main`` for 2 epochs with and without ``--compression int8``."""
    import torch.nn.functional as F
    from chainermn_tpu_torch.datasets import make_classification
    from chainermn_tpu_torch.examples import train_mnist
    from chainermn_tpu_torch.models import MLP
    data = make_classification(n=1024, dim=784, n_classes=10, noise=4.0,
                               seed=0)
    xs = torch.tensor(np.stack([data[i][0] for i in range(len(data))]))
    ys = torch.tensor(np.asarray([data[i][1] for i in range(len(data))]))
    half = len(xs) // comm.size
    x, y = xs[rank * half:(rank + 1) * half], ys[rank * half:(rank + 1)
                                                 * half].long()
    for name in ("base", "int8"):
        model = MLP(64, 10, device="cpu",
                    generator=torch.Generator().manual_seed(0))
        comm.bcast_data(model)
        opt = create_multi_node_optimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3), comm,
            compression=None if name == "base" else name)
        step = make_train_step(
            comm, lambda b: F.cross_entropy(model(b[0]), b[1]), opt)
        losses, ef = [], []
        for _ in range(20):
            losses.append(float(step((x, y))))
            if name != "base":
                ef.append(float(opt.comp_state.ef.norm()))
        out[f"mnist/{name}/losses"] = np.asarray(losses)
        out[f"mnist/{name}/ef"] = np.asarray(ef)
    for name, flags in (("base", []), ("int8", ["--compression", "int8"])):
        res = train_mnist.main(["--device", "cpu", "--epoch", "2", "--unit",
                                "64", "--prefetch", "0", "--out",
                                str(inp["out_dir"]) + f"/{name}"] + flags)
        out[f"example/{name}/loss"] = np.asarray(
            [r["main/loss"] for r in res["log"]])


def run_compress(inp, rank):
    """The multi-rank checks of ``tests/test_torch_compression.py``:
    ``parts`` names which (``ef``, ``sum``, ``contracts``, ``opt``,
    ``fsdp``, ``mnist``)."""
    from chainermn_tpu_torch.compression import Fp8Compressor
    parts = str(inp["parts"]).split(",")
    comm = create_communicator("flat", device="cpu")
    out = {}
    if "ef" in parts:
        _compress_ef(inp, rank, comm, out)
    if "nc" in parts:
        # NoCompression(wire) on a plain flavor against the dtype knob
        from chainermn_tpu_torch.compression import NoCompression
        g = {k[3:]: torch.tensor(inp[k][rank]) for k in inp
             if k.startswith("ef/")}
        knob = create_communicator("xla", device="cpu",
                                   allreduce_grad_dtype="bfloat16")
        for name, red in (
                ("knob", knob.allreduce_grad(g)),
                ("comp", comm.allreduce_grad(
                    g, compressor=NoCompression("bfloat16"))),
                ("bare", comm.allreduce_grad(g, compressor=NoCompression())),
                ("plain", comm.allreduce_grad(g))):
            out.update({f"nc/{name}/{k}": v.numpy() for k, v in red.items()})
    if "sum" in parts:
        codes = torch.tensor(inp["sum/codes"][rank]).view(
            torch.float8_e4m3fn)
        out["sum/flat"] = comm._sum_codes(codes).view(torch.uint8).numpy()
        if comm.size == 4:
            hier = create_communicator("hierarchical", intra_size=2,
                                       device="cpu")
            out["sum/hier"] = hier._sum_codes(codes).view(
                torch.uint8).numpy()
        # the whole route: an fp8 mean over the hierarchical flavor
        if comm.size == 4:
            g = {"w": torch.tensor(inp["ef/w"][rank])}
            comp = Fp8Compressor(chunk_size=256, stochastic=False)
            mean, _ = hier.allreduce_grad(
                g, compressor=comp, state=hier.init_compression_state(
                    g, comp))
            out["sum/hier_mean"] = mean["w"].numpy()
    if "contracts" in parts:
        _compress_contracts(inp, rank, comm, out)
    if "opt" in parts:
        _compress_optimizer(inp, rank, out)
    if "fsdp" in parts:
        _compress_fsdp(inp, rank, out)
    if "mnist" in parts:
        _compress_mnist(inp, rank, comm, out)
    return out


# ---- pipeline parallelism ----------------------------------------------------

def _tanh_stage(p, a):
    return torch.tanh(a @ p["w"] + p["b"])


class SavedBytes:
    """The peak bytes held by autograd's saved tensors inside the
    context (``torch.autograd.graph.saved_tensors_hooks``)."""

    def __init__(self):
        self.now = self.peak = 0

    class _Box:
        def __init__(self, t):
            self.t = t

    def __enter__(self):
        import weakref

        def pack(t):
            n = t.numel() * t.element_size()
            self.now += n
            self.peak = max(self.peak, self.now)
            box = self._Box(t)
            weakref.finalize(box, self._free, n)
            return box

        self._ctx = torch.autograd.graph.saved_tensors_hooks(
            pack, lambda box: box.t)
        self._ctx.__enter__()
        return self

    def _free(self, n):
        self.now -= n

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


def run_pipe(inp, rank):
    """The multi-rank checks of ``tests/test_torch_pipeline.py``: the tanh
    stage (``w``/``b`` stacked ``[S, ...]``, rank s's slice) through GPipe
    and 1F1B, and a stage of two transformer Blocks from the stacked flax
    tree ``blk/...``."""
    from chainermn_tpu_torch.models.transformer import Block
    from chainermn_tpu_torch.parallel import (
        make_pipeline_fn, make_pipeline_train_fn, module_stage_fn,
        pipeline_apply)
    from chainermn_tpu_torch.weights import flax_stage_to_state_dict
    comm = create_communicator("flat", device="cpu")
    s, n = rank, comm.size
    m = int(inp["m"])
    out = {}

    def params():
        return {"w": torch.tensor(inp["w"][s]).requires_grad_(),
                "b": torch.tensor(inp["b"][s]).requires_grad_()}

    def mse(yy, tt):
        return ((yy - tt) ** 2).mean()

    x, t = torch.tensor(inp["x"]), torch.tensor(inp["t"])
    p = params()
    gpipe = make_pipeline_fn(_tanh_stage, comm, n_microbatches=m)
    y = gpipe(p, x)
    out["fwd"] = y.detach().numpy()
    (y ** 2).sum().backward()
    out.update({f"gpipe/{k}": v.grad.numpy() for k, v in p.items()})
    out["m1"] = make_pipeline_fn(_tanh_stage, comm, n_microbatches=1)(
        params(), x[:x.shape[0] // m]).detach().numpy()
    loss, g = make_pipeline_train_fn(_tanh_stage, mse, comm,
                                     n_microbatches=m)(params(), x, t)
    out["1f1b/loss"] = loss.numpy()
    out.update({f"1f1b/{k}": v.numpy() for k, v in g.items()})
    p = params()
    o = gpipe(p, x).reshape((m, -1) + tuple(x.shape[1:]))
    tm = t.reshape(o.shape)
    torch.stack([mse(o[i], tm[i]) for i in range(m)]).mean().backward()
    out.update({f"gpipe_mse/{k}": v.grad.numpy() for k, v in p.items()})
    # M = 8S: the ring's slots reused; the saved-tensor high-water marks
    xb, tb = torch.tensor(inp["xbig"]), torch.tensor(inp["tbig"])
    mb = 8 * n
    with SavedBytes() as one:
        loss, g = make_pipeline_train_fn(_tanh_stage, mse, comm,
                                         n_microbatches=mb)(params(), xb, tb)
    out["big/loss"] = loss.numpy()
    out.update({f"big/{k}": v.numpy() for k, v in g.items()})
    p = params()
    with SavedBytes() as gp:
        o = make_pipeline_fn(_tanh_stage, comm, n_microbatches=mb)(p, xb)
        o = o.reshape((mb, -1) + tuple(xb.shape[1:]))
        tm = tb.reshape(o.shape)
        torch.stack([mse(o[i], tm[i]) for i in range(mb)]).mean().backward()
    out["mem/1f1b"], out["mem/gpipe"] = np.asarray(one.peak), np.asarray(
        gp.peak)
    out["last"] = pipeline_apply(
        _tanh_stage, params(), x.reshape((m, -1) + tuple(x.shape[1:])),
        comm, collect="last").detach().numpy()
    # the Block stage: two blocks, weights from the stacked flax tree
    stacked = nest({k[4:]: v for k, v in inp.items()
                    if k.startswith("blk/")})
    d, heads = int(inp["blk_d"]), int(inp["blk_heads"])
    stage = torch.nn.Sequential(*[Block(d, heads, "xla") for _ in range(2)])
    sd = flax_stage_to_state_dict(stacked, s)
    stage.load_state_dict(sd)
    fn = module_stage_fn(stage)
    bp = {k: v.clone().requires_grad_() for k, v in sd.items()}
    bx, bt = torch.tensor(inp["bx"]), torch.tensor(inp["bt"])
    bm = int(inp["bm"])
    yb = make_pipeline_fn(fn, comm, n_microbatches=bm)(bp, bx)
    out["blk/fwd"] = yb.detach().numpy()
    loss, g = make_pipeline_train_fn(fn, mse, comm, n_microbatches=bm)(
        {k: v.detach() for k, v in bp.items()}, bx, bt)
    out["blk/1f1b/loss"] = loss.numpy()
    out.update({f"blk/1f1b/g/{k}": v.numpy() for k, v in g.items()})
    return out


def _plan_trees(inp, rank):
    """``{tree: {leaf: this rank's tensor}}`` of the ``tree/{tree}/{leaf}``
    inputs."""
    trees: dict = {}
    for k in inp:
        if k.startswith("tree/"):
            _, tree, leaf = k.split("/", 2)
            trees.setdefault(tree, {})[leaf] = torch.tensor(inp[k][rank])
    return trees


def _plans(inp, key):
    from chainermn_tpu_torch.planner import load_plan
    return [load_plan(d) for d in json.loads(str(inp[key]))]


def run_plan(inp, rank):
    """The collective planner on this world (``parts``, comma-separated):

    * ``flavors`` -- every flavor's ``allreduce_grad`` of each tree and
      ``execute_plan(comm.plan())`` of it (``fl/{label}/{own|plan}/...``);
    * ``plans`` -- ``execute_plan`` of every plan in ``plans`` (JSON) on a
      naive communicator (``pl/{plan}/{tree}/{leaf}``) and the JAX census
      kinds of what it issued (``census/{plan}``);
    * ``quant`` -- the per-hop plans in ``qplans`` through
      ``allreduce_grad(compressor=plan, state=)`` over the ``q{k}`` trees
      in turn (``qt/{plan}/{k}/{leaf}``, then each hop's ``ef``);
    * ``a2a`` -- ``execute_alltoall`` of the ``a2aplans`` on ``a2a/buf``,
      with the gradient of ``sum(y * a2a/w)``, and ``comm.alltoall``;
    * ``refuse`` -- the executor's refusals, as flags;
    * ``auto`` -- the auto communicator on the table ``table`` (JSON):
      its pick and mean of each tree beside ``execute_plan`` of the pick,
      and 3 double-buffered SGD steps beside the ``xla`` bf16 flavor's;
    * ``mnist`` -- the MNIST example for one epoch with ``--communicator
      flat`` and ``auto`` (``mnist/{name}/loss``).
    """
    from chainermn_tpu_torch.planner import (
        PlanError, census_of_record, execute_alltoall, execute_plan,
        flavor_plan, record_collectives)
    intra = int(inp["intra_size"])
    world = dist.get_world_size()
    parts = str(inp["parts"]).split(",")
    trees = _plan_trees(inp, rank)
    out = {}

    def put(prefix, tree):
        out.update({f"{prefix}/{n}": v.numpy() for n, v in tree.items()})

    if "flavors" in parts:
        for label, name, kw in FLAVORS:
            if name == "pure_nccl":
                continue
            size = world if name == "single_node" else intra
            comm = create_communicator(name, intra_size=size, device="cpu",
                                       **kw)
            for t, tree in trees.items():
                put(f"fl/{label}/own/{t}", comm.allreduce_grad(tree))
                put(f"fl/{label}/plan/{t}",
                    execute_plan(comm.plan(), comm, tree))
    comm = create_communicator("naive", intra_size=intra, device="cpu")
    if "plans" in parts:
        for plan in _plans(inp, "plans"):
            for t, tree in trees.items():
                with record_collectives() as rec:
                    put(f"pl/{plan.name}/{t}",
                        execute_plan(plan, comm, tree))
                out[f"census/{plan.name}"] = np.asarray(
                    census_of_record(rec) or ("",))
    if "quant" in parts:
        steps = sorted(k for k in trees if k.startswith("q"))
        for plan in _plans(inp, "qplans"):
            states = comm.init_compression_state(trees[steps[0]], plan)
            for k in steps:
                mean, states = comm.allreduce_grad(
                    trees[k], compressor=plan, state=states)
                put(f"qt/{plan.name}/{k}", mean)
            for hop, st in states.items():
                out[f"qt/{plan.name}/ef/{hop}"] = st.ef.numpy()
    if "a2a" in parts:
        buf = torch.tensor(inp["a2a/buf"][rank])
        w = torch.tensor(inp["a2a/w"][rank])
        out["a2a/ref"] = comm.alltoall(buf).numpy()
        for plan in _plans(inp, "a2aplans"):
            x = buf.clone().requires_grad_(True)
            with record_collectives() as rec:
                y = execute_alltoall(plan, comm, x)
            (y * w).sum().backward()
            out[f"a2a/{plan.name}"] = y.detach().numpy()
            out[f"a2a/{plan.name}/grad"] = x.grad.numpy()
            out[f"a2a/{plan.name}/census"] = np.asarray(
                census_of_record(rec) or ("",))
    if "refuse" in parts:
        from chainermn_tpu_torch.planner import (
            compressed_two_dimensional)
        tree = trees["q0"]
        plan = compressed_two_dimensional({"name": "int8", "chunk_size": 64,
                                           "stochastic": False})
        bad = comm.init_compression_state({"x": torch.zeros(64)}, plan)
        try:
            comm.allreduce_grad(tree, compressor=plan, state=bad)
        except ValueError as e:
            out["refuse/mis_sized"] = np.asarray(
                "init_plan_compression_states" in str(e))
        try:
            execute_plan(flavor_plan("naive"), comm, tree, states={})
        except PlanError:
            out["refuse/leaf_states"] = np.asarray(True)
        try:
            comm.allreduce_grad(tree, compressor=plan, state={})
        except ValueError as e:
            out["refuse/missing"] = np.asarray("missing" in str(e))
    if "auto" in parts:
        table = json.loads(str(inp["table"]))
        auto = create_communicator("auto", intra_size=intra, device="cpu",
                                   plan_table=table)
        for t, tree in trees.items():
            pick = auto._select(tree)
            out[f"auto/pick/{t}"] = np.asarray(pick.name)
            put(f"auto/own/{t}", auto.allreduce_grad(tree))
            put(f"auto/plan/{t}", execute_plan(pick, auto, tree))
        xla = create_communicator("xla", intra_size=intra, device="cpu",
                                  allreduce_grad_dtype="bfloat16")
        x = torch.tensor(inp["db/x"][rank])
        for label, c in (("auto", auto), ("xla", xla)):
            torch.manual_seed(0)
            lin = torch.nn.Linear(x.shape[1], 3)
            opt = create_multi_node_optimizer(
                torch.optim.SGD(lin.parameters(), lr=0.1), c,
                double_buffering=True)
            for _ in range(3):
                opt.zero_grad()
                lin(x).square().mean().backward()
                opt.step()
            opt._drain()
            out[f"db/{label}/w"] = lin.weight.detach().numpy()
    if "mnist" in parts:
        from chainermn_tpu_torch.examples import train_mnist
        for name in ("flat", "auto"):
            res = train_mnist.main([
                "--device", "cpu", "--epoch", "1", "--unit", "64",
                "--prefetch", "0", "--communicator", name,
                "--out", str(inp["out_dir"]) + f"/{name}"])
            out[f"mnist/{name}/loss"] = np.asarray(
                [r["main/loss"] for r in res["log"]])
    return out


def run_planuse(inp, rank):
    """The planner's consumers on this world (``parts``, comma-separated):

    * ``moe`` -- ``moe_apply(2 t, plan=)`` of this rank's ``moe/x`` under
      ``moe/logits`` for ``plan=None`` and every plan of ``moeplans``:
      ``moe/{name}/y`` and the gradient of the summed squares
      ``moe/{name}/gx``; and a MoE ``TransformerLM(moe_plan=)``'s logits;
    * ``bcast`` -- ``broadcast_inference_params(plan=)`` of this rank's
      tree for each plan of ``bplans`` (root in the plan), and
      ``Router.distribute_weights``' default plan;
    * ``engine`` -- a MoE serving engine over the world (``ep_size`` = the
      world) without and with the flat exchange plan (tokens), and the
      plan-table pickup: rank 0 registers a table before step 2 and every
      rank records the step it installed it on;
    * ``opt`` -- 3 SGD steps of ``create_multi_node_optimizer(
      compression=<per-hop plan>)`` beside the same steps through
      ``allreduce_grad(compressor=plan, state=)``;
    * ``tuner`` -- an ``OnlineTuner`` over an ``auto`` communicator, fed
      a degraded inter-node link on rank 0 only, then ``maybe_swap`` on
      every rank: each rank's swapped table hash and pin.
    """
    from chainermn_tpu_torch.planner import (
        PlanTable, active_plan_table_meta, clear_active_plan_table,
        compressed_two_dimensional, flavor_plan, load_plan,
        set_active_plan_table)
    intra = int(inp["intra_size"])
    world = dist.get_world_size()
    parts = str(inp["parts"]).split(",")
    comm = create_communicator("naive", intra_size=intra, device="cpu")
    out = {}
    if "moe" in parts:
        from chainermn_tpu_torch.models.transformer import TransformerLM
        from chainermn_tpu_torch.parallel.expert import moe_apply
        logits = torch.tensor(inp["moe/logits"][rank])
        e = logits.shape[-1]
        plans = [None] + _plans(inp, "moeplans")
        for plan in plans:
            name = "none" if plan is None else plan.name
            x = torch.tensor(inp["moe/x"][rank]).requires_grad_(True)
            y = moe_apply(lambda t: 2.0 * t, logits, x, comm,
                          num_experts=e, plan=plan)
            (y ** 2).sum().backward()
            out[f"moe/{name}/y"] = y.detach().numpy()
            out[f"moe/{name}/gx"] = x.grad.numpy()
        toks = torch.tensor(inp["moe/toks"][rank])
        for plan in (None, plans[1]):
            lm = TransformerLM(32, 16, 1, 2, max_len=16, moe_experts=2 *
                               world, moe_comm=comm, moe_plan=plan,
                               device="cpu",
                               generator=torch.Generator().manual_seed(0))
            with torch.no_grad():
                out[f"lm/{'none' if plan is None else 'plan'}"] = \
                    lm(toks).numpy()
    if "bcast" in parts:
        from chainermn_tpu_torch.serving import Router
        from chainermn_tpu_torch.serving import weights as sw
        tree = {"w": torch.tensor(inp["bc/w"][rank]),
                "h": torch.tensor(inp["bc/w"][rank]).to(torch.bfloat16),
                "ids": torch.arange(5) * (rank + 1),
                "q": sw.quantize_inference_params(
                    {"m": torch.tensor(inp["bc/w"][rank])})}
        for plan in _plans(inp, "bplans"):
            got = sw.broadcast_inference_params(comm, tree, plan=plan)
            out.update({f"bc/{plan.name}/{k}": v.float().numpy()
                        for k, v in flatten_tensors(got).items()})
        got = Router.distribute_weights(comm, tree)
        out.update({f"bc/router/{k}": v.float().numpy()
                    for k, v in flatten_tensors(got).items()})
        out.update({f"bc/mine/{k}": v.float().numpy()
                    for k, v in flatten_tensors(tree).items()})
    if "engine" in parts:
        from chainermn_tpu_torch.models.transformer import TransformerLM
        from chainermn_tpu_torch.serving import InferenceEngine, ServingConfig
        cfg = dict(page_size=4, num_pages=16, max_seqs=2, chunk_tokens=4,
                   max_pages_per_seq=4)
        a2a = load_plan(json.loads(str(inp["moeplans"]))[0])
        table = PlanTable()
        table.put(comm.plan_topology(), "float32", "<=4KiB",
                  flavor_plan("flat"))
        for label, plan in (("none", None), ("plan", a2a)):
            lm = TransformerLM(32, 16, 1, 2, max_len=64,
                               moe_experts=2 * world, moe_top_k=2,
                               device="cpu",
                               generator=torch.Generator().manual_seed(0))
            eng = InferenceEngine(lm, ServingConfig(
                **cfg, ep_size=world, moe_plan=plan), comm=comm)
            if rank == 0:
                for pr in ([1, 2, 3], [5, 6], [7]):
                    eng.submit(pr, 4)
            step = 0
            while not comm.bcast_obj(eng.idle(), root=0):
                if label == "plan" and step == 2 and rank == 0:
                    set_active_plan_table(table, step=40)
                eng.step()
                step += 1
            toks = {c.rid: c.tokens for c in eng.completions}
            out[f"engine/{label}/tokens"] = np.asarray(
                [t for rid in sorted(toks) for t in toks[rid]])
            if label == "plan":
                out["engine/pickups"] = np.asarray(eng.plan_table_pickups)
                meta = active_plan_table_meta()
                out["engine/hash"] = np.asarray(meta["table_hash"])
                out["engine/swap_step"] = np.asarray(meta["swap_step"])
        clear_active_plan_table()
    if "opt" in parts:
        plan = compressed_two_dimensional({"name": "int8",
                                           "stochastic": False})
        x = torch.tensor(inp["opt/x"][rank])
        finals = {}
        for label in ("opt", "manual"):
            torch.manual_seed(0)
            lin = torch.nn.Linear(x.shape[1], 3)
            sgd = torch.optim.SGD(lin.parameters(), lr=0.1)
            if label == "opt":
                opt = create_multi_node_optimizer(sgd, comm,
                                                  compression=plan)
            else:
                states = comm.init_compression_state(
                    [p.detach() for p in lin.parameters()], plan)
            for _ in range(3):
                lin.zero_grad()
                lin(x).square().mean().backward()
                if label == "opt":
                    opt.step()
                else:
                    params = list(lin.parameters())
                    mean, states = comm.allreduce_grad(
                        [p.grad for p in params], compressor=plan,
                        state=states)
                    for p, g in zip(params, mean):
                        p.grad = g
                    sgd.step()
            finals[label] = lin.weight.detach().numpy()
            if label == "opt":
                out["opt/hops"] = np.asarray(sorted(opt.comp_state))
        out["opt/opt"], out["opt/manual"] = finals["opt"], finals["manual"]
    if "tuner" in parts:
        from chainermn_tpu_torch.planner import OnlineTuner, plan_table_hash
        auto = create_communicator("auto", intra_size=intra, device="cpu")
        tuner = OnlineTuner(comm=auto, min_samples=1,
                            fallback_gbps={"nvlink": 100.0})
        if rank == 0:
            for _ in range(4):
                tuner.observations.add("ib", 8 << 20, (8 << 20) / 0.5e9)
                tuner.observe_payload(8 << 20)
            tuner.on_regression([{"bucket": "ib_comm", "ratio": 4.0}])
        decision = tuner.maybe_swap(step=7)
        out["tuner/swapped"] = np.asarray(decision is not None)
        out["tuner/hash"] = np.asarray(plan_table_hash(auto.plan_table))
        out["tuner/pin"] = np.asarray(json.dumps(active_plan_table_meta()))
        out["tuner/pick"] = np.asarray(auto.plan_for(8 << 20,
                                                     "float32").name)
        clear_active_plan_table()
    return out


def _obs_reset():
    from chainermn_tpu_torch import observability as obs
    obs.disable()
    obs.reset_flight_recorder()
    obs.get_registry().reset()


def comm_metric_rows(snapshot) -> list:
    """The ``comm_*`` records of a registry snapshot, seconds reduced to
    their counts: ``[name, labels, value]`` sorted (JSON-friendly)."""
    rows = []
    for r in snapshot:
        if not r["name"].startswith("comm_"):
            continue
        val = r["count"] if r["type"] == "histogram" else r["value"]
        rows.append([r["name"], sorted(r["labels"].items()), val])
    return sorted(rows)


def instrument_sequence(inst, rank: int, n: int) -> None:
    """The op sequence the instrumented-communicator parity runs (the
    JAX side runs the same in ``run_spmd``)."""
    g = {"a": torch.full((3, 4), float(rank)), "b": torch.ones(5)}
    inst.allreduce_grad(g)
    inst.bcast_data({"w": torch.ones(3, 4)})
    inst.allgather_obj(rank)
    inst.bcast_obj("x" if rank == 0 else None)
    inst.allreduce_obj({"v": rank})
    inst.gather_obj(rank)
    inst.scatter_obj(list(range(n)) if rank == 0 else None)
    inst.barrier()


def run_obs(inp, rank):
    """Observability parts (``parts``): ``inst`` -- the instrumented xla
    float16 communicator through :func:`instrument_sequence`, its
    ``comm_*`` rows as JSON; ``mnist`` -- ``train_mnist.main(argv)`` with
    observability off then on: both runs' parameters, the cast kernel's
    (plain on the CPU) call counts, the metrics records' kinds and keys;
    ``cp`` -- the default control plane (a socket world at MASTER_PORT +
    1), a communicator on it against the gloo plane on the same object
    ops, and a split of it; ``stream`` -- ``TelemetryAggregator.collect``
    over the gloo plane, the last rank's steps three times the others',
    the fleet document as JSON; ``swap`` -- an online tuner on the auto
    communicator, only rank 0 observing the slow inter-node link and
    armed, ``maybe_swap(step=11)`` on both ranks: each rank's decision,
    pin, swap events and 8 MiB plan; ``wdgloo`` -- the watchdog (no
    socket plane: local-only) on an instrumented communicator, rank 0 in
    an ``allgather_obj`` that the last rank joins ``inp["late"]``
    seconds late: rank 0's dump (written while its main thread waits in
    gloo) and the op's result."""
    from chainermn_tpu_torch import observability as obs
    parts = str(inp["parts"]).split(",")
    n = dist.get_world_size()
    out = {}
    if "inst" in parts:
        obs.enable()
        try:
            comm = create_communicator("xla", allreduce_grad_dtype="float16",
                                       device="cpu")
            inst = obs.instrument_communicator(comm)
            instrument_sequence(inst, rank, n)
            out["inst/rows"] = np.asarray(json.dumps(comm_metric_rows(
                obs.get_registry().snapshot())))
        finally:
            _obs_reset()
    if "mnist" in parts:
        from chainermn_tpu_torch.examples import train_mnist
        import importlib
        cs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")
        plain = cs.cast_scale_plain
        calls = [0]

        def counting(*a, **k):
            calls[0] += 1
            return plain(*a, **k)

        cs.cast_scale_plain = counting
        try:
            argv = str(inp["argv"]).split()
            for label, extra in (("off", []), ("on", ["--observability"])):
                calls[0] = 0
                try:
                    res = train_mnist.main(argv + extra + [
                        "--out", str(inp["out"]) + f"/{label}"])
                finally:
                    _obs_reset()
                out[f"{label}/casts"] = np.asarray(calls[0])
                out[f"{label}/iters"] = np.asarray(
                    res["log"][-1]["iteration"])
                for k, v in res["model"].state_dict().items():
                    out[f"{label}/param/{k}"] = v.numpy()
        finally:
            cs.cast_scale_plain = plain
    if "stream" in parts:
        obs.enable()
        try:
            fr = obs.install_flight_recorder()
            fs = dict(bucket=0, link="nvlink", nbytes=1 << 20)
            for _ in range(3):
                fr.record("fsdp_gather_begin", **fs)
                time.sleep(0.002)
                fr.record("fsdp_gather_end", **fs)
                fr.record_step(0.3 if rank == n - 1 else 0.1, 1)
            comm = create_communicator("naive", device="cpu")
            doc = obs.TelemetryAggregator(comm).collect(3)
            comm.barrier()  # rank 1's send completes while comm lives
            out["stream/doc"] = np.asarray(json.dumps(doc))
        finally:
            _obs_reset()
    if "swap" in parts:
        from chainermn_tpu_torch.planner.online import (
            OnlineTuner, active_plan_table_meta, clear_active_plan_table)
        comm = create_communicator("auto", device="cpu", intra_size=1)
        fr = obs.FlightRecorder(capacity=256)
        tuner = OnlineTuner(comm=comm, flight=fr, min_samples=1)
        if rank == 0:
            events, t = [], 0.0
            for _ in range(8):
                for plan, link, nbytes, gbps in (
                        ("flat", "ib", 8 << 20, 0.5),
                        ("hierarchical", "nvlink", 1 << 20, 16.0)):
                    dur = nbytes / (gbps * 1e9)
                    base = dict(plan=plan, stage=0, op="all_reduce",
                                scope="intra" if link == "nvlink"
                                else "inter", link=link, nbytes=nbytes)
                    events.append(dict(kind="plan_stage_begin", ts=t,
                                       **base))
                    events.append(dict(kind="plan_stage_end", ts=t + dur,
                                       **base))
                    t += dur
                t += 0.01
            tuner.ingest(events)
            tuner.on_regression([{"bucket": "dcn_comm", "ratio": 4.0,
                                  "iteration": 100}])
        decision = tuner.maybe_swap(step=11)
        swaps = [e for e in fr.events_since(-1)
                 if e["kind"] == "plan_table_swap"]
        out["swap/doc"] = np.asarray(json.dumps({
            "topology": comm.plan_topology().key(),
            "swapped": decision is not None,
            "step": decision["step"] if decision else None,
            "table_hash": decision["table_hash"] if decision else None,
            "best_speedup": decision["best_speedup"] if decision else None,
            "pin": active_plan_table_meta(),
            "n_swap_events": len(swaps),
            "plan_8mib": comm.plan_for(8 << 20, "float32").name}))
        clear_active_plan_table()
    if "wdgloo" in parts:
        obs.enable()
        try:
            obs.install_flight_recorder()
            comm = obs.instrument_communicator(
                create_communicator("naive", device="cpu"))
            wd = obs.start_watchdog(
                control_plane=getattr(comm, "_cp", None),
                out_dir=str(inp["out"]), rank=rank, deadline_s=0.3,
                poll_interval_s=0.05, collect_window_s=0.2)
            if rank == n - 1:
                time.sleep(float(inp["late"]))
            got = comm.allgather_obj(rank)
            wd.stop()
            out["wdgloo/threads"] = np.asarray(obs.watchdog_thread_count())
            out["wdgloo/got"] = np.asarray(got)
            out["wdgloo/dumps"] = np.asarray(json.dumps(wd.dump_paths))
            comm.barrier()
        finally:
            _obs_reset()
    if "cp" in parts:
        from chainermn_tpu_torch.runtime import control_plane as pcp
        cp = pcp.get_control_plane()
        out["cp/type"] = np.asarray(type(cp).__name__)
        out["cp/rank_size"] = np.asarray([cp.rank, cp.size])
        try:
            res = {}
            for label, kw in (("gloo", {}), ("socket", {"control_plane": cp})):
                comm = create_communicator("naive", device="cpu", **kw)
                got = [comm.bcast_obj({"s": 7} if rank == 0 else None),
                       comm.gather_obj(rank * 3),
                       comm.scatter_obj([f"i{r}" for r in range(n)]
                                        if rank == 0 else None),
                       comm.allgather_obj((rank, "x")),
                       comm.allreduce_obj({"a": rank + 1, "b": [rank]}),
                       comm.allreduce_obj(rank, op="max")]
                comm.barrier()
                if rank == 0:
                    comm.send_obj("ping", n - 1, tag=21)
                if rank == n - 1:
                    got.append(comm.recv_obj(0, tag=21))
                sub = comm.split(rank % 2, rank)
                got.append(sub.allgather_obj(rank))
                got.append(type(sub._cp).__name__)
                res[label] = got
            for label, got in res.items():  # numpy scalars as numbers
                out[f"cp/{label}"] = np.asarray(json.dumps(
                    got, default=lambda o: o.item()))
        finally:
            pcp.reset_control_plane()
    return out


def flatten_tensors(tree, prefix=""):
    """``{path: tensor}`` of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_tensors(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


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
           "mnist": run_mnist, "mnistpar": run_mnistpar, "lm": run_lm, "unused": run_unused,
           "coll": run_coll, "zero": run_zero, "syncbn": run_syncbn,
           "imagenet": run_imagenet, "seq": run_seq, "p2p": run_p2p,
           "chain": run_chain, "seq2seq": run_seq2seq,
           "pconv": run_pconv, "configs": run_configs,
           "serve": run_serve, "accum": run_accum,
           "fsdp": run_fsdp, "tpep": run_tpep,
           "moelm": run_moelm,
           "tpserve": run_tpserve, "compress": run_compress,
           "pipe": run_pipe, "plan": run_plan,
           "planuse": run_planuse, "obs": run_obs}[mode](inp, topo.rank)
    np.savez(f"{out_prefix}.{topo.rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
