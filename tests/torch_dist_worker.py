"""One rank of a multi-process gloo world for the port's parity tests.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_worker.py \\
            {comm|train|opt|mnist|lm|unused|coll|zero|syncbn|imagenet|seq} \\
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
    """``train_imagenet.main`` for each ``argv{i}`` (one string each):
    ``{i}/losses`` and ``{i}/model/{name}`` (parameters and buffers)."""
    from chainermn_tpu_torch.examples import train_imagenet

    out = {}
    i = 0
    while f"argv{i}" in inp:
        res = train_imagenet.main(str(inp[f"argv{i}"]).split())
        out[f"{i}/losses"] = np.asarray(res["losses"])
        out.update({f"{i}/model/{k}": v.detach().cpu().numpy()
                    for k, v in res["model"].state_dict().items()})
        i += 1
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
           "mnist": run_mnist, "lm": run_lm, "unused": run_unused,
           "coll": run_coll, "zero": run_zero, "syncbn": run_syncbn,
           "imagenet": run_imagenet, "seq": run_seq}[mode](inp, topo.rank)
    np.savez(f"{out_prefix}.{topo.rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
