"""Named lintable entry points -- the programs
``python -m chainermn_tpu_torch.tools.cmn_lint`` (and the CPU clean
sweep) hold to zero error findings.

Counterpart of ``chainermn_tpu/analysis/entrypoints.py``: JAX's six
entries, each rebuilding the port example's step the way the example
does (same factories, same loss structure) at JAX's toy widths and world
layouts.  Every entry runs **dry** on the fake process group
(:func:`~.schedule.dry_world`) on the CPU through the plain kernel
paths: one process builds and runs the step at rank 0 of the world under
:func:`~.lint.lint_step`, and once more at each variant rank
(``rank0``, ``rank1``) for ``schedule-desync`` -- a rank-branching step
shows there before anything is issued.  The collective structure is
invariant to width, so a 16-unit MLP proves the same theorem as the
1000-unit one.

The step of an entry is ``fn(state, batch)``: ``state`` is the
``(modules, optimizer)`` the example's step mutates in place, argument 0
(``donate_argnums=(0,)``: JAX donates its params and optimizer state;
a torch optimizer holds the very parameters of its module, so the two
are one argument here), so ``captured-constant`` counts them as inputs
and ``donation-alias`` holds them apart from the batch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from chainermn_tpu_torch.analysis.lint import (LintReport, allreduce_schedule,
                                               lint_step)
from chainermn_tpu_torch.analysis.schedule import dry_world, record

#: the seven communicator flavors the mnist sweep must hold clean
#: (pure_nccl is the xla alias and is accepted as a spelling)
MNIST_FLAVORS = ("naive", "flat", "hierarchical", "two_dimensional",
                 "single_node", "non_cuda_aware", "xla")

#: flavors whose decomposition needs a two-level topology on 8 ranks
_NEEDS_INTRA = {"hierarchical": 4, "two_dimensional": 4}

#: JAX's lint world: its 8-device virtual CPU mesh
WORLD = 8

_CPU = torch.device("cpu")


def _comm(flavor: str, **kw):
    from chainermn_tpu_torch.communicators import create_communicator
    intra = _NEEDS_INTRA.get(flavor)
    if intra is not None:
        kw.setdefault("intra_size", intra)
    return create_communicator(flavor, device="cpu", **kw)


def _subworlds(comm, blocks: Sequence[Sequence[int]]):
    """This rank's communicator over its block of ``blocks`` (lists of
    ranks of ``comm``'s world covering it), built as ``split`` builds it
    but from the blocks themselves: a dry run's object plane carries no
    other rank's ``(color, key)``."""
    import torch.distributed as dist
    from chainermn_tpu_torch.parallel.topology import Topology
    mine = None
    for members in blocks:
        group = dist.new_group(list(members))
        groups = comm._make_groups(list(members), len(members), group)
        if comm.rank in members:
            mine = (list(members), group, groups[comm.rank])
    members, group, groups = mine
    topo = Topology(rank=members.index(comm.rank), size=len(members),
                    intra_rank=members.index(comm.rank),
                    intra_size=len(members), device=comm.device)
    return type(comm)(topology=topo, group=group, _groups=groups)


def _step_of(step: Callable) -> Callable:
    """``fn(state, batch) -> step(batch)``, keeping the step's
    ``finalize``."""
    def fn(state, batch):
        del state  # the step holds it; named for the lint
        return step(batch)
    fn.__name__ = getattr(step, "__name__", "step")
    fn.finalize = getattr(step, "finalize", None)
    return fn


def _variant_schedules(build: Callable[[], dict], world: int,
                       ranks=(0, 1)) -> Dict[str, object]:
    """``{f"rank{r}": schedule}``: the target built and run once dry at
    each rank of ``world``."""
    out = {}
    for r in ranks:
        with dry_world(r, world):
            t = build()
            out[f"rank{r}"] = record(
                t["fn"], *t["args"], label=f"rank{r}",
                comms=t.get("comms", [t.get("comm")]),
                finalize=getattr(t["fn"], "finalize", None)).schedule
    return out


def _lint_dry(build: Callable[[], dict], world: int, name: str,
              rules=None, **extra) -> LintReport:
    """Build the target at rank 0 of a dry ``world`` and lint it there,
    with the variants' schedules of ranks 0 and 1."""
    variants = _variant_schedules(build, world)
    with dry_world(0, world):
        t = build()
        kw = dict(t.get("lint", {}))
        kw.update(extra)
        return lint_step(t["fn"], *t["args"], name=name,
                         comm=t.get("comm"), variants=variants,
                         rules=rules, raise_on_error=False, **kw)


# ---------------------------------------------------------------------------
# examples/mnist
# ---------------------------------------------------------------------------

def _mnist_target(flavor: str) -> dict:
    """The mnist example's step at toy width: MLP + multi-node Adam +
    ``make_train_step(has_aux=True)``."""
    from chainermn_tpu_torch.models import MLP
    from chainermn_tpu_torch.optimizers import (create_multi_node_optimizer,
                                                make_train_step)
    comm = _comm(flavor)
    model = MLP(16, 10, device=_CPU,
                generator=torch.Generator().manual_seed(0))
    optimizer = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm)

    def loss_fn(batch):
        x, y = batch
        logits = model(x)
        loss = F.cross_entropy(logits, y.long())
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, {"accuracy": acc}

    def probe_loss(m, x, y):
        return F.cross_entropy(m(x), y.long())

    step = make_train_step(comm, loss_fn, optimizer, has_aux=True)
    batch = (torch.zeros(4, 784), torch.zeros(4, dtype=torch.int32))
    return {"fn": _step_of(step), "args": ((model, optimizer), batch),
            "comm": comm,
            "lint": dict(flavor=flavor, loss=probe_loss,
                         loss_args=(model,) + batch,
                         donate_argnums=(0,), census=True)}


def lint_mnist(flavors: Optional[Sequence[str]] = None,
               rules: Optional[Sequence[str]] = None,
               world: Optional[int] = None) -> List[LintReport]:
    """One report per communicator flavor for the mnist step.  Every rule
    runs: schedule-desync over the dry runs at ranks 0 and 1,
    census-drift over the flavor's recorded allreduce, the gradient
    probe over the example's loss, captured-constant/donation-alias/
    async-pair over the recorded step."""
    return [_lint_dry(lambda f=flavor: _mnist_target(f), world or WORLD,
                      f"examples/mnist[{flavor}]", rules)
            for flavor in (flavors or MNIST_FLAVORS)]


# ---------------------------------------------------------------------------
# examples/long_context
# ---------------------------------------------------------------------------

def _long_context_target() -> dict:
    """``examples/train_lm.py``'s ring_flash step at toy size: seq 128
    over the 8-rank world (16 positions a rank), ``sp_loss`` (the ring of
    k/v blocks, the next-token shift, the pinned all-reduces), the
    gradients summed over the ranks, Adam."""
    from chainermn_tpu_torch.examples.train_lm import sp_loss, sum_gradients
    from chainermn_tpu_torch.models import TransformerLM
    comm = _comm("flat")
    seq_len = 16 * comm.size
    t_local = seq_len // comm.size
    model = TransformerLM(32, 16, 1, 2, seq_len, "ring_flash", comm=comm,
                          device=_CPU,
                          generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    toks = torch.zeros(2, t_local, dtype=torch.int32)

    def step(state, tk):
        m, o = state
        o.zero_grad(set_to_none=True)
        loss = sp_loss(m, tk, comm)
        loss.backward()
        sum_gradients(m, comm)
        o.step()
        return loss.detach()

    return {"fn": step, "args": ((model, opt), toks), "comm": comm,
            "lint": dict(donate_argnums=(0,))}


def lint_long_context(rules: Optional[Sequence[str]] = None,
                      world: Optional[int] = None) -> List[LintReport]:
    """One report for the long-context ring-attention step.  The step
    drives the communicator directly (no ``allreduce_grad`` and no
    flavor census), so census-drift and the gradient probe report as
    skipped; schedule-desync, captured-constant, donation-alias, and
    async-pair all run."""
    return [_lint_dry(_long_context_target, world or WORLD,
                      "examples/long_context[ring_flash]", rules)]


# ---------------------------------------------------------------------------
# examples/resnet_fused
# ---------------------------------------------------------------------------

def _resnet_fused_target(flavor: str = "xla") -> dict:
    """The resnet example's step with ``FusedBatchNormAct`` at every
    norm boundary at toy width (one BasicBlock stage, 8 filters, 16x16
    images): the kernels' plain versions on the CPU contribute no
    collectives, so the step's schedule is the flavor's gradient
    all-reduce plus the loss mean."""
    from chainermn_tpu_torch.models.resnet import BasicBlock, ResNet
    from chainermn_tpu_torch.ops.fused_norm import FusedBatchNormAct
    from chainermn_tpu_torch.optimizers import (create_multi_node_optimizer,
                                                make_train_step)
    comm = _comm(flavor)
    model = ResNet(stage_sizes=(1,), block_cls=BasicBlock, num_filters=8,
                   num_classes=10, norm_cls=FusedBatchNormAct, device=_CPU,
                   generator=torch.Generator().manual_seed(0))
    optimizer = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)

    def loss_fn(batch):
        x, y = batch
        return F.cross_entropy(model(x), y.long())

    def probe_loss(m, x, y):
        return F.cross_entropy(m(x), y.long())

    step = make_train_step(comm, loss_fn, optimizer)
    batch = (torch.zeros(2, 3, 16, 16), torch.zeros(2, dtype=torch.int32))
    return {"fn": _step_of(step), "args": ((model, optimizer), batch),
            "comm": comm,
            "lint": dict(flavor=flavor, loss=probe_loss,
                         loss_args=(model,) + batch,
                         donate_argnums=(0,), census=True)}


def lint_resnet_fused(rules: Optional[Sequence[str]] = None,
                      world: Optional[int] = None) -> List[LintReport]:
    """One report for the fused-norm resnet train step (xla flavor).
    Every rule runs: the desync variants build and run the step at two ranks,
    the census holds the recorded collectives to the flavor's plan (the
    norm kernels must contribute zero), and the gradient probe
    differentiates through the fused norm's autograd function -- a
    regrown statistics all-reduce would land here as
    unpinned-transpose."""
    return [_lint_dry(_resnet_fused_target, world or WORLD,
                      "examples/resnet_fused[xla]", rules)]


# ---------------------------------------------------------------------------
# moe/train
# ---------------------------------------------------------------------------

def _moe_train_target() -> dict:
    """The MoE LM example's train step at toy size over JAX's 2x4
    ``("ep", "data")`` layout of 8 ranks: the expert MLPs dispatched over
    this rank's EP pair (ranks ``d`` and ``d + 4``) through the planner's
    ``alltoall_flat_bfloat16`` plan (``moe_plan=``), the loss and the
    replicated gradients reduced over the world as the example does.
    The census spec is the plan itself: the ``census=`` callable records
    ONE ``execute_alltoall`` over the EP pair."""
    from chainermn_tpu_torch.examples.train_moe_lm import train_step
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel.expert import moe_plan_topology
    from chainermn_tpu_torch.planner.compiler import execute_alltoall
    from chainermn_tpu_torch.planner.plans import alltoall_plans
    world = _comm("naive")
    if world.size != 8:
        raise RuntimeError(f"moe/train needs 8 ranks for the 2x4 ep x data "
                           f"layout, have {world.size}")
    ep = _subworlds(world, [[d, d + 4] for d in range(4)])
    topo = moe_plan_topology(ep)
    plan = next(p for p in alltoall_plans(topo)
                if p.name == "alltoall_flat_bfloat16")
    model = TransformerLM(32, 16, 1, 2, 32, "xla", moe_experts=4,
                          moe_top_k=2, moe_comm=ep, moe_plan=plan,
                          device=_CPU,
                          generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    toks = torch.zeros(1, 16, dtype=torch.int32)

    def step(state, tk):
        return train_step(*state, tk, 1e-2, world)

    def census():
        buf = torch.zeros(ep.size, 4, 16)
        return record(lambda: execute_alltoall(plan, ep, buf),
                      comms=[ep], label="moe:alltoall").schedule

    return {"fn": step, "args": ((model, opt), toks), "comm": ep,
            "comms": [world, ep],
            "lint": dict(plan=plan, census=census, donate_argnums=(0,))}


def lint_moe_train(rules: Optional[Sequence[str]] = None,
                   world: Optional[int] = None) -> List[LintReport]:
    """One report for the MoE transformer train step (2x4 ep x data).
    census-drift holds the recorded token exchange to the MoE dispatch
    plan's kinds and per-hop wire dtypes; wire-dtype-mismatch checks the
    plan's declared bf16 wire is moved by the step; schedule-desync,
    captured-constant, donation-alias and async-pair run over the full
    step.  No communicator flavor is in play, so the gradient-probe rule
    reports as skipped."""
    return [_lint_dry(_moe_train_target, world or WORLD,
                      "examples/moe_lm[ep2xdata4]", rules)]


# ---------------------------------------------------------------------------
# serving/decode
# ---------------------------------------------------------------------------

def _serving_target(tp: int = 2, spec_k: int = 0) -> dict:
    """The serving engine's fused prefill+decode forward (``spec_k > 0``:
    the draft+verify speculative forward) at toy size, tensor-parallel
    over a world of ``tp`` ranks: the program every serving step runs.
    The lockstep plan broadcast of ``engine.step`` is the object plane's
    (the protocol lint's); the entry runs the forward on the plan rank 0
    built, as every rank does after the broadcast."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import InferenceEngine, ServingConfig
    from chainermn_tpu_torch.serving.engine import LocalPlane
    comm = _comm("naive")
    # the engine splits its comm by (ep index, tp index) -- one block of
    # every rank here; a dry object plane carries no other rank's color
    comm.split = lambda color, key: _subworlds(comm, [range(comm.size)])
    model = TransformerLM(32, 16, 1, 2, 64, "xla", device=_CPU,
                          generator=torch.Generator().manual_seed(0))
    cfg = ServingConfig(page_size=4, num_pages=8, max_seqs=2,
                        chunk_tokens=4, max_pages_per_seq=4, tp_size=tp,
                        spec_k=spec_k)
    eng = InferenceEngine(model, cfg, plane=LocalPlane(), comm=comm,
                          draft_model=model if spec_k else None)
    eng.submit([1, 2, 3], max_new_tokens=4 if spec_k else 2)
    eng.scheduler.apply_plan(eng.scheduler.build_plan())
    batch = eng.scheduler.step_batch()
    args = [eng._put(batch[k]) for k in ("page_table", "tokens", "pos0",
                                         "n_new")]
    if spec_k:
        args += [eng._put(a) for a in eng._spec_inputs(batch)]

    def forward(engine, inputs):
        with torch.inference_mode():
            fwd = engine._forward_spec if spec_k else engine._forward
            return fwd(*inputs)

    return {"fn": forward, "args": (eng, tuple(args)), "comm": comm}


def lint_serving_decode(rules: Optional[Sequence[str]] = None
                        ) -> List[LintReport]:
    """Two reports for the serving forward programs (tp=2): the plain
    fused prefill+decode step and the fused draft+verify speculative
    step.  Lockstep serving has the same SPMD obligation as training --
    every rank must issue the identical schedule for the broadcast plan
    -- so the schedule-desync variants run each forward at ranks 0 and
    1.  No flavor census is in play, so the comm-bound rules report as
    skipped."""
    return [_lint_dry(lambda: _serving_target(2), 2, "serving/decode[tp2]",
                      rules),
            _lint_dry(lambda: _serving_target(2, spec_k=2), 2,
                      "serving/decode[tp2,spec]", rules)]


# ---------------------------------------------------------------------------
# serving/weights
# ---------------------------------------------------------------------------

def _serving_weights_target() -> dict:
    """The router's multicast weight distribution
    (``serving.weights.broadcast_inference_params(plan=)``, the planner's
    leaf-mode stage chain) on the flat 8-rank communicator, with the plan
    IR as the census spec."""
    from chainermn_tpu_torch.serving.weights import (
        broadcast_inference_params, weights_multicast_plan)
    comm = _comm("flat")
    plan = weights_multicast_plan(root=0, topology=comm.plan_topology(),
                                  name="serving_weights")
    params = {"w": torch.zeros(64)}

    def program(c, p):
        return broadcast_inference_params(c, p, plan=plan)

    def census():
        return record(program, comm, params, comms=[comm],
                      label="serving_weights").schedule

    return {"fn": program, "args": (comm, params), "comm": comm,
            "lint": dict(plan=plan, census=census)}


def lint_serving_weights(rules: Optional[Sequence[str]] = None,
                         world: Optional[int] = None) -> List[LintReport]:
    """One report for the fleet weight-distribution multicast.  The
    census here is NOT the training allreduce: the ``census=`` callable
    records the router's own broadcast program and census-drift holds
    its collective decomposition to the multicast plan's census --
    params must reach every replica through the plan's ONE multicast
    stage, never a fan of point-to-point sends."""
    return [_lint_dry(_serving_weights_target, world or WORLD,
                      "serving/weights[multicast]", rules)]


ENTRY_POINTS: Dict[str, dict] = {
    "examples/mnist": {
        "fn": lint_mnist,
        "flavors": MNIST_FLAVORS,
        "help": "MLP data-parallel step, one report per communicator "
                "flavor (census + gradient probe + desync variants)",
    },
    "examples/long_context": {
        "fn": lint_long_context,
        "flavors": None,
        "help": "ring_flash sequence-parallel LM step (schedule, "
                "captured-constant, donation, async rules)",
    },
    "examples/resnet_fused": {
        "fn": lint_resnet_fused,
        "flavors": None,
        "help": "resnet train step with the fused BN(+ReLU) kernels at "
                "every norm boundary (census + gradient probe through "
                "the fused norm's backward + desync variants)",
    },
    "moe/train": {
        "fn": lint_moe_train,
        "flavors": None,
        "help": "MoE transformer train step over the 2x4 ep x data "
                "layout: census-drift holds the recorded token exchange "
                "to the dispatch plan's kinds and wire dtypes (plus "
                "schedule/captured-constant/donation/async rules)",
    },
    "serving/decode": {
        "fn": lint_serving_decode,
        "flavors": None,
        "help": "serving engine forwards, tp=2 Megatron sharding: plain "
                "prefill+decode AND the draft+verify speculative step "
                "(schedule, captured-constant, async rules)",
    },
    "serving/weights": {
        "fn": lint_serving_weights,
        "flavors": None,
        "help": "fleet weight-distribution multicast: census-drift holds "
                "the recorded broadcast program to the multicast plan "
                "(plus schedule/async rules)",
    },
}


def lint_entry_point(name: str, flavors: Optional[Sequence[str]] = None,
                     rules: Optional[Sequence[str]] = None,
                     world: Optional[int] = None) -> List[LintReport]:
    """Run a named entry point's lint sweep, returning its reports.
    ``world`` is the dry world's size (JAX's 8 devices by default; the
    serving decode entry keeps its tp=2 world, the MoE entry needs 8)."""
    kw = {} if world is None or name == "serving/decode" \
        else {"world": world}
    try:
        entry = ENTRY_POINTS[name]
    except KeyError:
        raise ValueError(
            f"unknown entry point {name!r}; available: "
            f"{sorted(ENTRY_POINTS)}") from None
    if entry["flavors"] is not None:
        return entry["fn"](flavors=flavors, rules=rules, **kw)
    if flavors:
        raise ValueError(f"{name} takes no --flavors")
    return entry["fn"](rules=rules, **kw)


__all__ = ["ENTRY_POINTS", "MNIST_FLAVORS", "WORLD", "allreduce_schedule",
           "lint_entry_point", "lint_long_context", "lint_mnist",
           "lint_moe_train", "lint_resnet_fused", "lint_serving_decode",
           "lint_serving_weights"]
