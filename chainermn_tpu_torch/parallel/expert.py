"""Expert parallelism: a mixture of experts with all-to-all token routing.

Counterpart of ``chainermn_tpu/parallel/expert.py``, over the ranks of a
communicator (the EP world, ``P`` ranks) where JAX takes a mesh
``axis_name``.  ``E`` experts, a multiple of ``P``: each rank hosts
``E/P`` of them.  :func:`moe_apply` is JAX's function step for step:

1. each rank routes its local tokens ``[N, D]``: softmax gates in float32
   over ``[N, E]`` logits, the top ``k`` (ties to the lower expert index,
   as ``lax.top_k``; ``torch.topk`` promises no order among equals, so a
   stable sort picks them), combine weights renormalised over the ``k``
   for ``k > 1`` (GShard) and the raw top gate for ``k = 1`` (Switch);
2. capacity ``C`` slots an expert (default ``max(1, 2 k N // E)``),
   assigned choice-major by a cumulative sum over ``[k N, E]``: every
   token's first choice before any second choice.  Kept choices are
   added into their rows of an ``[E, C, D]`` send buffer (a kept slot is
   unique to its expert, so the sum is exact; a dropped choice adds zeros
   at slot 0, and its combine weight is 0, so the gradients are exact in
   any order of the adds);
3. one all-to-all of the buffer as ``[P, E/P C, D]`` (made contiguous
   first) ships each rank its experts' slots from every rank; ``expert_fn``
   runs on ``[P C, D]`` (one expert a rank) or ``[E/P, P C, D]``; the
   inverse all-to-all brings the outputs home;
4. the gate-weighted sum of each token's kept choices; a token whose every
   choice overflowed passes through unchanged.

``return_stats=True`` adds JAX's statistics, each mean-reduced over the
EP ranks as its ``pmean``: ``aux_loss`` (``E * sum_e load_e *
mean_prob_e``, the load-balancing loss), ``overflow_fraction`` and
``expert_load`` (the share of first choices each expert took).  The
all-to-all's backward is the all-to-all of the cotangent and the mean's is
the cotangent over ``P`` (:mod:`chainermn_tpu_torch.functions`), JAX's
transposes.

:class:`ExpertParallelMLP` is built differently from JAX's by design: a
rank holds only its own ``E/P`` experts' slices of the ``up_kernel [E, d,
h]``, ``up_bias``, ``down_kernel [E, h, d]`` and ``down_bias`` stacks
(flax's names and layouts), where JAX replicates the global stacks and
zeroes the gradient outside each device's slice.  The owner's expert
gradients come back whole through the all-to-all's backward; only the
replicated parameters (the router, and the rest of a model) need summing
over the EP ranks.  ``comm=None`` is a world of one.

``plan=`` (an all-to-all :class:`~chainermn_tpu_torch.planner.Plan`, e.g.
from ``planner.alltoall_plans``) runs both exchanges through
:func:`~chainermn_tpu_torch.planner.execute_alltoall` -- the hierarchical
two-hop form, narrow wires on a hop -- with the same block layout as the
raw all-to-all; the exchange is announced as the ``"moe"`` plan slot and a
jointly tuned override installed there is honoured
(``planner.schedule.resolve_slot_plan``).  ``plan_topology`` defaults to
:func:`moe_plan_topology`; ``plan_obs`` (a ``PlanObs``, from
``observability.get_plan_obs(comm)``) brackets every hop of both exchanges
with ``plan_stage`` spans; :class:`ExpertParallelMLP` with a plan fetches
it itself, as JAX's does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch import functions
from chainermn_tpu_torch.models.resnet import _lecun_normal_
from chainermn_tpu_torch.parallel.topology import resolve_device


def moe_plan_topology(comm):
    """The :class:`~chainermn_tpu_torch.planner.PlanTopology` of the MoE
    exchange ranks: ``comm.plan_topology()`` (``(("inter", I), ("intra",
    J))``, the last the NVLink level), a world of one for ``comm=None``.
    JAX takes the mesh axis names instead."""
    from chainermn_tpu_torch.planner.ir import PlanTopology
    if comm is None:
        return PlanTopology(axes=(("inter", 1), ("intra", 1)))
    return comm.plan_topology()


def top_k_indices(gates: torch.Tensor, k: int) -> torch.Tensor:
    """``[N, k]`` indices of the ``k`` largest gates of each row, largest
    first, ties to the lower index (``lax.top_k``'s order).  Routing
    replays (a card run's decisions fed to a plain run) stand in for this
    function."""
    return torch.sort(gates, dim=-1, descending=True,
                      stable=True).indices[:, :k]


def route(gates, top_k: int, capacity: int, normalize_gates: bool):
    """JAX's routing decisions from float32 ``gates [N, E]``: ``topi [N,
    k]`` (:func:`top_k_indices`), the combine weights, each choice's
    capacity ``slot`` (int32, choice-major by a cumulative sum over ``[k
    N, E]``) and ``keep = slot < capacity``."""
    n, e = gates.shape
    topi = top_k_indices(gates, top_k)                       # [N, K]
    topv = torch.gather(gates, 1, topi)
    combine = topv / topv.sum(-1, keepdim=True) if normalize_gates else topv
    # capacity slots, choice-major: every token's first choice is slotted
    # before any token's second
    flat = F.one_hot(topi.T.reshape(-1), e).to(torch.int32)  # [K N, E]
    # the running count down each expert's column, scanned along a
    # contiguous row of [E, K N]
    slot_flat = torch.cumsum(flat.T.contiguous(), dim=1,
                             dtype=torch.int32).T - 1
    slot = (slot_flat * flat).sum(-1).reshape(top_k, n).T    # [N, K]
    return topi, combine, slot, slot < capacity


def _mean(comm, x):
    return x if comm is None or comm.size == 1 \
        else functions.allreduce(comm, x, op="mean")


def moe_apply(expert_fn: Callable, gate_logits, x, comm=None,
              capacity: Optional[int] = None, top_k: int = 1,
              num_experts: Optional[int] = None,
              normalize_gates: Optional[bool] = None,
              return_stats: bool = False, plan=None, plan_topology=None,
              plan_obs=None):
    """Route this rank's tokens ``x [N, D]`` to the experts spread over
    ``comm``'s ranks; returns ``[N, D]`` (and the statistics with
    ``return_stats``).  ``gate_logits`` is ``[N, E]``; see the module
    note for the rest."""
    p = 1 if comm is None else comm.size
    n, d = x.shape
    e = int(num_experts) if num_experts is not None else gate_logits.shape[-1]
    if gate_logits.shape[-1] != e:
        raise ValueError(
            f"gate_logits has {gate_logits.shape[-1]} experts but "
            f"num_experts={e}")
    if e % p:
        raise ValueError(
            f"num_experts ({e}) must be a multiple of the expert-parallel "
            f"world size ({p}) so every rank hosts E/P experts; a mismatch "
            f"would misroute tokens")
    epd = e // p
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k={top_k} out of range for {e} experts")
    c = capacity if capacity is not None else max(1, 2 * top_k * n // e)
    if normalize_gates is None:
        normalize_gates = top_k > 1

    gates = torch.softmax(gate_logits.float(), dim=-1)
    topi, combine, slot, keep = route(gates, top_k, c, normalize_gates)
    slot_safe = torch.where(keep, slot, 0).long()

    # each choice's row of the [E C, D] buffer; its backward (and the
    # combine's gather below) index the rows again rather than sorting
    rows = (topi * c + slot_safe).reshape(-1)                # [N K]
    send = x.new_zeros((e * c, d)).index_add(
        0, rows, torch.where(keep[..., None], x[:, None, :],
                             x.new_zeros(())).reshape(-1, d))
    # the experts lie contiguously by owner, so [P, E/P C] ships each
    # rank its block
    if plan is None:
        def exchange(b):
            return functions.alltoall(comm, b) if p > 1 else b
    else:
        from chainermn_tpu_torch.planner.compiler import execute_alltoall
        from chainermn_tpu_torch.planner.ir import dtype_name
        from chainermn_tpu_torch.planner.schedule import (
            register_plan_slot, resolve_slot_plan)
        topo = (plan_topology if plan_topology is not None
                else moe_plan_topology(comm))
        # the dispatch and combine exchanges are one slot (the same buffer
        # both ways)
        register_plan_slot("moe", nbytes=e * c * d * x.element_size(),
                           dtype=dtype_name(x.dtype), op="all-to-all",
                           owners=("moe",))
        plan = resolve_slot_plan("moe", plan)

        def exchange(b):
            return execute_alltoall(plan, comm, b.contiguous(),
                                    topology=topo, pobs=plan_obs)
    recv = exchange(send.reshape(p, epd * c, d))
    recv = recv.reshape(p, epd, c, d).transpose(0, 1)        # [E/P, P, C, D]
    if epd == 1:
        out = expert_fn(recv.reshape(p * c, d))
    else:
        out = expert_fn(recv.reshape(epd, p * c, d))
    back = exchange(
        out.reshape(epd, p, c, d).transpose(0, 1).reshape(p, epd * c, d))
    back = back.reshape(e, c, d)

    routed = back.reshape(e * c, d).index_select(0, rows).reshape(
        n, top_k, d)                                         # [N, K, D]
    weight = (keep * combine).to(x.dtype)[..., None]
    y = (routed * weight).sum(dim=1)
    y = torch.where(keep.any(-1)[:, None], y, x)
    if not return_stats:
        return y
    probs_mean = _mean(comm, gates.mean(dim=0))              # [E]
    load = _mean(comm, F.one_hot(topi[:, 0], e).float().mean(dim=0))
    stats = {
        "aux_loss": e * (probs_mean * load).sum(),
        "overflow_fraction": 1.0 - _mean(comm, keep.float().mean()),
        "expert_load": load,
    }
    return y, stats


def _stack(shape, fan_in, device, generator, rows):
    """This rank's ``rows`` of a global ``shape`` stack drawn whole from
    flax's lecun-normal (every world size holds the same global experts
    from one seed); zeros when ``fan_in`` is 0."""
    full = torch.empty(shape, dtype=torch.float32, device=device)
    if fan_in:
        _lecun_normal_(full, fan_in, generator)
    else:
        nn.init.zeros_(full)
    return nn.Parameter(full[rows].clone())


class ExpertParallelMLP(nn.Module):
    """Top-k MoE layer: a float32 router and ``num_experts`` distinct GELU
    MLPs of width ``hidden`` over the ranks of ``comm`` (default: one
    expert a rank).  ``forward(x [..., d])`` routes the flattened tokens;
    with ``with_stats`` it returns ``(y, stats)``.  The parameters:
    ``router`` (a float32 ``Dense``), and this rank's slices
    ``up_kernel [E/P, d, h]``, ``up_bias [E/P, h]``, ``down_kernel [E/P,
    h, d]``, ``down_bias [E/P, d]`` (flax initialises a ``[E, d, h]``
    stack with fan-in ``E d``, kept here)."""

    def __init__(self, d_model: int, hidden: int, comm=None, *,
                 num_experts: Optional[int] = None, top_k: int = 1,
                 capacity: Optional[int] = None, dtype=torch.float32,
                 with_stats: bool = False, plan=None, device=None,
                 generator=None):
        super().__init__()
        from chainermn_tpu_torch.models.transformer import Dense
        p = 1 if comm is None else comm.size
        e = num_experts if num_experts is not None else p
        if e % p:
            raise ValueError(f"num_experts ({e}) must be a multiple of the "
                             f"expert-parallel world size ({p})")
        device = resolve_device(device)
        self.comm, self.num_experts, self.top_k = comm, e, top_k
        self.capacity, self.dtype = capacity, dtype
        self.with_stats = with_stats
        self.plan = plan
        self.epd = e // p
        me = 0 if comm is None else comm.rank
        rows = slice(me * self.epd, (me + 1) * self.epd)
        self.expert_rows = (rows.start, rows.stop)
        self.router = Dense(d_model, e, dtype=torch.float32, device=device,
                            generator=generator)
        self.up_kernel = _stack((e, d_model, hidden), e * d_model, device,
                                generator, rows)
        self.up_bias = _stack((e, hidden), 0, device, None, rows)
        self.down_kernel = _stack((e, hidden, d_model), e * hidden, device,
                                  generator, rows)
        self.down_bias = _stack((e, d_model), 0, device, None, rows)

    def expert_fn(self, tokens):
        """This rank's experts on their received slots: ``[P C, d]`` with
        one expert, ``[E/P, P C, d]`` with several."""
        dt = self.dtype
        up, up_b = self.up_kernel.to(dt), self.up_bias.to(dt)
        down, down_b = self.down_kernel.to(dt), self.down_bias.to(dt)
        if self.epd == 1:
            h = F.gelu(tokens @ up[0] + up_b[0], approximate="tanh")
            return h @ down[0] + down_b[0]
        h = F.gelu(torch.bmm(tokens, up) + up_b[:, None],
                   approximate="tanh")
        return torch.bmm(h, down) + down_b[:, None]

    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        plan_obs = None
        if self.plan is not None:
            from chainermn_tpu_torch.observability.spans import get_plan_obs
            plan_obs = get_plan_obs(self.comm)
        res = moe_apply(self.expert_fn, self.router(flat), flat, self.comm,
                        capacity=self.capacity, top_k=self.top_k,
                        num_experts=self.num_experts,
                        return_stats=self.with_stats, plan=self.plan,
                        plan_obs=plan_obs)
        if self.with_stats:
            y, stats = res
            return y.reshape(shape), stats
        return res.reshape(shape)


def expert_parameter_names(model: nn.Module):
    """Names of ``model``'s rank-local expert slices (every
    :class:`ExpertParallelMLP`'s four stacks): the parameters NOT summed
    over the EP ranks."""
    return {f"{name}.{leaf}" if name else leaf
            for name, mod in model.named_modules()
            if isinstance(mod, ExpertParallelMLP)
            for leaf in ("up_kernel", "up_bias", "down_kernel", "down_bias")}


__all__ = ["ExpertParallelMLP", "expert_parameter_names", "moe_apply",
           "moe_plan_topology", "route", "top_k_indices"]
