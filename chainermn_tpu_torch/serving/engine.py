"""Continuous-batching inference engine.

Counterpart of ``chainermn_tpu/serving/engine.py``.  One fixed-shape
forward serves every step: each of the ``B`` slots contributes up to ``S =
chunk_tokens`` tokens -- a prefill chunk, one decode token, or nothing
(idle and finished slots write to the trash page and their logits are
ignored) -- so prefill and decode fuse into one batched forward.  A step:

1. rank 0 builds the admission plan (retire the finished, pack waiting
   requests into free pages) and, in a world of more than one process,
   broadcasts it over the plane's ``bcast_obj`` so every rank applies the
   same plan: lockstep by construction;
2. the fused forward writes the step's K/V into the paged cache in place,
   runs causal flash attention with per-sequence offsets in every layer
   (:func:`~chainermn_tpu_torch.serving.kv_cache.paged_attention`: the
   ``cmn_flash_fwd`` kernel on the card), and samples each slot's last
   valid position greedily;
3. the sampled tokens come to the host (the step's one sync point), are
   appended to their sequences, and finished sequences retire next step.

With ``spec_k > 0`` the step is the fused draft+verify step of
:meth:`InferenceEngine._forward_spec` instead.

With ``tp_size > 1`` or ``ep_size > 1``, or a MoE model, the engine runs
over a communicator of ``tp_size x ep_size`` ranks, one process a GPU:
rank ``r`` is ``(t, e) = (r // ep_size, r % ep_size)``, JAX's
``reshape(tp, ep)`` order, and ``comm.split`` makes the tensor-parallel
ranks (one ``e``) and the expert-parallel ranks (one ``t``).  Each rank
builds its shard of the given whole model: the blocks Megatron-sliced
(:func:`~chainermn_tpu_torch.serving.weights.shard_params_tp`) with their
row-parallel outputs summed over the tensor-parallel ranks, the KV cache
holding ``n_kv_heads / tp`` heads, the draft model sharded alike, and a
MoE model's experts split ``ep`` ways over the expert-parallel ranks (the
EP path at ``ep_size`` 1 too: a world of one).  Tokens and gate math are
the same on every rank, so are the logits and the greedy samples; the
plans ride the communicator's object plane.

Differences from JAX: the engine takes built ``nn.Module`` s (target and
draft, whole) that carry their weights where JAX takes ``(model,
params)``; the cache is written in place; the forwards are plain methods
run under ``torch.inference_mode()``; a communicator of exactly
``tp_size x ep_size`` ranks stands in for JAX's mesh of the first such
devices.  With observability on (bound at construction) the engine keeps
JAX's ``serving_*`` metric family and its ``serving_step`` /
``serving_forward`` / ``serving_plan_bcast`` flight spans; the forward
span ends after the sampled tokens' copy to the host, which waits for the
card, as JAX's ends after its sync point.  ``moe_plan`` runs a MoE model's exchanges through a planner
all-to-all plan.  An online plan-table hot-swap rides the step envelope as
in JAX: rank 0 piggybacks a newly registered table
(``planner.online.set_active_plan_table``) on the step's plan, and every
rank registers it on that same serving step.  The
spec-decode accept decisions ride the next step's plan as in JAX, and
every rank checks them.  The step's padded positions must lie inside the
model's position table (``max_len``): where JAX's embedding lookup fills
out-of-range rows, PyTorch's raises, so the engine refuses such a
configuration.

Wall-clock time is read on the host only (latency bookkeeping).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from chainermn_tpu_torch.serving import kv_cache as _kv
from chainermn_tpu_torch.serving.scheduler import AdmissionScheduler


def _serving_metrics(reg) -> dict:
    """JAX's ``serving_*`` family in ``reg`` (names and kinds)."""
    return {
        "steps": reg.counter("serving_steps", "engine steps run"),
        "gen": reg.counter("serving_generated_tokens",
                           "tokens sampled and emitted"),
        "prefill": reg.counter("serving_prefill_tokens",
                               "prompt tokens written to cache"),
        "admitted": reg.counter("serving_admitted",
                                "requests admitted into slots"),
        "retired": reg.counter("serving_retired", "sequences retired"),
        "active": reg.gauge("serving_active_seqs", "occupied slots"),
        "queue": reg.gauge("serving_queue_depth",
                           "waiting requests (rank 0)"),
        "pages": reg.gauge("serving_free_pages", "free KV pages"),
        # the latency SLO family: streaming histograms (mergeable fixed
        # log-grid buckets)
        "step_s": reg.streaming_histogram("serving_step_seconds",
                                          "wall time per engine step"),
        "ttft": reg.streaming_histogram("serving_ttft_seconds",
                                        "arrival to first emitted token"),
        "tok_s": reg.streaming_histogram(
            "serving_token_seconds", "inter-token gap per emitted token"),
        "spec_rows": reg.counter(
            "serving_spec_rows",
            "decode rows run through the draft+verify step"),
        "spec_proposed": reg.counter(
            "serving_spec_proposed_tokens",
            "draft tokens proposed (k per decode row)"),
        "spec_accepted": reg.counter(
            "serving_spec_accepted_tokens",
            "draft tokens accepted by the target verify pass"),
        "spec_out": reg.counter(
            "serving_spec_out_tokens",
            "tokens landed per verify pass (accepted + 1)"),
        "prefix_hits": reg.gauge("serving_prefix_hits",
                                 "admissions with a cache hit"),
        "prefix_hit_tokens": reg.gauge(
            "serving_prefix_hit_tokens",
            "prompt tokens served from shared pages"),
        "prefix_prompt_tokens": reg.gauge(
            "serving_prefix_prompt_tokens",
            "prompt tokens across all admissions"),
        "prefix_cached_pages": reg.gauge(
            "serving_prefix_cached_pages",
            "pages currently indexed by the prefix trie"),
        "prefix_evictions": reg.gauge(
            "serving_prefix_evictions",
            "trie pages evicted under page pressure"),
    }


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Engine knobs."""

    page_size: int = 16           # tokens per KV page
    num_pages: int = 64           # allocatable pages (excl. trash)
    max_seqs: int = 4             # batch slots B
    chunk_tokens: int = 8         # S: prefill chunk / step token budget
    max_pages_per_seq: int = 8    # page-table width (max ctx / page_size)
    eos_id: Optional[int] = None
    policy: str = "continuous"    # or "static" (benchmark baseline)
    tp_size: int = 1              # tensor-parallel ways
    ep_size: int = 1              # expert-parallel ways (MoE models)
    moe_plan: Any = None          # all-to-all Plan for the MoE exchanges
    cache_dtype: Any = torch.float32
    keep_logits: bool = False     # stash last-position logits per step
    prefix_cache: bool = False    # copy-on-write prompt-prefix sharing
    spec_k: int = 0               # draft tokens per decode step (0 = off)


@dataclasses.dataclass
class Completion:
    """A finished request (rank 0 carries the timing fields)."""

    rid: int
    prompt_len: int
    tokens: List[int]
    arrival: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> float:
        return self.token_times[0] - self.arrival if self.token_times \
            else float("nan")


@dataclasses.dataclass
class StepResult:
    step: int
    plan: dict
    emitted: list                  # [(rid, token, n_generated)]
    completed: List[Completion]
    ran_forward: bool
    last_logits: Optional[np.ndarray] = None   # [B, vocab] (keep_logits)
    n_new: Optional[np.ndarray] = None
    spec: Optional[dict] = None    # rows/proposed/accepted/out_tokens


class LocalPlane:
    """The plane of a single process: rank 0 of 1; ``bcast_obj`` returns
    its object.  A communicator (its object plane) stands in for it in a
    world of several processes."""

    rank = 0
    size = 1

    def bcast_obj(self, obj, root: int = 0):
        return obj


def _kv_shape(model):
    """This rank's kv heads (``n_kv_heads / tp``) and the head width."""
    blk = model.blocks[0]
    return blk.n_kv, blk.head_dim


def _shard(model, tp, t, tp_comm, ep, e, ep_comm, moe_plan=None):
    """Rank ``(t, e)``'s shard of the whole ``model``: a ``tp_size`` model
    over ``tp_comm`` and ``ep_comm`` holding shard ``t`` of its blocks and
    expert group ``e`` of its experts."""
    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.parallel.expert import expert_parameter_names
    from chainermn_tpu_torch.serving.weights import shard_params_tp
    if model.tp_size != 1 or any(getattr(b, "moe", None) is not None and
                                 b.moe.comm is not None for b in model.blocks):
        raise ValueError("the engine shards the model itself: give it the "
                         "whole model (tp_size 1, every expert)")
    dev = _device(model)
    local = TransformerLM(
        model.vocab, model.d_model, model.n_layers, model.n_heads,
        model.max_len, model.attention_impl, dtype=model.dtype,
        n_kv_heads=model.n_kv_heads, moe_experts=model.moe_experts,
        moe_top_k=model.moe_top_k, moe_capacity=model.moe_capacity,
        moe_comm=ep_comm, moe_plan=moe_plan, tp_size=tp, tp_comm=tp_comm,
        device=dev, generator=torch.Generator(dev))
    sd = model.state_dict()
    if tp > 1:
        sd = {k: v[t] for k, v in shard_params_tp(
            sd, tp, n_heads=model.n_heads,
            n_kv_heads=model.n_kv_heads).items()}
    if ep > 1:
        per = model.moe_experts // ep
        experts = expert_parameter_names(model)
        sd = {k: v[e * per:(e + 1) * per] if k in experts else v
              for k, v in sd.items()}
    local.load_state_dict(sd, strict=True)
    return local.train(model.training)


def _device(model) -> torch.device:
    return next(model.parameters()).device


class InferenceEngine:
    """``submit()`` on rank 0, then ``step()`` in lockstep on every rank
    (or :meth:`run_until_idle` in a single process).

    ``model`` (and ``draft_model`` with ``spec_k > 0``) are port
    :class:`~chainermn_tpu_torch.models.transformer.TransformerLM` s with
    their weights, whole; the cache lives on the model's device.
    ``plane`` is any object with ``rank``, ``size`` and ``bcast_obj`` (a
    communicator); the default is ``comm``, else :class:`LocalPlane`.
    ``comm`` (``tp_size x ep_size`` ranks) is needed when either is above
    1 (see the module note).
    """

    def __init__(self, model, config: ServingConfig, *, plane=None,
                 draft_model=None, comm=None):
        cfg = config
        self.cfg = cfg
        self.plane = plane if plane is not None else (
            comm if comm is not None else LocalPlane())
        self.model = model
        tp, ep = cfg.tp_size, cfg.ep_size
        if ep > 1:
            if not model.moe_experts:
                raise ValueError(
                    f"ep_size ({ep}) > 1 requires an MoE model "
                    f"(moe_experts > 0)")
            if model.moe_experts % ep:
                raise ValueError(
                    f"ep_size ({ep}) must divide moe_experts "
                    f"({model.moe_experts})")
            if cfg.spec_k:
                raise ValueError(
                    "speculative decoding (spec_k > 0) is not supported "
                    "with ep_size > 1")
        n_kv = model.n_kv_heads or model.n_heads
        if n_kv % tp:
            raise ValueError(
                f"tp_size ({tp}) must divide n_kv_heads ({n_kv})")
        size = 1 if comm is None else comm.size
        if tp * ep > size:
            raise ValueError(
                f"tp_size {tp} x ep_size {ep} exceeds the {size} ranks of "
                f"the communicator (comm=)")
        if tp * ep < size:
            raise ValueError(
                f"tp_size {tp} x ep_size {ep} uses {tp * ep} of the {size} "
                f"ranks of the communicator: give the engine a "
                f"communicator of tp_size x ep_size ranks")
        max_ctx = cfg.max_pages_per_seq * cfg.page_size
        if max_ctx + cfg.spec_k > model.max_len:
            raise ValueError(
                f"cache reach ({cfg.max_pages_per_seq} pages x "
                f"{cfg.page_size}) plus spec_k ({cfg.spec_k}) exceeds "
                f"the model's max_len ({model.max_len})")
        if cfg.spec_k:
            if draft_model is None:
                raise ValueError("spec_k > 0 requires a draft_model")
            if cfg.chunk_tokens < cfg.spec_k + 1:
                raise ValueError(
                    f"spec_k ({cfg.spec_k}) needs chunk_tokens >= "
                    f"spec_k + 1 (the verify pass scores k+1 positions "
                    f"in the [B, S] step shape), got {cfg.chunk_tokens}")
            if draft_model.vocab != model.vocab:
                raise ValueError(
                    f"draft vocab ({draft_model.vocab}) != target vocab "
                    f"({model.vocab})")
            if max_ctx + cfg.spec_k > draft_model.max_len:
                raise ValueError(
                    f"cache reach plus spec_k exceeds the draft model's "
                    f"max_len ({draft_model.max_len})")
        # the furthest position a [B, S] pass embeds: a row at the cache's
        # last position, its padded tail, and the draft's micro-steps
        reach = max_ctx + cfg.chunk_tokens - 1 + max(cfg.spec_k - 1, 0)
        for m in (model, draft_model) if cfg.spec_k else (model,):
            if reach > m.max_len:
                raise ValueError(
                    f"the [B, S] step embeds positions up to {reach - 1} "
                    f"(cache reach {max_ctx} + chunk_tokens "
                    f"{cfg.chunk_tokens} - 1 + spec_k - 1), past the "
                    f"model's max_len ({m.max_len}): raise max_len")
        self.scheduler = AdmissionScheduler(
            max_seqs=cfg.max_seqs, page_size=cfg.page_size,
            num_pages=cfg.num_pages,
            max_pages_per_seq=cfg.max_pages_per_seq,
            chunk_tokens=cfg.chunk_tokens, eos_id=cfg.eos_id,
            policy=cfg.policy, prefix_cache=cfg.prefix_cache)
        if cfg.moe_plan is not None:
            from chainermn_tpu_torch.planner.compiler import (
                check_exchange_plan)
            check_exchange_plan(cfg.moe_plan)
        moe_plan = cfg.moe_plan if model.moe_experts else None
        if tp > 1 or ep > 1 or moe_plan is not None:
            # every rank builds both groups, in one order (collective)
            r = comm.rank if comm is not None else 0
            t, e = r // ep, r % ep
            tp_comm = comm.split(e, t) if tp > 1 else None
            ep_comm = comm.split(t, e) if ep > 1 else None
            self.model = model = _shard(model, tp, t, tp_comm, ep, e,
                                        ep_comm, moe_plan)
            if cfg.spec_k and tp > 1:
                dn_kv = draft_model.n_kv_heads or draft_model.n_heads
                if dn_kv % tp:
                    raise ValueError(
                        f"tp_size ({tp}) must divide the draft model's "
                        f"n_kv_heads ({dn_kv})")
                draft_model = _shard(draft_model, tp, t, tp_comm, 1, 0, None)
        self.device = _device(model)
        self.cache = _kv.init_kv_cache(
            model.n_layers, cfg.num_pages, cfg.page_size, *_kv_shape(model),
            dtype=cfg.cache_dtype, device=self.device)
        self.draft_model = draft_model
        self.draft_cache = None
        if cfg.spec_k:
            self.draft_cache = _kv.init_kv_cache(
                draft_model.n_layers, cfg.num_pages, cfg.page_size,
                *_kv_shape(draft_model), dtype=cfg.cache_dtype,
                device=self.device)
        # (step, accept decisions) of the last spec forward: checked on
        # every rank against the next step's plan
        self._last_spec = None
        self._spec_pickups = 0
        # forward passes run (each launches the flash forward once a layer)
        self.passes = {"target": 0, "draft": 0}
        self._step_idx = 0
        # the content hash of the last plan table this engine saw
        self._plan_table_hash = None
        #: the serving steps on which a swapped plan table was picked up
        self.plan_table_pickups: List[int] = []
        self._arrivals: Dict[int, float] = {}
        self._token_times: Dict[int, List[float]] = {}
        self.completions: List[Completion] = []
        # observability seams, bound once (None while it is off)
        from chainermn_tpu_torch.observability import (
            flight_recorder as _flight, registry as _registry)
        reg = _registry.get_registry() if _registry.enabled() else None
        self._m = None if reg is None else _serving_metrics(reg)
        self._fr = _flight.get_flight_recorder()

    # -- online-tuner plan-table pickup --------------------------------------
    def _attach_plan_table(self, plan):
        """Rank 0: when a plan table was hot-swapped since this engine last
        broadcast one, piggyback it on the step's plan, so every rank picks
        it up on the SAME serving step (the plan broadcast is the engine's
        lockstep channel already)."""
        from chainermn_tpu_torch.planner.online import (
            active_plan_table_meta, get_active_plan_table)
        meta = active_plan_table_meta()
        if meta is not None and meta["table_hash"] != self._plan_table_hash:
            plan = dict(plan, plan_table={
                "table_hash": meta["table_hash"],
                "swap_step": meta["swap_step"],
                "table": get_active_plan_table().to_dict()})
        return plan

    def _pickup_plan_table(self, plan):
        """Every rank: take a piggybacked plan table off the plan and
        register it as this process's active table (the checkpoint
        sidecar's pin; an auto communicator's swap reads it)."""
        if not isinstance(plan, dict) or "plan_table" not in plan:
            return plan
        from chainermn_tpu_torch.planner.autotune import PlanTable
        from chainermn_tpu_torch.planner.online import set_active_plan_table
        plan = dict(plan)
        entry = plan.pop("plan_table")
        if entry["table_hash"] != self._plan_table_hash:
            self._plan_table_hash = entry["table_hash"]
            self.plan_table_pickups.append(self._step_idx)
            if self.plane.rank != 0:
                set_active_plan_table(PlanTable.from_dict(entry["table"]),
                                      step=entry.get("swap_step"))
        return plan

    # -- spec-decode accept decisions on the plan envelope -------------------
    def _attach_spec(self, plan):
        """Rank 0: put the previous step's accept decisions on the plan.
        Every rank computed the same decisions locally, so this is the
        lockstep proof channel, not the data channel."""
        if self._last_spec is not None:
            plan = dict(plan, spec={"step": self._last_spec[0],
                                    "decisions": self._last_spec[1]})
        return plan

    def _pickup_spec(self, plan):
        """Every rank: check rank 0's accept decisions against the ones
        this rank applied last step."""
        if not isinstance(plan, dict) or "spec" not in plan:
            return plan
        plan = dict(plan)
        entry = plan.pop("spec")
        mine = self._last_spec
        if (mine is None or entry["step"] != mine[0]
                or entry["decisions"] != mine[1]):
            step, decisions = mine if mine is not None else (None, None)
            raise RuntimeError(
                f"lockstep desync: rank 0 broadcast spec-decode accept "
                f"decisions {entry} but this rank applied "
                f"{ {'step': step, 'decisions': decisions} }")
        self._spec_pickups += 1
        return plan

    # -- forward -------------------------------------------------------------
    def _run(self, role, page_table, tokens, pos0, n_new):
        """One pass of the target or the draft (``role``) over ``tokens``
        [B, S] at per-row offsets ``pos0``, writing K/V into its cache in
        place; float32 logits [B, S, vocab]."""
        model, cache = ((self.model, self.cache) if role == "target"
                        else (self.draft_model, self.draft_cache))
        self.passes[role] += 1

        def attend(layer, q, k, v):
            lk = _kv.write_kv(cache.k[layer], page_table, pos0, n_new, k)
            lv = _kv.write_kv(cache.v[layer], page_table, pos0, n_new, v)
            return _kv.paged_attention(q, lk, lv, page_table, pos0)

        return model(tokens, pos_offset=pos0, attend=attend)

    @staticmethod
    def _at(logits, idx):
        """``logits[b, idx[b]]`` for every row: [B, vocab]."""
        return logits[torch.arange(logits.shape[0], device=logits.device),
                      idx]

    def _forward(self, page_table, tokens, pos0, n_new):
        """The fused prefill+decode step: (sampled [B], last logits
        [B, vocab]) at each slot's last valid position."""
        logits = self._run("target", page_table, tokens, pos0, n_new)
        last = (n_new - 1).clamp(0, tokens.shape[1] - 1)
        last_logits = self._at(logits, last)
        return last_logits.argmax(-1).to(torch.int32), last_logits

    def _forward_spec(self, page_table, tokens, pos0, n_new, dec, d_tok1,
                      d_pos1, d_n1):
        """The fused draft+verify step (fixed [B, S]), JAX's op order.

        Decode rows: the draft proposes ``k`` tokens greedily -- its first
        pass over ``[prev, t0]`` at ``pos0 - 1`` (re-feeding the
        second-to-last token heals the draft cache after a fully accepted
        round), then ``k - 1`` one-token micro-steps -- and ONE target pass
        scores ``[t0, d1..dk]``; the longest matching prefix is accepted
        and position ``a`` gives the correction or bonus token.  Rejected
        positions hold stale K/V above every live query (causally masked)
        and are overwritten by the next step's writes.  Prefill rows run
        their chunk through both models.  Returns (out [B, K+1], n_out [B],
        last logits [B, vocab]).
        """
        K = self.cfg.spec_k
        b, s = tokens.shape
        dev = tokens.device
        dlog = self._run("draft", page_table, d_tok1, d_pos1, d_n1)
        last1 = (d_n1 - 1).clamp(0, s - 1)
        cur = self._at(dlog, last1).argmax(-1).to(torch.int32)
        drafts = [cur]
        zeros = torch.zeros((b, s), dtype=torch.int32, device=dev)
        one = dec.to(torch.int32)
        for i in range(1, K):   # micro-steps: d_i at position L + i
            step_tokens = zeros.clone()
            step_tokens[:, 0] = cur
            dlog = self._run("draft", page_table, step_tokens, pos0 + i,
                             one)
            cur = dlog[:, 0].argmax(-1).to(torch.int32)
            drafts.append(cur)
        d_mat = torch.stack(drafts, dim=1)                       # [B, K]
        dec_tokens = torch.cat(
            [tokens[:, :1], d_mat, zeros[:, :s - (K + 1)]], dim=1)
        ver_tokens = torch.where(dec[:, None], dec_tokens, tokens)
        t_n = torch.where(dec, K + 1, n_new)
        tlog = self._run("target", page_table, ver_tokens, pos0, t_n)
        g = tlog[:, :K + 1, :].argmax(-1).to(torch.int32)
        # greedy accept: the longest leading prefix with d_i == g_{i-1}
        match = (d_mat == g[:, :K]).to(torch.int32)
        a = torch.cumprod(match, dim=1).sum(dim=1)               # [B]
        j_idx = torch.arange(K + 1, device=dev)[None, :]
        g_a = torch.gather(g, 1, a[:, None])                     # correction
        d_pad = torch.cat([d_mat, zeros[:, :1]], dim=1)
        out_dec = torch.where(j_idx < a[:, None], d_pad, g_a)
        # prefill rows: the greedy token at the last valid position
        lastp = (n_new - 1).clamp(0, s - 1)
        p_logits = self._at(tlog, lastp)
        p_tok = p_logits.argmax(-1).to(torch.int32)
        out_pre = torch.cat([p_tok[:, None], zeros[:, :K]], dim=1)
        out = torch.where(dec[:, None], out_dec, out_pre)        # [B, K+1]
        n_out = torch.where(dec, a + 1, 1)
        last_logits = torch.where(dec[:, None], tlog[:, 0, :], p_logits)
        return out, n_out, last_logits

    def _spec_inputs(self, batch):
        """The draft's first pass, on the host: decode rows feed ``[prev,
        t0]`` at ``pos0 - 1`` with 2 valid tokens, prefill rows their
        chunk; idle rows keep offset 0."""
        tokens, pos0, n_new = batch["tokens"], batch["pos0"], batch["n_new"]
        dec = batch["decode"].astype(bool)
        d_tok1 = tokens.copy()
        d_tok1[dec] = 0
        d_tok1[dec, 0] = batch["prev"][dec]
        d_tok1[dec, 1] = tokens[dec, 0]
        d_pos1 = np.where(dec, pos0 - 1, pos0).astype(np.int32)
        d_n1 = np.where(dec, 2, n_new).astype(np.int32)
        if (d_pos1 < 0).any():
            raise RuntimeError(f"spec draft: negative offsets {d_pos1}")
        return dec, d_tok1, d_pos1, d_n1

    # -- client side ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               arrival: Optional[float] = None) -> int:
        """Queue a request (rank 0).  ``arrival`` defaults to now."""
        arrival = time.perf_counter() if arrival is None else arrival
        rid = self.scheduler.submit(list(map(int, prompt)),
                                    max_new_tokens, arrival)
        self._arrivals[rid] = arrival
        return rid

    def idle(self) -> bool:
        return self.scheduler.idle()

    # -- the step loop -------------------------------------------------------
    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def step(self) -> StepResult:
        t0 = time.perf_counter()
        sched = self.scheduler
        fr = self._fr
        if self.plane.size > 1:
            plan = (self._attach_spec(self._attach_plan_table(
                sched.build_plan())) if self.plane.rank == 0 else None)
            btok = None
            if fr is not None:
                btok = fr.span_begin("object", "serving_plan_bcast",
                                     step=self._step_idx)
            plan = self.plane.bcast_obj(plan, root=0)
            if fr is not None:
                fr.span_end(btok)
        else:
            plan = self._attach_spec(self._attach_plan_table(
                sched.build_plan()))
        plan = self._pickup_spec(self._pickup_plan_table(plan))
        tok = None
        if fr is not None:
            tok = fr.span_begin(
                "serving", "serving_step", step=self._step_idx,
                admitted=len(plan["admit"]), retired=len(plan["retire"]))
        retired = sched.apply_plan(plan)
        completed = [self._finish(slot) for _, slot in retired]

        batch = sched.step_batch()
        n_new = batch["n_new"]
        ran = bool(n_new.sum())
        emitted: list = []
        last_logits = None
        spec_stats = None
        if ran:
            ftok = None
            if fr is not None:
                # the forward sub-span: dispatch plus the sampled tokens'
                # copy to the host (the device-bound slice of a step)
                ftok = fr.span_begin(
                    "serving", "serving_forward", step=self._step_idx,
                    n_new=int(n_new.sum()),
                    decode_slots=int((n_new == 1).sum()),
                    prefill_slots=int((n_new > 1).sum()),
                    spec=bool(self.cfg.spec_k))
            put = self._put
            table, tokens = put(batch["page_table"]), put(batch["tokens"])
            pos0, n_new_d = put(batch["pos0"]), put(n_new)
            with torch.inference_mode():
                if self.cfg.spec_k:
                    dec, d_tok1, d_pos1, d_n1 = self._spec_inputs(batch)
                    out_d, n_out_d, logits_d = self._forward_spec(
                        table, tokens, pos0, n_new_d, put(dec), put(d_tok1),
                        put(d_pos1), put(d_n1))
                    both = torch.cat([out_d, n_out_d[:, None].to(
                        out_d.dtype)], dim=1).cpu().numpy()  # sync point
                    out, n_out = both[:, :-1], both[:, -1]
                else:
                    sampled_d, logits_d = self._forward(table, tokens, pos0,
                                                        n_new_d)
                    sampled = sampled_d.cpu().numpy()        # sync point
                if self.cfg.keep_logits:
                    last_logits = logits_d.float().cpu().numpy()
            if fr is not None:
                fr.span_end(ftok)
            if self.cfg.spec_k:
                emitted = sched.note_sampled_spec(n_new, out, n_out)
                decisions = [
                    [int(i), int(n_out[i]),
                     [int(t) for t in out[i, :n_out[i]]]]
                    for i in range(len(n_out))
                    if dec[i] and n_new[i] > 0]
                self._last_spec = [self._step_idx, decisions]
                rows = len(decisions)
                spec_stats = {
                    "rows": rows,
                    "proposed": rows * self.cfg.spec_k,
                    "accepted": sum(d[1] - 1 for d in decisions),
                    "out_tokens": sum(d[1] for d in decisions),
                }
            else:
                emitted = sched.note_sampled(n_new, sampled)
            now = time.perf_counter()
            for rid, _tok, _n in emitted:
                times = self._token_times.setdefault(rid, [])
                if self._m is not None:
                    if times:
                        self._m["tok_s"].observe(now - times[-1])
                    else:
                        arrival = self._arrivals.get(rid)
                        if arrival is not None:
                            self._m["ttft"].observe(now - arrival)
                times.append(now)

        if self._m is not None:
            self._observe_step(plan, batch, n_new, emitted, spec_stats, t0)
        if fr is not None:
            fr.span_end(
                tok, emitted=len(emitted), ran_forward=ran,
                spec_accepted=0 if spec_stats is None
                else spec_stats["accepted"])
        res = StepResult(step=self._step_idx, plan=plan, emitted=emitted,
                         completed=completed, ran_forward=ran,
                         last_logits=last_logits, n_new=n_new,
                         spec=spec_stats)
        self._step_idx += 1
        return res

    def _observe_step(self, plan, batch, n_new, emitted, spec_stats,
                      t0: float) -> None:
        """One step into the ``serving_*`` family (JAX's updates)."""
        m, sched = self._m, self.scheduler
        m["steps"].inc()
        m["gen"].inc(len(emitted))
        if spec_stats is None:
            m["prefill"].inc(int(n_new.sum()) - len(emitted))
        else:
            m["prefill"].inc(int(n_new[batch["decode"] == 0].sum()))
            m["spec_rows"].inc(spec_stats["rows"])
            m["spec_proposed"].inc(spec_stats["proposed"])
            m["spec_accepted"].inc(spec_stats["accepted"])
            m["spec_out"].inc(spec_stats["out_tokens"])
        m["admitted"].inc(len(plan["admit"]))
        m["retired"].inc(len(plan["retire"]))
        m["active"].set(sched.active_count)
        m["queue"].set(sched.queue_depth)
        m["pages"].set(sched.allocator.num_free)
        if sched.prefix is not None:
            ps = sched.prefix_stats()
            m["prefix_hits"].set(ps["hits"])
            m["prefix_hit_tokens"].set(ps["hit_tokens"])
            m["prefix_prompt_tokens"].set(ps["prompt_tokens"])
            m["prefix_cached_pages"].set(ps["cached_pages"])
            m["prefix_evictions"].set(ps["evictions"])
        m["step_s"].observe(time.perf_counter() - t0)

    def _finish(self, slot) -> Completion:
        comp = Completion(
            rid=slot.rid, prompt_len=len(slot.prompt),
            tokens=list(slot.generated),
            arrival=self._arrivals.get(slot.rid, 0.0),
            token_times=self._token_times.pop(slot.rid, []))
        self.completions.append(comp)
        return comp

    def run_until_idle(self, max_steps: int = 10_000) -> List[Completion]:
        """Step until every submitted request has retired (a single
        process; several processes drive ``step()`` in lockstep
        themselves)."""
        start = len(self.completions)
        for _ in range(max_steps):
            if self.idle():
                break
            self.step()
        else:
            raise RuntimeError(
                f"engine still busy after {max_steps} steps "
                f"(active={self.scheduler.active_count}, "
                f"queued={self.scheduler.queue_depth})")
        return self.completions[start:]


__all__ = ["Completion", "InferenceEngine", "LocalPlane", "ServingConfig",
           "StepResult"]
