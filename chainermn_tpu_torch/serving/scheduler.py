"""Admission scheduling for continuous batching.

Counterpart of ``chainermn_tpu/serving/scheduler.py``, host Python and
numpy only, so its plans, page tables and batches equal JAX's.  The
scheduler splits a pure DECISION step from a deterministic APPLY step so a
multi-process serving world runs in lockstep: rank 0 calls
:meth:`AdmissionScheduler.build_plan` (no mutation), broadcasts the
plain-dict plan over the communicator's object plane, and EVERY rank --
rank 0 included -- applies it with :meth:`AdmissionScheduler.apply_plan`.
The plan carries the admitted prompts and the page allocator is
deterministic (the lowest free pages first), so all ranks hold the same
slots, page tables and -- greedy sampling being deterministic on the same
logits -- the same generated tokens.  Only rank 0 holds the waiting queue.

Two admission policies:

* ``"continuous"`` -- every step, waiting requests are packed into any free
  slot whose page reservation fits (finished sequences retire and their
  slot refills next step);
* ``"static"`` -- requests are admitted only when ALL slots are empty: the
  classic static batch, the benchmark's baseline
  (:mod:`chainermn_tpu_torch.benchmarks.bench_serving`).

Pages are reserved on admission for the worst case (``ceil((prompt +
max_new) / page_size)``) and freed on retirement, so a running sequence
never runs out of pages mid-flight.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from chainermn_tpu_torch.serving.kv_cache import PageAllocator, PrefixCache

_POLICIES = ("continuous", "static")


@dataclasses.dataclass
class Request:
    """One inference request (rank 0 / client side)."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0  # host-side submit time (never traced)


@dataclasses.dataclass
class _Slot:
    """Replicated per-slot decode state (identical on every rank)."""

    rid: int
    prompt: List[int]
    max_new: int
    pages: List[int]
    seq_len: int = 0                 # tokens whose KV sit in the cache
    generated: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    hit_tokens: int = 0              # prompt tokens served from the prefix cache
    indexed: bool = False            # prompt pages already in the prefix trie


class AdmissionScheduler:
    def __init__(self, *, max_seqs: int, page_size: int, num_pages: int,
                 max_pages_per_seq: int, chunk_tokens: int,
                 eos_id: Optional[int] = None,
                 policy: str = "continuous",
                 prefix_cache: bool = False):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, "
                             f"got {policy!r}")
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq
        self.chunk_tokens = chunk_tokens
        self.eos_id = eos_id
        self.policy = policy
        self.allocator = PageAllocator(num_pages)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(page_size, self.allocator) if prefix_cache else None)
        self.slots: List[Optional[_Slot]] = [None] * max_seqs
        self.waiting: Deque[Request] = deque()   # rank 0 only
        # trash page = physical index num_pages (kv_cache layout);
        # unassigned table entries point there
        self.page_table = np.full((max_seqs, max_pages_per_seq),
                                  num_pages, np.int32)
        self._next_rid = 0
        # prefix-cache stats, updated in apply_plan/note_sampled so every
        # rank counts identically
        self.prefix_admits = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0

    # -- client side (rank 0) ------------------------------------------------
    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        total = prompt_len + max_new
        return -(-total // self.page_size)  # ceil

    def submit(self, prompt: List[int], max_new_tokens: int,
               arrival: float = 0.0) -> int:
        """Queue a request (rank 0 only); returns its request id."""
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        need = self.pages_needed(len(prompt), max_new_tokens)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"request needs {need} pages (prompt {len(prompt)} + "
                f"max_new {max_new_tokens} at page_size "
                f"{self.page_size}) but the page table holds "
                f"{self.max_pages_per_seq} per sequence — raise "
                f"max_pages_per_seq or shorten the request")
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(rid, list(map(int, prompt)),
                                    int(max_new_tokens), arrival))
        return rid

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def active_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def idle(self) -> bool:
        return self.active_count == 0 and not self.waiting

    # -- lockstep plan: decide (rank 0), broadcast, apply (all ranks) --------
    def build_plan(self) -> dict:
        """Pure decision: which finished slots retire this step, which
        prefix-cache pages are evicted, and which waiting requests are
        admitted into which slots (with their cache-hit pages).  Mutates
        nothing — the same plan is applied by every rank via
        :meth:`apply_plan`."""
        retire = [[i, s.rid] for i, s in enumerate(self.slots)
                  if s is not None and s.finished]
        retiring = {i for i, _ in retire}
        free_slots = [i for i, s in enumerate(self.slots)
                      if s is None or i in retiring]
        retiring_pages = [p for i in retiring for p in self.slots[i].pages]
        # Refcount-aware: a retiring slot's shared pages stay resident
        # (the prefix trie still holds them) — only pages whose last
        # holder is the retiring slot actually come back.
        free_pages = (self.allocator.num_free
                      + self.allocator.would_free(retiring_pages))
        admit = []
        evict: List[int] = []
        evicted_set: set = set()
        protect: set = set()
        if self.policy == "static" and len(free_slots) < self.max_seqs:
            free_slots = []  # static batch: wait for the whole batch
        for req in self.waiting:
            if not free_slots:
                break
            hit_pages: List[int] = []
            hit_tokens = 0
            if self.prefix is not None:
                hit_pages, hit_tokens = self.prefix.lookup(req.prompt)
                for j, p in enumerate(hit_pages):
                    if p in evicted_set:  # already claimed by this plan
                        hit_pages = hit_pages[:j]
                        hit_tokens = j * self.page_size
                        break
            need = self.pages_needed(len(req.prompt), req.max_new_tokens)
            need_new = need - len(hit_pages)
            if need_new > free_pages:
                shortfall = need_new - free_pages
                more = []
                if self.prefix is not None:
                    want = len(evict) + shortfall
                    full = self.prefix.plan_evictions(
                        want, exclude=protect | set(hit_pages))
                    if len(full) >= want:
                        more = full[len(evict):]
                if not more:
                    break  # FIFO head-of-line: keep admission order stable
                evict.extend(more)
                evicted_set.update(more)
                free_pages += len(more)
            protect.update(hit_pages)
            entry = [free_slots.pop(0), req.rid, list(req.prompt),
                     req.max_new_tokens]
            if self.prefix is not None:
                entry += [hit_tokens, list(hit_pages)]
            admit.append(entry)
            free_pages -= need_new
        plan = {"retire": retire, "admit": admit}
        if evict:
            plan["evict"] = evict
        return plan

    def apply_plan(self, plan: dict) -> list:
        """Apply a (possibly remote) plan deterministically.  Returns the
        retired ``(slot_idx, _Slot)`` pairs (the engine turns them into
        completions)."""
        retired = []
        for slot_idx, rid in plan["retire"]:
            slot = self.slots[slot_idx]
            if slot is None or slot.rid != rid:
                raise RuntimeError(
                    f"lockstep desync: plan retires rid {rid} from slot "
                    f"{slot_idx} but this rank holds "
                    f"{None if slot is None else slot.rid}")
            self.allocator.free(slot.pages)
            self.page_table[slot_idx, :] = self.num_pages
            self.slots[slot_idx] = None
            retired.append((slot_idx, slot))
        evict = plan.get("evict") or []
        if evict:
            if self.prefix is None:
                raise RuntimeError(
                    "lockstep desync: plan evicts prefix pages but this "
                    "rank has no prefix cache")
            self.prefix.evict_pages(evict)
        for entry in plan["admit"]:
            slot_idx, rid, prompt, max_new = entry[:4]
            hit_tokens = int(entry[4]) if len(entry) > 4 else 0
            hit_pages = [int(p) for p in entry[5]] if len(entry) > 5 else []
            if self.slots[slot_idx] is not None:
                raise RuntimeError(
                    f"lockstep desync: admitting rid {rid} into occupied "
                    f"slot {slot_idx}")
            if hit_pages:
                got, _ = self.prefix.lookup(prompt)
                if got[:len(hit_pages)] != hit_pages:
                    raise RuntimeError(
                        f"lockstep desync: plan admits rid {rid} with "
                        f"prefix hit {hit_pages} but this rank's trie "
                        f"holds {got[:len(hit_pages)]}")
                self.allocator.retain(hit_pages)
                self.prefix.touch(prompt, len(hit_pages))
            need = self.pages_needed(len(prompt), max_new)
            fresh = self.allocator.alloc(need - len(hit_pages))
            if fresh is None:
                raise RuntimeError(
                    f"lockstep desync: no pages for admitted rid {rid} "
                    f"(need {need - len(hit_pages)}, free "
                    f"{self.allocator.num_free})")
            pages = hit_pages + fresh
            self.slots[slot_idx] = _Slot(rid=rid, prompt=list(prompt),
                                         max_new=max_new, pages=pages,
                                         seq_len=hit_tokens,
                                         hit_tokens=hit_tokens)
            self.page_table[slot_idx, :] = self.num_pages
            self.page_table[slot_idx, :len(pages)] = pages
            self.prefix_admits += 1
            self.prefix_prompt_tokens += len(prompt)
            if hit_tokens:
                self.prefix_hits += 1
                self.prefix_hit_tokens += hit_tokens
            if self.waiting and self.waiting[0].rid == rid:
                self.waiting.popleft()  # rank 0 drains its queue
        return retired

    # -- per-step batch construction ----------------------------------------
    def step_batch(self) -> Dict[str, np.ndarray]:
        """Fixed-shape [B, S] batch for the fused prefill+decode forward:
        prefilling slots contribute their next prompt chunk (up to
        ``chunk_tokens``), decoding slots their last sampled token, idle
        or finished slots nothing (``n_new == 0``, writes go to the trash
        page)."""
        b, s = self.max_seqs, self.chunk_tokens
        tokens = np.zeros((b, s), np.int32)
        pos0 = np.zeros((b,), np.int32)
        n_new = np.zeros((b,), np.int32)
        decode = np.zeros((b,), np.int32)
        prev = np.zeros((b,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is None or slot.finished:
                continue
            pos0[i] = slot.seq_len
            if slot.seq_len < len(slot.prompt):          # prefill chunk
                chunk = slot.prompt[slot.seq_len:slot.seq_len + s]
                tokens[i, :len(chunk)] = chunk
                n_new[i] = len(chunk)
            else:                                        # decode: 1 token
                tokens[i, 0] = slot.generated[-1]
                n_new[i] = 1
                decode[i] = 1  # a 1-token prefill tail is NOT decode —
                #                only the host can tell (spec-decode mask)
                # second-to-last sequence token (position seq_len - 1):
                # the spec draft re-feeds it to heal the one-position
                # draft-cache hole a fully-accepted round leaves behind
                prev[i] = (slot.generated[-2] if len(slot.generated) > 1
                           else slot.prompt[-1])
        return {"tokens": tokens, "pos0": pos0, "n_new": n_new,
                "decode": decode, "prev": prev,
                "page_table": self.page_table.copy()}

    def _maybe_index_prefix(self, slot: _Slot) -> None:
        """Index a just-prefilled slot's full prompt pages in the trie
        (every rank runs this at the same step — lockstep-identical)."""
        if self.prefix is None or slot.indexed:
            return
        slot.indexed = True
        n_full = len(slot.prompt) // self.page_size
        if n_full:
            self.prefix.insert(slot.prompt, slot.pages, n_full)

    def note_sampled(self, n_new: np.ndarray, sampled: np.ndarray) -> list:
        """Advance slot state after the forward.  ``sampled[i]`` is the
        greedy token at slot ``i``'s last valid position.  Returns the
        emitted tokens ``[(rid, token, n_generated)]`` — a sequence emits
        only once its whole prompt is in the cache (the step that
        consumed the final prompt chunk produces its first token)."""
        sampled = np.asarray(sampled)
        return self.note_sampled_spec(
            n_new, sampled.reshape(len(sampled), 1),
            np.ones(len(sampled), np.int32))

    def note_sampled_spec(self, n_new: np.ndarray, out_tokens: np.ndarray,
                          n_out: np.ndarray) -> list:
        """Spec-decode generalization of :meth:`note_sampled`: a decoding
        slot may land up to ``n_out[i]`` tokens this step
        (``out_tokens[i, :n_out[i]]`` = accepted draft tokens plus the
        target's correction/bonus token), truncated at ``max_new``/EOS.
        ``seq_len`` advances by the kept count — the KV of every kept
        token except the last is already in the cache, preserving the
        vanilla decode invariant."""
        emitted = []
        for i, slot in enumerate(self.slots):
            if slot is None or slot.finished or n_new[i] == 0:
                continue
            if slot.seq_len < len(slot.prompt):          # prefill row
                slot.seq_len += int(n_new[i])
                if slot.seq_len < len(slot.prompt):
                    continue  # still prefilling
                self._maybe_index_prefix(slot)
                tok = int(out_tokens[i, 0])
                slot.generated.append(tok)
                emitted.append((slot.rid, tok, len(slot.generated)))
                if (len(slot.generated) >= slot.max_new
                        or (self.eos_id is not None
                            and tok == self.eos_id)):
                    slot.finished = True
                continue
            kept = 0                                     # decode row
            for j in range(int(n_out[i])):
                tok = int(out_tokens[i, j])
                slot.generated.append(tok)
                kept += 1
                emitted.append((slot.rid, tok, len(slot.generated)))
                if (len(slot.generated) >= slot.max_new
                        or (self.eos_id is not None
                            and tok == self.eos_id)):
                    slot.finished = True
                    break
            slot.seq_len += kept
        return emitted

    def prefix_stats(self) -> dict:
        """Prefix-cache counters (identical on every rank)."""
        return {
            "enabled": self.prefix is not None,
            "admits": self.prefix_admits,
            "hits": self.prefix_hits,
            "hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens": self.prefix_prompt_tokens,
            "cached_pages": 0 if self.prefix is None else len(self.prefix),
            "evictions": 0 if self.prefix is None else self.prefix.evictions,
        }


__all__ = ["AdmissionScheduler", "Request"]
