"""Paged KV cache: fixed-size pages, per-sequence page tables.

Counterpart of ``chainermn_tpu/serving/kv_cache.py``.  The physical cache
of one layer is ``[num_pages + 1, page_size, Hkv, Dh]``: ``num_pages``
allocatable pages plus one TRASH page (the last physical index) that takes
the writes of padded and idle batch rows, so the fused prefill+decode step
runs one ``[B, S]`` shape every step.

**Layout invariant**: a sequence's page-table row maps logical page ``j``
to the physical page holding its global positions ``j*page_size ..
(j+1)*page_size - 1``, filled left to right with no holes.  Gathering a
row's pages back to back rebuilds the sequence: gathered index ``i`` IS
global position ``i``, so the causal mask of
:func:`chainermn_tpu_torch.ops.flash_attention.flash_attention` with a
per-sequence ``q_offset`` drops every position past a sequence's length
(unwritten page tails, entries that point at the trash page).

Where JAX returns new arrays, :func:`write_kv` writes the layer in place
(and returns it).  :func:`paged_attention` is a gather followed by the
flash forward: on CUDA tensors the hand-written ``cmn_flash_fwd`` kernel,
on CPU tensors its plain version.

:class:`PageAllocator` (refcounted, always the lowest free pages) and
:class:`PrefixCache` (a trie of page-aligned prompt chunks with
leaf-first LRU eviction) are host Python, JAX's own, so every controller
of a lockstep serving world reaches the same physical layout from the
same admission plan.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from chainermn_tpu_torch.ops.flash_attention import flash_attention


class KvCache(NamedTuple):
    """Per-layer stacked physical pages: ``k``/``v`` are ``[n_layers,
    num_pages + 1, page_size, Hkv, Dh]`` (last physical page = trash)."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_pages(self) -> int:
        """Allocatable pages (the trash page is not counted)."""
        return int(self.k.shape[1]) - 1

    @property
    def page_size(self) -> int:
        return int(self.k.shape[2])


def init_kv_cache(n_layers: int, num_pages: int, page_size: int,
                  n_kv_heads: int, head_dim: int, dtype=torch.float32,
                  device=None) -> KvCache:
    """Zero-initialised cache with ``num_pages`` allocatable pages plus the
    trash page."""
    shape = (n_layers, num_pages + 1, page_size, n_kv_heads, head_dim)
    return KvCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def write_kv(cache_layer, page_table, pos0, n_new, new):
    """Scatter one step's K or V into a layer's pages, in place; returns
    ``cache_layer``.

    ``cache_layer`` [P+1, page, H, D]; ``page_table`` [B, max_pages] ints;
    ``pos0`` [B] = each sequence's length BEFORE this step; ``n_new`` [B]
    = valid new tokens (0 for idle slots); ``new`` [B, S, H, D].  Row
    ``b``'s token ``t`` lands at global position ``pos0[b] + t``; padded
    tokens (``t >= n_new[b]``) and positions past the table's reach land in
    the trash page (several may hit one trash slot; no other slot is
    written twice).
    """
    n_phys, page_size, h, d = cache_layer.shape
    trash = n_phys - 1
    dev = cache_layer.device
    table = _long(page_table, dev)
    b, s = new.shape[:2]
    t = torch.arange(s, device=dev)[None, :]
    pos = _long(pos0, dev)[:, None] + t                          # [B, S]
    logical_raw = pos // page_size
    logical = logical_raw.clamp(0, table.shape[1] - 1)
    phys = torch.gather(table, 1, logical)                       # [B, S]
    # positions past the table's reach (a speculative over-run when a
    # sequence holds every table entry) must not alias into its last real
    # page: they go to trash with the padded tokens
    valid = (t < _long(n_new, dev)[:, None]) & (logical_raw < table.shape[1])
    phys = torch.where(valid, phys, trash)
    flat_idx = phys * page_size + pos % page_size
    flat = cache_layer.view(-1, h, d)
    flat.index_copy_(0, flat_idx.reshape(-1),
                     new.reshape(-1, h, d).to(cache_layer.dtype))
    return cache_layer


def gather_kv(cache_layer, page_table):
    """Every sequence's pages back into contiguous ``[B, max_pages *
    page_size, H, D]``: index ``i`` is global position ``i``."""
    n_phys, page_size, h, d = cache_layer.shape
    dev = cache_layer.device
    table = _long(page_table, dev)
    b, m = table.shape
    idx = (table[:, :, None] * page_size
           + torch.arange(page_size, device=dev)[None, None, :]
           ).reshape(b, m * page_size)
    return cache_layer.view(-1, h, d)[idx]


def paged_attention(q, cache_k_layer, cache_v_layer, page_table, pos0,
                    sm_scale: Optional[float] = None):
    """Causal attention of this step's queries over the paged cache.

    ``q`` [B, S, H, D] sits at global positions ``pos0[b] + t`` (write the
    step's K/V first so the queries see themselves).  The gathered cache is
    position-aligned, so the per-sequence ``q_offset`` is the whole mask.
    Grouped kv heads pass through (``Hkv`` divides ``H``).
    """
    kc = gather_kv(cache_k_layer, page_table)
    vc = gather_kv(cache_v_layer, page_table)
    return flash_attention(q, kc, vc, causal=True, sm_scale=sm_scale,
                           q_offset=pos0)


class PageAllocator:
    """Deterministic host-side refcounted free-page list.

    Always allocates the lowest-numbered free pages, so identical
    alloc/retain/free call sequences on different controllers produce
    identical physical layouts (the lockstep-admission contract).

    Every allocated page carries a reference count: ``alloc`` hands out
    pages at refcount 1, :meth:`retain` adds a holder (copy-on-write
    prefix sharing — the prefix index and each admitted sequence count
    as separate holders), and :meth:`free` drops one holder, returning
    the page to the free list only when the last holder lets go.
    Freeing a page with no holders is still the hard "double free"
    error it always was.
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages))  # sorted ascending
        self._refs: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        """Current holder count (0 for a free page)."""
        if not 0 <= page < self.num_pages:
            raise ValueError(f"out-of-range page {page}")
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take the ``n`` lowest free pages at refcount 1, or None
        (nothing taken) if fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        taken, self._free = self._free[:n], self._free[n:]
        for p in taken:
            self._refs[p] = 1
        return taken

    def retain(self, pages: Sequence[int]) -> None:
        """Add one holder to each (already-allocated) page."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"retaining out-of-range page {p}")
            if p not in self._refs:
                raise ValueError(f"retaining free page {p}")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one holder per page; a page returns to the free list
        when its refcount reaches zero."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"freeing out-of-range page {p}")
            r = self._refs.get(p, 0)
            if r <= 0:
                raise ValueError(f"double free of page {p}")
            if r == 1:
                del self._refs[p]
                bisect.insort(self._free, p)
            else:
                self._refs[p] = r - 1

    def would_free(self, pages: Sequence[int]) -> int:
        """How many pages a ``free(pages)`` call would return to the
        free list (pure — admission planning looks ahead with this)."""
        pending: Dict[int, int] = {}
        n = 0
        for p in pages:
            pending[p] = pending.get(p, 0) + 1
            if self._refs.get(p, 0) == pending[p]:
                n += 1
        return n


class _TrieNode:
    """One cached full page of a token prefix."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_TrieNode"], last_used: int):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.parent = parent
        self.last_used = last_used


class PrefixCache:
    """Token-prefix → page-list index: a hash trie over page-aligned
    prompt chunks.

    Each trie node owns one *full* physical page (the trie holds one
    allocator reference to it) keyed by that page's ``page_size`` token
    chunk; a root-to-node path spells out a page-aligned token prefix
    whose KV is already resident.  :meth:`lookup` is pure;
    admission-plan application calls :meth:`touch` (LRU clock is a
    deterministic counter, never wall time) and prefill completion calls
    :meth:`insert` — both driven by lockstep-identical state, so every
    controller's trie is identical.

    Eviction is leaf-first LRU and refcount-respecting: only pages whose
    sole holder is the trie itself (``refcount == 1``) are candidates —
    evicting a page a live sequence still maps would not free memory and
    would only destroy reuse.  :meth:`plan_evictions` is the pure
    planning half (rank 0 puts its result in the admission plan);
    :meth:`evict_pages` applies it everywhere.
    """

    def __init__(self, page_size: int, allocator: PageAllocator):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.allocator = allocator
        self._root: Dict[Tuple[int, ...], _TrieNode] = {}
        self._by_page: Dict[int, _TrieNode] = {}
        self._clock = 0
        self.evictions = 0

    def __len__(self) -> int:
        """Number of cached pages."""
        return len(self._by_page)

    def _chunks(self, prompt: Sequence[int], n_pages: int):
        ps = self.page_size
        for j in range(n_pages):
            yield tuple(prompt[j * ps:(j + 1) * ps])

    def lookup(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of ``prompt`` → (pages,
        hit tokens).  Pure.  At least one prompt token is always left
        for the admitted sequence to prefill (the step that completes
        prefill is what samples the first output token), so a fully
        cached prompt still hits at most ``(len-1) // page_size`` pages.
        """
        max_pages = max(0, (len(prompt) - 1) // self.page_size)
        pages: List[int] = []
        level = self._root
        for key in self._chunks(prompt, max_pages):
            node = level.get(key)
            if node is None:
                break
            pages.append(node.page)
            level = node.children
        return pages, len(pages) * self.page_size

    def touch(self, prompt: Sequence[int], n_pages: int) -> None:
        """Refresh the LRU clock along the first ``n_pages`` of
        ``prompt``'s path (called when a plan admits a cache hit)."""
        level = self._root
        for key in self._chunks(prompt, n_pages):
            node = level.get(key)
            if node is None:
                raise ValueError("prefix-cache touch of a missing path")
            self._clock += 1
            node.last_used = self._clock
            level = node.children

    def insert(self, prompt: Sequence[int], pages: Sequence[int],
               n_pages: int) -> int:
        """Index the first ``n_pages`` full pages of a prefilled
        sequence.  Chunks already present keep their existing page (the
        KV content is identical by determinism); new nodes retain the
        sequence's page.  Returns how many pages were newly adopted."""
        adopted = 0
        level = self._root
        parent: Optional[_TrieNode] = None
        for j, key in enumerate(self._chunks(prompt, n_pages)):
            node = level.get(key)
            if node is None:
                page = int(pages[j])
                self.allocator.retain([page])
                self._clock += 1
                node = _TrieNode(key, page, parent, self._clock)
                level[key] = node
                self._by_page[page] = node
                adopted += 1
            parent = node
            level = node.children
        return adopted

    def plan_evictions(self, n_needed: int,
                       exclude: Sequence[int] = ()) -> List[int]:
        """Pure leaf-first LRU plan: up to ``n_needed`` pages whose only
        holder is the trie, ordered children-before-parents so
        :meth:`evict_pages` can apply them in sequence.  ``exclude``
        protects pages (e.g. hits being admitted this very plan)."""
        if n_needed <= 0:
            return []
        import heapq
        protected = set(int(p) for p in exclude)

        def evictable(node: _TrieNode) -> bool:
            return (node.page not in protected
                    and self.allocator.refcount(node.page) == 1)

        kids = {id(n): len(n.children) for n in self._by_page.values()}
        heap = [(n.last_used, n.page, n) for n in self._by_page.values()
                if kids[id(n)] == 0 and evictable(n)]
        heapq.heapify(heap)
        planned: List[int] = []
        while heap and len(planned) < n_needed:
            _, _, node = heapq.heappop(heap)
            planned.append(node.page)
            parent = node.parent
            if parent is not None:
                kids[id(parent)] -= 1
                if kids[id(parent)] == 0 and evictable(parent):
                    heapq.heappush(
                        heap, (parent.last_used, parent.page, parent))
        return planned

    def evict_pages(self, pages: Sequence[int]) -> None:
        """Drop the trie nodes holding ``pages`` (in the given
        children-before-parents order) and release their references."""
        for p in pages:
            node = self._by_page.get(int(p))
            if node is None:
                raise ValueError(f"evicting uncached page {p}")
            if node.children:
                raise ValueError(f"evicting non-leaf page {p}")
            if node.parent is not None:
                del node.parent.children[node.key]
            else:
                del self._root[node.key]
            del self._by_page[node.page]
            self.allocator.free([node.page])
            self.evictions += 1


__all__ = ["KvCache", "PageAllocator", "PrefixCache", "gather_kv",
           "init_kv_cache", "paged_attention", "write_kv"]
