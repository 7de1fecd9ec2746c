# Copy of src/repro/serving/block_allocator.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Device KV-page pool: alloc/free, watermarks, LRU victim selection.

The contiguous slot cache reserved ``max_slots x max_seq`` tokens of KV up
front, so the engine's memory footprint was a config constant and the
paper's central finding — GenAI apps on end-user devices fail on *shared,
constrained memory*, not compute (ConsumerBench Section 4.3) — was invisible to
every Scenario. The paged refactor replaces that reservation with a pool of
fixed-size pages plus one block table per decode slot:

* **pool** — ``num_pages`` pages of ``page_size`` tokens each. Model-side
  the pool is a per-layer array ``(P, page_size, KV, hd)``; a page id
  indexes the same row of every layer's pool (vLLM-style layout).
* **block table** — ``(max_slots, max_blocks)`` int32 page ids. Unassigned
  entries hold ``SENTINEL`` (page 0): always safe to *gather* (the data is
  garbage but sits beyond every row's valid length, so attention masks it);
  *writes* only ever target the page covering the row's current length,
  which the engine maps before dispatch.
* **watermarks** — when ``pages_in_use >= high_watermark * num_pages`` the
  engine preempts the least-recently-used slot (evict-and-recompute: free
  its pages, requeue the request, re-prefill on re-admission) until usage
  falls below ``low_watermark`` or no eligible victim remains.

The allocator is pure host-side bookkeeping (numpy); it never touches
device memory. The ``tables`` array follows the engine's copy-on-write
rule: any buffer already handed to a jitted call is never mutated in
place — every mutation rebinds ``self.tables`` to a fresh array.

Refcounted sharing (prefix cache)
---------------------------------
Every allocated page carries a reference count. A normal private page has
refcount 1 (its owning slot); the prefix cache
(:mod:`repro.serving.prefix_cache`) retains published pages with its own
reference, and admission maps cached pages into a new slot's block table
via ``alloc_slot(..., shared=pages)`` — each holder is one reference.
``ref_decr`` frees the page only when the LAST reference drops; a page
with refcount > 1 can therefore never reach the free list through any
single holder's release (eviction safety), and decrementing an
unallocated page raises (double-free detection). The first WRITE into a
shared page must fork it first (``fork_table``): the slot swaps the
shared id for a fresh private page and the engine device-copies the pool
row (copy-on-write).
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import numpy as np

#: block-table filler for unallocated entries. Page 0 — NOT an out-of-range
#: id — so gathers through the table are always in bounds; stale contents
#: sit past the row's valid length and are masked by the attention kernels.
SENTINEL = 0


class PoolExhausted(RuntimeError):
    """No free page and no eligible eviction victim."""


class BlockAllocator:
    """Page bookkeeping for one engine's KV pool."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 max_blocks: int, *, high_watermark: float = 1.0,
                 low_watermark: Optional[float] = None):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if not 0.0 < high_watermark <= 1.0:
            raise ValueError(f"high_watermark must be in (0, 1], got "
                             f"{high_watermark}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_blocks = max_blocks
        self.high_watermark = high_watermark
        self.low_watermark = (high_watermark if low_watermark is None
                              else low_watermark)
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._reserved: list[int] = []               # external pressure holds
        self._pages: dict[int, list[int]] = {}       # slot -> page ids
        self._ref: dict[int, int] = {}               # page -> refcount
        self._last_touch: dict[int, int] = {}        # slot -> tick
        self._tick = 0
        self.tables = np.full((max_slots, max_blocks), SENTINEL, np.int32)

    # ------------------------------------------------------------ queries
    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.page_size))

    def can_admit(self, tokens: int) -> bool:
        return self.pages_needed(tokens) <= self.free_pages

    def admit_within_watermark(self, tokens: int) -> bool:
        """Would admitting this request keep the pool under the high
        watermark? Admission never evicts (two fresh requests could evict
        each other forever without progressing); it just waits for
        headroom. An idle pool always admits — a request too big for the
        watermark alone must still be able to run."""
        if self.pages_in_use == 0:
            return True
        return (self.pages_in_use + self.pages_needed(tokens)
                <= self.high_watermark * self.num_pages)

    def fits(self, tokens: int) -> bool:
        """Can this request EVER run on this pool (ignoring current use)?"""
        return (self.pages_needed(tokens) <= self.num_pages
                and self.pages_needed(tokens) <= self.max_blocks)

    def slot_pages(self, slot: int) -> int:
        return len(self._pages.get(slot, ()))

    def slot_page_ids(self, slot: int) -> list[int]:
        """The page ids a slot maps, in block order (prefix-cache publish
        reads the prompt-covering prefix of this list)."""
        return list(self._pages.get(slot, ()))

    def ref_count(self, page: int) -> int:
        """Current reference count of a page (0 = free / never allocated)."""
        return self._ref.get(page, 0)

    def over_high_watermark(self) -> bool:
        return self.pages_in_use >= self.high_watermark * self.num_pages

    def over_low_watermark(self) -> bool:
        return self.pages_in_use > self.low_watermark * self.num_pages

    # -------------------------------------------------------- alloc / free
    def _take_page(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"KV pool exhausted ({self.num_pages} pages of "
                f"{self.page_size} tokens) and no eviction victim")
        page = self._free.pop()
        self._ref[page] = 1
        return page

    # ------------------------------------------------------- refcounting
    def ref_incr(self, page: int) -> int:
        """Add a reference to an ALLOCATED page (prefix-cache retain /
        shared mapping). Returns the new count."""
        n = self._ref.get(page, 0)
        if n < 1:
            raise ValueError(f"page {page} is not allocated; cannot share")
        self._ref[page] = n + 1
        return n + 1

    def ref_decr(self, page: int) -> bool:
        """Drop one reference; the page returns to the free list only when
        the LAST reference drops (returns True then). Decrementing a page
        with no live references is a double free and raises."""
        n = self._ref.get(page, 0)
        if n < 1:
            raise ValueError(f"double free: page {page} has no live "
                             "references")
        if n == 1:
            del self._ref[page]
            self._free.append(page)
            return True
        self._ref[page] = n - 1
        return False

    def fork_table(self, slot: int, block_idx: int) -> tuple[int, int]:
        """Copy-on-write fork: if the slot's ``block_idx`` page is SHARED
        (refcount > 1), swap in a fresh private page and drop the slot's
        reference to the old one. Returns ``(old_page, new_page)`` — equal
        when the page was already private (no-op). The caller owns the
        device copy of the pool row (``ModelBundle.copy_page``)."""
        pages = self._pages.get(slot)
        if pages is None or not 0 <= block_idx < len(pages):
            raise ValueError(f"slot {slot} has no block {block_idx}")
        old = pages[block_idx]
        if self._ref.get(old, 0) <= 1:
            return old, old
        new = self._take_page()            # may raise PoolExhausted
        self.ref_decr(old)
        pages[block_idx] = new
        self._map(slot, block_idx, new)
        return old, new

    def _map(self, slot: int, block_idx: int, page: int) -> None:
        tables = self.tables.copy()          # copy-on-write (jit aliasing)
        tables[slot, block_idx] = page
        self.tables = tables

    def alloc_slot(self, slot: int, tokens: int,
                   shared: Sequence[int] = ()) -> None:
        """Map pages covering ``tokens`` for a freshly admitted slot.

        ``shared`` maps already-allocated (prefix-cache) pages as the
        slot's LEADING blocks — each gains a reference instead of costing
        a fresh page; only the remainder draws from the free list."""
        if slot in self._pages:
            raise ValueError(f"slot {slot} already holds pages")
        need = self.pages_needed(tokens)
        shared = list(shared)
        if len(shared) > need:
            raise ValueError(
                f"{len(shared)} shared pages exceed the {need} the request "
                "needs")
        if need > self.max_blocks:
            raise PoolExhausted(
                f"request needs {need} pages but the block table holds "
                f"{self.max_blocks}")
        if need - len(shared) > self.free_pages:
            raise PoolExhausted(
                f"request needs {need - len(shared)} fresh pages, "
                f"{self.free_pages} free")
        for p in shared:
            self.ref_incr(p)
        pages = shared + [self._take_page()
                          for _ in range(need - len(shared))]
        self._pages[slot] = pages
        tables = self.tables.copy()
        tables[slot, :need] = pages
        self.tables = tables
        self.touch(slot)

    def grow_to(self, slot: int, tokens: int) -> int:
        """Ensure the slot's mapping covers ``tokens``; returns pages newly
        allocated. Raises :class:`PoolExhausted` when the pool is out of
        pages (the engine evicts a victim and retries)."""
        pages = self._pages.get(slot)
        if pages is None:
            raise ValueError(f"slot {slot} holds no pages")
        need = self.pages_needed(tokens)
        if need > self.max_blocks:
            raise PoolExhausted(
                f"slot {slot} needs {need} pages but the block table holds "
                f"{self.max_blocks}")
        added = 0
        while len(pages) < need:
            page = self._take_page()       # may raise PoolExhausted
            self._map(slot, len(pages), page)
            pages.append(page)
            added += 1
        if added:
            self.touch(slot)
        return added

    def free_slot(self, slot: int) -> int:
        """Drop the slot's reference on every page it maps; returns how
        many actually reached the free list (shared pages survive under
        their remaining holders' references)."""
        pages = self._pages.pop(slot, [])
        freed = sum(1 for p in reversed(pages) if self.ref_decr(p))
        self._last_touch.pop(slot, None)
        if pages:
            tables = self.tables.copy()
            tables[slot, :] = SENTINEL
            self.tables = tables
        return freed

    # -------------------------------------------------- external pressure
    def reserve(self, n: int) -> int:
        """An EXTERNAL tenant (repro.resilience's ``memory_spike``) grabs
        up to ``n`` free pages out of the pool. Only free-list pages are
        ever taken — allocated pages, and in particular refcounted shared
        prefix pages, are structurally untouchable. Returns how many pages
        were actually reserved (caller evicts and retries for the rest)."""
        if n < 0:
            raise ValueError(f"reserve count must be >= 0, got {n}")
        got = []
        while len(got) < n and self._free:
            got.append(self._take_page())
        self._reserved.extend(got)
        return len(got)

    @property
    def reserved_pages(self) -> int:
        return len(self._reserved)

    def release_reserved(self) -> int:
        """Return every externally reserved page to the free list (spike
        end); returns how many were released."""
        n = len(self._reserved)
        while self._reserved:
            self.ref_decr(self._reserved.pop())
        return n

    # ------------------------------------------------------ victim choice
    def touch(self, slot: int) -> None:
        """Mark the slot as just used (decode step / prefill advance)."""
        self._tick += 1
        self._last_touch[slot] = self._tick

    def lru_victim(self, exclude: Iterable[int] = ()) -> Optional[int]:
        """Least-recently-touched page-holding slot outside ``exclude``."""
        skip = set(exclude)
        cands = [s for s in self._pages if s not in skip]
        if not cands:
            return None
        return min(cands, key=lambda s: self._last_touch.get(s, 0))
