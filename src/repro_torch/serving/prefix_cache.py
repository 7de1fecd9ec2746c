# Copy of src/repro/serving/prefix_cache.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Radix prefix cache: token-keyed trie over refcounted KV pages.

Multi-turn chat re-arrives carrying its full history, and concurrent
users share system prompts — on the constrained devices ConsumerBench
profiles (Section 4.3) that redundancy is pure waste: every request
re-prefills tokens whose KV an earlier request already computed, and
every user pays pages for pages-worth of identical state. This module
keeps finished requests' prompt KV alive in a trie keyed on token
content, at page granularity:

* **Node = one page.** A node's ``key`` is the tuple of tokens whose KV
  its page holds (``page_size`` for interior nodes, possibly fewer for a
  tail). Children hang off FULL pages only — a partial tail can never be
  extended in place, it is superseded by a longer tail when one is
  published.
* **Refcounts, not copies.** The trie retains each page with one
  :meth:`BlockAllocator.ref_incr` reference. Admission maps matched
  pages straight into the new slot's block table (another reference);
  the data is never copied until a slot WRITES into a shared page, which
  copy-on-write forks it (``fork_table`` + a device row copy).
* **Safe partial hits.** A lookup may match only a prefix of a node's
  key. Mapping the page is still sound: the reader's length stops at the
  matched token, attention masks everything past it, and the first
  diverging write forks the page. This is what makes CoW real rather
  than theoretical — hits are floored to the engine's prefill-chunk grid
  (bit-identical resumed dispatches), which routinely lands mid-page.
* **Cold-only LRU eviction.** The trie evicts leaf-first, oldest-first,
  and ONLY nodes whose page it holds the sole reference to (refcount 1 =
  no slot is reading the page). A page with refcount > 1 is pinned by
  its readers and is never evicted — eviction pressure reclaims cold
  history, never live state.

The trie is host-side bookkeeping only (token tuples and page ids); the
engine owns every device interaction. The simulator substrate mirrors
the same accounting analytically (``PodSimulator``'s prefix model) so
both substrates report one ``prefix`` schema block.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.serving.block_allocator import BlockAllocator


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_use")

    def __init__(self, key: tuple = (), page: Optional[int] = None,
                 parent: Optional["_Node"] = None):
        self.key = key                    # tokens this page holds
        self.page = page                  # allocator page id (None = root)
        self.children: list[_Node] = []
        self.parent = parent
        self.last_use = 0


@dataclass
class PrefixStats:
    lookups: int = 0
    hits: int = 0                 # lookups that matched >= 1 token
    hit_tokens: int = 0           # tokens served from the trie (pre-floor)
    inserted_pages: int = 0       # pages newly retained by publishes
    evicted_pages: int = 0        # cold pages reclaimed under pressure
    nodes: int = 0                # live nodes (== live retained pages)


class PrefixCache:
    """Radix trie over one :class:`BlockAllocator`'s pages."""

    def __init__(self, allocator: BlockAllocator):
        self.alloc = allocator
        self.page_size = allocator.page_size
        self.root = _Node()
        self._tick = 0
        self.stats = PrefixStats()

    # ------------------------------------------------------------ helpers
    def _touch(self, node: _Node) -> None:
        self._tick += 1
        while node is not None and node.page is not None:
            node.last_use = self._tick
            node = node.parent

    def _pieces(self, tokens: Sequence[int]):
        ps = self.page_size
        return [tuple(tokens[i:i + ps]) for i in range(0, len(tokens), ps)]

    # ------------------------------------------------------------- lookup
    def lookup(self, tokens: Sequence[int]) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens``.

        Returns ``(hit_tokens, pages)`` where ``pages`` covers the hit in
        block order; the last page may be a partial match (the caller
        floors the hit and trims pages to what the floored hit needs).
        Does NOT take references — :meth:`BlockAllocator.alloc_slot` does,
        atomically with the mapping."""
        self.stats.lookups += 1
        node, matched, pages = self.root, 0, []
        i = 0
        while i < len(tokens):
            piece = tokens[i:i + self.page_size]
            best, best_lcp = None, 0
            for ch in node.children:
                l = _lcp(piece, ch.key)
                if l > best_lcp:
                    best, best_lcp = ch, l
            if best is None:
                break
            pages.append(best.page)
            matched += best_lcp
            if best_lcp < len(best.key) or len(best.key) < self.page_size:
                node = best
                break               # diverged mid-page / partial tail
            node, i = best, i + self.page_size
        if matched:
            self.stats.hits += 1
            self.stats.hit_tokens += matched
            self._touch(node)
        return matched, pages

    def peek(self, tokens: Sequence[int]) -> int:
        """Length of the longest cached prefix of ``tokens``, with ZERO
        side effects — no stats, no LRU touch. The router's prefix-aware
        policy probes every replica with this before choosing one, so a
        probe must not perturb eviction order or hit-rate accounting on
        the replicas that lose the race."""
        node, matched = self.root, 0
        i = 0
        while i < len(tokens):
            piece = tokens[i:i + self.page_size]
            best, best_lcp = None, 0
            for ch in node.children:
                l = _lcp(piece, ch.key)
                if l > best_lcp:
                    best, best_lcp = ch, l
            if best is None:
                break
            matched += best_lcp
            if best_lcp < len(best.key) or len(best.key) < self.page_size:
                break               # diverged mid-page / partial tail
            node, i = best, i + self.page_size
        return matched

    # ------------------------------------------------------------ publish
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Publish a finished slot's prompt pages under their token key.

        ``pages[i]`` holds the KV of ``tokens[i*page_size:(i+1)*page_size]``.
        Already-known pages are skipped (the donor's duplicates are simply
        not retained); new nodes gain one trie reference each. A longer
        partial tail supersedes a shorter one along the same path (the old
        tail's reference is dropped). Returns pages newly retained."""
        pieces = self._pieces(tokens)
        if len(pieces) > len(pages):
            raise ValueError(f"{len(pieces)} pages of tokens but only "
                             f"{len(pages)} page ids")
        node, retained = self.root, 0
        for depth, piece in enumerate(pieces):
            exact = next((ch for ch in node.children if ch.key == piece),
                         None)
            if exact is not None:
                node = exact
                continue
            # supersede a strictly shorter childless tail along this path
            # (its KV is a prefix of ours — the longer page replaces it)
            shorter = next(
                (ch for ch in node.children
                 if not ch.children and len(ch.key) < len(piece)
                 and _lcp(ch.key, piece) == len(ch.key)), None)
            if shorter is not None:
                self.alloc.ref_decr(shorter.page)
                node.children.remove(shorter)
                self.stats.nodes -= 1
            if len(piece) < self.page_size:
                covered = next(
                    (ch for ch in node.children
                     if _lcp(ch.key, piece) == len(piece)), None)
                if covered is not None:
                    break           # an equal-or-longer tail already exists
            child = _Node(piece, pages[depth], node)
            self.alloc.ref_incr(child.page)
            node.children.append(child)
            self.stats.nodes += 1
            self.stats.inserted_pages += 1
            retained += 1
            node = child
        self._touch(node)
        return retained

    # ----------------------------------------------------------- eviction
    def _cold_leaves(self) -> list[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children)
            if (n.page is not None and not n.children
                    and self.alloc.ref_count(n.page) == 1):
                out.append(n)
        return out

    def reclaimable_pages(self) -> int:
        """Pages eviction COULD free right now: nodes whose entire subtree
        is cold (every page refcount 1 — held only by the trie)."""
        def cold(n: _Node) -> tuple[bool, int]:
            total, all_cold = 0, self.alloc.ref_count(n.page) == 1
            for ch in n.children:
                c, t = cold(ch)
                all_cold, total = all_cold and c, total + t
            return all_cold, total + (1 if all_cold else 0)
        return sum(cold(ch)[1] for ch in self.root.children)

    def evict_cold(self, need_pages: int,
                   protect: frozenset = frozenset()) -> int:
        """Reclaim up to ``need_pages`` pages, cold leaves first, oldest
        ``last_use`` first (a freed leaf may expose its parent as the next
        cold leaf). ``protect`` shields pages an in-flight admission is
        about to map (they are still refcount 1 until ``alloc_slot`` runs).
        Returns pages actually freed."""
        freed = 0
        while freed < need_pages:
            leaves = [n for n in self._cold_leaves()
                      if n.page not in protect]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_use)
            self.alloc.ref_decr(victim.page)
            victim.parent.children.remove(victim)
            self.stats.nodes -= 1
            self.stats.evicted_pages += 1
            freed += 1
        return freed

    def drop_all(self) -> int:
        """Release every reference the trie holds (engine shutdown)."""
        count = 0
        stack = list(self.root.children)
        while stack:
            n = stack.pop()
            stack.extend(n.children)
            self.alloc.ref_decr(n.page)
            count += 1
        self.root = _Node()
        self.stats.nodes = 0
        return count
