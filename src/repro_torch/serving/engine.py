"""Continuous-batching inference engine (PyTorch).

Port of :mod:`repro.serving.engine` on both of its caches — the paged KV
pool (the dense family's default) and the contiguous slot-resident cache
(``paged=False``, the ssm family's recurrent state, and every family under
the ``kv_cache_dtype="int8"`` hint, read when the engine is built: the
transformer families' int8 KV with its scales): the same slot
scheduling through the pluggable
:class:`~repro_torch.bench.policy.SchedulingPolicy` objects (``fcfs``,
``chunked``, ``mixed`` step budgets with multi-slot batched prefill,
``slo_aware``, ...), the same page-gated admission, LRU
preempt-to-evict with token-identical recompute, radix prefix sharing with
copy-on-write forks, decode-stall accounting and trace-recorder events —
and the same :class:`EngineStats` counters. On the same weights and
requests it emits the JAX engine's token streams. It also carries the
JAX engine's options for the Scenario runner
(:mod:`repro_torch.bench.engine_runner`) and the resilience layer: the
virtual cost clock (``step_cost_s``/``request_cost_s``, ``time_warp``,
:meth:`advance_to`), eviction watermarks, fault hooks (:meth:`crash_active`,
:meth:`abort`, :meth:`steal_pages`), the router's :meth:`prefix_peek`, and
per-partition telemetry (``recorder_chips``, ``recorder_label``,
``request_work``). ``prefill_chunk=None`` and, on the paged cache,
``page_size=None`` take the autotuner's picks
(:mod:`repro_torch.kernels.autotune`), as in the JAX engine.

What differs:

  * the JAX engine's jitted dispatches are eager calls into
    :class:`~repro_torch.models.factory.ModelBundle`, which write the page
    pools IN PLACE (``self.cache`` keeps the same tensors);
  * the engine runs on the model's device; on CUDA every layer's attention
    goes through the hand-written paged kernels (``repro_torch.kernels``);
  * on the wall clock (no cost functions) a dispatch's span starts before
    the dispatch and a decode step's time is read after its argmax reaches
    the host: the card runs behind the host until that sync. The rows of
    one batched prefill each get the dispatch's span; the rows of a decode
    step get an even split of the step's, an accounting split that keeps
    the busy time (the ``engine.decode`` scope is the step's true
    interval);
  * with a recorder the engine also records its scopes on its clock
    (:meth:`TraceRecorder.scope`): ``engine.step`` and, inside it,
    ``engine.admit`` (admission), ``engine.prefill`` (one a dispatch:
    input staging and the model call up to its return; counts ``rows``,
    the batch rows, ``width``, the dispatch's tokens a row, and ``useful``,
    the rows' real tokens), ``engine.decode`` (the same for a decode step;
    ``rows``, the rows decoded), ``engine.sync`` (the argmax reaching the
    host) and ``engine.book`` (token bookkeeping and frees). Without one,
    each scope site costs one None check.

Hot path, as in the JAX engine: one ``prefill_chunk[_paged]`` dispatch per
chunk (``stats.prefill_dispatches``), one full-batch ``decode_step[_paged]``
per step with an ``active`` mask that keeps idle and mid-prefill rows'
cache untouched, and per-slot lengths mirrored on the host in numpy. Host
arrays reach the card through pinned, non-blocking copies, so the decode
loop's one host sync is the argmax fetch (``stats.decode_syncs``).
"""
from __future__ import annotations

import math
import time as _time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.bench.policy import SchedulingPolicy, get_policy
from repro_torch.kernels import autotune
from repro_torch.models.factory import ModelBundle
from repro_torch.serving.block_allocator import BlockAllocator, PoolExhausted
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request
from repro_torch.telemetry.recorder import TraceRecorder

_NO_SCOPE = nullcontext()


@dataclass
class EngineStats:
    steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0
    max_decode_gap_s: float = 0.0
    prefill_dispatches: int = 0   # prefill_chunk calls (≤ ceil(P/C))
    decode_syncs: int = 0         # host-device syncs in the decode loop
    pages_in_use: int = 0         # PEAK pages held at once (paged cache)
    evictions: int = 0            # preempt-to-evict events (paged cache)
    recompute_tokens: int = 0     # cached tokens lost to evictions
    prefix_hit_tokens: int = 0    # prefill tokens served from the trie
    shared_pages: int = 0         # cached pages mapped into admitted slots
    cow_forks: int = 0            # shared pages forked on first write
    replays: int = 0              # in-flight requests replayed after a crash
    # ---- mixed batching (policy.step_budget; schema-1.7 batching block)
    budget_enabled: bool = False  # a step_budget split was ever applied
    mixed_steps: int = 0          # steps advancing BOTH prefill and decode
    decode_ready_time_s: float = 0.0  # phase time with decode rows ready
    decode_stall_time_s: float = 0.0  # ...of which no decode happened


class InferenceEngine:
    def __init__(self, model: ModelBundle, *, max_slots: int = 4,
                 max_seq: int = 256,
                 policy: "str | SchedulingPolicy" = "fcfs",
                 prefill_chunk: Optional[int] = None,
                 step_cost_s: Optional[Callable[[str, int], float]] = None,
                 request_cost_s: Optional[
                     Callable[[Request, str, int], float]] = None,
                 paged: Optional[bool] = None,
                 prefix_cache: bool = False,
                 kv_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 evict_high_watermark: float = 1.0,
                 evict_low_watermark: Optional[float] = None,
                 recorder: Optional[TraceRecorder] = None,
                 recorder_chips: int = 1,
                 recorder_label: str = "",
                 request_work: Optional[
                     Callable[[Request, str, int],
                              "tuple[float, float]"]] = None,
                 time_warp: Optional[
                     Callable[[float, float], float]] = None):
        #: telemetry: when a recorder is attached the engine emits
        #: admit/evict instants, one span per prefill-chunk dispatch and
        #: per decoded row, and a per-pool KV-occupancy counter
        #: (``kv_pages@<label>``). ``request_work(req, kind, tokens) ->
        #: (flops, hbm_bytes)`` resolves the work each span moved.
        #: recorder=None (default) keeps every emit site a single None
        #: check.
        self._recorder = recorder
        self._recorder_chips = recorder_chips
        self._recorder_label = recorder_label
        self._req_work = request_work
        self.model = model
        self.cfg = model.cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.policy = get_policy(policy)
        if prefill_chunk is None:
            # roofline-autotuned per model, as in the JAX engine
            prefill_chunk = autotune.engine_prefill_chunk(model.cfg,
                                                          max_seq=max_seq)
        self.prefill_chunk = prefill_chunk
        self.device = model.device
        self._step_cost = step_cost_s
        self._req_cost = request_cost_s
        #: fault integrator (repro_torch.resilience): maps ``(t0, nominal_s)
        #: -> t1`` so thermal derating / stall windows stretch the virtual
        #: clock
        self._time_warp = time_warp
        self._use_vclock = step_cost_s is not None or request_cost_s is not None
        self._vclock = 0.0
        self._t0 = _time.monotonic()
        self.stats = EngineStats()
        self._last_decode_t: Optional[float] = None

        if paged is None:
            paged = model.cache_pages()
        elif paged and not model.cache_pages():
            raise ValueError(
                f"family {self.cfg.family!r} cannot page its cache "
                "(no growing KV, or int8 KV hint active)")
        self.paged = paged
        self.params = None
        self.allocator: Optional[BlockAllocator] = None
        if paged:
            if page_size is None:
                kv = max(self.cfg.num_kv_heads, 1)
                page_size = autotune.best_config(
                    "paged_decode_attention",
                    {"b": max_slots, "kv": kv,
                     "g": max(self.cfg.num_heads // kv, 1),
                     "s": max_seq,
                     "d": self.cfg.resolved_head_dim})["page_size"]
            page_size = min(page_size, max_seq)
            max_blocks = math.ceil(max_seq / page_size)
            # default pool reproduces the contiguous capacity exactly (one
            # full block table per slot): no eviction pressure, identical
            # admission — the drop-in configuration
            if kv_pages is None:
                kv_pages = max_slots * max_blocks
            self.page_size = page_size
            self.kv_pages = kv_pages
            self.allocator = BlockAllocator(
                kv_pages, page_size, max_slots, max_blocks,
                high_watermark=evict_high_watermark,
                low_watermark=evict_low_watermark)
            if prefix_cache and not model.prefix_shareable():
                raise ValueError(
                    f"family {self.cfg.family!r} cannot share prefixes: "
                    "its prefill state is not fully page-resident "
                    "(slot-resident SSM state / cross-KV) or its numerics "
                    "are batch-coupled (MoE capacity)")
            self.prefix = (PrefixCache(self.allocator) if prefix_cache
                           else None)
            self.cache = self.model.init_paged_cache(
                kv_pages, page_size, max_slots, max_seq)
            # slot-resident leaves only (SSM state / enc-dec cross-KV);
            # page leaves pass through set_cache_slice untouched, so the
            # fresh piece can come from a 1-page dummy pool
            self._fresh_slot = self.model.slice_cache(
                self.model.init_paged_cache(1, page_size, 1, max_seq), 0)
        else:
            if prefix_cache:
                raise ValueError("prefix sharing needs the paged cache "
                                 "(pages are the unit of sharing)")
            self.prefix = None
            if kv_pages is not None:
                budget_tokens = kv_pages * (page_size or 16)
                reserved = max_slots * max_seq
                if reserved > budget_tokens:
                    raise ValueError(
                        f"contiguous KV cache reserves max_slots x max_seq "
                        f"= {reserved} tokens up front, exceeding the page "
                        f"budget of {budget_tokens} tokens; construct with "
                        "paged=True to admit by actual demand")
            self.page_size = page_size or 16
            self.kv_pages = kv_pages
            self.cache = self.model.init_cache(max_slots, max_seq)
            self._fresh_slot = self.model.slice_cache(
                self.model.init_cache(1, max_seq), 0)
        # host mirror: no device sync ever needed to READ a slot's length.
        # COPY-ON-WRITE invariant: torch.from_numpy ALIASES this buffer on
        # the CPU (as jnp.asarray may in the JAX engine), so any buffer
        # already handed to a dispatch must never be mutated in place —
        # every update below rebinds self.lengths to a fresh array. (The
        # allocator's block tables follow the same rule internally.)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.active: list[Optional[Request]] = [None] * max_slots
        self.waiting: list[Request] = []
        self._partial: dict[int, int] = {}   # slot -> prompt tokens prefilled
        #: slot -> the token sequence to prefill, FROZEN at admission (an
        #: evicted request re-admits with its generated tokens replayed;
        #: recomputing it live would grow with every decode step)
        self._eff: dict[int, np.ndarray] = {}
        self.done: list[Request] = []

    # ------------------------------------------------------------- setup
    def load_params(self, params):
        self.params = params

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device. On the CPU it
        aliases the numpy buffer (see the copy-on-write invariant); on a
        GPU it is staged in pinned memory and copied without blocking, so
        the host does not wait for the card's queue to drain."""
        t = torch.from_numpy(arr)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def now(self) -> float:
        return self._vclock if self._use_vclock else _time.monotonic() - self._t0

    def _advance(self, kind: str, tokens: int,
                 req: Optional[Request] = None):
        if not self._use_vclock:
            return
        if self._req_cost is not None and req is not None:
            cost = self._req_cost(req, kind, tokens)
        elif self._step_cost is not None:
            cost = self._step_cost(kind, tokens)
        else:
            return
        if self._time_warp is not None:
            self._vclock = self._time_warp(self._vclock, cost)
        else:
            self._vclock += cost

    def advance_to(self, t: float) -> None:
        """Jump the virtual clock forward to ``t`` (idle gap to the next
        arrival); no-op on wall-clock engines or when ``t`` is in the past.
        Resets the decode-gap tracker: idle waiting is not a stall, so
        ``stats.max_decode_gap_s`` keeps measuring scheduling-induced
        decode starvation only."""
        if self._use_vclock and t > self._vclock:
            self._vclock = t
            self._last_decode_t = None

    # ------------------------------------------------------------ intake
    def submit(self, req: Request):
        self.waiting.append(req)

    def _admit_order(self) -> list[Request]:
        now = self.now()
        ready = [r for r in self.waiting if r.arrival_s <= now]
        return self.policy.admit_order(ready, now)

    # --------------------------------------------------------- telemetry
    def _emit_span(self, kind: str, req: Request, tokens: int,
                   t0: float, t1: float) -> None:
        r = self._recorder
        if r is None:
            return
        fl = by = ici = 0.0
        if self._req_work is not None:
            # the hook returns (flops, hbm_bytes) or, for spans that move
            # interconnect traffic, (flops, hbm_bytes, ici_bytes)
            work = self._req_work(req, kind, tokens)
            fl, by = work[0], work[1]
            if len(work) > 2:
                ici = work[2]
        r.span(kind, req.app, req.request_id, t0, t1,
               chips=self._recorder_chips, flops=fl, hbm_bytes=by,
               tokens=tokens, ici_bytes=ici)

    def _scope(self, name: str, **counts):
        """The recorder's scope ``name`` on the engine clock, or a shared
        no-op without a recorder."""
        r = self._recorder
        return _NO_SCOPE if r is None else r.scope(name, self.now, **counts)

    def _emit_kv(self) -> None:
        if self._recorder is not None and self.allocator is not None:
            self._recorder.counter(f"kv_pages@{self._recorder_label}",
                                   self.now(), self.allocator.pages_in_use)

    # ------------------------------------------------------------- paged
    def _effective_prompt(self, req: Request) -> np.ndarray:
        """The token sequence a (re-)admitted request must prefill.

        For a fresh request this is the prompt. For an EVICTED request it
        replays the exact cache the slot held before eviction: prompt, the
        duplicated last prompt token (the engine's first decode step feeds
        ``prompt[-1]`` again), then all but the newest generated token —
        so the recomputed state is bit-comparable and the continuation
        token-identical to a never-evicted run."""
        if not req.tokens_out:
            return np.asarray(req.prompt, np.int32)
        replay = [int(req.prompt[-1])] + [int(t) for t in req.tokens_out[:-1]]
        return np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(replay, np.int32)])

    def _note_pages(self) -> None:
        if self.allocator is not None:
            self.stats.pages_in_use = max(self.stats.pages_in_use,
                                          self.allocator.pages_in_use)

    def _evict(self, victim: int, *, crash: bool = False) -> None:
        """Preempt-to-evict: free the victim slot's pages and requeue its
        request; the tokens it had cached are recomputed on re-admission.
        ``crash=True`` is the fault-injection variant (partition lost its
        state): the same mechanism, counted as ``stats.replays`` and traced
        as a ``replay`` instant, because a crash is not a memory event."""
        req = self.active[victim]
        if crash:
            self.stats.replays += 1
        else:
            self.stats.evictions += 1
        self.stats.recompute_tokens += int(self.lengths[victim])
        if self._recorder is not None:
            self._recorder.instant("replay" if crash else "evict",
                                   req.app, req.request_id, self.now(),
                                   tokens=int(self.lengths[victim]))
        if self.allocator is not None:
            self.allocator.free_slot(victim)
        self.active[victim] = None
        self._partial.pop(victim, None)
        self._eff.pop(victim, None)
        new_lengths = self.lengths.copy()
        new_lengths[victim] = 0
        self.lengths = new_lengths
        self.waiting.insert(0, req)
        self._emit_kv()

    # ------------------------------------------------------------- faults
    def crash_active(self) -> int:
        """Partition crash (``engine_stall`` with ``crash: true``): every
        active slot loses its in-flight state and replays from scratch on
        recovery. Returns how many requests were killed (requeued at the
        head of the waiting queue)."""
        n = 0
        for i, r in enumerate(self.active):
            if r is not None:
                self._evict(i, crash=True)
                n += 1
        return n

    def abort(self, request_id: int) -> Optional[Request]:
        """Client-side abort (timeout / cancellation): drop the request
        wherever it is — waiting queue or active slot — freeing its pages
        WITHOUT publishing its prefix. Returns the request so the caller
        can reset and resubmit it, or None when it is unknown or already
        finished."""
        for i, r in enumerate(self.waiting):
            if r.request_id == request_id:
                return self.waiting.pop(i)
        for i, r in enumerate(self.active):
            if r is not None and r.request_id == request_id:
                if self.allocator is not None:
                    self.allocator.free_slot(i)
                self.active[i] = None
                self._partial.pop(i, None)
                self._eff.pop(i, None)
                new_lengths = self.lengths.copy()
                new_lengths[i] = 0
                self.lengths = new_lengths
                self._emit_kv()
                return r
        return None

    def steal_pages(self, n: int) -> int:
        """External memory pressure (``memory_spike``): an outside tenant
        reserves ``n`` pages out of this engine's pool. Free pages go
        first, then cold cached prefixes, then live LRU slots are evicted
        to make room; the allocator only ever hands over FREE-list pages,
        so shared pages with live readers are structurally safe. Returns
        how many pages were actually taken."""
        alloc = self.allocator
        if alloc is None or n <= 0:
            return 0
        got = alloc.reserve(n)
        while got < n:
            if self.prefix is not None and self.prefix.evict_cold(1):
                got += alloc.reserve(n - got)
                continue
            victim = alloc.lru_victim()
            if victim is None:
                break
            self._evict(victim)
            got += alloc.reserve(n - got)
        self._note_pages()
        self._emit_kv()
        return got

    def release_stolen(self) -> int:
        """Spike end: the external tenant returns every reserved page."""
        alloc = self.allocator
        if alloc is None:
            return 0
        n = alloc.release_reserved()
        if n:
            self._emit_kv()
        return n

    def _rebalance(self, protect: set[int]) -> None:
        """Watermark policy: once the pool hits the high watermark, evict
        LRU slots until usage falls below the low watermark (no-op at the
        default high_watermark=1.0, where eviction is purely on-demand)."""
        alloc = self.allocator
        if alloc is None or alloc.high_watermark >= 1.0:
            return
        if not alloc.over_high_watermark():
            return
        if self.prefix is not None:
            # cold cached prefixes are the cheapest pages on the pool:
            # reclaim them before preempting any live slot
            excess = alloc.pages_in_use - int(
                alloc.low_watermark * alloc.num_pages)
            self.prefix.evict_cold(excess)
        while alloc.over_low_watermark():
            victim = alloc.lru_victim(exclude=protect)
            if victim is None:
                break
            self._evict(victim)

    def _grow_pages(self, slot: int, tokens: int) -> bool:
        """Ensure the slot's block table covers ``tokens``; reclaims cold
        prefix pages first, then evicts LRU victims. False when no page
        can be found (pool smaller than this one row) — the caller
        finishes the request cache-full."""
        alloc = self.allocator
        while True:
            try:
                alloc.grow_to(slot, tokens)
                self._note_pages()
                self._emit_kv()
                self._rebalance(protect={slot})
                return True
            except PoolExhausted:
                if self.prefix is not None and self.prefix.evict_cold(1):
                    continue       # cold cached history goes before live state
                victim = alloc.lru_victim(exclude={slot})
                if victim is None:
                    return False
                self._evict(victim)

    # ------------------------------------------------------ prefix sharing
    def _cow_guard(self, slot: int, start: int, n: int) -> None:
        """Copy-on-write barrier: fork every SHARED page the next dispatch
        writes into (positions ``start .. start+n-1``). Private pages are a
        refcount check each — no cost when sharing is off or cold."""
        if self.prefix is None or n <= 0:
            return
        alloc = self.allocator
        ps = alloc.page_size
        ids = alloc.slot_page_ids(slot)
        last = min((start + n - 1) // ps, len(ids) - 1)
        for b in range(start // ps, last + 1):
            if alloc.ref_count(ids[b]) <= 1:
                continue
            while True:
                try:
                    old, new = alloc.fork_table(slot, b)
                    break
                except PoolExhausted:
                    if self.prefix.evict_cold(1):
                        continue
                    victim = alloc.lru_victim(exclude={slot})
                    if victim is None:
                        raise
                    self._evict(victim)
            if new != old:
                self.cache = self.model.copy_page(self.cache, old, new)
                self.stats.cow_forks += 1
                self._note_pages()
                self._emit_kv()
                if self._recorder is not None:
                    req = self.active[slot]
                    self._recorder.instant(
                        "cow_fork", req.app, req.request_id, self.now(),
                        meta={"page": int(new)})

    def _publish_prefix(self, slot: int) -> None:
        """Release-time publish: the slot's prompt-covering pages move
        into the trie (one retained reference each) instead of dying with
        the slot — the next request with this prefix maps them back."""
        if self.prefix is None:
            return
        eff = self._eff.get(slot)
        if eff is None or len(eff) == 0:
            return
        npages = self.allocator.pages_needed(len(eff))
        ids = self.allocator.slot_page_ids(slot)
        if len(ids) >= npages:
            self.prefix.insert([int(t) for t in eff], ids[:npages])

    def prefix_peek(self, tokens) -> int:
        """Router probe: tokens of ``tokens`` this engine's prefix cache
        already holds, floored to the prefill-chunk grid exactly like
        :meth:`_prefix_lookup` floors a real admission hit — and with no
        side effects (no stats, no LRU touch), so probing the losing
        replicas of a routing decision leaves them untouched."""
        if self.prefix is None or tokens is None:
            return 0
        matched = self.prefix.peek([int(t) for t in tokens])
        return self._floor_to_chunk(matched)

    def _floor_to_chunk(self, matched: int) -> int:
        """Floor a prefix-cache hit to the prefill-chunk grid: a resumed
        prefill must re-dispatch on exactly the chunk boundaries a cold
        prefill would use, or the stream is no longer bit-identical. The
        ONE flooring rule shared by :meth:`prefix_peek` (router probes)
        and :meth:`_prefix_lookup` (real admissions)."""
        return (matched // self.prefill_chunk) * self.prefill_chunk

    def _prefix_lookup(self, eff: np.ndarray) -> tuple[int, list[int]]:
        """Longest cached prefix of ``eff``, floored to the prefill-chunk
        grid so the resumed prefill re-dispatches on exactly the chunk
        boundaries a from-scratch prefill would use (bit-identical
        streams); pages are trimmed to what the floored hit covers."""
        if self.prefix is None:
            return 0, []
        matched, pages = self.prefix.lookup([int(t) for t in eff])
        hit = self._floor_to_chunk(matched)
        if hit <= 0:
            return 0, []
        return hit, pages[:self.allocator.pages_needed(hit)]

    # ----------------------------------------------------------- prefill
    def _prefill_slot(self, slot: int, req: Request,
                      chunk: Optional[int]) -> bool:
        """Advance the slot's prefill by ``chunk`` tokens (None = all) in
        ``prefill_chunk_paged`` dispatches of at most ``self.prefill_chunk``
        tokens each. The slot mask keeps every other row's cache untouched,
        so no slice/restore copies are needed.

        Dispatch widths are capped at ``self.prefill_chunk`` even for
        whole-prompt (chunk=None, fcfs) prefill, as in the JAX engine, so
        both engines dispatch on the same chunk grid."""
        done_tok = self._partial.get(slot, 0)
        prompt = self._eff[slot]
        upto = len(prompt) if chunk is None else min(len(prompt),
                                                     done_tok + chunk)
        piece = prompt[done_tok:upto]
        if len(piece) == 0:
            return True
        for lo in range(0, len(piece), self.prefill_chunk):
            sub = piece[lo:lo + self.prefill_chunk]
            c = len(sub)
            with self._scope("engine.prefill", rows=self.max_slots, width=c,
                             useful=c):
                tokens = np.zeros((self.max_slots, c), np.int32)
                tokens[slot] = np.asarray(sub, np.int32)
                mask = np.zeros((self.max_slots,), bool)
                mask[slot] = True
                if self.paged:
                    self.allocator.touch(slot)
                    self._cow_guard(slot, int(self.lengths[slot]), c)
                t0 = self.now()
                if self.paged:
                    _, self.cache = self.model.prefill_chunk_paged(
                        self.params, self.cache, self._dev(tokens),
                        self._dev(self.lengths),
                        self._dev(self.allocator.tables), self._dev(mask),
                        None)
                else:
                    _, self.cache = self.model.prefill_chunk(
                        self.params, self.cache, self._dev(tokens),
                        self._dev(self.lengths), self._dev(mask), None)
            new_lengths = self.lengths.copy()
            new_lengths[slot] += c
            self.lengths = new_lengths
            self.stats.prefill_tokens += c
            self.stats.prefill_dispatches += 1
            # cost + timestamp accrue per dispatched sub-chunk, so
            # whole-prompt policies still expose intra-prompt boundaries to
            # step-SLO accounting (Request.t_prefill)
            self._advance("prefill", c, req)
            req.t_prefill.append(self.now())
            self._emit_span("prefill", req, c, t0, self.now())
        self._partial[slot] = upto
        return upto >= len(prompt)

    def _prefill_budget_plan(self, prefilling: list[int],
                             budget: int) -> list[tuple[int, int]]:
        """Split a prefill token budget across the mid-prefill slots.

        Even split first (every slot gets ``max(budget // n, 1)`` tokens,
        capped by its remaining prompt and by ``prefill_chunk`` so resumed
        streams stay on the chunk grid), then a second pass spends any
        leftover on the already-planned slots. Returns ``[(slot, c)]`` with
        every ``c > 0``."""
        plan: list[tuple[int, int]] = []
        if budget <= 0 or not prefilling:
            return plan
        base = max(budget // len(prefilling), 1)
        rem = budget
        for slot in prefilling:
            if rem <= 0:
                break
            left = len(self._eff[slot]) - self._partial.get(slot, 0)
            c = min(rem, base, left, self.prefill_chunk)
            if c > 0:
                plan.append((slot, c))
                rem -= c
        if rem > 0:
            for k, (slot, c) in enumerate(plan):
                if rem <= 0:
                    break
                left = (len(self._eff[slot]) - self._partial.get(slot, 0)
                        - c)
                extra = min(rem, left, self.prefill_chunk - c)
                if extra > 0:
                    plan[k] = (slot, c + extra)
                    rem -= extra
        return plan

    def _prefill_batch(self, prefilling: list[int], budget: int) -> bool:
        """Budgeted prefill phase: advance EVERY mid-prefill slot under a
        shared token budget, in ONE ``prefill_chunk`` dispatch when the
        model allows it (``multi_slot_batchable``). Rows with shorter
        pieces than the dispatch width are tail-padded and length-masked
        via the per-row ``valid`` count, so each row's cache writes are
        bit-identical to a solo prefill of the same piece.

        Cost stays per-row serialized (shared hardware serializes service
        demand), but ``prefill_dispatches`` counts actual dispatches — the
        tentpole win this stat is meant to show. Returns True when any
        prefill work was dispatched."""
        plan = self._prefill_budget_plan(prefilling, budget)
        if not plan:
            return False
        if len(plan) == 1 or not self.model.multi_slot_batchable():
            # MoE routing couples rows through batch-level capacity: fall
            # back to per-slot dispatches (same budget, same token grid)
            for slot, c in plan:
                self._prefill_slot(slot, self.active[slot], c)
            return True
        width = max(c for _, c in plan)
        with self._scope("engine.prefill", rows=self.max_slots, width=width,
                         useful=sum(c for _, c in plan)):
            tokens = np.zeros((self.max_slots, width), np.int32)
            mask = np.zeros((self.max_slots,), bool)
            valid = np.zeros((self.max_slots,), np.int32)
            for slot, c in plan:
                done_tok = self._partial.get(slot, 0)
                piece = self._eff[slot][done_tok:done_tok + c]
                tokens[slot, :c] = np.asarray(piece, np.int32)
                mask[slot] = True
                valid[slot] = c
                if self.paged:
                    self.allocator.touch(slot)
                    self._cow_guard(slot, int(self.lengths[slot]), c)
            # uniform widths skip the valid mask entirely, as in the JAX
            # engine
            val = (None if all(c == width for _, c in plan)
                   else self._dev(valid))
            t_disp = self.now()
            if self.paged:
                _, self.cache = self.model.prefill_chunk_paged(
                    self.params, self.cache, self._dev(tokens),
                    self._dev(self.lengths), self._dev(self.allocator.tables),
                    self._dev(mask), val)
            else:
                _, self.cache = self.model.prefill_chunk(
                    self.params, self.cache, self._dev(tokens),
                    self._dev(self.lengths), self._dev(mask), val)
        self.stats.prefill_dispatches += 1
        new_lengths = self.lengths.copy()
        for slot, c in plan:
            new_lengths[slot] += c
            self._partial[slot] = self._partial.get(slot, 0) + c
            self.stats.prefill_tokens += c
        self.lengths = new_lengths
        for slot, c in plan:
            req = self.active[slot]
            # the virtual clock serializes the rows' costs; on the wall
            # clock each row's span is the dispatch's
            t0 = self.now() if self._use_vclock else t_disp
            self._advance("prefill", c, req)
            req.t_prefill.append(self.now())
            self._emit_span("prefill", req, c, t0, self.now())
            if (self._partial[slot] < len(self._eff[slot])
                    and self._recorder is not None):
                self._recorder.instant("preempt", req.app, req.request_id,
                                       self.now())
        return True

    # ------------------------------------------------------------- steps
    def step(self) -> list[tuple[int, int]]:
        """One engine step (the ``engine.step`` scope). Returns
        [(request_id, token)] emitted."""
        with self._scope("engine.step"):
            return self._step()

    def _admit(self) -> None:
        """Admit waiting requests into free slots (zeroed state). Paged
        cache: admission is ALSO gated on free pages — each request
        reserves pages for its actual prompt (not the max_seq worst case),
        so small requests keep flowing while a big one waits."""
        for req in self._admit_order():
            free = [i for i, a in enumerate(self.active) if a is None]
            if not free:
                break
            hit, hit_pages = 0, []
            if self.paged:
                eff = self._effective_prompt(req)
                need_tok = len(eff) + 1
                if not self.allocator.fits(need_tok):
                    raise RuntimeError(
                        f"request {req.request_id} needs "
                        f"{self.allocator.pages_needed(need_tok)} pages but "
                        f"the pool holds {self.allocator.num_pages} "
                        f"(block table: {self.allocator.max_blocks}); it "
                        "can never be admitted")
                # prefix sharing: cached pages cost a reference, not a
                # page, and cold trie pages count as reclaimable headroom
                hit, hit_pages = self._prefix_lookup(eff)
                fresh = self.allocator.pages_needed(need_tok) - len(hit_pages)
                reclaim = (self.prefix.reclaimable_pages()
                           if self.prefix is not None else 0)
                reclaim = max(0, reclaim - len(hit_pages))
                in_use_eff = self.allocator.pages_in_use - reclaim
                if fresh > self.allocator.free_pages + reclaim:
                    continue   # memory-aware: smaller requests may still fit
                if in_use_eff > 0 and (in_use_eff + len(hit_pages) + fresh
                                       > self.allocator.high_watermark
                                       * self.allocator.num_pages):
                    continue
                if fresh > self.allocator.free_pages:
                    self.prefix.evict_cold(
                        fresh - self.allocator.free_pages,
                        protect=frozenset(hit_pages))
                    if fresh > self.allocator.free_pages:
                        continue
            slot = free[0]
            self.active[slot] = req
            self.waiting.remove(req)
            self.policy.on_admit(req)
            if self._recorder is not None:
                self._recorder.instant("admit", req.app, req.request_id,
                                       self.now())
            self._partial[slot] = hit
            self._eff[slot] = self._effective_prompt(req)
            if self.paged:
                self.allocator.alloc_slot(slot, need_tok, shared=hit_pages)
                self._note_pages()
                self._emit_kv()
            self.cache = self.model.set_cache_slice(self.cache, slot,
                                                    self._fresh_slot)
            new_lengths = self.lengths.copy()
            new_lengths[slot] = hit
            self.lengths = new_lengths
            if hit:
                # fully-hit chunks skip prefill: zero FLOPs, but the pages
                # must be gathered through the block table once — charged
                # as a memory-bound item, not compute
                self.stats.prefix_hit_tokens += hit
                self.stats.shared_pages += len(hit_pages)
                t0 = self.now()
                self._advance("prefix_gather", hit, req)
                req.t_prefill.append(self.now())
                if self._recorder is not None:
                    self._recorder.instant(
                        "prefix_hit", req.app, req.request_id, t0,
                        tokens=hit, meta={"pages": len(hit_pages)})

    def _step(self) -> list[tuple[int, int]]:
        self.stats.steps += 1
        emitted: list[tuple[int, int]] = []

        # 1) admission
        with self._scope("engine.admit"):
            self._admit()

        # 2) prefill work — legacy one-slot-per-step, or budgeted multi-slot
        #    when the policy's step_budget() hook splits the step's tokens
        prefilling = [i for i, r in enumerate(self.active)
                      if r is not None and
                      self._partial.get(i, 0) < len(self._eff[i])]
        ready0 = [i for i, r in enumerate(self.active)
                  if r is not None and
                  self._partial.get(i, 0) >= len(self._eff[i])]
        t_phase0 = self.now()
        budget = self.policy.step_budget(self.prefill_chunk,
                                         len(prefilling), len(ready0))
        did_prefill = False
        skip_decode = False
        if budget is None:
            if prefilling:
                slot = prefilling[0]
                chunk = self.policy.prefill_chunk_tokens(self.prefill_chunk)
                done = self._prefill_slot(slot, self.active[slot], chunk)
                did_prefill = True
                if (not done and chunk is not None
                        and self._recorder is not None):
                    # chunk-boundary preemption: the prompt yields the
                    # engine mid-prefill (the simulator's chunk-remainder
                    # requeue)
                    req = self.active[slot]
                    self._recorder.instant("preempt", req.app,
                                           req.request_id, self.now())
                if self.policy.exclusive_prefill:
                    skip_decode = True  # greedy: prefill ate the whole step
        else:
            self.stats.budget_enabled = True
            pf_budget, _ = budget
            if prefilling and pf_budget > 0:
                did_prefill = self._prefill_batch(prefilling, pf_budget)

        # 3) decode step for all fully-prefilled slots
        decoded_n = 0
        if not skip_decode:
            emitted, decoded_n = self._decode_phase()

        # stall accounting: a step during which some row sat decode-ready
        # (before prefill ran) but no decode token landed is a decode
        # stall — the head-of-line-blocking the budget hook exists to kill
        dt = self.now() - t_phase0
        if ready0:
            self.stats.decode_ready_time_s += dt
            if decoded_n == 0:
                self.stats.decode_stall_time_s += dt
        if self.stats.budget_enabled and did_prefill and decoded_n > 0:
            self.stats.mixed_steps += 1
        return emitted

    def _decode_phase(self) -> tuple[list[tuple[int, int]], int]:
        """One batched decode dispatch over every fully-prefilled slot —
        the active mask isolates mid-prefill/idle rows. Returns the
        ``(request_id, token)`` pairs emitted and how many rows decoded."""
        emitted: list[tuple[int, int]] = []
        decoding = [i for i, r in enumerate(self.active)
                    if r is not None and
                    self._partial.get(i, 0) >= len(self._eff[i])]
        if self.paged and decoding:
            # page growth before dispatch: the new token writes at position
            # lengths[i]; growing may evict LRU victims (possibly other
            # decoding slots — drop those from this step's batch)
            for i in list(decoding):
                if self.active[i] is None:
                    continue   # evicted by an earlier slot's growth
                if self._grow_pages(i, int(self.lengths[i]) + 1):
                    # the new token writes into the page covering
                    # lengths[i]; fork it first if it is shared (evictions
                    # this triggers are re-filtered below, like growth's)
                    self._cow_guard(i, int(self.lengths[i]), 1)
                else:
                    # pool smaller than this one row: finish cache-full
                    req = self.active[i]
                    req.t_done = self.now()
                    self.done.append(req)
                    self._publish_prefix(i)
                    self.allocator.free_slot(i)
                    self._emit_kv()
                    self.active[i] = None
                    self._partial.pop(i, None)
                    self._eff.pop(i, None)
            decoding = [i for i in decoding if self.active[i] is not None]
        if decoding:
            with self._scope("engine.decode", rows=len(decoding)):
                mask = np.zeros((self.max_slots,), bool)
                tokens = np.zeros((self.max_slots, 1), np.int32)
                for i in decoding:
                    mask[i] = True
                    req = self.active[i]
                    tokens[i, 0] = (req.tokens_out[-1] if req.tokens_out
                                    else int(req.prompt[-1]))
                t_step0 = self.now()
                if self.paged:
                    for i in decoding:
                        self.allocator.touch(i)
                    logits, self.cache = self.model.decode_step_paged(
                        self.params, self.cache, self._dev(tokens),
                        self._dev(self.lengths),
                        self._dev(self.allocator.tables), self._dev(mask))
                else:
                    logits, self.cache = self.model.decode_step(
                        self.params, self.cache, self._dev(tokens),
                        self._dev(self.lengths), self._dev(mask))
            # the one host sync of the decode loop: fetch the argmaxes. The
            # tokens reach the host only here, so the step's time is read
            # after it
            with self._scope("engine.sync"):
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            self.stats.decode_syncs += 1
            with self._scope("engine.book"):
                self._book(decoding, nxt, mask, t_step0, emitted)
        return emitted, len(decoding)

    def _book(self, decoding: list[int], nxt: np.ndarray, mask: np.ndarray,
              t_step0: float, emitted: list) -> None:
        """After a decode step: its cost and spans, the rows' new lengths
        and tokens (into ``emitted``), and the frees of finished rows."""
        if self._req_cost is not None:
            # shared hardware serializes service demand: the step costs
            # the sum of every active row's per-token decode cost; each
            # row's telemetry span covers its own serialized slice
            for i in decoding:
                s0 = self.now()
                self._advance("decode", 1, self.active[i])
                self._emit_span("decode", self.active[i], 1, s0,
                                self.now())
        else:
            self._advance("decode", len(decoding))
            if self._recorder is not None:
                # one batched dispatch: split the step interval across
                # rows so busy time is conserved (N overlapping spans
                # each claiming the full engine would overstate SMACT)
                dt = (self.now() - t_step0) / len(decoding)
                for j, i in enumerate(decoding):
                    self._emit_span("decode", self.active[i], 1,
                                    t_step0 + j * dt,
                                    t_step0 + (j + 1) * dt)
        t = self.now()
        if self._last_decode_t is not None:
            self.stats.max_decode_gap_s = max(
                self.stats.max_decode_gap_s, t - self._last_decode_t)
        self._last_decode_t = t
        self.lengths = self.lengths + mask  # rebind, never mutate
        for i in decoding:
            req = self.active[i]
            tok = int(nxt[i]) % self.cfg.vocab_size
            req.tokens_out.append(tok)
            req.t_tokens.append(t)
            if req.t_first_token is None:
                req.t_first_token = t
            emitted.append((req.request_id, tok))
            full = int(self.lengths[i]) >= self.max_seq - 1
            if len(req.tokens_out) >= req.max_new_tokens or full:
                req.t_done = t
                self.done.append(req)
                if self.paged:
                    self._publish_prefix(i)
                    self.allocator.free_slot(i)
                    self._emit_kv()
                self.active[i] = None
                self._partial.pop(i, None)
                self._eff.pop(i, None)
        self.stats.decode_tokens += len(decoding)

    def run(self, max_steps: int = 100_000) -> list[Request]:
        for _ in range(max_steps):
            if not self.waiting and all(a is None for a in self.active):
                break
            if (self._use_vclock and
                    not any(r.arrival_s <= self.now() for r in self.waiting)
                    and all(a is None for a in self.active)):
                self.advance_to(min(r.arrival_s for r in self.waiting))
            self.step()
        return self.done
