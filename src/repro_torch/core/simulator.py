# Copy of src/repro/core/simulator.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Discrete-event pod simulator: the TPU analogue of the paper's concurrent
GPU execution, driven by the roofline cost model.

Scheduling is fully delegated to a pluggable
:class:`~repro_torch.bench.policy.SchedulingPolicy` (paper §4.2 strategies + the
SLO-aware scheduler §5.2 calls for — see ``repro/bench/policy.py`` for the
shipped policies). The simulator owns only the event loop and metrics; the
policy decides chip partitioning, queue priority, and chunk splitting:

  partition(traces, chips)        — app -> partition, partition -> chips
  priority(trace, req, item, now) — queue order inside a partition
  chunk_fraction(item, dur, frac, target) — preemption at chunk boundaries
  on_dispatch(...)                — state hook (e.g. fair-queueing vtime)

The simulator records per-request latency records (→ SLO attainment), a chip
utilization timeline (SMACT/SMOCC analogue), and energy via the power model.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import warnings
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Union

from repro_torch.bench.policy import (SchedulingPolicy, get_policy,
                                resolve_partition)
from repro_torch.core.costs import WorkItem
from repro_torch.core.slo import SLO, RequestRecord, SLOReport
from repro_torch.resilience import (FaultSchedule, FaultStats, ShedConfig,
                              SloTracker, time_to_recover)
from repro_torch.roofline.hw import ChipSpec, TPU_V5E
from repro_torch.serving.router import RouteRequest, Router, empty_routing_block
from repro_torch.telemetry.recorder import TraceRecorder
from repro_torch.telemetry.requests import empty_attribution_block

if TYPE_CHECKING:  # pragma: no cover - typing only (avoids an import cycle)
    from repro_torch.telemetry.streaming import StreamingPipeline


@dataclass
class SimRequest:
    """A chain of sequential work items with SLO bookkeeping."""
    app: str
    request_id: int
    arrival_s: float
    items: list[WorkItem]
    deadline_hint_s: float = 1.0      # for slack priority
    background: bool = False
    #: KV/working-set tokens the request holds while in flight (full-scale
    #: accounting for the analytic memory model; 0 = no resident footprint,
    #: e.g. diffusion denoising)
    kv_tokens: int = 0
    #: prefix sharing (analytic mirror of the engine's radix trie):
    #: requests with the same ``prefix_key`` share the leading
    #: ``prefix_tokens`` of their prompt — a conversation session's
    #: accumulated history, or a fleet-wide system prompt. 0 / None keeps
    #: the request out of the prefix model entirely.
    prefix_key: Union[str, None] = None
    prefix_tokens: int = 0
    #: optional shared ANCESTOR prefix (e.g. a fleet-wide system prompt):
    #: when ``prefix_key`` misses, the lookup falls back to this key for
    #: the leading ``prefix_sys_tokens`` — the two-level analogue of the
    #: radix trie's nesting (session paths descend from the system-prompt
    #: path, so any session's publish seeds every other session's turn 0).
    prefix_sys_key: Union[str, None] = None
    prefix_sys_tokens: int = 0


@dataclass
class AppTrace:
    name: str
    slo: SLO
    requests: list[SimRequest]
    background: bool = False
    closed_loop: bool = False      # request i+1 issues only after i completes


@dataclass
class UtilSample:
    t0: float
    t1: float
    busy_chips: int
    total_chips: int


class PodSimulator:
    """``kv_token_budget`` enables the analytic memory model (the paged
    engine's discrete-event mirror): each request's ``kv_tokens`` must be
    resident while it runs; when an admission would overflow the budget,
    the least-recently-dispatched resident request is EVICTED — its chain
    restarts from item 0 (evict-and-recompute) and the lost work is counted
    in ``SimResult.recompute_tokens``. None (default) keeps memory
    unconstrained, the pre-paging behaviour."""

    def __init__(self, total_chips: int, *,
                 policy: Union[str, SchedulingPolicy] = "greedy",
                 chip: ChipSpec = TPU_V5E, chunk_target_s: float = 0.05,
                 kv_token_budget: Union[int, None] = None,
                 page_size: int = 16,
                 prefix_cache: bool = False,
                 faults: Optional[FaultSchedule] = None,
                 shed: Optional[ShedConfig] = None,
                 replicas: int = 1,
                 routing: Union[str, None] = None,
                 routing_rng=None,
                 pipeline: Union["StreamingPipeline", None] = None,
                 trace_ring: Union[int, None] = None,
                 strategy: Union[str, None] = None):
        if strategy is not None:
            warnings.warn("PodSimulator(strategy=...) is deprecated; use "
                          "policy=<name or SchedulingPolicy>",
                          DeprecationWarning, stacklevel=2)
            policy = strategy
        self.total_chips = total_chips
        self.policy = get_policy(policy)
        self.chip = chip
        self.chunk_target_s = chunk_target_s
        self.kv_token_budget = kv_token_budget
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        #: router tier (analytic mirror of the engine's replica fleet):
        #: each partition is served by ``replicas`` execution lanes and a
        #: routing policy picks one per request. replicas=1 + routing=None
        #: keeps the event loop bit-identical to the pre-router simulator.
        self.replicas = replicas
        self.routing = routing
        self.routing_rng = routing_rng
        #: resilience (repro_torch.resilience): injected fault schedule + the
        #: shed-on-SLO admission controller — None keeps the clean path
        #: bit-identical to the pre-resilience simulator
        self.faults = faults
        self.shed = shed
        #: streaming observability (repro_torch.telemetry.streaming): an online
        #: metrics pipeline subscribed to the trace bus, and an optional
        #: ring bound on retained events — None keeps the unbounded
        #: append-only recorder bit-identical to the pre-streaming runs
        self.pipeline = pipeline
        self.trace_ring = trace_ring
        self._seq = itertools.count()

    @property
    def strategy(self) -> str:
        """Deprecated alias: the active policy's registry name."""
        return self.policy.name

    # ---------------------------------------------------------------- run
    def run(self, traces: list[AppTrace]) -> "SimResult":
        policy = self.policy
        policy.reset()
        # telemetry: the simulator ALWAYS records its event trace (one
        # span per dispatch — same cost class as the UtilSample it already
        # appends); SimResult.trace feeds repro_torch.telemetry's derived views
        telem = TraceRecorder(ring=self.trace_ring)
        if self.pipeline is not None:
            # subscribe BEFORE any emission so the online pipeline sees
            # the full stream (fault windows included) in causal order
            telem.subscribe(self.pipeline)
        apps = {t.name: t for t in traces}
        plan = resolve_partition(policy, traces, self.total_chips,
                                 replicas=self.replicas)
        partition_of = plan.apps            # app -> BASE partition
        # ---- router tier: replica lanes per partition -------------------
        # With routing enabled the execution partitions are the router's
        # replica labels (chips split across them); faults keep matching
        # on BASE partition names via base_of. Disabled, everything below
        # runs on the base partitions exactly as before.
        router: Union[Router, None] = None
        if plan.replicas > 1 or self.routing is not None:
            router = Router(plan, self.routing or "round_robin",
                            rng=self.routing_rng, recorder=telem)
            chips_of = router.chips_of()    # exec label -> chips
            base_of = dict(router.base_of)
        else:
            chips_of = plan.chips
            base_of = {p: p for p in chips_of}
        #: sticky route: (app, request_id) -> exec label, assigned once at
        #: arrival; evictions, crash replays and client reissues all go
        #: back to the SAME replica (its cache holds the request's state)
        route_of: dict[tuple, str] = {}
        route_toks: dict[tuple, int] = {}

        def pkey(lbl: str, key: str):
            """Prefix-model key: per-replica when routing is on (each
            replica has its own trie), the plain global key otherwise."""
            return (lbl, key) if router is not None else key

        # ---- resilience: fault schedule + shed-on-SLO controller --------
        fsched = self.faults
        fstats = FaultStats()
        shed_cfg = self.shed
        tracker = SloTracker(shed_cfg.window) if shed_cfg is not None else None
        if tracker is not None and self.pipeline is not None:
            # one rolling-SLO truth: the pipeline's burn-rate monitor reads
            # the SAME window the shed_on_slo controller consults
            self.pipeline.bind_tracker(tracker)
        client = fsched.client if fsched is not None else None
        if fsched is not None:
            fsched.bind_partitions(partition_of)
            fstats.injected = fsched.injected_count()
            fsched.emit(telem)

        queues: dict[str, list] = {p: [] for p in chips_of}
        busy_until: dict[str, float] = {p: 0.0 for p in chips_of}
        util: list[UtilSample] = []
        records: dict[str, list[RequestRecord]] = {t.name: [] for t in traces}

        # event heap: (time, seq, kind, payload)
        events: list = []
        next_idx: dict[str, int] = {}
        for t in traces:
            if t.closed_loop and t.requests:
                heapq.heappush(events, (t.requests[0].arrival_s,
                                        next(self._seq), "arrival",
                                        t.requests[0]))
                next_idx[t.name] = 1
            else:
                for r in t.requests:
                    heapq.heappush(events, (r.arrival_s, next(self._seq),
                                            "arrival", r))
        if fsched is not None:
            # crash instants kill in-flight state; spike starts force live
            # eviction down to the shrunken budget (the restore needs no
            # event: admissions consult cur_budget at their own `now`)
            for w in fsched.stalls:
                if w.crash:
                    heapq.heappush(events, (w.t0, next(self._seq),
                                            "crash", w))
                # "wake": a bare dispatch kick at the window edge, so work
                # parked behind a stall/spike cannot outlive the event heap
                heapq.heappush(events, (w.t1, next(self._seq), "wake", None))
            for sp in fsched.spikes:
                heapq.heappush(events, (sp.t0, next(self._seq), "spike", sp))
                heapq.heappush(events, (sp.t1, next(self._seq), "wake", None))

        state: dict[tuple[str, int], dict] = {}
        #: resilience bookkeeping (all empty on the clean path)
        req_of: dict[tuple[str, int], SimRequest] = {}
        finished: set[tuple] = set()
        cancelled: set[tuple] = set()
        attempts: dict[tuple, int] = {}        # client-timeout attempt no.
        first_arrival: dict[tuple, float] = {}
        crash_killed: set[tuple] = set()       # (key, epoch) of dead flights

        # ---- analytic memory model (None budget = unconstrained) -------
        budget = self.kv_token_budget
        resident: dict[tuple, tuple[SimRequest, int]] = {}  # key -> (req, tok)
        executing: set[tuple] = set()
        epoch: dict[tuple, int] = {}        # bumped on eviction: stale marker
        last_use: dict[tuple, float] = {}
        #: anti-livelock: a request that has been evicted loses its right
        #: to evict others — its re-admissions wait for FREE budget. Two
        #: footprints that cannot co-reside then serialize instead of
        #: ping-pong evicting each other forever; total evictions are
        #: bounded by (requests x residents), so run() always terminates.
        evicted_ever: set[tuple] = set()
        mem = {"resident": 0, "peak": 0, "evictions": 0, "recompute": 0}

        # ---- analytic prefix model (the engine's radix trie, mirrored) --
        # Page-granular: a key's published tokens are what a trie at this
        # page_size could serve, and hits floor to whole pages — CoW forks
        # (a mid-page divergence) are an engine-level effect the analytic
        # model never produces, so it reports 0 forks in the same schema
        # block. Published prefixes cost persistent residency under a
        # budget and are reclaimed cold-first (no in-flight sharer) before
        # any live request is evicted, matching the engine's order.
        prefix_cached: dict[str, int] = {}     # key -> published tokens
        prefix_sharers: dict[str, int] = {}    # key -> in-flight readers
        prefix_res: dict[str, int] = {}        # key -> resident tokens
        prefix_use: dict[str, float] = {}      # key -> last hit time
        pf = {"lookups": 0, "hits": 0, "hit_tokens": 0, "shared_pages": 0,
              "prompt_tokens": 0}

        # ---- analytic batching model (schema 1.7's "batching" block) ----
        # The engine interleaves prefill and decode inside ONE step when
        # the policy's step_budget() hook splits the step's tokens; the
        # serial event loop mirrors that analytically: a prefill dispatch
        # issued while decode work sits queued-ready counts as a MIXED
        # step under a budget (decode advances within the same step) and
        # as a decode STALL without one (head-of-line blocking). Decode
        # spans always accrue ready time.
        bat = {"enabled": policy.step_budget(1, 1, 1) is not None,
               "steps": 0, "mixed": 0, "prefill_tokens": 0.0,
               "decode_tokens": 0.0, "ready": 0.0, "stalled": 0.0}

        def decode_ready(partition: str) -> bool:
            """Any live queued entry whose next item is a decode."""
            for e in queues[partition]:
                req_q, idx_q, ep_q = e[3], e[4], e[6]
                if (ep_q == epoch.get((req_q.app, req_q.request_id), 0)
                        and idx_q < len(req_q.items)
                        and req_q.items[idx_q].kind == "decode"):
                    return True
            return False

        if router is not None:
            # prefix-aware routing probe: what the analytic trie of one
            # replica would serve for this request — same key fallback and
            # page-grid floor as the arrival-time hit computation below
            def _make_probe(lbl: str):
                def probe(rr: RouteRequest) -> int:
                    hit = 0
                    if rr.prefix_key and rr.prefix_tokens > 0:
                        hit = min(prefix_cached.get(pkey(lbl, rr.prefix_key),
                                                    0), rr.prefix_tokens)
                        if rr.prefix_sys_key:
                            hit = max(hit, min(
                                prefix_cached.get(
                                    pkey(lbl, rr.prefix_sys_key), 0),
                                rr.prefix_sys_tokens))
                    return (hit // self.page_size) * self.page_size
                return probe
            for lbl in router.by_label:
                router.set_probe(lbl, _make_probe(lbl))

        def cur_budget(now: float):
            """Budget net of memory spikes active at ``now`` (time-varying
            under faults; the base budget otherwise)."""
            if budget is None or fsched is None:
                return budget
            return budget - fsched.steal_tokens_at(now, budget)

        def release_next(app: str, now: float):
            """Advance a closed-loop chain (normal completion, shed, or
            cancellation — sessions must never wedge on a lost request)."""
            trace = apps[app]
            if trace.closed_loop:
                i = next_idx.get(app, len(trace.requests))
                if i < len(trace.requests):
                    next_idx[app] = i + 1
                    nxt = trace.requests[i]
                    # effective arrival = max(now, nominal); the trace
                    # itself is never mutated, so re-running the same
                    # AppTrace is reproducible
                    heapq.heappush(events, (max(now, nxt.arrival_s),
                                            next(self._seq), "arrival", nxt))

        def abort_progress(k: tuple, now: float):
            """Client abort / crash: drop residency + chain progress and
            stale-mark every queued entry (epoch bump). Unlike evict(),
            the request keeps its eviction rights — this is not a memory
            event."""
            if k in resident:
                mem["resident"] -= resident.pop(k)[1]
                note_kv(now)
            st = state[k]
            st["tokens_done"] = 0
            st["decode_done"] = 0
            st["decode_t0"] = None
            epoch[k] = epoch.get(k, 0) + 1

        def enqueue(partition: str, ready_t: float, req: SimRequest,
                    item_idx: int, chunk_frac: float):
            prio = policy.priority(apps[req.app], req, req.items[item_idx],
                                   ready_t)
            heapq.heappush(queues[partition],
                           (prio, ready_t, next(self._seq), req, item_idx,
                            chunk_frac,
                            epoch.get((req.app, req.request_id), 0)))

        def note_kv(now: float):
            """KV-occupancy counter sample (pages, matching the engine's
            pool accounting) — only meaningful under a budget."""
            if budget is not None:
                telem.counter("kv_pages", now,
                              math.ceil(mem["resident"] / self.page_size))

        def evict(k: tuple, now: float):
            """Evict-and-recompute: drop the victim's residency and restart
            its chain from item 0 (its queued entry goes stale)."""
            req, toks = resident.pop(k)
            mem["resident"] -= toks
            mem["evictions"] += 1
            st = state[k]
            mem["recompute"] += int(st.get("tokens_done", 0))
            telem.instant("evict", req.app, req.request_id, now,
                          tokens=int(st.get("tokens_done", 0)))
            note_kv(now)
            st["tokens_done"] = 0
            st["decode_done"] = 0
            st["decode_t0"] = None
            epoch[k] = epoch.get(k, 0) + 1
            evicted_ever.add(k)
            enqueue(route_of[k], now, req, 0, 1.0)

        #: requests whose first admission was already traced — the
        #: unbudgeted path admits trivially but must still emit ONE
        #: "admit" instant per request (budgeted re-admissions after an
        #: eviction emit again, matching the engine's slot admission)
        admitted: set[tuple] = set()

        def admit(req: SimRequest, now: float) -> bool:
            """Make the request resident, LRU-evicting idle residents to
            fit; False = no room right now (an in-flight request holds the
            pool — retry after its completion)."""
            k = (req.app, req.request_id)
            if budget is None or req.kv_tokens <= 0 or k in resident:
                if k not in admitted:
                    admitted.add(k)
                    telem.instant("admit", req.app, req.request_id, now)
                return True
            # shared prefix pages are already resident under their key:
            # the request only needs its INCREMENTAL footprint
            hit = state[k].get("prefix_hit", 0)
            need = min(max(req.kv_tokens - hit, 0), budget)
            b = cur_budget(now)
            while mem["resident"] + need > b:
                cold = [kk for kk, tok in prefix_res.items()
                        if tok > 0 and prefix_sharers.get(kk, 0) == 0]
                if cold:
                    # cold cached prefixes go before any live request
                    kk = min(cold, key=lambda x: prefix_use.get(x, 0.0))
                    mem["resident"] -= prefix_res.pop(kk)
                    prefix_cached.pop(kk, None)  # pages gone: future misses
                    note_kv(now)
                    continue
                cands = [kk for kk in resident
                         if kk not in executing and kk != k]
                # previously-evicted requests have no eviction rights, but
                # an otherwise-empty pool must still admit them (the last
                # residents standing may be un-evictable executing ones)
                if not cands or (k in evicted_ever and resident):
                    return False
                # feasibility first: if the EXECUTING residue alone still
                # blocks admission, evicting idle victims only destroys
                # their work without helping — wait for a completion
                if (mem["resident"]
                        - sum(resident[kk][1] for kk in cands)
                        + need > b):
                    return False
                evict(min(cands, key=lambda kk: last_use.get(kk, 0.0)), now)
            resident[k] = (req, need)
            mem["resident"] += need
            mem["peak"] = max(mem["peak"], mem["resident"])
            admitted.add(k)
            telem.instant("admit", req.app, req.request_id, now, tokens=need)
            note_kv(now)
            return True

        def try_dispatch(partition: str, now: float):
            # memory-blocked entries are HELD aside (and restored after),
            # not left at the head: a request waiting for KV room must not
            # stall residents queued behind it, whose completions are what
            # eventually free that room
            held: list = []
            try:
                _try_dispatch(partition, now, held)
            finally:
                for entry in held:
                    heapq.heappush(queues[partition], entry)

        def _try_dispatch(partition: str, now: float, held: list):
            while queues[partition] and busy_until[partition] <= now + 1e-12:
                entry = heapq.heappop(queues[partition])
                prio, ready_t, seq, req, idx, frac, ep = entry
                k = (req.app, req.request_id)
                if ep != epoch.get(k, 0):
                    continue    # superseded by an eviction restart
                if not admit(req, now):
                    held.append(entry)
                    continue
                item = req.items[idx]
                chips = chips_of[partition]
                # prefix sharing: fully-hit prompt tokens skip their
                # prefill share of work (the engine's skipped chunks)
                scale = 1.0
                st_d = state[k]
                if item.kind == "prefill" and st_d.get("prefill_total", 0):
                    scale = 1.0 - (st_d.get("prefix_hit", 0)
                                   / st_d["prefill_total"])
                full_dur = item.duration_s(chips, self.chip) * scale
                run_frac = min(frac, policy.chunk_fraction(
                    item, full_dur, frac, self.chunk_target_s))
                dur = full_dur * run_frac
                # faults: thermal derating / stall windows stretch the
                # dispatch through the SAME piecewise time integrator the
                # engine's virtual clock uses (parity by construction)
                end = (fsched.advance(now, dur, base_of[partition])
                       if fsched is not None else now + dur)
                busy_until[partition] = end
                util.append(UtilSample(now, end, chips, self.total_chips))
                telem.span(item.kind, req.app, req.request_id, now, end,
                           chips=chips, flops=item.flops * run_frac * scale,
                           hbm_bytes=item.hbm_bytes * run_frac * scale,
                           tokens=item.tokens * run_frac * scale)
                policy.on_dispatch(apps[req.app], req, item, now, end, chips)
                bat["steps"] += 1
                if item.kind == "prefill":
                    bat["prefill_tokens"] += item.tokens * run_frac * scale
                elif item.kind == "decode":
                    bat["decode_tokens"] += item.tokens * run_frac
                dt = end - now
                if dt > 0:
                    if item.kind == "decode":
                        bat["ready"] += dt
                    elif decode_ready(partition):
                        bat["ready"] += dt
                        if bat["enabled"]:
                            if item.kind == "prefill":
                                bat["mixed"] += 1
                        else:
                            bat["stalled"] += dt
                executing.add(k)
                last_use[k] = now
                rem = frac - run_frac
                heapq.heappush(events, (end, next(self._seq), "complete",
                                        (partition, req, idx, rem, now,
                                         run_frac, ep)))
                return

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if kind == "arrival":
                req = payload
                fstats.issued += 1
                # lifecycle anchor: every issued request opens with an
                # "arrive" instant (sheds included — their terminal closes
                # a zero-length lifecycle), so the assembler's completeness
                # invariant holds: one terminal per arrive
                telem.instant("arrive", req.app, req.request_id, now)
                decision = "admit"
                if (tracker is not None
                        and tracker.should_degrade(req.app, shed_cfg)):
                    decision = policy.shed_decision(
                        req.app, req, tracker.rolling(req.app), shed_cfg,
                        now)
                if decision == "shed":
                    fstats.sheds += 1
                    telem.instant("shed", req.app, req.request_id, now)
                    release_next(req.app, now)
                    continue
                if decision == "downgrade":
                    fstats.downgrades += 1
                    telem.instant("downgrade", req.app, req.request_id, now)
                    # a fresh demoted copy: the trace's request is never
                    # mutated (re-running the same AppTrace reproduces)
                    req = dataclasses.replace(req, background=True)
                k = (req.app, req.request_id)
                req_of[k] = req
                if client is not None and client.applies_to(req.app):
                    first_arrival[k] = now
                    attempts[k] = 0
                    heapq.heappush(events, (now + client.timeout_s,
                                            next(self._seq), "timeout",
                                            (k, 0)))
                st = state[k] = {
                    "rec": RequestRecord(req.app, req.request_id, now),
                    "t_start": now, "decode_done": 0, "decode_t0": None,
                    "tokens_done": 0,
                }
                # route once, at arrival, on the event-heap order — the
                # engine runner routes the SAME requests in the same
                # (arrival, seq) order, so a given (policy, seed) pair
                # makes identical choices on both substrates
                if router is not None:
                    rr = RouteRequest(
                        app=req.app, request_id=req.request_id,
                        tokens=sum(it.tokens for it in req.items),
                        session_key=req.prefix_key or req.app,
                        prefix_key=req.prefix_key or "",
                        prefix_tokens=req.prefix_tokens,
                        prefix_sys_key=req.prefix_sys_key or "",
                        prefix_sys_tokens=req.prefix_sys_tokens)
                    route_of[k] = router.route(partition_of[req.app], rr,
                                               now)
                    route_toks[k] = rr.tokens
                else:
                    route_of[k] = partition_of[req.app]
                lbl = route_of[k]
                if self.prefix_cache:
                    ptoks = sum(it.tokens for it in req.items
                                if it.kind == "prefill")
                    pf["prompt_tokens"] += ptoks
                    st["prefill_total"] = ptoks
                    hit, held = 0, None
                    if req.prefix_key and req.prefix_tokens > 0:
                        pf["lookups"] += 1
                        hit = min(prefix_cached.get(pkey(lbl,
                                                         req.prefix_key), 0),
                                  req.prefix_tokens, ptoks)
                        held = pkey(lbl, req.prefix_key)
                        if req.prefix_sys_key:
                            # ancestor fallback: the session path descends
                            # from the shared system-prompt path in the trie
                            sys_hit = min(
                                prefix_cached.get(
                                    pkey(lbl, req.prefix_sys_key), 0),
                                req.prefix_sys_tokens, ptoks)
                            if sys_hit > hit:
                                hit, held = sys_hit, pkey(
                                    lbl, req.prefix_sys_key)
                        hit = (hit // self.page_size) * self.page_size
                    if hit > 0:
                        pf["hits"] += 1
                        pf["hit_tokens"] += hit
                        pf["shared_pages"] += hit // self.page_size
                        prefix_sharers[held] = (
                            prefix_sharers.get(held, 0) + 1)
                        prefix_use[held] = now
                        st["prefix_held"] = held
                        telem.instant("prefix_hit", req.app, req.request_id,
                                      now, tokens=hit)
                    st["prefix_hit"] = hit
                enqueue(lbl, now, req, 0, 1.0)
            elif kind == "complete":
                partition, req, idx, rem, started, run_frac, ep = payload
                k = (req.app, req.request_id)
                if (k, ep) in crash_killed:
                    # the partition died mid-dispatch: the work never ran
                    # to completion and busy_until was re-seeded at the
                    # crash, so this completion must not touch either
                    crash_killed.discard((k, ep))
                    live = False
                else:
                    busy_until[partition] = now
                    executing.discard(k)
                    last_use[k] = now
                    # a timeout abort bumped the epoch mid-flight: the chip
                    # time was burned (wasted work, busy_until above) but
                    # the result is discarded
                    live = ep == epoch.get(k, 0) and k not in cancelled
                if live:
                    st = state[k]
                    # partial chunks count toward the recompute bill too: an
                    # eviction mid-prefill loses real work
                    done_scale = 1.0
                    if (req.items[idx].kind == "prefill"
                            and st.get("prefill_total", 0)):
                        done_scale = 1.0 - (st.get("prefix_hit", 0)
                                            / st["prefill_total"])
                    st["tokens_done"] += (req.items[idx].tokens * run_frac
                                          * done_scale)
                    if rem > 1e-9:  # chunk remainder goes back to the queue
                        telem.instant("preempt", req.app, req.request_id, now)
                        enqueue(partition, now, req, idx, rem)
                    else:
                        item = req.items[idx]
                        rec: RequestRecord = st["rec"]
                        if item.kind == "decode":
                            if st["decode_t0"] is None:
                                st["decode_t0"] = now
                                if rec.ttft_s is None:  # evicted: keep first
                                    rec.ttft_s = now - rec.arrival_s
                            st["decode_done"] += item.tokens
                            st.setdefault("decode_ts", []).append(now)
                        if item.kind in ("denoise", "encode", "train"):
                            rec.step_times_s.append(
                                now - max(started, rec.arrival_s))
                        if idx + 1 < len(req.items):
                            enqueue(partition, now, req, idx + 1, 1.0)
                        else:
                            finished.add(k)
                            if router is not None:
                                router.note_done(route_of[k],
                                                 route_toks.get(k, 0), now)
                            if k in resident:    # release the KV footprint
                                mem["resident"] -= resident.pop(k)[1]
                                note_kv(now)
                            key = (pkey(route_of[k], req.prefix_key)
                                   if req.prefix_key else None)
                            if (self.prefix_cache and key
                                    and req.prefix_tokens > 0):
                                # publish: the prompt's shareable prefix
                                # stays behind for the next arrival under
                                # this key; the shared-ancestor portion is
                                # published (and charged) once under the sys
                                # key, the session key carries only its
                                # increment beyond it
                                sysk = (pkey(route_of[k], req.prefix_sys_key)
                                        if req.prefix_sys_key else None)
                                syst = 0
                                if sysk:
                                    syst = min(req.prefix_sys_tokens,
                                               req.prefix_tokens)
                                    prefix_cached[sysk] = max(
                                        prefix_cached.get(sysk, 0), syst)
                                    prefix_use.setdefault(sysk, now)
                                prefix_cached[key] = max(
                                    prefix_cached.get(key, 0),
                                    req.prefix_tokens)
                                if budget is not None:
                                    grow = 0
                                    if sysk:
                                        want = min(syst, budget)
                                        g = want - prefix_res.get(sysk, 0)
                                        if g > 0:
                                            prefix_res[sysk] = want
                                            grow += g
                                    want = max(0, min(prefix_cached[key],
                                                      budget) - syst)
                                    g = want - prefix_res.get(key, 0)
                                    if g > 0:
                                        prefix_res[key] = want
                                        grow += g
                                    if grow > 0:
                                        mem["resident"] += grow
                                        mem["peak"] = max(mem["peak"],
                                                          mem["resident"])
                                        note_kv(now)
                                prefix_use.setdefault(key, now)
                            if st.get("prefix_held"):
                                prefix_sharers[st["prefix_held"]] -= 1
                            rec.e2e_s = now - rec.arrival_s
                            if (st["decode_done"] > 1
                                    and st["decode_t0"] is not None):
                                rec.tpot_s = ((now - st["decode_t0"]) /
                                              max(st["decode_done"] - 1, 1))
                            elif st["decode_done"] == 1:
                                rec.tpot_s = 0.0
                            dts = st.get("decode_ts", [])
                            if len(dts) > 1:
                                rec.itl_samples_s = [
                                    b - a for a, b in zip(dts, dts[1:])]
                            records[req.app].append(rec)
                            ok = rec.meets_slo(apps[req.app].slo)
                            if tracker is not None:
                                tracker.note(req.app, ok)
                            # terminal event carries the request's own
                            # metrics so streaming consumers reproduce the
                            # post-hoc report without a second metrics path
                            telem.instant(
                                "finish", req.app, req.request_id, now,
                                meta={"ok": ok, "ttft_s": rec.ttft_s,
                                      "tpot_s": rec.tpot_s,
                                      "e2e_s": rec.e2e_s,
                                      "itl": list(rec.itl_samples_s or ())})
                            release_next(req.app, now)
            elif kind == "crash":
                w = payload
                # the partition lost its in-flight state: every request
                # with progress (running or partially done) restarts from
                # scratch when the window lifts
                for kk, r in list(req_of.items()):
                    if kk in finished or kk in cancelled or kk not in state:
                        continue
                    if not w.matches(partition_of[r.app]):
                        continue
                    if (kk in executing
                            or state[kk].get("tokens_done", 0) > 0):
                        if kk in executing:
                            crash_killed.add((kk, epoch.get(kk, 0)))
                            executing.discard(kk)
                        fstats.replays += 1
                        telem.instant("replay", r.app, r.request_id, now)
                        abort_progress(kk, now)
                        enqueue(route_of[kk], w.t1, r, 0, 1.0)
                for p in chips_of:
                    if w.matches(base_of[p]):
                        busy_until[p] = w.t1   # restart at window end
            elif kind == "spike":
                # an external app grabbed part of the pool: evict live
                # residents down to the shrunken budget NOW (admissions
                # already consult cur_budget; this handles the occupants).
                # Shared-prefix pages with in-flight readers are pinned —
                # cold published prefixes go first, exactly as in admit().
                b = cur_budget(now)
                if budget is not None:
                    while mem["resident"] > b:
                        cold = [kk for kk, tok in prefix_res.items()
                                if tok > 0 and prefix_sharers.get(kk, 0) == 0]
                        if cold:
                            kk = min(cold,
                                     key=lambda x: prefix_use.get(x, 0.0))
                            mem["resident"] -= prefix_res.pop(kk)
                            prefix_cached.pop(kk, None)
                            note_kv(now)
                            continue
                        cands = [kk for kk in resident
                                 if kk not in executing]
                        if not cands:
                            break   # executing footprints are unevictable
                        evict(min(cands,
                                  key=lambda kk: last_use.get(kk, 0.0)), now)
            elif kind == "timeout":
                k, att = payload
                if (k not in finished and k not in cancelled
                        and attempts.get(k, 0) == att):
                    r = req_of[k]
                    fstats.timeouts += 1
                    telem.instant("timeout", r.app, r.request_id, now)
                    # in-flight work keeps burning chip time until its
                    # (now stale) completion — wasted work, by design
                    abort_progress(k, now)
                    executing.discard(k)
                    st = state[k]
                    st["rec"].ttft_s = None   # re-measured on the retry
                    attempts[k] = att + 1
                    deadline = (first_arrival[k] + client.deadline_s
                                if client.deadline_s > 0 else math.inf)
                    backoff = client.backoff_s(att + 1)
                    if (att + 1 > client.max_retries
                            or now + backoff > deadline):
                        cancelled.add(k)
                        fstats.cancels += 1
                        telem.instant("cancel", r.app, r.request_id, now)
                        if st.get("prefix_held"):
                            prefix_sharers[st["prefix_held"]] -= 1
                            st["prefix_held"] = None
                        if tracker is not None:   # a cancel IS an SLO miss
                            tracker.note(r.app, False)
                        release_next(r.app, now)
                    else:
                        fstats.retries += 1
                        telem.instant("retry", r.app, r.request_id, now)
                        heapq.heappush(events, (now + backoff,
                                                next(self._seq),
                                                "reissue", k))
            elif kind == "reissue":
                k = payload
                if k not in finished and k not in cancelled:
                    r = req_of[k]
                    enqueue(route_of[k], now, r, 0, 1.0)
                    heapq.heappush(events, (now + client.timeout_s,
                                            next(self._seq), "timeout",
                                            (k, attempts[k])))
            elif kind == "wake":
                pass   # dispatch kick only (the loop below)
            # after any event, try to dispatch in every partition
            for p in queues:
                try_dispatch(p, now)

        reports = {t.name: SLOReport(t.name, t.slo, records[t.name])
                   for t in traces}
        if fsched is not None and fsched.stalls:
            def finish_of(w):
                for t in traces:
                    if not w.matches(partition_of[t.name]):
                        continue
                    for r in records[t.name]:
                        if r.e2e_s is not None:
                            yield (r.arrival_s, r.arrival_s + r.e2e_s)
            fstats.time_to_recover_s = time_to_recover(fsched.stalls,
                                                       finish_of)
        return SimResult(reports=reports, util=util,
                         fault_stats=fstats,
                         total_chips=self.total_chips, chip=self.chip,
                         strategy=policy.name,
                         batching={
                             "enabled": bat["enabled"],
                             "mixed_steps": bat["mixed"],
                             "steps": bat["steps"],
                             "prefill_tokens": int(round(
                                 bat["prefill_tokens"])),
                             "decode_tokens": int(round(
                                 bat["decode_tokens"])),
                             "prefill_share": (
                                 float(getattr(policy, "prefill_share", 0.0))
                                 if bat["enabled"] else 0.0),
                             "decode_stall_fraction": (
                                 bat["stalled"] / bat["ready"]
                                 if bat["ready"] > 0 else 0.0),
                         },
                         kv_token_budget=budget, page_size=self.page_size,
                         peak_kv_tokens=mem["peak"],
                         evictions=mem["evictions"],
                         recompute_tokens=mem["recompute"],
                         prefix_enabled=self.prefix_cache,
                         prefix_hit_tokens=pf["hit_tokens"],
                         prefix_prompt_tokens=pf["prompt_tokens"],
                         prefix_shared_pages=pf["shared_pages"],
                         prefix_hits=pf["hits"],
                         prefix_lookups=pf["lookups"],
                         routing=(router.routing_block()
                                  if router is not None else None),
                         trace=telem,
                         attribution=(self.pipeline.attribution_block()
                                      if self.pipeline is not None
                                      else None))


def empty_batching_block() -> dict:
    """Schema 1.7 "batching" block, zero-filled — what a run without a
    step-budget policy (or a legacy result) reports. The block is ALWAYS
    present, like "faults" and "routing", so downstream diffing never
    branches on its existence."""
    return {"enabled": False, "mixed_steps": 0, "steps": 0,
            "prefill_tokens": 0, "decode_tokens": 0,
            "prefill_share": 0.0, "decode_stall_fraction": 0.0}


@dataclass
class SimResult:
    reports: dict[str, SLOReport]
    util: list[UtilSample]
    total_chips: int
    chip: ChipSpec
    strategy: str           # the scheduling policy's registry name
    # ---- memory model (schema 1.2's "memory" block; None budget = off)
    kv_token_budget: Union[int, None] = None
    page_size: int = 16
    peak_kv_tokens: int = 0
    evictions: int = 0
    recompute_tokens: int = 0
    # ---- prefix sharing (schema 1.4's "prefix" block; disabled = absent)
    prefix_enabled: bool = False
    prefix_hit_tokens: int = 0
    prefix_prompt_tokens: int = 0
    prefix_shared_pages: int = 0
    prefix_hits: int = 0
    prefix_lookups: int = 0
    prefix_cow_forks: int = 0     # engine-only effect; analytic model: 0
    # ---- router tier (schema 1.6's ALWAYS-present "routing" block; a
    # router-less run carries the zero-filled block)
    routing: Union[dict, None] = None
    # ---- mixed batching (schema 1.7's ALWAYS-present "batching" block;
    # a run without a step-budget policy carries the zero-filled block)
    batching: Union[dict, None] = None
    #: recorded event trace (repro_torch.telemetry) — always present for
    #: simulator runs; engine runs carry one when telemetry is enabled.
    #: NOT part of summary()/to_json() unless the scenario opts in.
    trace: Union[TraceRecorder, None] = None
    # ---- critical-path attribution (schema 1.8's ALWAYS-present
    # "attribution" block; filled by the streaming pipeline when the
    # scenario enables telemetry, zero-filled otherwise on BOTH substrates)
    attribution: Union[dict, None] = None
    # ---- resilience (schema 1.5's ALWAYS-present "faults" block; a
    # fault-free run carries the zero-filled counters)
    fault_stats: Union[FaultStats, None] = None

    @property
    def policy_name(self) -> str:
        return self.strategy

    @property
    def makespan_s(self) -> float:
        return max((u.t1 for u in self.util), default=0.0)

    def utilization(self) -> float:
        """Time-averaged fraction of chips busy (SMACT analogue)."""
        span = self.makespan_s
        if span <= 0:
            return 0.0
        busy = sum((u.t1 - u.t0) * u.busy_chips for u in self.util)
        return busy / (span * self.total_chips)

    def energy_j(self) -> float:
        span = self.makespan_s
        busy = sum((u.t1 - u.t0) * u.busy_chips for u in self.util)
        idle = span * self.total_chips - busy
        return (busy * self.chip.peak_power_w +
                idle * self.chip.idle_power_w)

    def memory_summary(self) -> Union[dict, None]:
        """Schema 1.2 "memory" block: page-pool accounting (None when the
        run was memory-unconstrained)."""
        if self.kv_token_budget is None:
            return None
        pages_total = max(1, math.ceil(self.kv_token_budget / self.page_size))
        pages_peak = math.ceil(self.peak_kv_tokens / self.page_size)
        return {
            "kv_token_budget": self.kv_token_budget,
            "page_size": self.page_size,
            "pages_total": pages_total,
            "pages_in_use": pages_peak,          # peak
            "page_utilization": pages_peak / pages_total,
            "evictions": self.evictions,
            "recompute_tokens": self.recompute_tokens,
        }

    def prefix_summary(self) -> Union[dict, None]:
        """Schema 1.4 "prefix" block — identical keys on both substrates
        (the engine runner assembles the same dict from EngineStats)."""
        if not self.prefix_enabled:
            return None
        return {
            "enabled": True,
            "hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens": self.prefix_prompt_tokens,
            "hit_rate": (self.prefix_hit_tokens / self.prefix_prompt_tokens
                         if self.prefix_prompt_tokens else 0.0),
            "shared_pages": self.prefix_shared_pages,
            "hits": self.prefix_hits,
            "lookups": self.prefix_lookups,
            "cow_forks": self.prefix_cow_forks,
        }

    def routing_summary(self) -> dict:
        """Schema 1.6 "routing" block — ALWAYS present (zero-filled when
        no router fronted the run), identical keys on both substrates."""
        return dict(self.routing) if self.routing else empty_routing_block()

    def batching_summary(self) -> dict:
        """Schema 1.7 "batching" block — ALWAYS present (zero-filled when
        the policy has no step budget), identical keys on both substrates.
        ``steps`` is substrate-native (engine steps vs simulator
        dispatches); cross-substrate parity is pinned on ``enabled``,
        ``mixed_steps`` and ``decode_stall_fraction``."""
        return dict(self.batching) if self.batching \
            else empty_batching_block()

    def attribution_summary(self) -> dict:
        """Schema 1.8 "attribution" block — ALWAYS present (zero-filled
        when the run had no streaming pipeline attached, i.e. telemetry
        off), identical keys on both substrates. Per-request critical-path
        seconds partitioned into queue / sched / prefill / decode /
        recompute / stall / fault buckets, folded into a per-app blame
        table, plus goodput-under-SLO."""
        return (dict(self.attribution) if self.attribution
                else empty_attribution_block())

    def faults_summary(self) -> dict:
        """Schema 1.5 "faults" block — ALWAYS present (zero-filled when no
        faults were injected), identical keys on both substrates. Goodput
        = SLO-meeting completions over requests issued: shed, cancelled
        and still-failing requests all stay in the denominator."""
        fs = self.fault_stats or FaultStats()
        ok = sum(1 for rep in self.reports.values()
                 for r in rep.records if r.meets_slo(rep.slo))
        total = sum(len(rep.records) for rep in self.reports.values())
        return fs.block(ok, total)

    def summary(self) -> dict:
        mem = self.memory_summary()
        pfx = self.prefix_summary()
        return {
            "strategy": self.strategy,
            "makespan_s": self.makespan_s,
            "utilization": self.utilization(),
            "energy_kj": self.energy_j() / 1e3,
            **({"memory": mem} if mem is not None else {}),
            **({"prefix": pfx} if pfx is not None else {}),
            "faults": self.faults_summary(),
            "routing": self.routing_summary(),
            "batching": self.batching_summary(),
            "attribution": self.attribution_summary(),
            "apps": {
                name: {
                    "slo_attainment": rep.attainment,
                    "normalized_latency": rep.normalized_latency(),
                    **rep.latency_stats(),
                    **rep.token_latency_stats(),
                }
                for name, rep in self.reports.items()
            },
        }
