# Copy of src/repro/bench/engine_runner.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Engine-substrate scenario execution: run any :class:`Scenario` on the
real continuous-batching :class:`~repro_torch.serving.engine.InferenceEngine`.

The simulator and the engine answer the same question — how do scheduling
policies behave under realistic concurrent execution? — from two sides:
the simulator is analytic (roofline work items, discrete events), the
engine is real JAX execution (jitted prefill/decode dispatches, slot
admission, chunked-prefill interleaving). This module closes the gap the
ROADMAP names: one YAML spec, two substrates, one versioned result schema.

How a ScenarioApp becomes an engine trace
-----------------------------------------
Each app's :meth:`AppDef.request_chain` work items are the ground truth for
*service demand*. Per request we collapse them into an engine
:class:`CostedRequest`:

* non-decode items (``prefill``/``encode``/``denoise``) → a synthetic
  prompt whose per-token virtual cost spreads the chain's total
  prefill-like service time (at the partition's chip count, from
  :mod:`repro_torch.core.costs` via ``WorkItem.duration_s``), sized so one
  prefill chunk ≈ ``chunk_target_s`` — the simulator's preemption quantum;
  ``step``-SLO accounting reads per-chunk advance timestamps;
* ``decode`` items → one engine decode step per item, each charged the
  mean item duration, so TTFT granularity matches the simulator's item
  granularity. TPOT is re-normalized to the app's FULL decode token count
  (``decode_tokens_full``) before SLO accounting.

Execution is real (the tiny ``ENGINE_ARCH`` model actually prefill/decodes
every request through the engine's jitted hot path) while time is virtual
(``request_cost_s``), so CPU CI runs are deterministic and fast, and the
emitted :class:`ScenarioResult` carries pod-scale seconds.

Scheduling fidelity
-------------------
``SchedulingPolicy.partition`` is honoured: each partition gets its own
engine (chips scale that partition's virtual costs), so ``static`` shows
its idle-partition pathology on this substrate too. ``admit_order`` /
``prefill_chunk_tokens`` / ``exclusive_prefill`` drive the engine exactly
as in production serving. Workflow mode releases dependent requests at
PER-REQUEST granularity by default (``Scenario.workflow_release =
"request"``): request *j* of a node waits only for request *j* of its
dependencies (clamped to their length), not for the whole node — the
concurrency fix over the simulator's all-requests release
(``workflow_release="node"`` reproduces the old behaviour for A/B runs).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Optional

import numpy as np

from repro_torch.bench.conversation import (ConversationSpec, conversation_prompt,
                                      session_turn)
from repro_torch.bench.policy import get_policy, resolve_partition
from repro_torch.bench.scenario import SETUP_S, Scenario, ScenarioResult
from repro_torch.bench.seeding import child_rng, child_seed
from repro_torch.core.dag import Phase, build_dag
from repro_torch.core.apps import app_from_task
from repro_torch.core.simulator import AppTrace, SimResult, UtilSample
from repro_torch.core.slo import RequestRecord, SLOReport
from repro_torch.resilience import FaultStats, SloTracker, time_to_recover
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.router import RouteRequest, Router

ENGINE_ARCH = "tinyllama-1.1b"   # execution vehicle; timing is virtual
ENGINE_LAYERS = 2
ENGINE_SLOTS = 4
ENGINE_PREFILL_CHUNK = 8
#: prompt sizing: the request chain's total prefill-like service time is
#: spread over enough synthetic tokens that ONE engine prefill chunk
#: (``ENGINE_PREFILL_CHUNK`` tokens) costs about ``Scenario.chunk_target_s``
#: of virtual time — the engine then preempts at the same TIME granularity
#: the simulator's ``chunk_fraction`` hook uses, while ``exclusive_prefill``
#: policies (greedy/fcfs) still stall every decode for the whole prompt
#: (the paper's Fig. 5b starvation mechanism on the real engine).
#: PROMPT_MAX_TOKENS bounds real dispatch count and cache size per request:
#: chains needing more than PROMPT_MAX_TOKENS/ENGINE_PREFILL_CHUNK chunks
#: (e.g. deep_research's 100s-scale prefill) degrade gracefully to a
#: coarser quantum of prefill_s / (PROMPT_MAX_TOKENS/ENGINE_PREFILL_CHUNK)
#: per chunk — exactly as a real engine cannot slice a chunk below its
#: compute time.
PROMPT_MIN_TOKENS = 4
PROMPT_MAX_TOKENS = 1024
SEQ_BUCKET = 64                  # max_seq rounds up to this (bounds compiles)
#: work-item kinds that map onto engine decode steps (one step per item);
#: everything else (prefill/encode/denoise) becomes prompt tokens
DECODE_KINDS = ("decode",)
_MAX_ITERS = 1_000_000


@lru_cache(maxsize=None)
def engine_model(device: str = "cuda"):
    """The shared reduced model every engine run executes on (correctness
    of cross-app tokens is irrelevant to the benchmark; costs are virtual).
    Cached per device so repeated scenario runs reuse one set of weights;
    they are drawn from seed 0 by a CPU generator and moved to ``device``,
    so the card and the CPU run the same model."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.configs.registry import CONFIGS
    from repro_torch.models.factory import build_model
    cfg = dataclasses.replace(CONFIGS[ENGINE_ARCH].reduced(),
                              num_layers=ENGINE_LAYERS)
    model = build_model(cfg, device)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.to(model.device), params)
    return model, params, cfg


@dataclass
class CostedRequest(Request):
    """Engine request carrying its app's analytic per-token costs."""
    trace_idx: int = 0               # index within the app's trace
    prefill_tok_s: float = 0.0
    decode_tok_s: float = 0.0
    decode_tokens_full: int = 0      # full-scale decode tokens (tpot norm)
    prefill_items: int = 0           # source chain items (step-SLO bounds)
    # per-token WORK (full-scale analytic FLOPs / HBM bytes from the source
    # work items, incl. KV traffic) — the telemetry numerators behind the
    # engine substrate's SMOCC and bandwidth timelines
    prefill_flops_tok: float = 0.0
    prefill_hbm_tok: float = 0.0
    decode_flops_tok: float = 0.0
    decode_hbm_tok: float = 0.0
    # prefix-cache hits skip prefill COMPUTE but still pay a memory-bound
    # gather over the shared pages' KV rows: one full-scale KV read per
    # hit token at the partition's aggregate HBM bandwidth, zero FLOPs
    gather_tok_s: float = 0.0
    gather_hbm_tok: float = 0.0
    # router tier: the replica that served this request and the load
    # (tokens) it was charged — released via Router.note_done at completion
    route_label: str = ""
    route_tokens: int = 0


def _request_cost(req: CostedRequest, kind: str, tokens: int) -> float:
    if kind == "prefix_gather":
        return req.gather_tok_s * tokens
    rate = req.prefill_tok_s if kind == "prefill" else req.decode_tok_s
    return rate * tokens


def _request_work(req: CostedRequest, kind: str,
                  tokens: int) -> tuple[float, float]:
    """(flops, hbm_bytes) a telemetry span of ``tokens`` actually moved —
    the :class:`InferenceEngine` ``request_work`` hook."""
    if kind == "prefix_gather":
        return 0.0, req.gather_hbm_tok * tokens
    if kind == "prefill":
        return req.prefill_flops_tok * tokens, req.prefill_hbm_tok * tokens
    return req.decode_flops_tok * tokens, req.decode_hbm_tok * tokens


# ----------------------------------------------------------------- driver
@dataclass
class _Pending:
    """A request not yet submitted: released once its gates complete."""
    run_idx: int
    request: CostedRequest
    offset_s: float                  # nominal arrival offset (cadence)
    setup_s: float                   # per-node engine warmup (workflow)
    deadline_hint_s: float
    background: bool
    dep_gates: tuple = ()            # (app, idx) completions gating release
    pred: Optional[tuple] = None     # closed-loop predecessor key
    # router tier: base partition, source work items (for route-time
    # recosting at the chosen replica's chip count), KV gather rate input,
    # and the substrate-neutral routing view of this request
    group: str = ""
    items: Optional[list] = None
    kv_tok_bytes: float = 0.0
    route_req: Optional[RouteRequest] = None

    @property
    def gates(self) -> tuple:
        return self.dep_gates + ((self.pred,) if self.pred else ())


def _recost(req: CostedRequest, items: list, chips: int, chip,
            kv_tok_bytes: float) -> None:
    """Recompute a request's per-token virtual costs at ``chips`` — the
    routed replica's share, which can differ from the chip count the
    request was built at. ``WorkItem.duration_s`` is NOT purely inverse in
    chips (launch overhead + host terms), so costs must be recomputed from
    the source items, never scaled by a chip ratio. Per-token WORK
    (flops/hbm) is full-scale and chip-independent: unchanged."""
    pre = [it for it in items if it.kind not in DECODE_KINDS]
    dec = [it for it in items if it.kind in DECODE_KINDS]
    prefill_s = sum(it.duration_s(chips, chip) for it in pre)
    decode_s = sum(it.duration_s(chips, chip) for it in dec)
    req.prefill_tok_s = prefill_s / len(req.prompt)
    req.decode_tok_s = decode_s / max(len(dec), 1)
    req.gather_tok_s = (kv_tok_bytes / (chips * chip.hbm_bandwidth)
                        if kv_tok_bytes else 0.0)


@dataclass
class _EngineRun:
    engine: InferenceEngine
    chips: int
    seen: int = 0                    # engine.done entries already collected


class _FaultController:
    """Engine-substrate fault driver (repro_torch.resilience).

    Applies the SAME resolved :class:`FaultSchedule` the pod simulator
    consumes to the per-partition engines: thermal/stall windows reach the
    engines through their ``time_warp`` hook (set at construction), so
    this controller only owns the *stateful* faults — crash instants
    (``InferenceEngine.crash_active``), memory-spike page reservations
    (``steal_pages`` / ``release_stolen``), client timeouts with
    backoff-retry/cancel, and the shed-on-SLO admission gate. All
    bookkeeping mirrors the simulator's event handlers so the two
    substrates score the same ``faults`` block within parity tolerance."""

    def __init__(self, fsched, shed_cfg, policy, traces: dict,
                 recorder=None):
        self.fsched = fsched
        self.shed_cfg = shed_cfg
        self.policy = policy
        self.traces = traces
        self._rec = recorder
        self.fstats = FaultStats()
        self.client = fsched.client if fsched is not None else None
        self.tracker = (SloTracker(shed_cfg.window)
                        if shed_cfg is not None else None)
        if fsched is not None:
            self.fstats.injected = fsched.injected_count()
        #: per-run ordered (t, kind, payload) action queues (consumed as
        #: each engine's virtual clock crosses t)
        self.actions: dict[int, list] = {}
        self.attempts: dict[tuple, int] = {}
        self.first_issue: dict[tuple, float] = {}
        self.issue_t: dict[tuple, float] = {}
        self.cancelled: set[tuple] = set()

    def build_actions(self, parts: list) -> None:
        if self.fsched is None:
            return
        for i, part in enumerate(parts):
            acts = []
            for w in self.fsched.stalls:
                if w.crash and w.matches(part):
                    acts.append((w.t0, "crash", w))
            for sp in self.fsched.spikes:
                acts.append((sp.t0, "spike", sp))
                acts.append((sp.t1, "spike", sp))
            acts.sort(key=lambda a: a[0])
            self.actions[i] = acts

    def next_action_t(self, run_i: int) -> float:
        acts = self.actions.get(run_i)
        return acts[0][0] if acts else math.inf

    # --------------------------------------------------------- per-tick
    def poll(self, runs: list, completed: dict) -> None:
        """Apply every action each engine's clock has crossed, then scan
        for client timeouts — called once per driver iteration."""
        for i, run in enumerate(runs):
            eng = run.engine
            now = eng.now()
            acts = self.actions.get(i)
            while acts and acts[0][0] <= now + 1e-12:
                t, kind, _ = acts.pop(0)
                if kind == "crash":
                    eng.crash_active()
                elif kind == "spike":
                    self._apply_spike(eng, t)
        if self.client is not None:
            self._poll_timeouts(runs, completed)

    def _apply_spike(self, eng, t: float) -> None:
        """Re-derive the external hold from the fraction of spikes active
        just after ``t`` (handles overlapping spikes on one boundary)."""
        if eng.allocator is None:
            return
        frac = sum(sp.steal_fraction for sp in self.fsched.spikes
                   if sp.t0 <= t + 1e-12 < sp.t1)
        eng.release_stolen()
        want = min(int(frac * eng.kv_pages), eng.kv_pages - 1)
        if want > 0:
            eng.steal_pages(want)

    def _poll_timeouts(self, runs: list, completed: dict) -> None:
        cl = self.client
        for run in runs:
            eng = run.engine
            now = eng.now()
            for r in list(eng.active) + list(eng.waiting):
                if r is None or not cl.applies_to(r.app):
                    continue
                key = (r.app, r.trace_idx)
                if key in self.cancelled or key in completed:
                    continue
                issued = self.issue_t.get(key)
                if issued is None or now - issued < cl.timeout_s:
                    continue
                self.fstats.timeouts += 1
                if self._rec is not None:
                    self._rec.instant("timeout", r.app, r.request_id, now)
                eng.abort(r.request_id)
                att = self.attempts.get(key, 0) + 1
                self.attempts[key] = att
                deadline = (self.first_issue[key] + cl.deadline_s
                            if cl.deadline_s > 0 else math.inf)
                backoff = cl.backoff_s(att)
                if att > cl.max_retries or now + backoff > deadline:
                    self.cancelled.add(key)
                    self.fstats.cancels += 1
                    completed[key] = now   # the gate resolves: chains advance
                    if self.tracker is not None:  # a cancel IS an SLO miss
                        self.tracker.note(r.app, False)
                    if self._rec is not None:
                        self._rec.instant("cancel", r.app, r.request_id, now)
                else:
                    self.fstats.retries += 1
                    # full client-side restart: state reset, re-submitted
                    # after the backoff (arrival_s gates engine admission)
                    r.tokens_out = []
                    r.t_tokens = []
                    r.t_prefill = []
                    r.t_first_token = None
                    r.t_done = None
                    r.arrival_s = now + backoff
                    self.issue_t[key] = now + backoff
                    eng.submit(r)
                    if self._rec is not None:
                        self._rec.instant("retry", r.app, r.request_id, now)

    # ------------------------------------------------------- admission
    def on_release(self, p: "_Pending", completed: dict) -> bool:
        """Shed-on-SLO gate at release time; False = shed (never submit —
        but the completion gate resolves so dependent chains advance)."""
        self.fstats.issued += 1
        req = p.request
        key = (req.app, req.trace_idx)
        decision = "admit"
        if (self.tracker is not None
                and self.tracker.should_degrade(req.app, self.shed_cfg)):
            decision = self.policy.shed_decision(
                req.app, req, self.tracker.rolling(req.app), self.shed_cfg,
                req.arrival_s)
        if decision == "shed":
            self.fstats.sheds += 1
            completed[key] = req.arrival_s
            if self._rec is not None:
                self._rec.instant("shed", req.app, req.request_id,
                                  req.arrival_s)
            return False
        if decision == "downgrade":
            self.fstats.downgrades += 1
            p.background = True          # demoted: loses its deadline
            req.priority = max(req.priority, 1)
            if self._rec is not None:
                self._rec.instant("downgrade", req.app, req.request_id,
                                  req.arrival_s)
        if self.client is not None and self.client.applies_to(req.app):
            self.first_issue.setdefault(key, req.arrival_s)
            self.issue_t[key] = req.arrival_s
            self.attempts.setdefault(key, 0)
        return True

    def note_done(self, r) -> None:
        """Feed the rolling SLO tracker as completions land (online — the
        shed gate needs attainment DURING the run, not post-hoc)."""
        if self.tracker is None:
            return
        trace = self.traces[r.app]
        rec = _record_for(r, trace,
                          self.first_issue.get((r.app, r.trace_idx)))
        self.tracker.note(r.app, rec.meets_slo(trace.slo))

    # -------------------------------------------------------- finalize
    def finalize(self, runs: list, recs: dict,
                 part_of: dict) -> FaultStats:
        self.fstats.replays = sum(r.engine.stats.replays for r in runs)
        if self.fsched is not None and self.fsched.stalls:
            def finish_of(w):
                for name, rl in recs.items():
                    if not w.matches(part_of[name]):
                        continue
                    for rec in rl:
                        if rec.e2e_s is not None:
                            yield (rec.arrival_s, rec.arrival_s + rec.e2e_s)
            self.fstats.time_to_recover_s = time_to_recover(
                self.fsched.stalls, finish_of)
        return self.fstats


def _drive(runs: list[_EngineRun], pending: list[_Pending],
           total_chips: int,
           recorder=None, faults: Optional[_FaultController] = None,
           router: Optional[Router] = None,
           run_idx_of: Optional[dict] = None,
           group_runs: Optional[dict] = None,
           chip=None,
           finish_meta: Optional[Callable] = None
           ) -> tuple[dict, list[UtilSample]]:
    """Event loop over one or more engines (one per chip partition — or one
    per replica under the router tier) sharing a single virtual timeline.
    Always steps the laggard engine among those with runnable work so
    cross-partition dependency releases stay causal; idle engines jump
    their clock to the next arrival.

    Without a router, gate-resolved requests submit immediately (their
    ``arrival_s`` gates engine admission) — the pre-router path, verbatim.
    With a router, a gate-resolved request is HELD until its group's
    virtual clock reaches its arrival, then routed in (arrival, id) order —
    the same order the simulator's event heap pops arrivals — so routing
    decisions see the replica state (outstanding load, prefix caches) of
    arrival time, not of release time."""
    completed: dict[tuple, float] = {}
    util: list[UtilSample] = []
    waiting = list(pending)
    n_total = len(pending)

    def _release(p: _Pending, arr: float) -> bool:
        """Shed gate + submit; shared by both release paths."""
        if recorder is not None:
            # lifecycle anchor (BEFORE the shed gate, so shed terminals
            # close a zero-length lifecycle): one "arrive" per issue
            recorder.instant("arrive", p.request.app, p.request.request_id,
                             arr)
        if faults is not None and not faults.on_release(p, completed):
            return False   # shed: dropped without ever being submitted
        if not p.background:
            p.request.deadline_s = arr + p.deadline_hint_s
        if recorder is not None and p.dep_gates:
            # workflow dependency release (per-request granularity);
            # request_id, not trace_idx: every event of one engine
            # trace keys requests the same way (Chrome tid)
            recorder.instant("release", p.request.app,
                             p.request.request_id, arr)
        runs[p.run_idx].engine.submit(p.request)
        return True

    for _ in range(_MAX_ITERS):
        if faults is not None:
            faults.poll(runs, completed)
        for run in runs:
            done = run.engine.done
            while run.seen < len(done):
                r = done[run.seen]
                run.seen += 1
                completed[(r.app, r.trace_idx)] = r.t_done
                if router is not None and getattr(r, "route_label", ""):
                    router.note_done(r.route_label, r.route_tokens, r.t_done)
                if faults is not None:
                    faults.note_done(r)
                if recorder is not None and finish_meta is not None:
                    # terminal event carries the request's own metrics so
                    # streaming consumers reproduce the post-hoc report
                    recorder.instant("finish", r.app, r.request_id,
                                     r.t_done, meta=finish_meta(r))
        if len(completed) >= n_total:
            return completed, util
        still, ready = [], []
        for p in waiting:
            if all(g in completed for g in p.gates):
                dep_t = max((completed[g] for g in p.dep_gates), default=0.0)
                arr = dep_t + p.setup_s + p.offset_s
                if p.pred is not None:
                    arr = max(arr, completed[p.pred])
                p.request.arrival_s = arr
                if router is None:
                    _release(p, arr)
                else:
                    ready.append(p)
            else:
                still.append(p)
        if router is not None and ready:
            ready.sort(key=lambda p: (p.request.arrival_s,
                                      p.request.request_id))
            for p in ready:
                arr = p.request.arrival_s
                group_now = max(runs[i].engine.now()
                                for i in group_runs[p.group])
                if arr > group_now + 1e-9:
                    still.append(p)   # not due yet: route with arrival-
                    continue          # time replica state, like the sim
                lbl = router.route(p.group, p.route_req, arr)
                i = run_idx_of[lbl]
                p.run_idx = i
                p.request.route_label = lbl
                p.request.route_tokens = p.route_req.tokens
                _recost(p.request, p.items, runs[i].chips, chip,
                        p.kv_tok_bytes)
                _release(p, arr)
        waiting = still
        # same predicate as InferenceEngine._admit_order: a request the
        # engine would not admit must not make its engine a candidate, or
        # an epsilon-future arrival spins the loop without advancing time
        cands = [run for run in runs
                 if any(a is not None for a in run.engine.active)
                 or any(w.arrival_s <= run.engine.now()
                        for w in run.engine.waiting)]
        if cands:
            run = min(cands, key=lambda r: r.engine.now())
            t0 = run.engine.now()
            run.engine.step()
            t1 = run.engine.now()
            if t1 > t0:
                util.append(UtilSample(t0, t1, run.chips, total_chips))
            continue
        # no engine has runnable work: jump idle clocks to the next
        # arrival — engine-visible (submitted) or router-held
        idle = [run for run in runs if run.engine.waiting]
        held = []
        if router is not None:
            held = [p for p in waiting if all(g in completed
                                              for g in p.gates)]
        if not idle and not held:
            raise RuntimeError(
                f"engine scenario deadlocked: {len(waiting)} request(s) "
                "gated on completions that can no longer happen")
        t_eng = min((min(w.arrival_s for w in r.engine.waiting)
                     for r in idle), default=math.inf)
        t_held = min((p.request.arrival_s for p in held), default=math.inf)
        if t_held < t_eng:
            # advance the whole group of the earliest held request so its
            # group clock reaches the arrival and the hold above releases
            p = min(held, key=lambda p: (p.request.arrival_s,
                                         p.request.request_id))
            for i in group_runs[p.group]:
                run = runs[i]
                tgt = p.request.arrival_s
                if faults is not None:
                    tgt = min(tgt, max(faults.next_action_t(i),
                                       run.engine.now() + 1e-9))
                if tgt > run.engine.now():
                    run.engine.advance_to(tgt)
        else:
            run = min(idle, key=lambda r: min(w.arrival_s
                                              for w in r.engine.waiting))
            tgt = min(w.arrival_s for w in run.engine.waiting)
            if faults is not None:
                # don't jump past a pending crash/spike boundary: the
                # action must apply before admissions at the next arrival
                tgt = min(tgt, max(faults.next_action_t(runs.index(run)),
                                   run.engine.now() + 1e-9))
            run.engine.advance_to(tgt)
    raise RuntimeError("engine scenario exceeded the iteration budget")


# ----------------------------------------------------------- trace mapping
def _build_pending(trace: AppTrace, run_idx: int, *,
                   chips: int, chip, vocab: int, seed: int, rid,
                   chunk_target_s: float = 0.05, setup_s: float = 0.0,
                   dep_gates_for: Optional[Callable[[int], list]] = None,
                   priority: int = 0,
                   conv: Optional[ConversationSpec] = None,
                   kv_tok_bytes: float = 0.0,
                   group: str = "", routed: bool = False) -> list[_Pending]:
    if conv is not None and conv.max_prompt_tokens() > PROMPT_MAX_TOKENS:
        raise ValueError(
            f"conversation prompts grow to {conv.max_prompt_tokens()} "
            f"tokens; the engine substrate caps prompts at "
            f"{PROMPT_MAX_TOKENS} — use smaller blocks or fewer turns")
    rng = np.random.default_rng(seed)
    gather_tok_s = kv_tok_bytes / (chips * chip.hbm_bandwidth) \
        if kv_tok_bytes else 0.0
    out = []
    for j, sim_req in enumerate(trace.requests):
        pre = [it for it in sim_req.items if it.kind not in DECODE_KINDS]
        dec = [it for it in sim_req.items if it.kind in DECODE_KINDS]
        prefill_s = sum(it.duration_s(chips, chip) for it in pre)
        decode_s = sum(it.duration_s(chips, chip) for it in dec)
        if conv is not None:
            # LITERAL shared token blocks (system prompt + session
            # history), not synthetic sizing: the radix trie matches on
            # content, so the prompt must BE the conversation
            s, t = session_turn(conv, j)
            prompt_arr = conversation_prompt(conv, s, t, vocab, seed=seed)
            prompt_tokens = len(prompt_arr)
        else:
            n_chunks = math.ceil(prefill_s / max(chunk_target_s, 1e-9))
            prompt_tokens = min(max(ENGINE_PREFILL_CHUNK * n_chunks,
                                    PROMPT_MIN_TOKENS), PROMPT_MAX_TOKENS)
            prompt_arr = rng.integers(0, vocab,
                                      size=prompt_tokens).astype(np.int32)
        n_steps = max(len(dec), 1)
        full = sum(it.tokens for it in dec)
        req = CostedRequest(
            request_id=next(rid),
            prompt=prompt_arr,
            max_new_tokens=n_steps,
            app=trace.name,
            priority=priority,
            trace_idx=j,
            prefill_tok_s=prefill_s / prompt_tokens,
            decode_tok_s=decode_s / n_steps,
            decode_tokens_full=full,
            prefill_items=len(pre),
            prefill_flops_tok=sum(it.flops for it in pre) / prompt_tokens,
            prefill_hbm_tok=sum(it.hbm_bytes for it in pre) / prompt_tokens,
            decode_flops_tok=sum(it.flops for it in dec) / n_steps,
            decode_hbm_tok=sum(it.hbm_bytes for it in dec) / n_steps,
            gather_tok_s=gather_tok_s,
            gather_hbm_tok=kv_tok_bytes)
        rr = None
        if routed:
            # the substrate-neutral routing view: token volume and keys
            # are computed from the SAME SimRequest the simulator routes,
            # so a (policy, seed) pair makes identical choices; the
            # literal prompt feeds the engine-side prefix probe
            rr = RouteRequest(
                app=trace.name, request_id=j,
                tokens=sum(it.tokens for it in sim_req.items),
                session_key=sim_req.prefix_key or trace.name,
                prefix_key=sim_req.prefix_key or "",
                prefix_tokens=sim_req.prefix_tokens,
                prefix_sys_key=sim_req.prefix_sys_key or "",
                prefix_sys_tokens=sim_req.prefix_sys_tokens,
                prompt=prompt_arr)
        out.append(_Pending(
            run_idx=run_idx, request=req, offset_s=sim_req.arrival_s,
            setup_s=setup_s, deadline_hint_s=sim_req.deadline_hint_s,
            background=sim_req.background or trace.background,
            dep_gates=tuple(dep_gates_for(j)) if dep_gates_for else (),
            pred=(trace.name, j - 1) if trace.closed_loop and j > 0
            else None,
            group=group, items=list(sim_req.items),
            kv_tok_bytes=kv_tok_bytes, route_req=rr))
    return out


def _record_for(r, trace: AppTrace,
                arrival: Optional[float] = None) -> RequestRecord:
    """One request's SLO record from engine timing. ``arrival`` overrides
    the request's (possibly retry-shifted) ``arrival_s`` with the FIRST
    issue time, so a timed-out-then-retried request is scored on its
    client-perceived latency, exactly as on the simulator substrate."""
    arr = r.arrival_s if arrival is None else arrival
    rec = RequestRecord(r.app, r.trace_idx, arr)
    rec.e2e_s = r.t_done - arr
    if r.decode_tokens_full > 0:
        if r.t_first_token is not None:
            rec.ttft_s = r.t_first_token - arr
        if r.decode_tokens_full > 1 and len(r.t_tokens) > 1:
            rec.tpot_s = ((r.t_tokens[-1] - r.t_tokens[0])
                          / (r.decode_tokens_full - 1))
            # raw inter-token gaps from the engine's real per-token
            # timestamps — the itl_p99 samples (schema 1.7)
            rec.itl_samples_s = [float(b - a) for a, b in
                                 zip(r.t_tokens, r.t_tokens[1:])]
        else:
            rec.tpot_s = 0.0
    if trace.slo.step is not None:
        # the source chain had `prefill_items` separately-schedulable
        # steps (denoise iterations); the engine prompt collapses them,
        # so resample the per-dispatch timestamps at item boundaries —
        # a step's span then reflects the policy's actual interleaving
        # at the same granularity the simulator dispatches items
        times = r.t_prefill or r.t_tokens
        m = max(r.prefill_items, 1) if isinstance(r, CostedRequest) \
            else len(times)
        k = len(times)
        prev = arr
        for i in range(min(m, k)):
            t = times[min(k - 1, math.ceil(k * (i + 1) / m) - 1)]
            rec.step_times_s.append(t - prev)
            prev = t
    return rec


def _records(runs: list[_EngineRun], traces: dict[str, AppTrace],
             first_issue: Optional[dict] = None
             ) -> dict[str, list[RequestRecord]]:
    """Per-request SLO records from engine timing, in completion order."""
    recs: dict[str, list[RequestRecord]] = {name: [] for name in traces}
    all_done = sorted((r for run in runs for r in run.engine.done),
                      key=lambda r: (r.t_done, r.app, r.trace_idx))
    for r in all_done:
        arrival = (first_issue or {}).get((r.app, r.trace_idx))
        recs[r.app].append(_record_for(r, traces[r.app], arrival))
    return recs


def _run_traces(sc: Scenario, traces: list[AppTrace],
                total_chips: int, *, setup_s: float = 0.0,
                dep_map: Optional[dict[str, list[tuple[str, int]]]] = None,
                release: str = "request",
                conv_of: Optional[dict[str, ConversationSpec]] = None,
                kv_tok_of: Optional[dict[str, float]] = None,
                device: str = "cuda"):
    """Run a set of app traces on per-partition engines; returns the merged
    SimResult, per-partition EngineStats, and the completion-time map.
    ``conv_of``/``kv_tok_of`` (trace name keyed) carry each app's
    conversation shape and full-scale per-token KV bytes — the literal
    prompt builder and the prefix-gather roofline rate."""
    model, params, ecfg = engine_model(device)
    chip = sc.chip_spec
    policy = get_policy(sc.policy)
    policy.reset()
    plan = resolve_partition(policy, traces, total_chips,
                             replicas=sc.replicas)
    part_of = plan.apps                 # app -> BASE partition
    # ---- router tier: one engine per replica of each partition ----------
    router = None
    if plan.replicas > 1 or sc.routing is not None:
        router = Router(plan, sc.routing or "round_robin",
                        rng=child_rng(sc.seed, "routing"))
        chips_of = router.chips_of()    # exec label -> chips
        base_of = dict(router.base_of)
    else:
        chips_of = dict(plan.chips)
        base_of = {p: p for p in chips_of}
    parts = list(chips_of)
    run_idx_of = {p: i for i, p in enumerate(parts)}
    rid = itertools.count()

    # resilience: the SAME seeded schedule the simulator substrate resolves
    # (Scenario.fault_schedule is a fresh, identically-seeded instance);
    # faults always target BASE partition names, never replica labels
    fsched = sc.fault_schedule()
    shed_cfg = sc.shed_config()
    if fsched is not None:
        fsched.bind_partitions(part_of)

    pending: list[_Pending] = []
    for t_i, trace in enumerate(traces):
        base = part_of[trace.name]
        if router is not None:
            # costs are built at the first replica's share and recomputed
            # at the routed replica's share on release (_recost)
            build_part = router.labels_for(base)[0]
        else:
            build_part = base
        if hasattr(policy, "level_for"):
            prio = policy.level_for(trace.name, trace.background)
        else:
            prio = 1 if trace.background else 0
        dep_fn = None
        if dep_map and trace.name in dep_map:
            deps = dep_map[trace.name]
            if release == "node":
                def dep_fn(j, deps=deps):
                    return [(d, k) for d, n in deps for k in range(n)]
            else:
                def dep_fn(j, deps=deps):
                    return [(d, min(j, n - 1)) for d, n in deps if n > 0]
        pending += _build_pending(
            trace, run_idx_of[build_part], chips=chips_of[build_part],
            chip=chip, vocab=ecfg.vocab_size,
            seed=child_seed(sc.seed, "prompts", t_i), rid=rid,
            chunk_target_s=sc.chunk_target_s, setup_s=setup_s,
            dep_gates_for=dep_fn, priority=prio,
            conv=(conv_of or {}).get(trace.name),
            kv_tok_bytes=(kv_tok_of or {}).get(trace.name, 0.0),
            group=base, routed=router is not None)

    # memory knobs -> a page budget for the (reduced) execution vehicle,
    # via the shared pool-sizing helper; partitions own their chips, so
    # each gets a chip-proportional share
    pages_total = sc.kv_page_budget
    if pages_total is None and sc.memory_mb is not None:
        from repro_torch.roofline.hw import kv_pool_pages
        pages_total = kv_pool_pages(chip, model.kv_bytes_per_token(),
                                    sc.page_size,
                                    memory_mb=sc.memory_mb) or None

    # telemetry: one shared recorder across partition engines — their
    # virtual clocks are windows onto the same scenario timeline (exactly
    # how the UtilSamples merge), so events interleave by timestamp
    recorder = None
    pipeline = None
    if getattr(sc, "telemetry", False):
        from repro_torch.telemetry import TraceRecorder
        recorder = TraceRecorder(ring=getattr(sc, "trace_ring", None))
        pipeline = sc.streaming_pipeline()
        if pipeline is not None:
            # subscribe BEFORE any emission so the online pipeline sees
            # the full stream (fault windows included) in causal order
            recorder.subscribe(pipeline)
    if fsched is not None and recorder is not None:
        fsched.emit(recorder)

    runs = []
    for p_i, part in enumerate(parts):
        if router is not None:
            # any replica of a group may serve any of its requests
            mine = [p for p in pending if p.group == base_of[part]]
        else:
            mine = [p for p in pending if p.run_idx == p_i]
        need = max((len(p.request.prompt) + p.request.max_new_tokens
                    for p in mine), default=PROMPT_MIN_TOKENS) + 8
        max_seq = math.ceil(need / SEQ_BUCKET) * SEQ_BUCKET
        kv_pages = None
        if pages_total is not None:
            kv_pages = max(1, pages_total * chips_of[part] // total_chips)
        # the scenario's page_size only governs budgeted pools; without a
        # budget the engine consults the autotuner's paged_decode_attention
        # entry for the page size (page_size=None)
        eng = InferenceEngine(model, max_slots=ENGINE_SLOTS, max_seq=max_seq,
                              policy=policy,
                              prefill_chunk=ENGINE_PREFILL_CHUNK,
                              request_cost_s=_request_cost,
                              kv_pages=kv_pages,
                              page_size=(sc.page_size
                                         if pages_total is not None else None),
                              prefix_cache=sc.prefix_cache,
                              recorder=recorder,
                              recorder_chips=chips_of[part],
                              recorder_label=str(part),
                              request_work=_request_work,
                              time_warp=(fsched.time_warp(base_of[part])
                                         if fsched is not None else None))
        eng.load_params(params)
        runs.append(_EngineRun(engine=eng, chips=chips_of[part]))
    group_runs = None
    if router is not None:
        router.recorder = recorder
        group_runs = {base: [run_idx_of[lbl]
                             for lbl in router.labels_for(base)]
                      for base in plan.chips}
        # prefix-aware probe: each replica's REAL radix trie, floored to
        # the prefill-chunk grid exactly like an admission hit
        for lbl, i in run_idx_of.items():
            router.set_probe(
                lbl, lambda rr, eng=runs[i].engine:
                eng.prefix_peek(rr.prompt))

    faults = None
    if fsched is not None or shed_cfg is not None:
        faults = _FaultController(fsched, shed_cfg, policy,
                                  {t.name: t for t in traces}, recorder)
        faults.build_actions([base_of[p] for p in parts])
    if pipeline is not None and faults is not None \
            and faults.tracker is not None:
        # one rolling-SLO truth: the pipeline's burn-rate monitor reads
        # the SAME window the shed_on_slo controller consults
        pipeline.bind_tracker(faults.tracker)
    finish_meta = None
    if recorder is not None:
        traces_by_name = {t.name: t for t in traces}

        def finish_meta(r):
            """The finish instant's meta: the SAME record the post-hoc
            report scores, so streaming reproduces it exactly."""
            tr = traces_by_name[r.app]
            first = (faults.first_issue.get((r.app, r.trace_idx))
                     if faults is not None else None)
            rec = _record_for(r, tr, first)
            return {"ok": rec.meets_slo(tr.slo), "ttft_s": rec.ttft_s,
                    "tpot_s": rec.tpot_s, "e2e_s": rec.e2e_s,
                    "itl": list(rec.itl_samples_s or ())}
    completed, util = _drive(runs, pending, total_chips, recorder, faults,
                             router=router, run_idx_of=run_idx_of,
                             group_runs=group_runs, chip=chip,
                             finish_meta=finish_meta)
    recs = _records(runs, {t.name: t for t in traces},
                    first_issue=faults.first_issue if faults else None)
    reports = {t.name: SLOReport(t.name, t.slo, recs[t.name]) for t in traces}
    paged = [r.engine for r in runs if r.engine.paged]
    mem = {}
    # the versioned "memory" block appears only when the scenario set a
    # budget — mirroring the simulator substrate, so the two substrates
    # keep emitting schema-identical documents. Partition pools are
    # independent memory slices whose peaks happen at different instants,
    # so the binding constraint is the MOST-utilized pool: report the max
    # per-pool utilization (scaled onto the total budget), not the sum of
    # staggered peaks, which could overstate utilization past 1.0.
    if paged and pages_total is not None:
        page = paged[0].page_size
        budget = sum(e.kv_pages for e in paged)
        pool_util = max(e.stats.pages_in_use / e.kv_pages for e in paged)
        mem = dict(
            kv_token_budget=budget * page,
            page_size=page,
            peak_kv_tokens=round(pool_util * budget) * page,
            evictions=sum(e.stats.evictions for e in paged),
            recompute_tokens=sum(e.stats.recompute_tokens for e in paged))
    engines = [r.engine for r in runs]
    # schema 1.7 "batching" block from the REAL engine's step accounting —
    # same keys the simulator's analytic mirror emits
    es = [e.stats for e in engines]
    bat_on = any(s.budget_enabled for s in es)
    ready = sum(s.decode_ready_time_s for s in es)
    bat = {
        "enabled": bat_on,
        "mixed_steps": sum(s.mixed_steps for s in es),
        "steps": sum(s.steps for s in es),
        "prefill_tokens": sum(s.prefill_tokens for s in es),
        "decode_tokens": sum(s.decode_tokens for s in es),
        "prefill_share": (float(getattr(policy, "prefill_share", 0.0))
                          if bat_on else 0.0),
        "decode_stall_fraction": (
            sum(s.decode_stall_time_s for s in es) / ready
            if ready > 0 else 0.0),
    }
    pfx = {}
    if sc.prefix_cache:
        # schema 1.4 "prefix" block, from the REAL trie's counters. The
        # denominator mirrors the simulator's "prompt tokens seen": what
        # was actually prefilled plus what the trie served instead.
        hit = sum(e.stats.prefix_hit_tokens for e in engines)
        pfx = dict(
            prefix_enabled=True,
            prefix_hit_tokens=hit,
            prefix_prompt_tokens=sum(e.stats.prefill_tokens
                                     for e in engines) + hit,
            prefix_shared_pages=sum(e.stats.shared_pages for e in engines),
            prefix_hits=sum(e.prefix.stats.hits for e in engines
                            if e.prefix is not None),
            prefix_lookups=sum(e.prefix.stats.lookups for e in engines
                               if e.prefix is not None),
            prefix_cow_forks=sum(e.stats.cow_forks for e in engines))
    sim = SimResult(reports=reports, util=util, total_chips=total_chips,
                    chip=chip, strategy=policy.name, trace=recorder,
                    fault_stats=(faults.finalize(runs, recs, part_of)
                                 if faults is not None else None),
                    routing=(router.routing_block()
                             if router is not None else None),
                    batching=bat,
                    attribution=(pipeline.attribution_block()
                                 if pipeline is not None else None),
                    **mem, **pfx)
    stats = {part: runs[i].engine.stats for part, i in run_idx_of.items()}
    return sim, stats, completed


# ------------------------------------------------------------ entry point
def run_scenario_on_engine(sc: Scenario, *,
                           device: str = "cuda") -> ScenarioResult:
    """Execute ``sc`` on the real InferenceEngine; same modes, same result
    schema as the simulator substrate (``substrate`` field aside). The
    engines run on ``device``: the card unless the caller asks for the
    CPU."""
    if sc.mode == "exclusive":
        return _run_exclusive(sc, device)
    if sc.mode == "concurrent":
        return _run_concurrent(sc, device)
    return _run_workflow(sc, device)


def _app_maps(sc: Scenario):
    """(conv_of, kv_tok_of): per-app conversation shapes and full-scale
    per-token KV bytes (the prefix-gather roofline rate), by app name."""
    from repro_torch.roofline.hw import kv_bytes_per_token
    conv_of, kv_tok_of = {}, {}
    for sa in sc.apps:
        app = sa.build()
        if sa.conversation is not None:
            conv_of[app.name] = sa.conversation
        if sc.prefix_cache:
            kv_tok_of[app.name] = float(kv_bytes_per_token(app.cfg))
    return conv_of, kv_tok_of


def _run_concurrent(sc: Scenario, device: str) -> ScenarioResult:
    traces = [sc._trace(i, sa, sa.build()) for i, sa in enumerate(sc.apps)]
    conv_of, kv_tok_of = _app_maps(sc)
    sim, stats, _ = _run_traces(sc, traces, sc.total_chips,
                                conv_of=conv_of, kv_tok_of=kv_tok_of,
                                device=device)
    return ScenarioResult(scenario=sc, sims={"concurrent": sim},
                          substrate="engine", engine_stats=stats)


def _run_exclusive(sc: Scenario, device: str) -> ScenarioResult:
    chips = sc.total_chips if sc.chip_spec.name != "host-cpu" else 1
    conv_of, kv_tok_of = _app_maps(sc)
    sims, stats = {}, {}
    for i, sa in enumerate(sc.apps):
        app = sa.build()
        sim, st, _ = _run_traces(sc, [sc._trace(i, sa, app)], chips,
                                 conv_of=conv_of, kv_tok_of=kv_tok_of,
                                 device=device)
        sims[app.name] = sim
        stats[app.name] = next(iter(st.values()))
    return ScenarioResult(scenario=sc, sims=sims, substrate="engine",
                          engine_stats=stats)


def _run_workflow(sc: Scenario, device: str) -> ScenarioResult:
    spec = sc.workflow_spec()
    dag = build_dag(spec)
    exec_nodes = {n.node: n for n in dag.nodes.values()
                  if n.phase == Phase.EXEC}
    traces: list[AppTrace] = []
    lens: dict[str, int] = {}
    for name, node in exec_nodes.items():
        app = dataclasses.replace(app_from_task(node.task), name=name)
        tr = app.sim_trace(node.task.num_requests)
        tr = AppTrace(name=name, slo=tr.slo, requests=tr.requests,
                      background=tr.background or node.background,
                      closed_loop=tr.closed_loop)
        traces.append(tr)
        lens[name] = len(tr.requests)
    dep_map: dict[str, list[tuple[str, int]]] = {}
    for name, node in exec_nodes.items():
        deps = [d.split(":")[0] for d in node.deps if d.endswith(":exec")]
        if deps:
            dep_map[name] = [(d, lens[d]) for d in deps]
    sim, stats, completed = _run_traces(
        sc, traces, sc.total_chips, setup_s=SETUP_S,
        dep_map=dep_map, release=sc.workflow_release, device=device)
    finish = {name: max((completed[(name, j)] for j in range(lens[name])),
                        default=0.0) for name in exec_nodes}
    e2e = max(finish.values(), default=0.0)
    return ScenarioResult(scenario=sc, sims={"workflow": sim},
                          node_finish_s=finish, e2e_s=e2e,
                          substrate="engine", engine_stats=stats)
