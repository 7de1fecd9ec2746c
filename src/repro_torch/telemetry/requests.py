# Copy of src/repro/telemetry/requests.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Per-request lifecycle assembly + critical-path attribution.

The trace bus answers "what did the system do"; this module answers
"where did each REQUEST's latency go". A :class:`RequestAssembler` is a
recorder sink (``TraceRecorder.subscribe``) that stitches the events
carrying one ``(app, request_id)`` — arrive → route → admit → prefill
chunks → decode → evict/replay → retry/timeout → terminal — into a
causal timeline, and on the terminal event (``finish`` / ``cancel`` /
``shed``) closes it into a :class:`RequestLifecycle` whose critical-path
breakdown PARTITIONS the request's wall-clock span exactly:

    queue_s + sched_s + prefill_s + decode_s + recompute_s
            + stall_s + fault_s  ==  t_end - t_arrive   (to 1e-6)

Bucket semantics:

* ``queue_s``      — arrive → first admit (waiting for memory / a slot)
* ``sched_s``      — first admit → first work dispatch
* ``prefill_s``    — non-decode work-span time (prefill / encode /
                     denoise / train), net of recompute
* ``decode_s``     — decode work-span time
* ``recompute_s``  — the share of post-eviction work spans re-earning
                     tokens an ``evict``/``replay`` threw away (consumed
                     pro-rata from the eviction's token debt)
* ``stall_s``      — gaps between work spans not explained by a fault
                     window (scheduling starvation, preemption,
                     retry backoff)
* ``fault_s``      — the part of those gaps inside an injected fault
                     window (``fault`` spans, app ``__faults__``)

Work spans of one request are serialized, so overlap handling reduces to
clamping each span's start to the previous span's end (and the last span
to the terminal time — a cancelled request's in-flight dispatch keeps
burning chip time past the cancel, by design). State is O(open
requests): closed lifecycles fold into the per-app :class:`BlameTable`
and are handed to an optional callback; the assembler never retains
them, so it composes with ring-buffer recorders at million-request
scale.

``attribution_from_trace(trace)`` replays a retained trace through a
fresh assembler — the post-hoc path; the streaming pipeline
(:mod:`repro_torch.telemetry.streaming`) embeds a live one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.telemetry.recorder import TERMINAL_KINDS, WORK_KINDS, TraceEvent

#: the breakdown bucket names, in canonical (schema) order
BUCKETS = ("queue", "sched", "prefill", "decode", "recompute",
           "stall", "fault")

#: app label fault spans are emitted under (never a real app)
FAULT_APP = "__faults__"


@dataclass
class RequestLifecycle:
    """One closed request: its timeline endpoints, terminal kind, summary
    metrics (from the ``finish`` meta, when present) and the critical-path
    breakdown. ``total_s = t_end - t_arrive`` is the span the breakdown
    partitions; ``e2e_s`` is the SLO accounting's value (they differ only
    for client-retried requests, whose records re-base on the retry)."""
    app: str
    request_id: int
    terminal: str                  # "finish" | "cancel" | "shed"
    t_arrive: float
    t_end: float
    queue_s: float = 0.0
    sched_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    recompute_s: float = 0.0
    stall_s: float = 0.0
    fault_s: float = 0.0
    ok: bool = False               # met its SLO (finish meta; else False)
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    e2e_s: Optional[float] = None
    itl_samples_s: tuple = ()      # inter-token gaps (finish meta)
    evictions: int = 0
    retries: int = 0

    @property
    def total_s(self) -> float:
        return self.t_end - self.t_arrive

    def breakdown(self) -> dict:
        return {"queue": self.queue_s, "sched": self.sched_s,
                "prefill": self.prefill_s, "decode": self.decode_s,
                "recompute": self.recompute_s, "stall": self.stall_s,
                "fault": self.fault_s}


class _Open:
    """Accumulator for one in-flight request — O(1) state per request."""
    __slots__ = ("t_arrive", "t_admit", "t_first_work", "last_t1",
                 "prefill_s", "decode_s", "recompute_s",
                 "stall_s", "fault_s", "debt_tokens",
                 "last_span", "evictions", "retries")

    def __init__(self, t_arrive: float):
        self.t_arrive = t_arrive
        self.t_admit: Optional[float] = None
        self.t_first_work: Optional[float] = None
        self.last_t1: Optional[float] = None      # union frontier
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.recompute_s = 0.0
        self.stall_s = 0.0
        self.fault_s = 0.0
        self.debt_tokens = 0.0                    # evicted tokens to re-earn
        #: last work span's (t0_eff, t1, {bucket: credited_s}) — the only
        #: span that can straddle the terminal time and need re-clamping
        self.last_span: Optional[tuple] = None
        self.evictions = 0
        self.retries = 0


@dataclass
class BlameTable:
    """Per-app aggregate of closed lifecycles — the "blame table"."""
    requests: int = 0
    finishes: int = 0
    cancels: int = 0
    sheds: int = 0
    slo_ok: int = 0
    total_s: float = 0.0
    seconds: dict = field(
        default_factory=lambda: {b: 0.0 for b in BUCKETS})

    def fold(self, lc: RequestLifecycle) -> None:
        self.requests += 1
        if lc.terminal == "finish":
            self.finishes += 1
        elif lc.terminal == "cancel":
            self.cancels += 1
        else:
            self.sheds += 1
        if lc.ok:
            self.slo_ok += 1
        self.total_s += lc.total_s
        for b, v in lc.breakdown().items():
            self.seconds[b] += v

    def shares(self) -> dict:
        tot = self.total_s
        if tot <= 0:
            return {b: 0.0 for b in BUCKETS}
        return {b: self.seconds[b] / tot for b in BUCKETS}


class RequestAssembler:
    """Recorder sink stitching per-request causal timelines online.

    ``on_lifecycle`` (optional) receives each closed
    :class:`RequestLifecycle`; the assembler itself keeps only the
    per-app :class:`BlameTable` aggregates plus O(open-requests) state."""

    def __init__(self, on_lifecycle: Optional[
            Callable[[RequestLifecycle], None]] = None):
        self._open: dict[tuple, _Open] = {}
        self._faults: list[tuple[float, float]] = []
        self.tables: dict[str, BlameTable] = {}
        self.closed = 0
        self.t_max = 0.0
        self._cb = on_lifecycle

    # ------------------------------------------------------------- sink
    def on_event(self, ev: TraceEvent) -> Optional[RequestLifecycle]:
        if ev.t1 > self.t_max:
            self.t_max = ev.t1
        if ev.app == FAULT_APP:
            if ev.kind == "fault" and ev.t1 > ev.t0:
                self._faults.append((ev.t0, ev.t1))
            return None
        kind = ev.kind
        if kind == "arrive":
            self._open[(ev.app, ev.request_id)] = _Open(ev.t0)
            return None
        st = self._open.get((ev.app, ev.request_id))
        if st is None:
            return None      # pre-arrive noise (or a replayed partial ring)
        if kind == "admit":
            if st.t_admit is None:
                st.t_admit = ev.t0
        elif kind in WORK_KINDS and ev.phase == "X":
            self._work(st, ev)
        elif kind in ("evict", "replay"):
            st.debt_tokens += ev.tokens
            st.evictions += 1
        elif kind == "retry":
            st.retries += 1
        elif kind in TERMINAL_KINDS:
            return self._close(ev, st)
        return None

    # ------------------------------------------------------- accounting
    def _gap(self, st: _Open, t0: float, t1: float) -> None:
        """Charge idle time [t0, t1] to fault (inside an injected fault
        window) or stall (everything else)."""
        if t1 <= t0:
            return
        covered = 0.0
        for f0, f1 in self._faults:
            lo, hi = max(t0, f0), min(t1, f1)
            if hi > lo:
                covered += hi - lo
        covered = min(covered, t1 - t0)   # overlapping windows never overbill
        st.fault_s += covered
        st.stall_s += (t1 - t0) - covered

    def _work(self, st: _Open, ev: TraceEvent) -> None:
        if st.t_first_work is None:
            st.t_first_work = ev.t0
            st.last_t1 = ev.t0
        # serialized per request: clamp to the union frontier so wasted
        # (crash-killed) dispatches overlapping their replay never double-
        # count; the gap before this span splits into stall vs fault
        t0 = max(ev.t0, st.last_t1)
        if ev.t0 > st.last_t1:
            self._gap(st, st.last_t1, ev.t0)
        dur = max(ev.t1 - t0, 0.0)
        credited: dict[str, float] = {}
        if dur > 0.0:
            if ev.kind == "decode":
                st.decode_s += dur
                credited["decode"] = dur
            else:
                frac = 0.0
                if st.debt_tokens > 0.0 and ev.tokens > 0.0:
                    eat = min(ev.tokens, st.debt_tokens)
                    st.debt_tokens -= eat
                    frac = eat / ev.tokens
                if frac > 0.0:
                    st.recompute_s += dur * frac
                    credited["recompute"] = dur * frac
                if frac < 1.0:
                    st.prefill_s += dur * (1.0 - frac)
                    credited["prefill"] = dur * (1.0 - frac)
        if ev.t1 > st.last_t1:
            st.last_t1 = ev.t1
        st.last_span = (t0, ev.t1, credited)

    def _close(self, ev: TraceEvent,
               st: _Open) -> RequestLifecycle:
        key = (ev.app, ev.request_id)
        del self._open[key]
        t_end = ev.t0
        # the last span may straddle the terminal (a cancel aborts a
        # dispatch whose chip time keeps burning): keep only its share
        # inside [arrive, t_end]
        if st.last_span is not None:
            t0, t1, credited = st.last_span
            if t1 > t_end and t1 > t0:
                keep = max(t_end - t0, 0.0) / (t1 - t0)
                for b, v in credited.items():
                    trim = v * (1.0 - keep)
                    if b == "decode":
                        st.decode_s -= trim
                    elif b == "recompute":
                        st.recompute_s -= trim
                    else:
                        st.prefill_s -= trim
                st.last_t1 = min(st.last_t1, t_end)
        lc = RequestLifecycle(ev.app, ev.request_id, ev.kind,
                              st.t_arrive, t_end)
        if st.t_admit is None:
            # never admitted (shed, or cancelled while queued): the whole
            # span is queueing
            lc.queue_s = max(t_end - st.t_arrive, 0.0)
        else:
            t_admit = min(st.t_admit, t_end)
            lc.queue_s = max(t_admit - st.t_arrive, 0.0)
            if st.t_first_work is None:
                lc.sched_s = max(t_end - t_admit, 0.0)
            else:
                t_work = min(max(st.t_first_work, t_admit), t_end)
                lc.sched_s = t_work - t_admit
                # trailing idle: last work end -> terminal
                self._gap(st, min(st.last_t1, t_end), t_end)
                lc.prefill_s = st.prefill_s
                lc.decode_s = st.decode_s
                lc.recompute_s = st.recompute_s
                lc.stall_s = st.stall_s
                lc.fault_s = st.fault_s
        meta = ev.meta or {}
        lc.ok = bool(meta.get("ok", False))
        lc.ttft_s = meta.get("ttft_s")
        lc.tpot_s = meta.get("tpot_s")
        lc.e2e_s = meta.get("e2e_s")
        lc.itl_samples_s = tuple(meta.get("itl") or ())
        lc.evictions = st.evictions
        lc.retries = st.retries
        self.closed += 1
        tbl = self.tables.get(ev.app)
        if tbl is None:
            tbl = self.tables[ev.app] = BlameTable()
        tbl.fold(lc)
        if self._cb is not None:
            self._cb(lc)
        return lc

    # ---------------------------------------------------------- derived
    @property
    def open_count(self) -> int:
        return len(self._open)

    def block(self, makespan_s: Optional[float] = None) -> dict:
        """The schema-1.8 ``attribution`` result block (see
        :func:`empty_attribution_block` for the zero-filled shape)."""
        span = self.t_max if makespan_s is None else makespan_s
        finishes = sum(t.finishes for t in self.tables.values())
        cancels = sum(t.cancels for t in self.tables.values())
        sheds = sum(t.sheds for t in self.tables.values())
        ok = sum(t.slo_ok for t in self.tables.values())
        per_app = {}
        for app in sorted(self.tables):
            t = self.tables[app]
            per_app[app] = {
                "requests": t.requests,
                "slo_ok": t.slo_ok,
                "e2e_total_s": round(t.total_s, 9),
                "e2e_mean_s": round(t.total_s / t.requests, 9)
                              if t.requests else 0.0,
                "seconds": {b: round(t.seconds[b], 9) for b in BUCKETS},
                "shares": {b: round(v, 6) for b, v in t.shares().items()},
            }
        return {
            "enabled": True,
            "requests": self.closed,
            "open": self.open_count,
            "terminal": {"finish": finishes, "cancel": cancels,
                         "shed": sheds},
            "slo_ok": ok,
            "goodput_rps": round(ok / span, 9) if span > 0 else 0.0,
            "per_app": per_app,
        }


def empty_attribution_block() -> dict:
    """Schema-1.8 ``attribution`` block, zero-filled — what a run without
    streaming telemetry reports. ALWAYS present, like "faults"/"routing"/
    "batching", so downstream diffing never branches on key existence."""
    return {"enabled": False, "requests": 0, "open": 0,
            "terminal": {"finish": 0, "cancel": 0, "shed": 0},
            "slo_ok": 0, "goodput_rps": 0.0, "per_app": {}}


def attribution_from_trace(trace) -> dict:
    """Post-hoc attribution: replay a retained trace through a fresh
    assembler. Exact for unbounded recorders; under ring mode prefer the
    live streaming pipeline (the window has forgotten early requests)."""
    asm = RequestAssembler()
    trace.replay(asm)
    return asm.block(trace.makespan_s)
