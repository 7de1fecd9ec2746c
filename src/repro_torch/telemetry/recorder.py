# Copy of src/repro/telemetry/recorder.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Low-overhead trace-event bus shared by both execution substrates.

The paper's system-level observability (§3.2: SMACT/SMOCC, memory
bandwidth, memory occupancy sampled alongside app-level SLOs) needs one
primitive: a timestamped event stream from the execution engine. Both
substrates emit into a :class:`TraceRecorder` —

* the :class:`~repro.core.simulator.PodSimulator` from its discrete-event
  schedule (one span per dispatched work item, at the item's analytic
  FLOPs/bytes), and
* the real :class:`~repro.serving.engine.InferenceEngine` /
  ``bench.engine_runner`` from the virtual cost clock (one span per
  prefill-chunk dispatch and per decoded row, with per-token FLOPs/bytes
  resolved through the engine's ``request_work`` hook).

The recorder is an EVENT BUS, not just a store: sinks attached through
:meth:`TraceRecorder.subscribe` (objects with an ``on_event(event)``
method and, optionally, ``on_counter(name, t, value)``) see every
emission in order, online — this is what the streaming-metrics pipeline
(:mod:`repro.telemetry.streaming`) and the per-request lifecycle
assembler (:mod:`repro.telemetry.requests`) consume. The append-only
list stays the default sink; with no recorder attached the emit sites
are still a single ``is None`` check, so the serving hot path pays
nothing by default.

Ring-buffer mode (``TraceRecorder(ring=N)``) bounds the retained event
list to the most recent ``N`` events (and each counter series to its
most recent ``N`` samples) so open-loop million-request runs hold
O(window) memory instead of O(trace). The aggregate views —
:meth:`counts`, :meth:`token_total`, :attr:`makespan_s` — stay EXACT
under ring mode: they are maintained incrementally at emit time, never
by scanning the (truncated) window.

Derived views (:mod:`repro.telemetry.timeline`) and exporters
(:mod:`repro.telemetry.export`) consume the recorder; emission itself
is deliberately dumb — appends plus sink fan-out, no locking (both
substrates are single-threaded event loops).

Event vocabulary
----------------
Span events (``phase == "X"``, ``t1 >= t0``) are work dispatches named by
work-item kind: ``prefill``, ``decode``, ``encode``, ``denoise``,
``train``. Instant events (``phase == "i"``) mark lifecycle and
scheduler decisions: ``arrive`` (request issued / entered the system),
``route`` (router picked a serving replica; ``meta.replica``), ``admit``
(request became memory-resident / claimed a slot), ``evict``
(preempt-to-evict; ``tokens`` carries the cached tokens lost, i.e. the
recompute bill), ``preempt`` (chunk-boundary preemption), ``release``
(workflow dependency release), ``prefix_hit`` (admission mapped cached
prefix pages; ``tokens`` carries the prefill tokens skipped),
``cow_fork`` (first write into a shared page forked it) and ``finish``
(request completed; ``meta`` carries the request's summary metrics —
``ok``/``ttft_s``/``tpot_s``/``e2e_s``/``itl`` — so streaming consumers
never need a second metrics path). Counters are named step series —
both substrates emit ``kv_pages`` (suffix ``@<partition>`` on the
engine) for the KV-pool occupancy timeline; real wall-clock runs add
``host_cpu_pct`` / ``host_rss_mb`` via
:class:`~repro.telemetry.host.HostMonitor`.

Resilience events (repro.resilience): ``fault`` spans mark injected fault
windows (app ``__faults__``, chips=0 — never chip-occupying work);
``timeout`` / ``retry`` / ``cancel`` mark the client-timeout lifecycle,
``shed`` / ``downgrade`` the admission controller's decisions, and
``replay`` an in-flight request restarted after a partition crash.

Exactly one TERMINAL event (``finish``, ``cancel`` or ``shed``) closes
every issued request's lifecycle — the invariant the per-request
assembler's completeness accounting rests on.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

#: canonical event kinds — always present (zero-filled) in count maps so
#: the two substrates emit schema-identical telemetry blocks even when one
#: never produces a given kind
EVENT_KINDS = ("prefill", "decode", "encode", "denoise", "train",
               "arrive", "route", "admit", "evict", "preempt", "release",
               "prefix_hit", "cow_fork",
               "fault", "timeout", "retry", "cancel", "shed", "downgrade",
               "replay", "finish")
#: span-event kinds that represent chip-occupying work
WORK_KINDS = ("prefill", "decode", "encode", "denoise", "train")
#: instant kinds that close a request lifecycle (exactly one per request)
TERMINAL_KINDS = ("finish", "cancel", "shed")


@dataclass
class TraceEvent:
    kind: str
    app: str
    request_id: int
    t0: float
    t1: float                    # == t0 for instant events
    phase: str = "X"             # "X" complete span | "i" instant
    chips: int = 0               # chips the span occupied (SMACT numerator)
    flops: float = 0.0           # actual work moved in [t0, t1] (SMOCC /
    hbm_bytes: float = 0.0       # bandwidth-timeline numerators)
    tokens: float = 0.0
    meta: Optional[dict] = None
    #: interconnect bytes the span moved (disaggregated/multi-chip spans;
    #: feeds the roofline ICI term — 0 for chip-local work)
    ici_bytes: float = 0.0


@dataclass
class TraceRecorder:
    """Event/counter store + subscriber bus; one per run.

    ``ring=N`` keeps only the newest ``N`` events (and ``N`` samples per
    counter series) — aggregate views stay exact, derived TIMELINE views
    cover the retained window only."""
    events: "list | deque" = field(default_factory=list)
    #: counter name -> [(t, value)] step series (value holds until next)
    counters: dict = field(default_factory=dict)
    #: retained-window size; None = unbounded (the default sink keeps all)
    ring: Optional[int] = None

    def __post_init__(self):
        if self.ring is not None:
            if self.ring <= 0:
                raise ValueError(f"ring must be positive, got {self.ring}")
            self.events = deque(self.events, maxlen=int(self.ring))
        self._sinks: list = []
        # incremental aggregates — exact even when the ring drops events
        self._counts: dict[str, int] = {}
        self._token_totals: dict[str, float] = {}
        self._t_max = 0.0

    # -------------------------------------------------------------- bus
    def subscribe(self, sink) -> None:
        """Attach a streaming sink: ``sink.on_event(event)`` is called for
        every span/instant emission, ``sink.on_counter(name, t, value)``
        (optional) for every counter sample — synchronously, in emission
        order. Sinks must not emit back into the recorder."""
        self._sinks.append(sink)

    def replay(self, sink) -> None:
        """Feed every RETAINED event (in emission order), then every
        retained counter sample, through ``sink`` — post-hoc equivalent of
        having subscribed before the run. Under ring mode only the window
        is replayed; subscribe live for exact aggregates."""
        on_event = sink.on_event
        for e in self.events:
            on_event(e)
        on_counter = getattr(sink, "on_counter", None)
        if on_counter is not None:
            for name in sorted(self.counters):
                for t, v in self.counters[name]:
                    on_counter(name, t, v)

    # ------------------------------------------------------------- emit
    def _emit(self, ev: TraceEvent) -> None:
        self._counts[ev.kind] = self._counts.get(ev.kind, 0) + 1
        if ev.tokens:
            self._token_totals[ev.kind] = (
                self._token_totals.get(ev.kind, 0.0) + ev.tokens)
        if ev.t1 > self._t_max:
            self._t_max = ev.t1
        self.events.append(ev)
        for s in self._sinks:
            s.on_event(ev)

    def span(self, kind: str, app: str, request_id: int,
             t0: float, t1: float, *, chips: int = 0, flops: float = 0.0,
             hbm_bytes: float = 0.0, tokens: float = 0.0,
             meta: Optional[dict] = None, ici_bytes: float = 0.0) -> None:
        self._emit(TraceEvent(kind, app, request_id, t0, t1, "X",
                              chips, flops, hbm_bytes, tokens, meta,
                              ici_bytes))

    def instant(self, kind: str, app: str, request_id: int, t: float, *,
                tokens: float = 0.0, meta: Optional[dict] = None) -> None:
        self._emit(TraceEvent(kind, app, request_id, t, t, "i",
                              0, 0.0, 0.0, tokens, meta))

    def counter(self, name: str, t: float, value: float) -> None:
        pts = self.counters.get(name)
        if pts is None:
            pts = (deque(maxlen=int(self.ring)) if self.ring is not None
                   else [])
            self.counters[name] = pts
        pts.append((t, float(value)))
        if t > self._t_max:
            self._t_max = t
        for s in self._sinks:
            cb = getattr(s, "on_counter", None)
            if cb is not None:
                cb(name, t, value)

    # ---------------------------------------------------------- derived
    @property
    def makespan_s(self) -> float:
        span = max((e.t1 for e in self.events), default=0.0)
        for pts in self.counters.values():
            if pts:
                span = max(span, pts[-1][0])
        return max(span, self._t_max)

    def counts(self) -> dict:
        """Events per kind — every canonical kind present (0 default), so
        count maps are schema-identical across substrates. Maintained
        incrementally: exact even when ring mode dropped old events."""
        out = {k: 0 for k in EVENT_KINDS}
        out.update(self._counts)
        return out

    def token_total(self, kind: str) -> float:
        """Sum of ``tokens`` over events of ``kind`` (e.g. the recompute
        bill = ``token_total("evict")``) — exact under ring mode."""
        return self._token_totals.get(kind, 0.0)
