# Copy of src/repro/bench/policy.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Pluggable scheduling policies (paper §4.2 strategies + §5.2's SLO-aware
scheduler, redesigned as one API).

A :class:`SchedulingPolicy` is consumed by BOTH execution substrates:

* the discrete-event :class:`~repro.core.simulator.PodSimulator` (pod-scale
  roofline numbers) via the ``partition`` / ``priority`` / ``chunk_fraction``
  / ``on_dispatch`` hooks, and
* the real-JAX :class:`~repro.serving.engine.InferenceEngine` (continuous
  batching) via ``admit_order`` / ``prefill_chunk_tokens`` /
  ``exclusive_prefill``.

Policies are looked up by name through a registry so new schedulers plug in
without touching either substrate::

    @register_policy("my_policy")
    class MyPolicy(SchedulingPolicy):
        def priority(self, trace, req, item, now):
            ...

    PodSimulator(256, policy="my_policy")
    InferenceEngine(model, policy="my_policy")

Shipped policies:

  greedy (alias: fcfs) — one FIFO queue over all chips; whole-prompt prefill
               engine-side. Small latency-critical items suffer head-of-line
               blocking (paper Fig. 5b).
  chunked    — FIFO admission + chunked prefill/denoise: long chunkable items
               split at ``chunk_target_s`` boundaries so short work can
               interleave (the engine's former 'chunked' policy, now also
               available at pod scale).
  mixed      — BEYOND-PAPER: stall-free mixed batching (Sarathi-style).
               Every engine step carries a token budget split between
               prefill and decode (``step_budget``), so decode rows advance
               EVERY step; mid-prefill slots share one multi-slot batched
               prefill dispatch. Chunk behaviour inherited from chunked.
  static     — chips split equally among apps at start (≙ MPS 33%); idle
               partitions stay idle → underutilization (paper Fig. 5a).
  slo_aware  — work-conserving EDF by per-item SLO slack + chunking;
               background apps yield. BEYOND-PAPER (§5.2's ask).
  weighted_fair — BEYOND-PAPER: weighted fair queueing by cumulative
               normalized service time per app; backgrounds get a small
               weight instead of strict demotion, so no app starves even
               without SLO hints.
  preemptive_priority — strict priority classes (explicit per-app levels,
               else background demoted one class) with chunk-boundary
               preemption simulator-side and class-ordered slot admission
               engine-side (ROADMAP follow-on).
  deficit_round_robin (alias: drr) — BEYOND-PAPER: per-app TOKEN deficits
               (Shreedhar–Varghese DRR); one quantum of tokens per app per
               round on both substrates, no SLO hints or weights needed
               (ROADMAP follow-on).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterable, Optional, Union

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.serving.request import Request

_REGISTRY: dict[str, type["SchedulingPolicy"]] = {}

BACKGROUND_DEMOTION_S = 1e6   # priority offset pushing background work last


# ------------------------------------------------------------ partitioning
@dataclass
class PartitionPlan:
    """Structured partition/placement decision (the redesigned
    ``SchedulingPolicy.partition`` return type).

    The old API returned a raw ``(app -> partition, partition -> chips)``
    tuple, which could not express replica counts, weights, or any future
    placement hints — the router tier needs all three. ``PartitionPlan``
    stays tuple-unpackable (``part_of, chips_of = plan``) so legacy callers
    and tests keep working while they migrate.

    ``replicas`` asks the router tier to front each partition with N engine
    replicas (the partition's chips split across them); 1 keeps the
    single-engine-per-partition behaviour bit-identical to the old API.
    """
    apps: dict[str, str]                       # app name -> partition key
    chips: dict[str, int]                      # partition key -> chip count
    weights: dict[str, float] = field(default_factory=dict)
    replicas: int = 1

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"PartitionPlan.replicas must be >= 1, "
                             f"got {self.replicas}")
        missing = sorted(set(self.apps.values()) - set(self.chips))
        if missing:
            raise ValueError(f"PartitionPlan maps app(s) onto unknown "
                             f"partition(s) {missing}")

    def __iter__(self):
        # back-compat: the legacy tuple order, (partition_of, chips_of)
        yield self.apps
        yield self.chips

    def partition_for(self, app: str) -> str:
        return self.apps[app]


_TUPLE_PARTITION_WARNED = False


def resolve_partition(policy: "SchedulingPolicy",
                      traces: Iterable["AppTrace"], total_chips: int, *,
                      replicas: int = 1) -> PartitionPlan:
    """Call ``policy.partition`` and normalize the result to a
    :class:`PartitionPlan` — the ONE entry point both substrates use.

    Legacy policies that still return the raw ``(dict, dict)`` tuple are
    adapted with a one-per-process :class:`DeprecationWarning`. A
    ``replicas`` override > 1 is applied to plans that did not set their
    own replica count (a policy that explicitly plans replicas wins)."""
    plan = policy.partition(traces, total_chips)
    if not isinstance(plan, PartitionPlan):
        global _TUPLE_PARTITION_WARNED
        if not _TUPLE_PARTITION_WARNED:
            _TUPLE_PARTITION_WARNED = True
            warnings.warn(
                f"{type(policy).__name__}.partition returned the legacy "
                "(partition_of, chips_of) tuple; return a PartitionPlan "
                "instead (the tuple form is deprecated and cannot express "
                "replicas or weights)",
                DeprecationWarning, stacklevel=2)
        part_of, chips_of = plan
        plan = PartitionPlan(apps=dict(part_of), chips=dict(chips_of))
    if replicas > 1 and plan.replicas == 1:
        plan = dataclasses.replace(plan, replicas=replicas)
    return plan


def register_policy(*names: str):
    """Class decorator registering a policy under one or more names (the
    first name is canonical and becomes ``cls.name``)."""
    if not names:
        raise ValueError("register_policy needs at least one name")

    def deco(cls: type["SchedulingPolicy"]):
        for n in names:
            if n in _REGISTRY:
                raise ValueError(f"scheduling policy {n!r} already "
                                 f"registered ({_REGISTRY[n].__name__})")
            _REGISTRY[n] = cls
        cls.name = names[0]
        return cls
    return deco


def get_policy(policy: Union[str, "SchedulingPolicy"]) -> "SchedulingPolicy":
    """Resolve a registry name (fresh instance) or pass an instance through."""
    if isinstance(policy, SchedulingPolicy):
        return policy
    try:
        cls = _REGISTRY[policy]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {policy!r}; available: "
            f"{', '.join(available_policies())}") from None
    return cls()


def available_policies() -> list[str]:
    return sorted(_REGISTRY)


class SchedulingPolicy:
    """Base policy: shared pool, FIFO, no chunking on either substrate
    (simulator items run whole; engine prefill advances whole-prompt).

    Subclasses override only the hooks they care about. Policies may hold
    per-run state (see :class:`WeightedFairPolicy`); the simulator calls
    :meth:`reset` once at the start of every run.
    """

    name = "base"
    #: engine: prefill consumes the whole engine step (no decode interleave)
    exclusive_prefill = False

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        """Clear per-run state. Called once per ``PodSimulator.run``."""

    # ------------------------------------------------- simulator-side hooks
    def partition(self, traces: Iterable["AppTrace"],
                  total_chips: int) -> PartitionPlan:
        """Placement decision: app -> partition, partition -> chips (and
        optionally weights/replicas) as a :class:`PartitionPlan`.
        Default: every app shares one pool of all chips. Returning the
        legacy ``(partition_of, chips_of)`` tuple still works through
        :func:`resolve_partition` but is deprecated."""
        traces = list(traces)
        return PartitionPlan(apps={t.name: "__shared__" for t in traces},
                             chips={"__shared__": total_chips})

    def priority(self, trace: "AppTrace", req: "SimRequest",
                 item: "WorkItem", now: float) -> float:
        """Queue key for a ready work item — smaller runs first.
        Default: FIFO by ready time."""
        return now

    def chunk_fraction(self, item: "WorkItem", full_dur: float,
                       frac: float, chunk_target_s: float) -> float:
        """Fraction of ``item`` to run now given ``frac`` remains.
        Default: run everything that is left (no chunk splitting)."""
        return frac

    def on_dispatch(self, trace: "AppTrace", req: "SimRequest",
                    item: "WorkItem", start: float, end: float,
                    chips: int) -> None:
        """Observe a dispatched (chunk of a) work item — state hook."""

    # ---------------------------------------------------- engine-side hooks
    def admit_order(self, ready: list["Request"],
                    now: float) -> list["Request"]:
        """Order in which ready requests claim free decode slots.
        Default: FIFO by arrival."""
        return sorted(ready, key=lambda r: r.arrival_s)

    def prefill_chunk_tokens(self, default_chunk: int) -> Optional[int]:
        """Tokens of prefill to advance per engine step; None = whole
        prompt at once (mirrors the simulator's no-chunking default —
        :class:`ChunkedPolicy` and descendants opt into chunking)."""
        return None

    def step_budget(self, default_chunk: int, prefilling: int,
                    decoding: int) -> Optional[tuple[int, int]]:
        """Per-step token budget split for STALL-FREE MIXED BATCHING
        (Sarathi-style): return ``(prefill_tokens, decode_tokens)`` and the
        engine makes EVERY step a mixed batch — up to ``prefill_tokens`` of
        prefill spread over the mid-prefill slots (one multi-slot batched
        dispatch where the family allows), then one decode step for all
        ready rows. ``prefilling`` / ``decoding`` are the current counts of
        mid-prefill and decode-ready slots. ``None`` (the default) keeps
        the legacy step path — prefill phase first, decode only when the
        policy is not ``exclusive_prefill`` — byte-for-byte. The simulator
        mirrors the same split analytically (``batching`` summary block);
        only :class:`MixedBatchPolicy` opts in out of the box."""
        return None

    def on_admit(self, req: "Request") -> None:
        """Observe a request actually claiming a decode slot — the
        engine-side state hook (mirror of the simulator's
        :meth:`on_dispatch`; deficit/fair-queueing policies charge here)."""

    # ------------------------------------------------- degradation hook
    def shed_decision(self, app: str, req, attainment: float,
                      cfg, now: float) -> str:
        """Graceful-degradation triage (repro.resilience), consulted by
        BOTH substrates at admission time once the app's rolling SLO
        attainment has crossed ``cfg.attainment`` (a
        :class:`~repro.resilience.ShedConfig`). Return ``"shed"`` to drop
        the request, ``"downgrade"`` to demote it to background priority,
        or ``"admit"`` to wave it through anyway. The default honours the
        scenario's configured action; policies override for smarter
        triage (e.g. shed only background apps)."""
        return cfg.action

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}(name={self.name!r})"


@register_policy("greedy", "fcfs")
class GreedyPolicy(SchedulingPolicy):
    """Step-level FCFS over one shared pool; engine-side whole-prompt
    prefill that stalls every active decode (paper's LiveCaptions
    starvation, §4.2)."""

    exclusive_prefill = True

    def prefill_chunk_tokens(self, default_chunk: int) -> Optional[int]:
        return None


@register_policy("chunked")
class ChunkedPolicy(SchedulingPolicy):
    """FIFO admission with chunked prefill: chunkable items are split at
    ``chunk_target_s`` boundaries so urgent short work can jump in."""

    def chunk_fraction(self, item: "WorkItem", full_dur: float,
                       frac: float, chunk_target_s: float) -> float:
        if item.chunkable and full_dur * frac > chunk_target_s:
            return min(frac, chunk_target_s / full_dur)
        return frac

    def prefill_chunk_tokens(self, default_chunk: int) -> Optional[int]:
        return default_chunk


@register_policy("mixed")
class MixedBatchPolicy(ChunkedPolicy):
    """Stall-free mixed batching (Sarathi-style): every engine step carries
    a fixed TOKEN budget split between prefill and decode, so decode rows
    advance every step — no decode stall while a long prompt prefills —
    while prefill throughput is bounded, not starved.

    ``step_tokens``: total token budget per step (default ``2 *
    prefill_chunk``: the legacy chunk of prefill plus a decode token per
    slot at typical slot counts). ``prefill_share``: fraction of the budget
    given to prefill (0..1); the decode side always covers every
    decode-ready row (decode is one batched token per row — starving it
    saves almost nothing and costs TPOT, the whole point of the policy).
    Chunk-level behaviour (admission order, simulator ``chunk_fraction``)
    is inherited from :class:`ChunkedPolicy`, so the analytic substrate
    chunks work at the same boundaries the engine steps at.
    """

    def __init__(self, step_tokens: Optional[int] = None,
                 prefill_share: float = 0.5):
        if not 0.0 <= prefill_share <= 1.0:
            raise ValueError(f"prefill_share must be in [0, 1], "
                             f"got {prefill_share}")
        self.step_tokens = step_tokens
        self.prefill_share = prefill_share

    def step_budget(self, default_chunk: int, prefilling: int,
                    decoding: int) -> Optional[tuple[int, int]]:
        total = self.step_tokens or 2 * default_chunk
        prefill_tokens = int(round(total * self.prefill_share))
        # at least one prefill token whenever prefill work exists —
        # prefill_share=0 throttles prefill, it must not deadlock it
        prefill_tokens = max(prefill_tokens, 1) if prefilling else 0
        return prefill_tokens, decoding


@register_policy("static")
class StaticPartitionPolicy(SchedulingPolicy):
    """Chips split among apps at start (≙ MPS 33%); per-partition FIFO
    queues; idle partitions stay idle (paper Fig. 5a right).

    ``weights`` makes the split heterogeneous: each app's chip count is
    proportional to its weight (default 1.0), rounded down with every
    partition keeping at least one chip; leftover chips go to the largest
    fractional remainders (largest-remainder apportionment, ties by trace
    order). ``StaticPartitionPolicy(weights={"chat": 3})`` gives chat 3×
    the chips of each unweighted app."""

    def __init__(self, weights: Optional[dict[str, float]] = None):
        self.weights = dict(weights or {})

    def partition(self, traces: Iterable["AppTrace"],
                  total_chips: int) -> PartitionPlan:
        traces = list(traces)
        if not traces:
            return PartitionPlan(apps={}, chips={})
        part = {t.name: t.name for t in traces}
        if not self.weights:
            # unweighted: the historical equal split (remainder chips idle
            # — pinned by the Fig. 5 seed-parity numbers)
            per = max(total_chips // len(traces), 1)
            return PartitionPlan(apps=part,
                                 chips={t.name: per for t in traces})
        w = {t.name: float(self.weights.get(t.name, 1.0)) for t in traces}
        if any(v <= 0 for v in w.values()):
            raise ValueError("static partition weights must be positive")
        total_w = sum(w.values())
        share = {n: total_chips * v / total_w for n, v in w.items()}
        chips = {n: max(int(s), 1) for n, s in share.items()}
        # the at-least-one-chip floor can oversubscribe a tiny pod: shave
        # the largest partitions back until the split fits
        while sum(chips.values()) > total_chips:
            n = max(chips, key=lambda x: chips[x])
            if chips[n] == 1:
                break
            chips[n] -= 1
        left = total_chips - sum(chips.values())
        if left > 0:
            # largest fractional remainder first; stable for ties
            order = sorted(w, key=lambda n: share[n] - int(share[n]),
                           reverse=True)
            for i in range(left):
                chips[order[i % len(order)]] += 1
        return PartitionPlan(apps=part, chips=chips, weights=w)


@register_policy("slo_aware")
class SloAwarePolicy(ChunkedPolicy):
    """Work-conserving earliest-deadline-first by per-item SLO slack, with
    chunked prefill; background apps are demoted behind everything else.
    BEYOND-PAPER (the scheduler §5.2 calls for)."""

    def priority(self, trace: "AppTrace", req: "SimRequest",
                 item: "WorkItem", now: float) -> float:
        if req.background or trace.background:
            return BACKGROUND_DEMOTION_S + now
        # EDF with per-item slack measured from readiness
        return now + getattr(item, "slo_hint_s", req.deadline_hint_s)

    def admit_order(self, ready: list["Request"],
                    now: float) -> list["Request"]:
        return sorted(ready, key=lambda r: (
            r.deadline_s if r.deadline_s is not None else float("inf"),
            r.arrival_s))


@register_policy("preemptive_priority")
class PreemptivePriorityPolicy(ChunkedPolicy):
    """Strict priority classes with chunk-boundary preemption.

    Each app maps to an integer *level* (0 = most urgent): explicit levels
    win, otherwise background apps land one class below foreground. On the
    simulator the level dominates the queue key while chunked splitting
    (inherited from :class:`ChunkedPolicy`) bounds how long a low-priority
    chunk can delay a high-priority arrival — preemption at chunk
    boundaries. On the engine, slot admission is ordered by
    ``Request.priority`` then arrival; chunked prefill provides the same
    bounded-delay interleaving (running decodes are never revoked)."""

    def __init__(self, levels: Optional[dict[str, int]] = None,
                 background_level: int = 1):
        self.levels = dict(levels or {})
        self.background_level = background_level

    def level_for(self, name: str, background: bool) -> int:
        lv = self.levels.get(name)
        if lv is not None:
            return lv
        return self.background_level if background else 0

    def priority(self, trace: "AppTrace", req: "SimRequest",
                 item: "WorkItem", now: float) -> float:
        lv = self.level_for(req.app, req.background or trace.background)
        return lv * BACKGROUND_DEMOTION_S + now

    def admit_order(self, ready: list["Request"],
                    now: float) -> list["Request"]:
        return sorted(ready, key=lambda r: (getattr(r, "priority", 0),
                                            r.arrival_s))


@register_policy("deficit_round_robin", "drr")
class DeficitRoundRobinPolicy(SchedulingPolicy):
    """BEYOND-PAPER: deficit round robin over apps, in TOKENS.

    Each app carries a token deficit replenished by ``quantum_tokens`` per
    round; serving work charges its token count against the deficit, and
    an app that overdraws advances to a later round. The queue key is the
    app's current round (then ready time), so every app gets roughly one
    quantum of tokens per round regardless of how bursty or token-hungry
    its requests are — O(1) fairness without SLO hints or weights (the
    classic Shreedhar–Varghese scheduler, applied to tokens).

    Both substrates consume the same deficit state: the simulator charges
    each dispatched work item (``on_dispatch``), the engine charges a
    request's whole token demand when admission ordering consults it
    (``admit_order``) — slot admission is the engine's scheduling decision
    point, mirroring ``priority`` being the simulator's."""

    def __init__(self, quantum_tokens: int = 256,
                 background_rounds: int = 4):
        self.quantum_tokens = quantum_tokens
        #: background apps replenish every Nth round: strict-ish demotion
        #: without starvation
        self.background_rounds = background_rounds
        self._round: dict[str, int] = {}
        self._deficit: dict[str, float] = {}

    def reset(self) -> None:
        self._round = {}
        self._deficit = {}

    def _charge(self, app: str, tokens: float, background: bool) -> None:
        """Spend ``tokens`` of the app's deficit, rolling into later rounds
        (background apps pay ``background_rounds`` rounds per quantum)."""
        per_round = self.quantum_tokens / (self.background_rounds
                                           if background else 1)
        d = self._deficit.get(app, per_round) - max(tokens, 1.0)
        while d < 0:
            self._round[app] = self._round.get(app, 0) + 1
            d += per_round
        self._deficit[app] = d

    def _item_tokens(self, item: "WorkItem") -> float:
        return float(getattr(item, "tokens", 0) or 1)

    # simulator: round dominates the queue key; dispatch charges the item
    def priority(self, trace: "AppTrace", req: "SimRequest",
                 item: "WorkItem", now: float) -> float:
        return self._round.get(req.app, 0) * BACKGROUND_DEMOTION_S + now

    def on_dispatch(self, trace: "AppTrace", req: "SimRequest",
                    item: "WorkItem", start: float, end: float,
                    chips: int) -> None:
        self._charge(req.app, self._item_tokens(item),
                     req.background or trace.background)

    # engine: round-ordered slot admission; actual admission charges the
    # request's whole token demand (the engine's scheduling decision point)
    def admit_order(self, ready: list["Request"],
                    now: float) -> list["Request"]:
        return sorted(
            ready, key=lambda r: (self._round.get(r.app, 0), r.arrival_s))

    def on_admit(self, req: "Request") -> None:
        if req.tokens_out:
            return   # preempt-to-evict re-admission: demand already charged
        self._charge(req.app, len(req.prompt) + req.max_new_tokens,
                     getattr(req, "priority", 0) > 0)

    def prefill_chunk_tokens(self, default_chunk: int) -> Optional[int]:
        return default_chunk    # chunked prefill: rounds stay responsive


@register_policy("weighted_fair")
class WeightedFairPolicy(ChunkedPolicy):
    """BEYOND-PAPER: weighted fair queueing. Each app accumulates virtual
    service time (busy seconds / weight); the app with the least virtual
    time runs next. So that a burst of simultaneous arrivals from one app
    doesn't all enqueue at the same virtual time (which would degrade to
    FIFO head-of-line blocking), each queued-but-unserved item additionally
    charges its app one virtual quantum — bursts from different apps
    interleave. Background apps default to a small weight — they make
    progress whenever foreground apps are idle, but can never starve the
    pod, and no SLO hints are required (contrast ``slo_aware``)."""

    def __init__(self, weights: Optional[dict[str, float]] = None,
                 default_weight: float = 1.0,
                 background_weight: float = 0.1,
                 backlog_quantum_s: float = 1.0):
        self.weights = dict(weights or {})
        self.default_weight = default_weight
        self.background_weight = background_weight
        self.backlog_quantum_s = backlog_quantum_s
        self._vtime: dict[str, float] = {}
        self._backlog: dict[str, int] = {}

    def reset(self) -> None:
        self._vtime = {}
        self._backlog = {}

    def _weight(self, trace: "AppTrace") -> float:
        w = self.weights.get(trace.name)
        if w is not None:
            return max(w, 1e-9)
        if trace.background:
            return self.background_weight
        return self.default_weight

    def priority(self, trace: "AppTrace", req: "SimRequest",
                 item: "WorkItem", now: float) -> float:
        backlog = self._backlog.get(req.app, 0)
        self._backlog[req.app] = backlog + 1
        return (self._vtime.get(req.app, 0.0)
                + backlog * self.backlog_quantum_s / self._weight(trace))

    def on_dispatch(self, trace: "AppTrace", req: "SimRequest",
                    item: "WorkItem", start: float, end: float,
                    chips: int) -> None:
        self._backlog[req.app] = max(self._backlog.get(req.app, 0) - 1, 0)
        self._vtime[req.app] = (self._vtime.get(req.app, 0.0)
                                + (end - start) / self._weight(trace))
