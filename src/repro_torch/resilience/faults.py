# Copy of src/repro/resilience/faults.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Declarative fault injection shared by BOTH execution substrates.

ConsumerBench's end-user devices are not clean rooms: clocks derate under
thermal load, co-tenant apps steal memory, engines stall or crash, and
clients give up on slow requests. This module turns those conditions into
a seeded, reproducible benchmark axis: a ``faults:`` list in the Scenario
YAML builds one :class:`FaultSchedule`, and the SAME schedule drives the
analytic pod simulator and the real inference engine's virtual cost clock.

Fault kinds (the registry; ``make_fault`` resolves YAML dicts):

``thermal_throttle``
    Time-varying clock/bandwidth derating: work dispatched inside the
    window takes ``1/derate`` times its nominal duration. ``period_s``
    repeats the window indefinitely (duty-cycled throttling).
``memory_spike``
    An external "app" steals a fraction of the KV page pool for the
    window: the simulator shrinks its analytic token budget (forcing live
    eviction), the engine reserves pages out of its
    :class:`~repro_torch.serving.block_allocator.BlockAllocator` — never pages
    with refcount > 1 (shared prefixes are structurally safe).
``engine_stall``
    A partition makes no progress for the window (speed 0 in the shared
    time integrator). ``crash: true`` additionally loses in-flight state
    at window start: every running request restarts from scratch on
    recovery (token-identical replay on the engine substrate).
``client_timeout``
    Client-side per-attempt timeouts with capped exponential backoff
    (``min(backoff_base_s * 2**attempt, backoff_cap_s)``) and an optional
    absolute deadline after which the request is cancelled outright.

Parity by construction: both substrates route every work duration through
:meth:`FaultSchedule.advance` — a piecewise-constant speed integrator over
the same resolved windows — so thermal and stall effects cannot drift
between the analytic and the real engine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields
from typing import Optional, Union

import numpy as np


class FaultSpecError(ValueError):
    """A fault spec names an unknown kind or carries unknown keys."""


_REGISTRY: dict[str, type] = {}


def register_fault(kind: str):
    def deco(cls):
        if kind in _REGISTRY:
            raise ValueError(f"fault kind {kind!r} already registered")
        _REGISTRY[kind] = cls
        cls.kind = kind
        return cls
    return deco


def available_faults() -> list[str]:
    return sorted(_REGISTRY)


def make_fault(spec: Union[dict, "FaultSpec"]) -> "FaultSpec":
    """Resolve a YAML dict (``{"kind": ..., ...}``) into a FaultSpec."""
    if isinstance(spec, FaultSpec):
        return spec
    if not isinstance(spec, dict):
        raise FaultSpecError(f"fault spec must be a mapping, got {spec!r}")
    d = dict(spec)
    kind = d.pop("kind", None)
    cls = _REGISTRY.get(kind)
    if cls is None:
        raise FaultSpecError(
            f"unknown fault kind {kind!r}; available: "
            f"{', '.join(available_faults())}")
    valid = {f.name for f in fields(cls)}
    unknown = sorted(set(d) - valid)
    if unknown:
        raise FaultSpecError(
            f"unknown key(s) {unknown} for fault {kind!r}; valid keys: "
            f"{sorted(valid)}")
    return cls(**d)


@dataclass(frozen=True)
class FaultSpec:
    kind = "base"

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        for f in fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                d[f.name] = v
        return d


@register_fault("thermal_throttle")
@dataclass(frozen=True)
class ThermalThrottle(FaultSpec):
    """Clock/bandwidth derating: speed *= ``derate`` inside the window."""
    start_s: float = 0.0
    duration_s: float = 10.0
    derate: float = 0.5          # speed multiplier in (0, 1]
    period_s: float = 0.0        # > 0: the window repeats every period_s

    def __post_init__(self):
        if not 0.0 < self.derate <= 1.0:
            raise FaultSpecError(
                f"thermal_throttle derate must be in (0, 1], got "
                f"{self.derate}")
        if self.period_s and self.period_s < self.duration_s:
            raise FaultSpecError(
                "thermal_throttle period_s must be >= duration_s")


@register_fault("memory_spike")
@dataclass(frozen=True)
class MemorySpike(FaultSpec):
    """An external app holds ``steal_fraction`` of the KV pool."""
    start_s: float = 0.0
    duration_s: float = 10.0
    steal_fraction: float = 0.5
    start_jitter_s: float = 0.0   # seeded uniform start offset

    def __post_init__(self):
        if not 0.0 < self.steal_fraction < 1.0:
            raise FaultSpecError(
                f"memory_spike steal_fraction must be in (0, 1), got "
                f"{self.steal_fraction}")


@register_fault("engine_stall")
@dataclass(frozen=True)
class EngineStall(FaultSpec):
    """A partition freezes for the window; ``crash`` loses in-flight state."""
    start_s: float = 0.0
    duration_s: float = 5.0
    partition: str = ""           # app or partition key; "" = all partitions
    crash: bool = False
    start_jitter_s: float = 0.0


@register_fault("client_timeout")
@dataclass(frozen=True)
class ClientTimeout(FaultSpec):
    """Per-attempt client timeout with capped exponential-backoff retries."""
    timeout_s: float = 30.0
    max_retries: int = 2
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 4.0
    deadline_s: float = 0.0       # absolute cap from first issue; 0 = none
    apps: tuple = ()              # restrict to these app names; () = all

    def __post_init__(self):
        object.__setattr__(self, "apps", tuple(self.apps))

    def backoff_s(self, attempt: int) -> float:
        """Backoff before re-issue number ``attempt`` (1-based)."""
        return min(self.backoff_base_s * (2.0 ** (attempt - 1)),
                   self.backoff_cap_s)

    def applies_to(self, app: str) -> bool:
        return not self.apps or app in self.apps

    def to_dict(self) -> dict:
        d = super().to_dict()
        if "apps" in d:
            d["apps"] = list(d["apps"])
        return d


# ------------------------------------------------------------------ windows
@dataclass(frozen=True)
class StallWindow:
    t0: float
    t1: float
    partition: Optional[str]      # resolved partition key; None = all
    crash: bool

    def matches(self, partition: Optional[str]) -> bool:
        return self.partition is None or self.partition == partition


@dataclass(frozen=True)
class SpikeWindow:
    t0: float
    t1: float
    steal_fraction: float


class FaultSchedule:
    """The resolved, seeded schedule one run executes against.

    Construction resolves every stochastic choice (start jitters) from the
    provided generator, so the same ``(specs, rng)`` pair always yields the
    same windows on both substrates. ``bind_partitions`` maps app-named
    stalls onto the policy's partition keys before the run starts.
    """

    def __init__(self, specs: list, *,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(0)
        self.specs = [make_fault(s) for s in specs]
        self.thermal: list[ThermalThrottle] = []
        self.client: Optional[ClientTimeout] = None
        self._stall_specs: list[tuple[EngineStall, float]] = []
        self.spikes: list[SpikeWindow] = []
        # jitters draw in declaration order: deterministic under the rng
        for spec in self.specs:
            if isinstance(spec, ThermalThrottle):
                self.thermal.append(spec)
            elif isinstance(spec, MemorySpike):
                t0 = spec.start_s
                if spec.start_jitter_s > 0:
                    t0 += float(rng.uniform(0.0, spec.start_jitter_s))
                self.spikes.append(SpikeWindow(t0, t0 + spec.duration_s,
                                               spec.steal_fraction))
            elif isinstance(spec, EngineStall):
                t0 = spec.start_s
                if spec.start_jitter_s > 0:
                    t0 += float(rng.uniform(0.0, spec.start_jitter_s))
                self._stall_specs.append((spec, t0))
            elif isinstance(spec, ClientTimeout):
                if self.client is not None:
                    raise FaultSpecError(
                        "at most one client_timeout fault per scenario")
                self.client = spec
        self.stalls: list[StallWindow] = [
            StallWindow(t0, t0 + s.duration_s, s.partition or None, s.crash)
            for s, t0 in self._stall_specs]

    # ------------------------------------------------------------- binding
    def bind_partitions(self, partition_of: dict) -> None:
        """Resolve app-named stall partitions to the policy's partition
        keys (an unknown name is taken to BE a partition key)."""
        self.stalls = [
            StallWindow(w.t0, w.t1,
                        (partition_of.get(w.partition, w.partition)
                         if w.partition is not None else None),
                        w.crash)
            for w in self.stalls]

    # ----------------------------------------------------------- integrator
    def _speed_and_edge(self, t: float,
                        partition: Optional[str]) -> tuple[float, float]:
        """(speed multiplier at ``t``, next window edge after ``t``)."""
        speed, edge = 1.0, math.inf
        for w in self.stalls:
            if w.matches(partition):
                if w.t0 <= t < w.t1:
                    speed = 0.0
                    edge = min(edge, w.t1)
                elif t < w.t0:
                    edge = min(edge, w.t0)
        for th in self.thermal:
            if th.period_s > 0:
                if t < th.start_s:
                    edge = min(edge, th.start_s)
                    continue
                phase = (t - th.start_s) % th.period_s
                if phase < th.duration_s:
                    speed *= th.derate
                    edge = min(edge, t + (th.duration_s - phase))
                else:
                    edge = min(edge, t + (th.period_s - phase))
            else:
                if th.start_s <= t < th.start_s + th.duration_s:
                    speed *= th.derate
                    edge = min(edge, th.start_s + th.duration_s)
                elif t < th.start_s:
                    edge = min(edge, th.start_s)
        return speed, edge

    def advance(self, t0: float, nominal_s: float,
                partition: Optional[str] = None) -> float:
        """Finish time of ``nominal_s`` seconds of work starting at ``t0``
        under the schedule's piecewise-constant speed curve — the ONE
        time-integration both substrates share (simulator dispatch end
        times; engine virtual-clock advance)."""
        t, left = t0, nominal_s
        while left > 1e-15:
            speed, edge = self._speed_and_edge(t, partition)
            if speed <= 0.0:
                t = edge                   # frozen through the stall window
                continue
            if edge == math.inf or t + left / speed <= edge + 1e-15:
                return t + left / speed
            left -= (edge - t) * speed
            t = edge
        return t

    def time_warp(self, partition: Optional[str] = None):
        """``(t0, nominal_s) -> t1`` closure for the engine's virtual
        clock (``InferenceEngine(time_warp=...)``)."""
        if not self.stalls and not self.thermal:
            return None
        return lambda t0, nominal_s: self.advance(t0, nominal_s, partition)

    # ------------------------------------------------------------- queries
    def steal_tokens_at(self, t: float, budget_tokens: int) -> int:
        """Tokens of a ``budget_tokens`` pool held by spikes active at t."""
        steal = 0
        for sp in self.spikes:
            if sp.t0 <= t < sp.t1:
                steal += int(sp.steal_fraction * budget_tokens)
        return min(steal, budget_tokens)

    def injected_count(self) -> int:
        """Scheduled fault windows (a periodic throttle counts once; the
        client-timeout policy counts once) — identical on both substrates
        by construction."""
        return (len(self.thermal) + len(self.stalls) + len(self.spikes)
                + (1 if self.client is not None else 0))

    # ----------------------------------------------------------- telemetry
    def emit(self, recorder) -> None:
        """One ``fault`` span per resolved window (chips=0: fault spans
        never count as chip-occupying work in the derived timelines)."""
        if recorder is None:
            return
        i = 0
        for th in self.thermal:
            recorder.span("fault", "__faults__", i, th.start_s,
                          th.start_s + th.duration_s,
                          meta={"kind": "thermal_throttle",
                                "derate": th.derate,
                                "period_s": th.period_s})
            i += 1
        for w in self.stalls:
            recorder.span("fault", "__faults__", i, w.t0, w.t1,
                          meta={"kind": "engine_stall", "crash": w.crash,
                                "partition": w.partition or ""})
            i += 1
        for sp in self.spikes:
            recorder.span("fault", "__faults__", i, sp.t0, sp.t1,
                          meta={"kind": "memory_spike",
                                "steal_fraction": sp.steal_fraction})
            i += 1


# ------------------------------------------------------------------- stats
@dataclass
class FaultStats:
    """Per-run resilience counters — the schema-1.5 ``faults`` block.

    The block is ALWAYS present (zero-filled without faults) so result
    documents stay schema-identical across substrates and scenarios;
    ``goodput`` is SLO-meeting completions over requests ISSUED — shed,
    cancelled, and timed-out-then-failed requests all stay in the
    denominator, which is exactly how degradation policies must be scored.
    """
    injected: int = 0
    retries: int = 0
    timeouts: int = 0
    cancels: int = 0
    sheds: int = 0
    downgrades: int = 0
    replays: int = 0              # in-flight requests replayed after a crash
    issued: int = 0
    time_to_recover_s: float = 0.0

    def block(self, slo_ok: int, total_records: int) -> dict:
        denom = max(self.issued, total_records, 1)
        return {
            "injected": self.injected,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "cancels": self.cancels,
            "sheds": self.sheds,
            "downgrades": self.downgrades,
            "replays": self.replays,
            "issued": max(self.issued, total_records),
            "completed_ok": slo_ok,
            "goodput": slo_ok / denom,
            "time_to_recover_s": self.time_to_recover_s,
        }


def time_to_recover(stalls: list[StallWindow], finish_of) -> float:
    """Post-hoc recovery metric, identical on both substrates: for each
    stall window, the latest finish among requests in flight at window
    start, minus the window end (clamped at 0); the metric is the max over
    windows. ``finish_of(window) -> iterable of (arrival_s, finish_s)``
    yields the candidate requests for that window's partition."""
    ttr = 0.0
    for w in stalls:
        fins = [fin for arr, fin in finish_of(w)
                if arr <= w.t0 < fin]
        if fins:
            ttr = max(ttr, max(max(fins) - w.t1, 0.0))
    return ttr
