# Copy of src/repro/serving/router.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Router tier: N engine replicas per partition behind a pluggable
routing policy.

``SchedulingPolicy.partition`` (now returning a :class:`PartitionPlan`)
decides how apps map onto chip partitions; the :class:`Router` decides
which of a partition's ``replicas`` serves each individual request. The
policy registry mirrors the scheduling-policy registry in
``bench/policy.py`` — string names in YAML (``routing: prefix_aware``),
``@register_routing_policy`` for out-of-tree policies.

Both substrates drive the SAME Router object shape: the analytic
simulator probes its flat prefix mirror, the engine runner probes each
replica's radix :class:`~repro_torch.serving.prefix_cache.PrefixCache` via
``InferenceEngine.prefix_peek``; routed/affinity counts and the
per-replica load distribution land in the schema-1.6 ``routing`` result
block either way.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Optional, Union

if TYPE_CHECKING:  # pragma: no cover - typing only
    import numpy as np

    from repro_torch.bench.policy import PartitionPlan
    from repro_torch.telemetry.recorder import TraceRecorder

_ROUTING_REGISTRY: dict[str, type["RoutingPolicy"]] = {}


def register_routing_policy(*names: str):
    """Class decorator registering a RoutingPolicy under YAML name(s)."""
    def deco(cls):
        for name in names:
            key = name.lower()
            if key in _ROUTING_REGISTRY:
                raise ValueError(f"routing policy {key!r} already registered "
                                 f"by {_ROUTING_REGISTRY[key].__name__}")
            _ROUTING_REGISTRY[key] = cls
        cls.names = tuple(n.lower() for n in names)
        return cls
    return deco


def get_routing_policy(name: str) -> "RoutingPolicy":
    key = str(name).lower()
    if key not in _ROUTING_REGISTRY:
        raise KeyError(f"unknown routing policy {name!r}; available: "
                       f"{', '.join(available_routing_policies())}")
    return _ROUTING_REGISTRY[key]()


def available_routing_policies() -> list[str]:
    return sorted(_ROUTING_REGISTRY)


# --------------------------------------------------------------- requests
@dataclass
class RouteRequest:
    """Substrate-neutral view of one request at routing time.

    ``tokens`` is the total work volume (prefill + decode tokens) — the
    unit the load-aware policies balance. ``prompt`` carries the literal
    token stream on the engine substrate (for radix-trie probing) and is
    None on the simulator, whose probe closure uses the prefix keys."""
    app: str
    request_id: int
    tokens: int
    session_key: str = ""
    prefix_key: str = ""
    prefix_tokens: int = 0
    prefix_sys_key: str = ""
    prefix_sys_tokens: int = 0
    prompt: Optional[list] = None


@dataclass
class ReplicaView:
    """One replica as the routing policies see it."""
    label: str                 # execution-partition key ("llm#r0", ...)
    index: int                 # position within its partition group
    chips: int
    outstanding_tokens: int = 0
    outstanding_requests: int = 0
    routed: int = 0
    routed_tokens: int = 0
    #: longest-prefix probe: tokens of ``req`` already resident on this
    #: replica (radix trie on the engine, analytic mirror on the sim)
    probe: Optional[Callable[[RouteRequest], int]] = None


# --------------------------------------------------------------- policies
class RoutingPolicy:
    """Base class: pick a replica index for a request within one
    partition group. Stateful policies keep per-group state and must
    clear it in :meth:`reset`."""

    names: tuple = ()

    def __init__(self):
        self.affinity_hits = 0

    def reset(self) -> None:
        self.affinity_hits = 0

    def choose(self, group: str, replicas: list[ReplicaView],
               req: RouteRequest, rng: "np.random.Generator") -> int:
        raise NotImplementedError


@register_routing_policy("round_robin")
class RoundRobinRouting(RoutingPolicy):
    """Cycle through replicas in arrival order, per partition group."""

    def __init__(self):
        super().__init__()
        self._next: dict[str, int] = {}

    def reset(self) -> None:
        super().reset()
        self._next.clear()

    def choose(self, group, replicas, req, rng) -> int:
        i = self._next.get(group, 0) % len(replicas)
        self._next[group] = i + 1
        return i


@register_routing_policy("least_outstanding_tokens", "least_outstanding")
class LeastOutstandingRouting(RoutingPolicy):
    """Send to the replica with the fewest in-flight tokens (JSQ on the
    token dimension; ties break to the lowest index)."""

    def choose(self, group, replicas, req, rng) -> int:
        return min(replicas,
                   key=lambda r: (r.outstanding_tokens, r.index)).index


@register_routing_policy("power_of_two_choices", "p2c")
class PowerOfTwoRouting(RoutingPolicy):
    """Sample two distinct replicas uniformly, keep the less loaded —
    the classic O(1)-state balancer whose max load is exponentially
    better than random (Mitzenmacher)."""

    def choose(self, group, replicas, req, rng) -> int:
        n = len(replicas)
        if n == 1:
            return 0
        i = int(rng.integers(n))
        j = int(rng.integers(n - 1))
        if j >= i:
            j += 1
        a, b = replicas[i], replicas[j]
        if (b.outstanding_tokens, b.index) < (a.outstanding_tokens, a.index):
            return b.index
        return a.index


@register_routing_policy("session_affinity", "sticky")
class SessionAffinityRouting(RoutingPolicy):
    """Pin each session (conversation) to the replica that served its
    first request; new sessions are spread round-robin. Repeat-session
    routes count as affinity hits."""

    def __init__(self):
        super().__init__()
        self._home: dict[tuple, int] = {}
        self._next: dict[str, int] = {}

    def reset(self) -> None:
        super().reset()
        self._home.clear()
        self._next.clear()

    def choose(self, group, replicas, req, rng) -> int:
        key = (group, req.session_key or req.app)
        if key in self._home:
            self.affinity_hits += 1
            return self._home[key] % len(replicas)
        i = self._next.get(group, 0) % len(replicas)
        self._next[group] = i + 1
        self._home[key] = i
        return i


@register_routing_policy("prefix_aware")
class PrefixAwareRouting(RoutingPolicy):
    """Probe every replica's prefix cache and route to the one already
    holding the longest prefix of the request (KV pages it can reuse);
    ties and cold requests fall back to least-outstanding-tokens.
    A route with a non-zero best probe counts as an affinity hit."""

    def choose(self, group, replicas, req, rng) -> int:
        best, best_hit = None, 0
        for r in replicas:
            hit = r.probe(req) if r.probe is not None else 0
            # prefer more resident tokens, then lighter load, then index
            if best is None or (-hit, r.outstanding_tokens, r.index) < \
                    (-best_hit, best.outstanding_tokens, best.index):
                best, best_hit = r, hit
        if best_hit > 0:
            self.affinity_hits += 1
        return best.index


# ----------------------------------------------------------------- router
def replica_labels(base: str, replicas: int) -> list[str]:
    """Execution-partition keys for ``replicas`` copies of partition
    ``base``. With one replica the base key is reused verbatim so the
    single-replica path is bit-identical to the pre-router schema."""
    if replicas <= 1:
        return [base]
    return [f"{base}#r{i}" for i in range(replicas)]


def split_chips(chips: int, replicas: int) -> list[int]:
    """Split a partition's chips across replicas: floor share each, the
    remainder to the first replicas, every replica at least 1 chip."""
    if replicas <= 1:
        return [chips]
    base, rem = divmod(max(chips, 0), replicas)
    return [max(1, base + (1 if i < rem else 0)) for i in range(replicas)]


def empty_routing_block() -> dict:
    """Schema-1.6 ``routing`` block for runs without a router — always
    present so downstream diffing never branches on key existence."""
    return {"enabled": False, "policy": "", "replicas": 1, "routed": 0,
            "affinity_hits": 0, "per_replica_load": {}, "imbalance": 0.0}


class Router:
    """Fronts the replica fleet of every partition in a
    :class:`~repro_torch.bench.policy.PartitionPlan`.

    ``route`` picks the serving replica for a request (charging its
    tokens to that replica's outstanding load); ``note_done`` releases
    the load on completion. Both substrates call these at the same
    logical points — request arrival and request completion on the
    shared virtual clock — so a given (policy, seed, workload) triple
    routes identically on the simulator and the engine."""

    def __init__(self, plan: "PartitionPlan",
                 policy: Union[str, RoutingPolicy],
                 rng: Optional["np.random.Generator"] = None,
                 recorder: Optional["TraceRecorder"] = None):
        import numpy as np
        self.plan = plan
        self.policy = (get_routing_policy(policy)
                       if isinstance(policy, str) else policy)
        self.policy.reset()
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.recorder = recorder
        self.groups: dict[str, list[ReplicaView]] = {}
        self.by_label: dict[str, ReplicaView] = {}
        self.base_of: dict[str, str] = {}
        for base, chips in plan.chips.items():
            labels = replica_labels(base, plan.replicas)
            shares = split_chips(chips, plan.replicas)
            views = [ReplicaView(label=lab, index=i, chips=sh)
                     for i, (lab, sh) in enumerate(zip(labels, shares))]
            self.groups[base] = views
            for v in views:
                self.by_label[v.label] = v
                self.base_of[v.label] = base
        self.routed = 0

    @property
    def policy_name(self) -> str:
        return self.policy.names[0] if self.policy.names \
            else type(self.policy).__name__

    def labels_for(self, base: str) -> list[str]:
        return [v.label for v in self.groups[base]]

    def chips_of(self) -> dict[str, int]:
        """Execution-partition key -> chips, over every replica."""
        return {v.label: v.chips for v in self.by_label.values()}

    def set_probe(self, label: str,
                  probe: Callable[[RouteRequest], int]) -> None:
        self.by_label[label].probe = probe

    def route(self, base: str, req: RouteRequest,
              now: float = 0.0) -> str:
        """Pick the replica of partition ``base`` serving ``req``."""
        views = self.groups[base]
        if len(views) == 1:
            idx = 0
        else:
            idx = self.policy.choose(base, views, req, self.rng)
        v = views[idx]
        v.outstanding_tokens += req.tokens
        v.outstanding_requests += 1
        v.routed += 1
        v.routed_tokens += req.tokens
        self.routed += 1
        if self.recorder is not None:
            self.recorder.instant("route", req.app, req.request_id, now,
                                  meta={"replica": v.label})
            self.recorder.counter(f"replica_load@{v.label}", now,
                                  v.outstanding_tokens)
        return v.label

    def note_done(self, label: str, tokens: int,
                  now: float = 0.0) -> None:
        """Release a completed request's load from its replica."""
        v = self.by_label.get(label)
        if v is None:
            return
        v.outstanding_tokens = max(0, v.outstanding_tokens - tokens)
        v.outstanding_requests = max(0, v.outstanding_requests - 1)
        if self.recorder is not None:
            self.recorder.counter(f"replica_load@{label}", now,
                                  v.outstanding_tokens)

    def routing_block(self) -> dict:
        """Schema-1.6 ``routing`` result block."""
        loads = {v.label: v.routed_tokens
                 for v in sorted(self.by_label.values(),
                                 key=lambda v: v.label)}
        vals = list(loads.values())
        imbalance = 0.0
        if len(vals) > 1:
            mean = sum(vals) / len(vals)
            if mean > 0:
                var = sum((x - mean) ** 2 for x in vals) / len(vals)
                imbalance = (var ** 0.5) / mean
        return {
            "enabled": True,
            "policy": self.policy_name,
            "replicas": self.plan.replicas,
            "routed": self.routed,
            "affinity_hits": self.policy.affinity_hits,
            "per_replica_load": loads,
            "imbalance": round(imbalance, 6),
        }
