# Copy of src/repro/bench/scenario.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Declarative scenario API: one schema + one runner for every execution
mode the paper exercises (exclusive §4.1, concurrent §4.2, workflow §4.3).

A :class:`Scenario` names the apps (with arch/SLO/arrival overrides), the
hardware (chip + pod size), the scheduling policy (registry name) and the
mode; ``Scenario.run()`` returns a :class:`ScenarioResult` with a stable,
versioned ``to_json()`` schema. Scenarios round-trip through YAML::

    name: fig5-slo-aware
    mode: concurrent
    policy: slo_aware
    total_chips: 256
    chip: tpu-v5e
    apps:
      - app: chatbot
        num_requests: 10
        slo: {ttft: 1.0, tpot: 0.25}
      - app: live_captions
        num_requests: 50
        arrival: {kind: poisson, rate_per_s: 0.5}

Multi-turn chat sessions (schema 1.4) declare a ``conversation`` shape —
``num_requests`` then counts sessions — and ``prefix_cache: true`` turns
on radix prefix sharing (real trie + copy-on-write on the engine
substrate, the analytic mirror on the simulator)::

    prefix_cache: true
    apps:
      - app: conversation
        num_requests: 4      # concurrent user sessions
        conversation: {turns: 4, system_tokens: 256, user_tokens: 64,
                       assistant_tokens: 64, think_time_s: 2.0}

Workflow mode embeds the existing workflow YAML (paper Fig. 23) under a
``workflow:`` key and honours its DAG dependencies via the same fixed-point
release-time iteration the Orchestrator used. ``Orchestrator`` remains as a
thin deprecated shim over this module.

Every scenario runs on TWO substrates from the same spec (``substrate:``):

* ``simulator`` (default) — the analytic discrete-event pod simulator, and
* ``engine`` — the real continuous-batching :class:`InferenceEngine` under
  a virtual cost clock (``repro_torch.bench.engine_runner``), with ``mode:
  engine`` accepted as shorthand for ``mode: concurrent`` + ``substrate:
  engine``.

Both emit the same versioned ``to_json()`` schema (1.1 adds the
``substrate`` field), so result documents diff across substrates and PRs
(``benchmarks/diff_results.py``).
"""
from __future__ import annotations

import copy
import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional, Union

import yaml

from repro_torch.bench.arrival import ArrivalProcess, make_arrival
from repro_torch.bench.conversation import ConversationSpec, conversation_trace
from repro_torch.bench.policy import (SchedulingPolicy, available_policies,
                                get_policy)
from repro_torch.bench.seeding import child_rng, child_seed
from repro_torch.core.apps import AppDef, DEFAULT_ARCH, app_from_task, make_app
from repro_torch.core.dag import Phase, build_dag
from repro_torch.core.simulator import AppTrace, PodSimulator, SimResult
from repro_torch.core.slo import SLO
from repro_torch.core.workflow import WorkflowSpec, parse_workflow
from repro_torch.resilience import (FaultSchedule, MemorySpike, ShedConfig,
                              make_fault)
from repro_torch.roofline.hw import ChipSpec, get_chip
from repro_torch.serving.router import available_routing_policies

SCHEMA_VERSION = "1.8"   # 1.1: + top-level "substrate", scenario.substrate
                         # 1.2: + per-sim "memory" block (page utilization,
                         #      evictions, recompute) + memory knobs in the
                         #      embedded scenario spec
                         # 1.3: + per-sim "telemetry" block (utilization/
                         #      bandwidth timelines, event counts, Gantt
                         #      spans — repro_torch.telemetry) when the scenario
                         #      sets telemetry: true
                         # 1.4: + per-sim "prefix" block (hit rate, shared
                         #      pages, CoW forks) when the scenario sets
                         #      prefix_cache: true; + "conversation" app
                         #      key (multi-turn sessions) in the spec
                         # 1.5: + per-sim ALWAYS-present "faults" block
                         #      (injected/retries/timeouts/cancels/sheds/
                         #      goodput/time-to-recover); + "faults" and
                         #      "shed_on_slo" scenario keys
                         #      (repro_torch.resilience) — zero-filled and absent
                         #      respectively on fault-free runs
                         # 1.6: + per-sim ALWAYS-present "routing" block
                         #      (policy/replicas/routed/affinity_hits/
                         #      per_replica_load/imbalance — zero-filled
                         #      without a router); + "replicas", "routing"
                         #      and "sweep_replicas" scenario keys
                         #      (the router tier, repro_torch.serving.router)
                         # 1.7: + per-sim ALWAYS-present "batching" block
                         #      (enabled/mixed_steps/steps/prefill_tokens/
                         #      decode_tokens/prefill_share/
                         #      decode_stall_fraction — zero-filled without
                         #      a step-budget policy); + per-app token-
                         #      latency percentiles (ttft_p50/p99,
                         #      tpot_p50/p99, itl_p99) in "apps"
                         # 1.8: + per-sim ALWAYS-present "attribution" block
                         #      (per-request critical-path seconds bucketed
                         #      queue/sched/prefill/decode/recompute/stall/
                         #      fault, per-app blame shares, goodput-under-
                         #      SLO — zero-filled when telemetry is off);
                         #      + always-present host_cpu_pct/host_rss_mb
                         #      series in the "telemetry" block; + the
                         #      "trace_ring" scenario key (bounded-memory
                         #      ring recorder for open-loop runs)
SETUP_S = 2.0      # model load/launch time per app (engine warmup)

MODES = ("exclusive", "concurrent", "workflow")
SUBSTRATES = ("simulator", "engine")
RELEASES = ("request", "node")   # workflow dependency-release granularity


_MODE_ENGINE_WARNED = False


class ScenarioError(ValueError):
    """A scenario spec is malformed — unknown key, unknown registry name
    (policy/arrival/fault), or an invalid fault/shed configuration. Always
    raised at LOAD time with the offending key and the valid options, so a
    YAML typo cannot silently run a different benchmark."""


# --------------------------------------------------------------------- spec
@dataclass
class ScenarioApp:
    """One application instance inside a scenario."""
    app_type: str
    name: str = ""                     # defaults to app_type
    arch: str = ""                     # defaults to DEFAULT_ARCH[app_type]
    num_requests: int = 10
    slo: Optional[SLO] = None          # None = the app type's default SLO
    background: bool = False
    kv_cache_on_host: bool = False
    arrival: Optional[ArrivalProcess] = None   # None = app default cadence
    #: multi-turn session shape (schema 1.4). Set — or use ``app:
    #: conversation`` — and ``num_requests`` counts SESSIONS, each issuing
    #: ``conversation.turns`` requests on the think-time cadence (the
    #: ``arrival`` override is ignored: turn timing is intrinsic).
    conversation: Optional[ConversationSpec] = None

    def __post_init__(self):
        if self.app_type == "conversation" and self.conversation is None:
            self.conversation = ConversationSpec()

    def build(self) -> AppDef:
        # `conversation` is chatbot-shaped (arch + SLO defaults); the trace
        # itself comes from repro_torch.bench.conversation, not AppDef
        base = "chatbot" if self.app_type == "conversation" else self.app_type
        return make_app(base,
                        name=self.name or self.app_type,
                        arch=self.arch or None,
                        slo=self.slo,
                        background=self.background,
                        kv_cache_on_host=self.kv_cache_on_host)

    # ------------------------------------------------------- serialization
    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioApp":
        d = dict(d)
        valid = ({f.name for f in dataclasses.fields(cls)}
                 | {"app", "kv_cache"})
        unknown = sorted(set(d) - valid)
        if unknown:
            raise ScenarioError(
                f"unknown app key(s) {unknown}; valid keys: {sorted(valid)}")
        app_type = d.pop("app", None) or d.pop("app_type")
        slo = d.pop("slo", None)
        arrival = d.pop("arrival", None)
        kv = d.pop("kv_cache", None)
        if kv is not None:
            d["kv_cache_on_host"] = str(kv) in ("host", "cpu", "True", "true")
        conv = d.pop("conversation", None)
        if conv is not None and not isinstance(conv, ConversationSpec):
            conv = ConversationSpec.from_dict(conv)
        try:
            arrival = make_arrival(arrival)
        except ValueError as e:
            raise ScenarioError(str(e)) from e
        return cls(app_type=app_type,
                   slo=SLO.parse(slo) if slo is not None else None,
                   arrival=arrival, conversation=conv, **d)

    def to_dict(self) -> dict:
        d: dict = {"app": self.app_type}
        if self.name:
            d["name"] = self.name
        if self.arch:
            d["arch"] = self.arch
        d["num_requests"] = self.num_requests
        if self.slo is not None:
            d["slo"] = {k: v for k, v in dataclasses.asdict(self.slo).items()
                        if v is not None}
        if self.background:
            d["background"] = True
        if self.kv_cache_on_host:
            d["kv_cache"] = "host"
        if self.arrival is not None:
            d["arrival"] = self.arrival.to_dict()
        if self.conversation is not None:
            d["conversation"] = self.conversation.to_dict()
        return d


@dataclass
class Scenario:
    """Declarative benchmark scenario; ``run()`` executes it on the chosen
    substrate (pod simulator or real inference engine) under the named
    scheduling policy."""
    name: str = "scenario"
    mode: str = "concurrent"           # exclusive | concurrent | workflow
    policy: Union[str, SchedulingPolicy] = "greedy"
    total_chips: int = 256
    chip: Union[str, ChipSpec] = "tpu-v5e"
    chunk_target_s: float = 0.05
    seed: int = 0
    substrate: str = "simulator"       # simulator | engine
    workflow_release: str = "request"  # workflow deps release per request
                                       # or per node (BOTH substrates)
    #: memory-pressure knobs (schema 1.2). ``kv_page_budget`` caps the KV
    #: pool in PAGES of ``page_size`` tokens; ``memory_mb`` derives the
    #: budget from bytes instead (substrate-native: full-scale KV bytes on
    #: the simulator, the reduced execution vehicle's on the engine).
    #: None = unconstrained (pre-paging behaviour).
    memory_mb: Optional[float] = None
    kv_page_budget: Optional[int] = None
    page_size: int = 16
    #: radix prefix sharing (schema 1.4): the engine substrate runs its
    #: paged pool with the real trie + copy-on-write; the simulator mirrors
    #: it analytically. Every sim gains a versioned ``prefix`` block.
    prefix_cache: bool = False
    #: attach the versioned ``telemetry`` block (schema 1.3) to every sim
    #: in ``to_json()``: utilization/bandwidth timelines, event counts,
    #: Gantt spans — schema-identical across substrates (repro_torch.telemetry).
    #: Telemetry also subscribes a streaming pipeline to the trace bus, so
    #: every sim fills the schema-1.8 ``attribution`` block online.
    telemetry: bool = False
    #: ring-buffer recorder bound (schema 1.8): retain only the last N
    #: trace events / counter points per series, so million-request
    #: open-loop runs hold O(window) memory. Streaming aggregates
    #: (event counts, token totals, attribution, makespan) stay EXACT —
    #: only the raw event list is bounded. None = unbounded (default).
    trace_ring: Optional[int] = None
    #: fault injection (schema 1.5, repro_torch.resilience): list of fault spec
    #: dicts (``{"kind": "thermal_throttle", ...}``) or FaultSpec objects.
    #: Both substrates resolve the SAME seeded schedule from this list.
    faults: list = field(default_factory=list)
    #: shed-on-SLO degradation hook (schema 1.5): dict / ShedConfig / true.
    #: When rolling attainment drops below the threshold, the scheduling
    #: policy's ``shed_decision`` sheds or downgrades new admissions.
    shed_on_slo: Union[None, bool, dict, ShedConfig] = None
    #: router tier (schema 1.6): each chip partition is fronted by
    #: ``replicas`` engine replicas (its chips split across them) and
    #: ``routing`` names the policy picking the serving replica per
    #: request — round_robin, least_outstanding_tokens,
    #: power_of_two_choices, session_affinity, prefix_aware
    #: (``repro_torch.serving.router`` registry). replicas=1 + routing=None
    #: keeps both substrates bit-identical to the pre-router behaviour;
    #: setting either one enables the router (routing alone defaults to
    #: round_robin over 1 replica, replicas alone to round_robin).
    replicas: int = 1
    routing: Union[None, str, dict] = None
    #: arrival rates for :meth:`sweep` (one ScenarioResult per rate);
    #: serialized so a sweep is one YAML document
    sweep_rates: list = field(default_factory=list)
    #: replica counts for :meth:`sweep` — crossed with ``sweep_rates``
    #: into a grid when both are set
    sweep_replicas: list = field(default_factory=list)
    apps: list[ScenarioApp] = field(default_factory=list)
    workflow: Union[None, str, dict, WorkflowSpec] = None

    def __post_init__(self):
        if self.mode == "engine":      # deprecated alias, kept working
            global _MODE_ENGINE_WARNED
            if not _MODE_ENGINE_WARNED:
                _MODE_ENGINE_WARNED = True
                warnings.warn(
                    "mode: engine is a deprecated alias for mode: "
                    "concurrent + substrate: engine; spell out the "
                    "substrate (or use Scenario.run(substrate='engine'))",
                    DeprecationWarning, stacklevel=3)
            self.mode, self.substrate = "concurrent", "engine"
        if isinstance(self.routing, dict):
            r = dict(self.routing)
            pol = r.pop("policy", None)
            reps = r.pop("replicas", None)
            if r or pol is None:
                raise ScenarioError(
                    f"routing block keys are 'policy' (required) and "
                    f"'replicas'; got {sorted(self.routing)}")
            self.routing = pol
            if reps is not None and self.replicas == 1:
                self.replicas = int(reps)
        if self.routing is not None \
                and self.routing not in available_routing_policies():
            raise ScenarioError(
                f"unknown routing policy {self.routing!r}; available: "
                f"{', '.join(available_routing_policies())}")
        if self.replicas < 1:
            raise ScenarioError(f"replicas must be >= 1, "
                                f"got {self.replicas}")
        if self.mode not in MODES:
            raise ValueError(f"unknown scenario mode {self.mode!r}; "
                             f"expected one of {MODES}")
        if self.substrate not in SUBSTRATES:
            raise ValueError(f"unknown substrate {self.substrate!r}; "
                             f"expected one of {SUBSTRATES}")
        if self.workflow_release not in RELEASES:
            raise ValueError(
                f"unknown workflow_release {self.workflow_release!r}; "
                f"expected one of {RELEASES}")
        try:
            self.faults = [make_fault(f) for f in self.faults]
            self.shed_on_slo = ShedConfig.from_dict(self.shed_on_slo)
        except ValueError as e:
            raise ScenarioError(str(e)) from e
        if (any(isinstance(f, MemorySpike) for f in self.faults)
                and self.kv_page_budget is None and self.memory_mb is None):
            raise ScenarioError(
                "memory_spike faults steal from the KV pool, which this "
                "scenario leaves unconstrained; set kv_page_budget or "
                "memory_mb")

    # ------------------------------------------------------------- helpers
    @property
    def chip_spec(self) -> ChipSpec:
        return self.chip if isinstance(self.chip, ChipSpec) \
            else get_chip(self.chip)

    @property
    def policy_name(self) -> str:
        return self.policy if isinstance(self.policy, str) else self.policy.name

    @property
    def routing_enabled(self) -> bool:
        """True when a Router fronts the partitions (replicas > 1 or an
        explicit routing policy) — the runs that emit a live (non-zero)
        schema-1.6 ``routing`` block."""
        return self.replicas > 1 or self.routing is not None

    def kv_token_budget(self) -> Optional[int]:
        """The memory knobs as a full-scale KV TOKEN budget (simulator
        substrate). ``kv_page_budget`` wins; ``memory_mb`` divides by the
        most expensive app's per-token KV bytes (conservative), through
        the same :func:`repro_torch.roofline.hw.kv_pool_pages` sizing the engine
        substrate and platform budgets use."""
        if self.kv_page_budget is not None:
            return self.kv_page_budget * self.page_size
        if self.memory_mb is None:
            return None
        from repro_torch.roofline.hw import kv_bytes_per_token, kv_pool_pages
        per_tok = max((kv_bytes_per_token(sa.build().cfg)
                       for sa in self.apps), default=0)
        pages = kv_pool_pages(self.chip_spec, per_tok, self.page_size,
                              memory_mb=self.memory_mb)
        if pages <= 0:
            return None              # no app holds KV: knob is a no-op
        return pages * self.page_size

    def workflow_spec(self) -> WorkflowSpec:
        if self.workflow is None:
            raise ValueError("mode='workflow' requires a workflow spec")
        if isinstance(self.workflow, WorkflowSpec):
            return self.workflow
        return parse_workflow(self.workflow)

    def fault_schedule(self) -> Optional[FaultSchedule]:
        """A FRESH resolved :class:`FaultSchedule` (seeded from the
        scenario seed's ``faults`` child stream). Each substrate constructs
        its own instance, so start jitters resolve identically on both —
        the parity guarantee of the resilience layer."""
        if not self.faults:
            return None
        return FaultSchedule(self.faults, rng=child_rng(self.seed, "faults"))

    def shed_config(self) -> Optional[ShedConfig]:
        return self.shed_on_slo   # normalized in __post_init__

    # ------------------------------------------------------- serialization
    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - valid)
        if unknown:
            raise ScenarioError(
                f"unknown scenario key(s) {unknown}; valid keys: "
                f"{sorted(valid)}")
        pol = d.get("policy")
        if isinstance(pol, str) and pol not in available_policies():
            raise ScenarioError(
                f"unknown policy {pol!r}; available: "
                f"{', '.join(available_policies())}")
        apps = [a if isinstance(a, ScenarioApp) else ScenarioApp.from_dict(a)
                for a in d.pop("apps", [])]
        try:
            return cls(apps=apps, **d)
        except ScenarioError:
            raise
        except (TypeError, ValueError) as e:
            raise ScenarioError(str(e)) from e

    @classmethod
    def from_yaml(cls, src: Union[str, dict]) -> "Scenario":
        if isinstance(src, str):
            src = yaml.safe_load(src)
        if not isinstance(src, dict):
            raise ValueError("scenario spec must be a mapping")
        return cls.from_dict(src)

    def to_dict(self) -> dict:
        d: dict = {
            "name": self.name,
            "mode": self.mode,
            "policy": self.policy_name,
            "total_chips": self.total_chips,
            "chip": self.chip_spec.name,
            "chunk_target_s": self.chunk_target_s,
            "seed": self.seed,
            "substrate": self.substrate,
        }
        if self.mode == "workflow":
            d["workflow_release"] = self.workflow_release
        if self.memory_mb is not None:
            d["memory_mb"] = self.memory_mb
        if self.kv_page_budget is not None:
            d["kv_page_budget"] = self.kv_page_budget
        if self.memory_mb is not None or self.kv_page_budget is not None:
            d["page_size"] = self.page_size
        if self.telemetry:
            d["telemetry"] = True
        if self.trace_ring is not None:
            d["trace_ring"] = self.trace_ring
        if self.prefix_cache:
            d["prefix_cache"] = True
        if self.faults:
            d["faults"] = [f.to_dict() for f in self.faults]
        if self.shed_on_slo is not None:
            d["shed_on_slo"] = self.shed_on_slo.to_dict()
        if self.replicas != 1:
            d["replicas"] = self.replicas
        if self.routing is not None:
            d["routing"] = self.routing
        if self.sweep_rates:
            d["sweep_rates"] = list(self.sweep_rates)
        if self.sweep_replicas:
            d["sweep_replicas"] = list(self.sweep_replicas)
        if self.apps:
            d["apps"] = [a.to_dict() for a in self.apps]
        if self.workflow is not None:
            wf = self.workflow
            if isinstance(wf, str):
                wf = yaml.safe_load(wf)
            d["workflow"] = wf.to_dict() if isinstance(wf, WorkflowSpec) else wf
        return d

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    # --------------------------------------------------------------- run
    def streaming_pipeline(self):
        """A fresh :class:`~repro_torch.telemetry.streaming.StreamingPipeline`
        when the scenario enables telemetry (it fills the schema-1.8
        ``attribution`` block online on BOTH substrates), else None."""
        if not self.telemetry:
            return None
        from repro_torch.telemetry.streaming import StreamingPipeline
        return StreamingPipeline()

    def _simulator(self, total_chips: Optional[int] = None,
                   policy: Union[None, str, SchedulingPolicy] = None
                   ) -> PodSimulator:
        return PodSimulator(total_chips or self.total_chips,
                            policy=policy if policy is not None else self.policy,
                            chip=self.chip_spec,
                            chunk_target_s=self.chunk_target_s,
                            kv_token_budget=self.kv_token_budget(),
                            page_size=self.page_size,
                            prefix_cache=self.prefix_cache,
                            faults=self.fault_schedule(),
                            shed=self.shed_config(),
                            replicas=self.replicas,
                            routing=self.routing,
                            routing_rng=child_rng(self.seed, "routing"),
                            pipeline=self.streaming_pipeline(),
                            trace_ring=self.trace_ring)

    def _trace(self, idx: int, sa: ScenarioApp, app: AppDef,
               start_s: float = 0.0) -> AppTrace:
        if sa.conversation is not None:
            return conversation_trace(app.name, app.cfg, sa.conversation,
                                      app.slo, sa.num_requests,
                                      start_s=start_s,
                                      background=app.background)
        return app.sim_trace(sa.num_requests, start_s=start_s,
                             seed=child_seed(self.seed, "arrival", idx),
                             arrival=sa.arrival)

    def run(self, substrate: Optional[str] = None) -> "ScenarioResult":
        """Execute the scenario. ``substrate`` overrides the spec's
        substrate for THIS run without mutating the scenario — the
        supported way to run one declaration on both substrates (parity
        tests used to mutate ``sc.substrate`` in place)."""
        if substrate is not None and substrate != self.substrate:
            if substrate not in SUBSTRATES:
                raise ValueError(f"unknown substrate {substrate!r}; "
                                 f"expected one of {SUBSTRATES}")
            return dataclasses.replace(self, substrate=substrate).run()
        names = [sa.name or sa.app_type for sa in self.apps]
        dups = sorted({n for n in names if names.count(n) > 1})
        if dups:
            # both substrates key traces/records by app name — duplicates
            # would silently merge (simulator) or deadlock (engine)
            raise ValueError(f"duplicate app name(s) {dups}; give each "
                             "ScenarioApp a unique name=")
        if self.substrate == "engine":
            # lazy import: the engine substrate pulls in JAX + the model
            # zoo, which simulator-only callers never need
            from repro_torch.bench.engine_runner import run_scenario_on_engine
            return run_scenario_on_engine(self)
        if self.mode == "exclusive":
            return self._run_exclusive()
        if self.mode == "concurrent":
            return self._run_concurrent()
        return self._run_workflow()

    def sweep(self, rates_per_s: Optional[list] = None, *,
              replicas: Optional[list] = None,
              apps: Optional[list] = None) -> list["ScenarioResult"]:
        """Load/scale curve: run this scenario once per sweep point and
        return one :class:`ScenarioResult` per point, on either substrate.

        Two axes — Poisson arrival rate (``rates_per_s`` or the spec's
        ``sweep_rates``) and replica count (``replicas`` or the spec's
        ``sweep_replicas``); setting both crosses them into a grid
        (rate-major order, point names ``{name}@{rate}x{rep}``). ``apps``
        restricts which app names get the swept arrival process
        (default: all).

        Every point runs on a DEEP COPY of the scenario, so per-point
        state (arrival processes, resolved fault specs, app lists) cannot
        leak between grid points — repeating a sweep yields byte-identical
        result documents (pinned in tests/test_router.py)."""
        rates = list(rates_per_s if rates_per_s is not None
                     else self.sweep_rates)
        reps = list(replicas if replicas is not None
                    else self.sweep_replicas)
        if not rates and not reps:
            raise ValueError("no sweep axes: pass rates_per_s/replicas or "
                             "set Scenario.sweep_rates/sweep_replicas")
        from repro_torch.bench.arrival import PoissonArrivals
        results = []
        for rate in (rates or [None]):
            for rep in (reps or [None]):
                point = copy.deepcopy(self)
                point.sweep_rates, point.sweep_replicas = [], []
                if rate is not None:
                    point.apps = [
                        dataclasses.replace(sa, arrival=PoissonArrivals(
                            rate_per_s=float(rate)))
                        if apps is None or (sa.name or sa.app_type) in apps
                        else sa
                        for sa in point.apps]
                if rep is not None:
                    point.replicas = int(rep)
                if rate is not None and rep is not None:
                    point.name = f"{self.name}@{rate}x{rep}"
                elif rep is not None:
                    point.name = f"{self.name}@r{rep}"
                else:
                    point.name = f"{self.name}@{rate}"
                results.append(point.run())
        return results

    def _run_exclusive(self) -> "ScenarioResult":
        """Each app alone on the device (paper §4.1 upper bound; on
        ``host-cpu`` the pod collapses to one host = lower bound)."""
        chips = self.total_chips if self.chip_spec.name != "host-cpu" else 1
        sims = {}
        for i, sa in enumerate(self.apps):
            app = sa.build()
            sim = self._simulator(total_chips=chips)
            sims[app.name] = sim.run([self._trace(i, sa, app)])
        return ScenarioResult(scenario=self, sims=sims)

    def _run_concurrent(self) -> "ScenarioResult":
        """All apps start together on the shared pod (paper §4.2)."""
        traces = [self._trace(i, sa, sa.build())
                  for i, sa in enumerate(self.apps)]
        sim = self._simulator().run(traces)
        return ScenarioResult(scenario=self, sims={"concurrent": sim})

    def _run_workflow(self, max_rounds: int = 12) -> "ScenarioResult":
        sim, finish, e2e = run_workflow_spec(
            self.workflow_spec(), total_chips=self.total_chips,
            policy=self.policy, chip=self.chip_spec,
            chunk_target_s=self.chunk_target_s, max_rounds=max_rounds,
            release=self.workflow_release,
            faults=self.fault_schedule(), shed=self.shed_config(),
            replicas=self.replicas, routing=self.routing,
            routing_seed=self.seed)
        if self.telemetry and sim.trace is not None:
            # the fixed-point runner re-runs the sim per round, so the
            # attribution comes from a post-hoc replay of the FINAL
            # round's trace rather than a live pipeline
            from repro_torch.telemetry.requests import attribution_from_trace
            sim.attribution = attribution_from_trace(sim.trace)
        return ScenarioResult(scenario=self, sims={"workflow": sim},
                              node_finish_s=finish, e2e_s=e2e)


# ------------------------------------------------------------------ result
@dataclass
class ScenarioResult:
    scenario: Scenario
    sims: dict[str, SimResult]         # exclusive: per app; else one entry
    node_finish_s: dict[str, float] = field(default_factory=dict)
    e2e_s: Optional[float] = None
    substrate: str = "simulator"
    #: engine substrate only: partition label -> EngineStats (dispatch
    #: counters); NOT part of the versioned to_json schema
    engine_stats: dict = field(default_factory=dict)

    @property
    def sim(self) -> SimResult:
        """The single combined SimResult (concurrent/workflow modes)."""
        if len(self.sims) != 1:
            raise ValueError(f"scenario produced {len(self.sims)} sims; "
                             "use .sims for exclusive mode")
        return next(iter(self.sims.values()))

    def report(self, app_name: str):
        """SLOReport for ``app_name`` regardless of mode."""
        for sim in self.sims.values():
            if app_name in sim.reports:
                return sim.reports[app_name]
        raise KeyError(app_name)

    def summary(self) -> dict:
        out = {}
        for label, sim in self.sims.items():
            s = sim.summary()
            if self.scenario.telemetry and sim.trace is not None:
                from repro_torch.telemetry import telemetry_block
                s["telemetry"] = telemetry_block(sim)
            out[label] = s
        if self.e2e_s is not None:
            out["e2e_s"] = self.e2e_s
            out["node_finish_s"] = dict(sorted(self.node_finish_s.items()))
        return out

    def to_json(self) -> dict:
        """Stable, versioned result schema (consumed by dashboards/CI).

        Schema 1.1: adds the ``substrate`` field (and mirrors it inside the
        embedded scenario spec). 1.0 documents are 1.1 documents with
        ``substrate: simulator`` implied — see docs/scenarios.md for the
        migration note and ``benchmarks/diff_results.py`` for the
        regression-diff consumer."""
        return {
            "schema_version": SCHEMA_VERSION,
            "substrate": self.substrate,
            "scenario": self.scenario.to_dict(),
            "results": self.summary(),
        }


# --------------------------------------------------------- workflow runner
def run_workflow_spec(spec: WorkflowSpec, *, total_chips: int,
                      policy: Union[str, SchedulingPolicy] = "greedy",
                      chip: Optional[ChipSpec] = None,
                      chunk_target_s: float = 0.05,
                      max_rounds: int = 12,
                      release: str = "node",
                      faults=None, shed=None,
                      replicas: int = 1,
                      routing: Union[str, None] = None,
                      routing_seed: int = 0
                      ) -> tuple[SimResult, dict[str, float], float]:
    """Execute a workflow DAG on the pod: the DAG scheduler releases each
    node's trace when its dependencies complete; the simulator runs ONCE
    over the merged stream so cross-app contention is faithful. Release
    times depend on dependency finish times, which depend on contention —
    fixed-point iterate until stable.

    ``release`` sets the dependency-release granularity (mirroring the
    engine substrate): ``"node"`` (the legacy fixed point — every request
    of a node waits for ALL requests of its dependencies) or
    ``"request"`` — request *j* waits only for request *j* of each
    dependency (clamped to its length), so downstream nodes pipeline
    behind upstream completions. The fixed point then iterates PER-REQUEST
    release floors instead of one scalar per node."""
    if release not in RELEASES:
        raise ValueError(f"unknown workflow release {release!r}; "
                         f"expected one of {RELEASES}")
    from repro_torch.roofline.hw import TPU_V5E
    chip = chip or TPU_V5E
    policy = get_policy(policy)
    dag = build_dag(spec)
    exec_nodes = {n.node: n for n in dag.nodes.values()
                  if n.phase == Phase.EXEC}
    deps_of = {name: [d.split(":")[0] for d in node.deps
                      if d.endswith(":exec")]
               for name, node in exec_nodes.items()}
    n_req = {name: node.task.num_requests
             for name, node in exec_nodes.items()}
    # per-request release floors (node mode keeps them identical per node)
    rel = {name: [0.0] * n_req[name] for name in exec_nodes}
    fin = dict(rel)
    offsets = {name: [] for name in exec_nodes}
    result: Optional[SimResult] = None

    for _ in range(max_rounds):
        traces = []
        for name, node in exec_nodes.items():
            app = dataclasses.replace(app_from_task(node.task), name=name)
            trace = app.sim_trace(node.task.num_requests, start_s=0.0)
            offsets[name] = [r.arrival_s for r in trace.requests]
            for j, r in enumerate(trace.requests):
                r.arrival_s = rel[name][j] + SETUP_S + offsets[name][j]
            trace = AppTrace(name=name, slo=trace.slo,
                             requests=trace.requests,
                             background=trace.background or node.background,
                             closed_loop=trace.closed_loop)
            traces.append(trace)
        sim = PodSimulator(total_chips, policy=policy, chip=chip,
                           chunk_target_s=chunk_target_s,
                           faults=faults, shed=shed,
                           replicas=replicas, routing=routing,
                           # a FRESH identically-seeded stream per round:
                           # routing choices repeat, so the fixed point
                           # converges on one consistent placement
                           routing_rng=child_rng(routing_seed, "routing"))
        result = sim.run(traces)
        new_fin = {}
        for name in exec_nodes:
            done = {r.request_id: r.arrival_s + (r.e2e_s or 0.0)
                    for r in result.reports[name].records}
            new_fin[name] = [done.get(j, rel[name][j])
                             for j in range(n_req[name])]
        new_rel = {}
        for name in exec_nodes:
            deps = [d for d in deps_of[name] if n_req[d] > 0]
            if release == "request":
                new_rel[name] = [
                    max((new_fin[d][min(j, n_req[d] - 1)] for d in deps),
                        default=0.0)
                    for j in range(n_req[name])]
            else:
                node_rel = max((max(new_fin[d], default=0.0) for d in deps),
                               default=0.0)
                new_rel[name] = [node_rel] * n_req[name]
        if all(abs(a - b) < 1e-6
               for name in rel for a, b in zip(new_rel[name], rel[name])):
            fin = new_fin
            break
        rel, fin = new_rel, new_fin

    # telemetry: dependency-release instants into the final round's trace
    if result is not None and result.trace is not None:
        for name in exec_nodes:
            if deps_of[name]:
                for j in range(n_req[name]):
                    result.trace.instant(
                        "release", name, j,
                        rel[name][j] + SETUP_S + (offsets[name][j]
                                                  if j < len(offsets[name])
                                                  else 0.0))
    finish = {name: max(fin[name], default=0.0) for name in exec_nodes}
    e2e = max(finish.values(), default=0.0)
    return result, finish, e2e
