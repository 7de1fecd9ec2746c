# Copy of src/repro/bench/__init__.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""repro_torch.bench — the declarative benchmarking API.

Two pillars (see docs/scenarios.md):

* :mod:`repro_torch.bench.policy` — pluggable :class:`SchedulingPolicy` objects
  consumed by both the pod simulator and the real JAX inference engine,
  looked up by name via ``@register_policy``.
* :mod:`repro_torch.bench.scenario` — the :class:`Scenario` spec (YAML-round-
  trippable) + runner subsuming exclusive / concurrent / workflow modes,
  with pluggable arrival processes (:mod:`repro_torch.bench.arrival`).

Attributes resolve lazily (PEP 562): the core simulator imports
``repro_torch.bench.policy`` while ``repro_torch.bench.scenario`` imports the core —
eager re-exports here would close that cycle.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "arrival": ["ArrivalProcess", "BurstyArrivals", "FixedSpacing",
                "PoissonArrivals", "available_arrivals", "make_arrival",
                "register_arrival"],
    "policy": ["ChunkedPolicy", "GreedyPolicy", "PartitionPlan",
               "PreemptivePriorityPolicy", "SchedulingPolicy",
               "SloAwarePolicy", "StaticPartitionPolicy",
               "WeightedFairPolicy", "available_policies", "get_policy",
               "register_policy", "resolve_partition"],
    "conversation": ["ConversationSpec", "conversation_prompt",
                     "conversation_trace"],
    "scenario": ["SCHEMA_VERSION", "SUBSTRATES", "Scenario", "ScenarioApp",
                 "ScenarioError", "ScenarioResult", "run_workflow_spec"],
    "engine_runner": ["CostedRequest", "engine_model",
                      "run_scenario_on_engine"],
    "seeding": ["child_rng", "child_seed", "child_sequence"],
}
_ATTR_TO_MODULE = {attr: mod for mod, attrs in _EXPORTS.items()
                   for attr in attrs}
__all__ = sorted(_ATTR_TO_MODULE)


def __getattr__(name: str):
    mod = _ATTR_TO_MODULE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
