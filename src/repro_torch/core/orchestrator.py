# Copy of src/repro/core/orchestrator.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""DEPRECATED shim over :mod:`repro_torch.bench.scenario` (paper §3.2 'resource
orchestrator').

The Orchestrator predates the declarative Scenario API; its three entry
points map directly onto scenario modes and now delegate to the shared
runner::

    Orchestrator(strategy=...).run_exclusive(app, n)   -> Scenario(mode="exclusive")
    Orchestrator(strategy=...).run_concurrent(apps, n) -> Scenario(mode="concurrent")
    Orchestrator(strategy=...).run_workflow(spec)      -> Scenario(mode="workflow")

New code should build a :class:`repro_torch.bench.Scenario` (see
docs/scenarios.md); this class is kept only so existing call sites keep
working and will be removed once nothing imports it.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.bench.scenario import SETUP_S, run_workflow_spec
from repro_torch.core.apps import AppDef
from repro_torch.core.simulator import PodSimulator, SimResult
from repro_torch.core.workflow import WorkflowSpec
from repro_torch.roofline.hw import ChipSpec, TPU_V5E

__all__ = ["Orchestrator", "WorkflowResult", "SETUP_S"]


@dataclass
class WorkflowResult:
    sim: SimResult
    node_finish_s: dict[str, float]
    e2e_s: float

    def summary(self) -> dict:
        d = self.sim.summary()
        d["e2e_s"] = self.e2e_s
        d["node_finish_s"] = dict(sorted(self.node_finish_s.items()))
        return d


class Orchestrator:
    def __init__(self, *, total_chips: int = 256, strategy: str = "greedy",
                 chip: ChipSpec = TPU_V5E):
        self.total_chips = total_chips
        self.strategy = strategy
        self.chip = chip

    # ------------------------------------------------------ workflow mode
    def run_workflow(self, spec: WorkflowSpec,
                     max_rounds: int = 12) -> WorkflowResult:
        sim, finish, e2e = run_workflow_spec(
            spec, total_chips=self.total_chips, policy=self.strategy,
            chip=self.chip, max_rounds=max_rounds)
        return WorkflowResult(sim=sim, node_finish_s=finish, e2e_s=e2e)

    # ---------------------------------------------------- concurrent mode
    def run_concurrent(self, apps: list[AppDef],
                       num_requests: dict[str, int]) -> SimResult:
        """Paper §4.2: all apps start together, no DAG."""
        traces = [a.sim_trace(num_requests.get(a.name, 10)) for a in apps]
        sim = PodSimulator(self.total_chips, policy=self.strategy,
                           chip=self.chip)
        return sim.run(traces)

    def run_exclusive(self, app: AppDef, num_requests: int) -> SimResult:
        """Paper §4.1: one app alone on the device (upper bound) — or on the
        host when chip=HOST_CPU (lower bound)."""
        chips = self.total_chips if self.chip.name != "host-cpu" else 1
        sim = PodSimulator(chips, policy="greedy", chip=self.chip)
        return sim.run([app.sim_trace(num_requests)])
