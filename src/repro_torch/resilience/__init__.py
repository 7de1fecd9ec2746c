# Copy of src/repro/resilience/__init__.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""repro_torch.resilience — fault injection + graceful degradation for both
execution substrates (see docs/resilience.md).

A Scenario's ``faults:`` list builds one seeded :class:`FaultSchedule`;
the pod simulator and the inference engine both integrate work durations
through :meth:`FaultSchedule.advance`, so injected thermal throttling and
stalls hit the two substrates identically. ``shed_on_slo:`` arms the
:class:`ShedConfig` admission controller. Every run's counters land in
the always-present schema-1.5 ``faults`` result block
(:meth:`FaultStats.block`).
"""
from repro_torch.resilience.degradation import ShedConfig, SloTracker
from repro_torch.resilience.faults import (ClientTimeout, EngineStall,
                                     FaultSchedule, FaultSpec,
                                     FaultSpecError, FaultStats, MemorySpike,
                                     SpikeWindow, StallWindow,
                                     ThermalThrottle, available_faults,
                                     make_fault, register_fault,
                                     time_to_recover)

__all__ = [
    "ClientTimeout", "EngineStall", "FaultSchedule", "FaultSpec",
    "FaultSpecError", "FaultStats", "MemorySpike", "ShedConfig",
    "SloTracker", "SpikeWindow", "StallWindow", "ThermalThrottle",
    "available_faults", "make_fault", "register_fault", "time_to_recover",
]
