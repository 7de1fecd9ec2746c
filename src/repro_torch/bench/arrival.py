# Copy of src/repro/bench/arrival.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Arrival-process generators for scenario diversity (open-loop analogue of
the paper's request traces).

Every process is a frozen dataclass with ``times(n, start_s, seed)``
returning ``n`` monotonically non-decreasing arrival timestamps; generation
is deterministic under a fixed seed (NumPy ``default_rng``). Processes
serialize to/from plain dicts (``{"kind": ..., **params}``) so they embed in
Scenario YAML.

  fixed    — constant spacing (the seed repo's per-app cadence)
  poisson  — exponential inter-arrivals at ``rate_per_s``
  bursty   — bursts of ``burst_size`` back-to-back requests every
             ``burst_gap_s`` (flash-crowd / notification-fanout shape)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

_ARRIVALS: dict[str, type["ArrivalProcess"]] = {}


def register_arrival(kind: str):
    def deco(cls):
        if kind in _ARRIVALS:
            raise ValueError(f"arrival process {kind!r} already registered")
        _ARRIVALS[kind] = cls
        cls.kind = kind
        return cls
    return deco


def available_arrivals() -> list[str]:
    return sorted(_ARRIVALS)


def make_arrival(spec: Union[None, dict, "ArrivalProcess"]
                 ) -> Optional["ArrivalProcess"]:
    """None (keep the app's default cadence), a process instance, or a dict
    ``{"kind": "poisson", "rate_per_s": 2.0}``."""
    if spec is None or isinstance(spec, ArrivalProcess):
        return spec
    if not isinstance(spec, dict):
        raise ValueError(f"arrival spec must be a mapping, got {spec!r}")
    body = dict(spec)
    kind = body.pop("kind", "fixed")
    try:
        cls = _ARRIVALS[kind]
    except KeyError:
        raise ValueError(f"unknown arrival process {kind!r}; available: "
                         f"{', '.join(available_arrivals())}") from None
    return cls(**body)


@dataclass(frozen=True)
class ArrivalProcess:
    kind = "base"

    def times(self, n: int, *, start_s: float = 0.0,
              seed: int = 0) -> list[float]:
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"kind": self.kind, **dataclasses.asdict(self)}


@register_arrival("fixed")
@dataclass(frozen=True)
class FixedSpacing(ArrivalProcess):
    """Constant inter-arrival spacing."""
    spacing_s: float = 1.0

    def times(self, n: int, *, start_s: float = 0.0,
              seed: int = 0) -> list[float]:
        return [start_s + i * self.spacing_s for i in range(n)]


@register_arrival("poisson")
@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals: exponential gaps at ``rate_per_s``."""
    rate_per_s: float = 1.0

    def times(self, n: int, *, start_s: float = 0.0,
              seed: int = 0) -> list[float]:
        if n <= 0:
            return []
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / max(self.rate_per_s, 1e-12), size=n)
        # first request lands at start_s (matches fixed-spacing semantics)
        gaps[0] = 0.0
        return list(start_s + np.cumsum(gaps))


@register_arrival("bursty")
@dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """Flash-crowd shape: ``burst_size`` requests ``intra_gap_s`` apart,
    bursts separated by ``burst_gap_s``."""
    burst_size: int = 4
    burst_gap_s: float = 5.0
    intra_gap_s: float = 0.0

    def times(self, n: int, *, start_s: float = 0.0,
              seed: int = 0) -> list[float]:
        out = []
        for i in range(n):
            burst, pos = divmod(i, max(self.burst_size, 1))
            out.append(start_s + burst * self.burst_gap_s
                       + pos * self.intra_gap_s)
        return out
