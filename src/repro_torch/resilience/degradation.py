# Copy of src/repro/resilience/degradation.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Graceful degradation: shed or downgrade admissions when rolling SLO
attainment collapses.

Under injected faults a system that keeps admitting everything drags EVERY
request past its SLO; a resilient one sacrifices some requests to keep the
rest inside theirs. ``shed_on_slo`` in the Scenario YAML arms this
controller on both substrates: a per-app rolling window of SLO outcomes is
consulted at admission time, and when attainment drops below the threshold
the scheduling policy's ``shed_decision`` hook picks the action —

* ``shed`` — the request is dropped (counted, never executed; closed-loop
  chains still advance so sessions are not wedged), or
* ``downgrade`` — the request is demoted to background priority and loses
  its deadline: it runs, but yields to SLO-carrying work.

Policies may override ``shed_decision`` to implement smarter triage (e.g.
shed only background apps); the default honours the configured action.
Scored via the ``faults`` block's goodput: shed requests stay in the
denominator.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, fields
from typing import Union

_ACTIONS = ("shed", "downgrade")


@dataclass(frozen=True)
class ShedConfig:
    """``shed_on_slo:`` scenario knob."""
    attainment: float = 0.8       # trigger when rolling attainment < this
    window: int = 8               # completed requests per app in the window
    action: str = "shed"          # shed | downgrade
    min_completed: int = 2        # no decision before this many completions

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown shed_on_slo action {self.action!r}; "
                             f"expected one of {_ACTIONS}")
        if not 0.0 < self.attainment <= 1.0:
            raise ValueError("shed_on_slo attainment must be in (0, 1]")
        if self.window < 1:
            raise ValueError("shed_on_slo window must be >= 1")

    @classmethod
    def from_dict(cls, d: Union[dict, "ShedConfig", None]):
        if d is None or d is False:
            return None
        if isinstance(d, ShedConfig):
            return d
        if d is True:
            return cls()
        valid = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - valid)
        if unknown:
            raise ValueError(f"unknown shed_on_slo key(s) {unknown}; "
                             f"valid keys: {sorted(valid)}")
        return cls(**d)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) != f.default} or {"action": "shed"}


class SloTracker:
    """Rolling per-app SLO attainment over the last ``window`` completions."""

    def __init__(self, window: int):
        self.window = window
        self._hist: dict[str, deque] = {}

    def note(self, app: str, ok: bool) -> None:
        self._hist.setdefault(app, deque(maxlen=self.window)).append(ok)

    def completed(self, app: str) -> int:
        return len(self._hist.get(app, ()))

    def rolling(self, app: str) -> float:
        h = self._hist.get(app)
        if not h:
            return 1.0
        return sum(h) / len(h)

    def should_degrade(self, app: str, cfg: ShedConfig) -> bool:
        return (self.completed(app) >= cfg.min_completed
                and self.rolling(app) < cfg.attainment)

    def burn_rate(self, app: str, target: float) -> float:
        """SRE-style SLO burn rate over the rolling window: observed miss
        rate over the error budget ``1 - target``. 1.0 = burning exactly
        the budget; > 1 = on track to violate; 0 = no misses. A target of
        1.0 has no budget — any miss reports an infinite burn, capped to
        the window size so the monitor stays finite."""
        miss = 1.0 - self.rolling(app)
        budget = 1.0 - target
        if budget <= 0.0:
            return 0.0 if miss <= 0.0 else float(self.window)
        return miss / budget
