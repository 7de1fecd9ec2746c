"""Fault tolerance for 1000+-node training (DESIGN.md §5).

- ``ResilientTrainer``: wraps the train loop with periodic checkpointing,
  NaN/failure detection, bounded restarts, and restart-exact data (the
  synthetic pipeline is a pure function of step).
- ``FailureInjector``: deterministic fault schedule for tests (process-level
  analogue of node loss).
- ``ElasticPlan``: shrink-remesh — on losing a data-parallel slice, rebuild
  the mesh with fewer data shards and rescale per-shard batch so the GLOBAL
  batch (and thus the loss trajectory) is preserved.
- ``StragglerMitigator``: detects slow steps vs a moving percentile and
  recommends action (re-dispatch / drop to backup) — the training analogue
  of the serving simulator's backup dispatch.

Counterpart of :mod:`repro.training.fault_tolerance`: the same logic, over
the port's :class:`~repro_torch.training.checkpoint.CheckpointManager`.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.training.checkpoint import CheckpointManager


class InjectedFault(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raise InjectedFault at the scheduled steps (once each)."""
    fail_at_steps: tuple[int, ...] = ()
    _fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFault(f"injected node failure at step {step}")


@dataclass
class ElasticPlan:
    """Data-parallel shrink plan after losing nodes."""
    data_shards: int
    per_shard_batch: int

    @staticmethod
    def shrink(global_batch: int, data_shards: int,
               lost_shards: int) -> "ElasticPlan":
        remaining = data_shards - lost_shards
        if remaining < 1:
            raise ValueError("no data shards left")
        # keep global batch; each survivor takes more rows
        if global_batch % remaining:
            # round down to a divisible per-shard batch, padding dropped
            per = max(global_batch // remaining, 1)
        else:
            per = global_batch // remaining
        return ElasticPlan(remaining, per)


class StragglerMitigator:
    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times: list[float] = []
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step was a straggler."""
        hist = self.times[-self.window:]
        self.times.append(dt)
        if len(hist) >= 8:
            p50 = float(np.percentile(hist, 50))
            if dt > self.threshold * p50:
                self.flagged.append(step)
                return True
        return False


@dataclass
class TrainLoopResult:
    final_step: int
    restarts: int
    losses: list[float]
    straggler_steps: list[int]


class ResilientTrainer:
    """Checkpoint/restart training loop.

    train_step_fn(state, batch) -> (state, metrics) where metrics['loss'] is
    a scalar. state is any pytree. batch_fn(step) -> batch. All restarts
    resume from the last durable checkpoint and replay the data stream by
    step index, so the loss trajectory is identical to an uninterrupted run.
    """

    def __init__(self, train_step_fn: Callable, batch_fn: Callable,
                 ckpt: CheckpointManager, *, ckpt_every: int = 10,
                 max_restarts: int = 5,
                 injector: Optional[FailureInjector] = None):
        self.train_step_fn = train_step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.stragglers = StragglerMitigator()

    def run(self, init_state, num_steps: int) -> tuple[Any, TrainLoopResult]:
        restarts = 0
        losses: list[float] = []
        state = init_state
        step = 0
        # resume if a checkpoint exists
        if self.ckpt.latest_step() is not None:
            step, state, extra = self.ckpt.restore()
            losses = list(extra.get("losses", []))

        while step < num_steps:
            try:
                t0 = time.monotonic()
                if self.injector:
                    self.injector.check(step)
                batch = self.batch_fn(step)
                state, metrics = self.train_step_fn(state, batch)
                loss = float(metrics["loss"])
                if math.isnan(loss) or math.isinf(loss):
                    raise InjectedFault(f"non-finite loss at step {step}")
                losses.append(loss)
                self.stragglers.observe(step, time.monotonic() - t0)
                step += 1
                if step % self.ckpt_every == 0 or step == num_steps:
                    self.ckpt.save(step, state, extra={"losses": losses})
            except InjectedFault:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                last = self.ckpt.latest_step()
                if last is None:
                    state, step, losses = init_state, 0, []
                else:
                    step, state, extra = self.ckpt.restore()
                    losses = list(extra.get("losses", []))
        self.ckpt.wait()
        return state, TrainLoopResult(step, restarts, losses,
                                      self.stragglers.flagged)
