# Copy of src/repro/telemetry/timeline.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Derived telemetry views: binned utilization/bandwidth timelines, KV
occupancy, and per-app Gantt spans (paper §3.2, Figs. 4–6).

TPU-honest metric translations:

  SMACT ≙ fraction of pod chips RESERVED by dispatched work per bin
  SMOCC ≙ reserved fraction × per-event roofline ACHIEVEMENT — the
          fraction of the binding roofline resource (compute, HBM
          bandwidth, or ICI for spans carrying interconnect traffic)
          each event actually moved, computed from the event's
          real FLOPs/bytes via :func:`repro_torch.roofline.analysis.achieved_fraction`
          (this replaces the old hard-coded ``occupancy=0.55``: compute-
          bound items land near the MXU efficiency, memory-bound decode
          saturates the bandwidth roof instead)
  bandwidth ≙ GB/s of HBM traffic per bin — each event's bytes (weights,
          activations, KV page reads) spread uniformly over its span
  power ≙ analytic chip power model (idle + utilization · dynamic)

Binning semantics (edge cases pinned in tests/test_telemetry.py): events
spanning bin boundaries contribute the exact overlap to each bin;
zero-length spans contribute no busy time (their bytes land in the bin
containing ``t0``); a zero makespan yields an all-zero timeline; the last
bin is closed (an event ending exactly at the makespan counts).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from repro_torch.roofline.analysis import achieved_fraction
from repro_torch.roofline.hw import ChipSpec

from repro_torch.telemetry.recorder import TraceRecorder, WORK_KINDS

if TYPE_CHECKING:  # pragma: no cover - typing only (avoids an import cycle)
    from repro_torch.core.simulator import SimResult


@dataclass
class UtilizationTimeline:
    """Binned pod-utilization timeline (Fig. 4/5 analogue)."""
    t: list                 # bin centers (s)
    smact: list             # fraction of chips reserved
    smocc: list             # reserved × roofline achievement
    power_w: list           # analytic power model
    bandwidth_gbs: list     # HBM GB/s actually moved
    dt_s: float = 0.0       # bin width (0 for a zero-makespan run)

    # ------------------------------------------------------------- means
    @property
    def smact_mean(self) -> float:
        return sum(self.smact) / len(self.smact) if self.smact else 0.0

    @property
    def smocc_mean(self) -> float:
        return sum(self.smocc) / len(self.smocc) if self.smocc else 0.0

    @property
    def bandwidth_gbs_mean(self) -> float:
        return (sum(self.bandwidth_gbs) / len(self.bandwidth_gbs)
                if self.bandwidth_gbs else 0.0)

    @property
    def power_w_mean(self) -> float:
        return sum(self.power_w) / len(self.power_w) if self.power_w else 0.0

    # ------------------------------------------------------ construction
    @staticmethod
    def from_trace(trace: TraceRecorder, *, chip: ChipSpec, total_chips: int,
                   bins: int = 100,
                   span_s: Optional[float] = None) -> "UtilizationTimeline":
        """Bin a recorded trace into ``bins`` equal intervals over
        ``span_s`` (default: the trace's makespan)."""
        if bins < 1:
            raise ValueError(f"bins must be >= 1, got {bins}")
        span = trace.makespan_s if span_s is None else span_s
        if span <= 0.0:
            zeros = [0.0] * bins
            return UtilizationTimeline(
                t=list(zeros), smact=list(zeros), smocc=list(zeros),
                power_w=[chip.idle_power_w] * bins,
                bandwidth_gbs=list(zeros), dt_s=0.0)
        dt = span / bins
        act = [0.0] * bins
        occ = [0.0] * bins
        bw = [0.0] * bins          # bytes per bin
        for e in trace.events:
            if e.kind not in WORK_KINDS:
                continue
            if e.t1 <= e.t0:
                # zero-length span: no busy time, but its bytes still moved
                if e.hbm_bytes:
                    bw[min(int(e.t0 / dt), bins - 1)] += e.hbm_bytes
                continue
            frac = e.chips / total_chips if total_chips else 0.0
            ach = achieved_fraction(e.flops, e.hbm_bytes, e.t1 - e.t0,
                                    max(e.chips, 1), chip,
                                    ici_bytes=e.ici_bytes)
            b0 = min(max(int(e.t0 / dt), 0), bins - 1)
            b1 = min(max(int(e.t1 / dt), 0), bins - 1)
            for b in range(b0, b1 + 1):
                lo = max(e.t0, b * dt)
                hi = min(e.t1, (b + 1) * dt)
                if hi <= lo:
                    continue
                w = (hi - lo) / dt
                act[b] += frac * w
                occ[b] += frac * w * ach
                bw[b] += e.hbm_bytes * (hi - lo) / (e.t1 - e.t0)
        smact = [min(a, 1.0) for a in act]
        smocc = [min(o, 1.0) for o in occ]
        power = [chip.idle_power_w +
                 (chip.peak_power_w - chip.idle_power_w) * a for a in smact]
        return UtilizationTimeline(
            t=[(b + 0.5) * dt for b in range(bins)],
            smact=smact, smocc=smocc, power_w=power,
            bandwidth_gbs=[b / dt / 1e9 for b in bw], dt_s=dt)

    @staticmethod
    def from_sim(result: "SimResult", *, bins: int = 200,
                 occupancy: Optional[float] = None) -> "UtilizationTimeline":
        """Timeline from a :class:`SimResult`. When the result carries a
        recorded trace (every simulator run, and engine runs with
        ``telemetry: true``), SMOCC/bandwidth come from the actual
        per-event FLOPs/bytes and ``occupancy`` is ignored. The legacy
        constant-occupancy path survives only for hand-built results
        without a trace (``occupancy`` defaults to the roofline MXU
        efficiency rather than the old hard-coded 0.55)."""
        trace = getattr(result, "trace", None)
        if trace is not None and (trace.events or trace.counters):
            return UtilizationTimeline.from_trace(
                trace, chip=result.chip, total_chips=result.total_chips,
                bins=bins, span_s=result.makespan_s)
        if occupancy is None:
            from repro_torch.core.costs import MXU_EFF
            occupancy = MXU_EFF
        span = result.makespan_s or 1.0
        dt = span / bins
        act = [0.0] * bins
        for u in result.util:
            b0 = min(int(u.t0 / dt), bins - 1)
            b1 = min(int(u.t1 / dt), bins - 1)
            frac = u.busy_chips / u.total_chips
            for b in range(b0, b1 + 1):
                lo = max(u.t0, b * dt)
                hi = min(u.t1, (b + 1) * dt)
                if hi > lo:
                    act[b] += frac * (hi - lo) / dt
        chip = result.chip
        smact = [min(a, 1.0) for a in act]
        power = [chip.idle_power_w +
                 (chip.peak_power_w - chip.idle_power_w) * a for a in smact]
        return UtilizationTimeline(
            t=[(b + 0.5) * dt for b in range(bins)],
            smact=smact, smocc=[a * occupancy for a in smact],
            power_w=power, bandwidth_gbs=[0.0] * bins, dt_s=dt)


# ------------------------------------------------------------- counters
def counter_timeline(trace: TraceRecorder, prefix: str, *, bins: int,
                     span_s: float) -> list:
    """Per-bin MAX of the summed step function of every counter named
    ``prefix`` or ``prefix@<label>`` (the engine suffixes per-partition
    pools; their step functions add). Per-bin max — not point sampling —
    so a short-lived peak (the page-pool watermark) is never missed."""
    if bins < 1:
        raise ValueError(f"bins must be >= 1, got {bins}")
    series = [pts for name, pts in trace.counters.items()
              if name == prefix or name.startswith(prefix + "@")]
    out = [0.0] * bins
    if not series:
        return out
    changes = []
    for si, pts in enumerate(series):
        for t, v in pts:
            changes.append((t, si, v))
    changes.sort(key=lambda c: c[0])
    dt = span_s / bins if span_s > 0 else 0.0
    cur = [0.0] * len(series)
    total = 0.0
    ci = 0
    for b in range(bins):
        hi = (b + 1) * dt if b < bins - 1 else float("inf")
        peak = total           # carry the value at bin start
        while ci < len(changes) and (dt == 0.0 or changes[ci][0] <= hi):
            t, si, v = changes[ci]
            total += v - cur[si]
            cur[si] = v
            ci += 1
            peak = max(peak, total)
        out[b] = peak
    return out


# ---------------------------------------------------------------- gantt
def gantt_spans(trace: TraceRecorder, *,
                merge_gap_s: float = 0.0) -> dict:
    """Per-app Gantt spans: ``{app: [(t0, t1, kind), ...]}`` in time
    order, with same-kind spans separated by at most ``merge_gap_s``
    coalesced (one bin width keeps exported documents compact without
    changing what a plot at that resolution shows)."""
    out: dict = {}
    for e in sorted((e for e in trace.events if e.phase == "X"),
                    key=lambda e: (e.app, e.t0, e.t1)):
        spans = out.setdefault(e.app, [])
        if (spans and spans[-1][2] == e.kind
                and e.t0 - spans[-1][1] <= merge_gap_s):
            spans[-1][1] = max(spans[-1][1], e.t1)
        else:
            spans.append([e.t0, e.t1, e.kind])
    return {app: [tuple(s) for s in spans] for app, spans in out.items()}
