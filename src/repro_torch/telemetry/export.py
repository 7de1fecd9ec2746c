# Copy of src/repro/telemetry/export.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Telemetry exporters: the versioned ``telemetry`` result block (schema
1.3) and Chrome ``trace_event`` JSON.

The block is attached by ``Scenario.run()`` (via ``ScenarioResult``) when
the scenario sets ``telemetry: true`` and is SCHEMA-IDENTICAL across
substrates: fixed keys, canonical zero-filled event counts, and the
KV-occupancy series present exactly when the run was memory-budgeted
(mirroring the schema-1.2 ``memory`` block). Floats are rounded to keep
documents compact; the virtual clock makes them bit-stable, so telemetry
rows diff in CI like every other metric.

Chrome export targets the ``chrome://tracing`` / Perfetto JSON object
format: one process per app (complete "X" spans per request on separate
tracks), instant events for scheduler decisions, and counter tracks for
KV-pool occupancy.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING

from repro_torch.telemetry.recorder import TraceRecorder
from repro_torch.telemetry.timeline import (UtilizationTimeline, counter_timeline,
                                      gantt_spans)

if TYPE_CHECKING:  # pragma: no cover - typing only (avoids an import cycle)
    from repro_torch.core.simulator import SimResult

#: version of the ``telemetry`` block embedded in result schema >= 1.3
TELEMETRY_VERSION = 1
#: default timeline resolution for exported blocks
TELEMETRY_BINS = 100


def _r(v: float, nd: int = 6) -> float:
    return round(float(v), nd)


def telemetry_block(sim: "SimResult", *, bins: int = TELEMETRY_BINS) -> dict:
    """The versioned ``telemetry`` block for one :class:`SimResult` that
    carries a recorded trace (``sim.trace``)."""
    trace = sim.trace
    if trace is None:
        raise ValueError("SimResult has no recorded trace; run the "
                         "scenario with telemetry enabled")
    span = sim.makespan_s
    tl = UtilizationTimeline.from_trace(trace, chip=sim.chip,
                                        total_chips=sim.total_chips,
                                        bins=bins, span_s=span)
    spans = gantt_spans(trace, merge_gap_s=tl.dt_s)
    block = {
        "version": TELEMETRY_VERSION,
        "bins": bins,
        "dt_s": _r(tl.dt_s, 9),
        "smact_mean": _r(tl.smact_mean),
        "smocc_mean": _r(tl.smocc_mean),
        "bandwidth_gbs_mean": _r(tl.bandwidth_gbs_mean, 3),
        "power_w_mean": _r(tl.power_w_mean, 3),
        "smact": [_r(v) for v in tl.smact],
        "smocc": [_r(v) for v in tl.smocc],
        "power_w": [_r(v, 3) for v in tl.power_w],
        "bandwidth_gbs": [_r(v, 3) for v in tl.bandwidth_gbs],
        "events": trace.counts(),
        "recompute_tokens": _r(trace.token_total("evict"), 3),
        "spans": {app: [[_r(t0), _r(t1), kind] for t0, t1, kind in sp]
                  for app, sp in sorted(spans.items())},
    }
    # Host CPU/RSS series are ALWAYS present: real runs with a
    # HostMonitor wired to the recorder fill them, virtual-clock runs
    # render zeros (counter_timeline zero-fills when no series match),
    # keeping the block schema-identical across substrates.
    for name in ("host_cpu_pct", "host_rss_mb"):
        series = counter_timeline(trace, name, bins=bins, span_s=span)
        block[name] = [_r(v, 3) for v in series]
        block[name + "_peak"] = _r(max(series), 3) if series else 0.0
    # KV occupancy mirrors the memory block: present only under a budget,
    # so unbudgeted documents stay schema-identical across substrates
    if sim.kv_token_budget is not None:
        kv = counter_timeline(trace, "kv_pages", bins=bins, span_s=span)
        block["kv_pages"] = [_r(v, 3) for v in kv]
        block["kv_pages_peak"] = _r(max(kv), 3) if kv else 0.0
    return block


# ------------------------------------------------------------ chrome trace
def chrome_trace(trace: TraceRecorder) -> dict:
    """The trace as a Chrome ``trace_event`` JSON object (load in
    ``chrome://tracing`` or Perfetto): apps become processes, requests
    become threads, work spans become complete ("X") events, scheduler
    decisions instants, and counters counter tracks."""
    apps: list = []
    for e in trace.events:
        if e.app not in apps:
            apps.append(e.app)
    pid_of = {app: i + 1 for i, app in enumerate(apps)}
    pool_pid = len(apps) + 1
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": app}} for app, pid in pid_of.items()]
    if trace.counters:
        out.append({"ph": "M", "name": "process_name", "pid": pool_pid,
                    "tid": 0, "args": {"name": "pool"}})
    for e in trace.events:
        base = {"name": e.kind, "cat": e.kind, "pid": pid_of[e.app],
                "tid": int(e.request_id), "ts": e.t0 * 1e6}
        if e.phase == "X":
            base.update(ph="X", dur=(e.t1 - e.t0) * 1e6,
                        args={"tokens": e.tokens, "flops": e.flops,
                              "hbm_bytes": e.hbm_bytes, "chips": e.chips})
        else:
            base.update(ph="i", s="t", args={"tokens": e.tokens})
        if e.meta:
            base["args"].update(e.meta)
        out.append(base)
    for name, pts in sorted(trace.counters.items()):
        for t, v in pts:
            out.append({"ph": "C", "name": name, "pid": pool_pid, "tid": 0,
                        "ts": t * 1e6, "args": {"value": v}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(trace: TraceRecorder, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(trace), f)
