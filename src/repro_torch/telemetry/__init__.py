# Copy of src/repro/telemetry/__init__.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""repro_torch.telemetry — system-level observability shared by both substrates.

The paper's differentiator (§3.2) is capturing SYSTEM metrics — GPU
utilization (SMACT/SMOCC), memory bandwidth, memory occupancy — alongside
app-level SLOs. This package is that capability for the repro:

* :mod:`repro_torch.telemetry.recorder` — :class:`TraceRecorder`, the
  low-overhead event bus both the :class:`PodSimulator` (always) and the
  :class:`InferenceEngine` (opt-in, wired by ``bench.engine_runner``)
  emit dispatch/admission/eviction/release events into. Sinks subscribe
  for online consumption; ring mode bounds retained events to O(window).
* :mod:`repro_torch.telemetry.streaming` — :class:`StreamingPipeline`, the
  online metrics pipeline: bounded-memory quantile sketches
  (:class:`GKSketch`, :class:`P2Quantile`) over TTFT/TPOT/ITL/e2e,
  rolling goodput / SLO burn rate, queue-depth and KV-occupancy gauges.
* :mod:`repro_torch.telemetry.requests` — :class:`RequestAssembler`, the
  per-request lifecycle stitcher: critical-path breakdown (queue / sched
  / prefill / decode / recompute / stall / fault) summing exactly to each
  request's wall-clock span, folded into per-app blame tables — the
  schema-1.8 ``attribution`` block.
* :mod:`repro_torch.telemetry.timeline` — derived views:
  :class:`UtilizationTimeline` (SMACT, roofline-achieved SMOCC, power,
  memory bandwidth), :func:`counter_timeline` (KV-pool occupancy), and
  :func:`gantt_spans` (per-app Gantt).
* :mod:`repro_torch.telemetry.export` — :func:`telemetry_block` (the versioned
  ``telemetry`` block in result schema 1.3) and :func:`chrome_trace` /
  :func:`write_chrome_trace` (Chrome ``trace_event`` JSON).

See docs/telemetry.md for the event model, timeline math, and the
streaming/attribution pipelines.
"""
from repro_torch.telemetry.export import (TELEMETRY_BINS, TELEMETRY_VERSION,
                                    chrome_trace, telemetry_block,
                                    write_chrome_trace)
from repro_torch.telemetry.recorder import (EVENT_KINDS, TERMINAL_KINDS,
                                      WORK_KINDS, TraceEvent, TraceRecorder)
from repro_torch.telemetry.requests import (BUCKETS, BlameTable, RequestAssembler,
                                      RequestLifecycle,
                                      attribution_from_trace,
                                      empty_attribution_block)
from repro_torch.telemetry.streaming import (GKSketch, P2Quantile,
                                       StreamingPipeline)
from repro_torch.telemetry.timeline import (UtilizationTimeline, counter_timeline,
                                      gantt_spans)

__all__ = [
    "BUCKETS", "EVENT_KINDS", "TERMINAL_KINDS", "WORK_KINDS",
    "TELEMETRY_BINS", "TELEMETRY_VERSION",
    "BlameTable", "GKSketch", "P2Quantile",
    "RequestAssembler", "RequestLifecycle", "StreamingPipeline",
    "TraceEvent", "TraceRecorder", "UtilizationTimeline",
    "attribution_from_trace", "chrome_trace", "counter_timeline",
    "empty_attribution_block", "gantt_spans", "telemetry_block",
    "write_chrome_trace",
]
