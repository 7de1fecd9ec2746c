# Copy of src/repro/telemetry/host.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Host-side sampling for real (wall-clock) runs — the container analogue
of the paper's ``stat``/``pcm-memory`` sampling (§3.2). Virtual-clock runs
use the :class:`~repro_torch.telemetry.recorder.TraceRecorder` event bus
instead; this sampler covers real CPU executions where wall time is the
clock.

When constructed with a ``recorder``, every sample is additionally merged
into the trace bus as ``host_cpu_pct`` / ``host_rss_mb`` counter series,
so :func:`repro_torch.telemetry.export.telemetry_block` renders host CPU/RSS
timelines alongside the roofline SMACT/SMOCC curves for real runs (the
series are zero-filled for virtual-clock runs, keeping the block
schema-identical across substrates)."""
from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.telemetry.recorder import TraceRecorder

#: counter names HostMonitor feeds into the trace bus
HOST_COUNTERS = ("host_cpu_pct", "host_rss_mb")


class HostMonitor:
    """Background sampler of host CPU/memory for real-mode runs."""

    def __init__(self, interval_s: float = 0.2,
                 recorder: Optional["TraceRecorder"] = None):
        self.interval_s = interval_s
        self.recorder = recorder
        self.samples: list[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _record(self, sample: dict) -> None:
        self.samples.append(sample)
        if self.recorder is not None:
            self.recorder.counter("host_cpu_pct", sample["t"],
                                  sample["cpu_pct"])
            self.recorder.counter("host_rss_mb", sample["t"],
                                  sample["rss_mb"])

    def __enter__(self):
        try:
            import psutil
        except ImportError:  # pragma: no cover
            psutil = None
        self._t0 = time.monotonic()

        def loop():
            import psutil
            proc = psutil.Process()
            while not self._stop.is_set():
                self._record({
                    "t": time.monotonic() - self._t0,
                    "cpu_pct": psutil.cpu_percent(interval=None),
                    "rss_mb": proc.memory_info().rss / 1e6,
                })
                time.sleep(self.interval_s)

        if psutil is not None:
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        return False

    def peak(self) -> dict:
        if not self.samples:
            return {"cpu_pct": 0.0, "rss_mb": 0.0}
        return {
            "cpu_pct": max(s["cpu_pct"] for s in self.samples),
            "rss_mb": max(s["rss_mb"] for s in self.samples),
        }
