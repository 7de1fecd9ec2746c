# Copy of src/repro/telemetry/streaming.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Online metrics pipeline: bounded-memory streaming aggregators.

The post-hoc metrics path (``SLOReport`` over materialized
``RequestRecord`` lists, ``UtilizationTimeline`` over the full event
list) is O(trace) memory — the ROADMAP's blocker for open-loop 10k–1M
request runs. This module computes the same per-app streaming metrics
INCREMENTALLY from the trace bus:

* :class:`GKSketch` — Greenwald–Khanna ε-approximate quantile summary;
  O((1/ε)·log(εn)) space, rank error ≤ εn. Exact (numpy-interpolating)
  while the stream still fits uncompressed, so small runs reproduce
  post-hoc percentiles bit-for-bit and large runs stay within ε.
* :class:`P2Quantile` — the classic P² single-quantile estimator: five
  markers, O(1) space; the cheap gauge variant.
* :class:`StreamingPipeline` — a recorder sink
  (``TraceRecorder.subscribe``) combining per-app TTFT/TPOT/ITL/e2e
  sketches, rolling-window goodput & SLO attainment, an SLO burn-rate
  monitor, queue-depth and KV-occupancy gauges, and an embedded
  :class:`~repro_torch.telemetry.requests.RequestAssembler` for the
  critical-path blame table. Everything is O(apps + sketches + open
  requests): compose with ``TraceRecorder(ring=N)`` and a million-request
  run holds O(window) state.

The rolling SLO machinery is deliberately the SAME
:class:`~repro_torch.resilience.degradation.SloTracker` the ``shed_on_slo``
admission controller consumes: when the run has a shed controller, the
substrate binds its tracker into the pipeline (``bind_tracker``) and the
burn-rate monitor reads the very window that feeds shedding decisions —
one rolling-SLO truth, not two.
"""
from __future__ import annotations

import bisect
import math
from typing import Optional

from repro_torch.resilience.degradation import SloTracker
from repro_torch.telemetry.recorder import TERMINAL_KINDS, TraceEvent
from repro_torch.telemetry.requests import RequestAssembler, RequestLifecycle

#: metric streams sketched per app (the schema-1.7/1.8 latency stats)
SKETCH_METRICS = ("ttft", "tpot", "itl", "e2e")


# --------------------------------------------------------------- sketches
class P2Quantile:
    """P² (Jain & Chlamtac 1985) single-quantile estimator: five markers,
    O(1) space and update. Exact below five observations."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._init: list[float] = []     # first five observations
        self._h: list[float] = []        # marker heights
        self._n: list[float] = []        # marker positions
        self._np: list[float] = []       # desired positions
        self.count = 0

    def add(self, x: float) -> None:
        self.count += 1
        if self._init is not None:
            bisect.insort(self._init, x)
            if len(self._init) == 5:
                q = self.q
                self._h = list(self._init)
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._np = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
                self._init = None
            return
        h, n, npos = self._h, self._n, self._np
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if h[i] <= x < h[i + 1])
        for i in range(k + 1, 5):
            n[i] += 1
        q = self.q
        dn = (0.0, q / 2, q, (1 + q) / 2, 1.0)
        for i in range(5):
            npos[i] += dn[i]
        for i in (1, 2, 3):
            d = npos[i] - n[i]
            if ((d >= 1 and n[i + 1] - n[i] > 1)
                    or (d <= -1 and n[i - 1] - n[i] < -1)):
                d = 1.0 if d >= 0 else -1.0
                # parabolic (P²) interpolation, linear fallback
                hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (h[i + 1] - h[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1])
                    / (n[i] - n[i - 1]))
                if not h[i - 1] < hp < h[i + 1]:
                    j = i + (1 if d > 0 else -1)
                    hp = h[i] + d * (h[j] - h[i]) / (n[j] - n[i])
                h[i] = hp
                n[i] += d

    @property
    def value(self) -> float:
        if self._init is not None:
            if not self._init:
                return 0.0
            return _interp_sorted(self._init, self.q)
        return self._h[2]


def _interp_sorted(vals: list, q: float) -> float:
    """numpy-style linear-interpolated quantile of a SORTED list."""
    if not vals:
        return 0.0
    pos = q * (len(vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


class GKSketch:
    """Greenwald–Khanna ε-approximate quantile summary.

    Entries are ``[value, g, delta]`` tuples sorted by value; ``g`` is
    the rank gap to the previous entry, ``delta`` the rank uncertainty.
    Any quantile query is answered within rank error εn. Below
    ``exact_cap`` observations nothing has been merged and queries fall
    back to numpy-style interpolation on the raw order statistics — so
    the streaming sketch reproduces post-hoc percentiles EXACTLY on
    small/medium runs and within ε on unbounded ones."""

    def __init__(self, eps: float = 0.001):
        if not 0.0 < eps < 0.5:
            raise ValueError(f"eps must be in (0, 0.5), got {eps}")
        self.eps = eps
        self.count = 0
        self._entries: list[list] = []   # [v, g, delta], sorted by v
        self._keys: list[float] = []     # bisect mirror of entry values
        self._exact = True
        self._since_compress = 0
        self._period = max(int(1.0 / (2.0 * eps)), 1)

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        i = bisect.bisect_right(self._keys, x)
        if i == 0 or i == len(self._entries):
            delta = 0
        else:
            delta = max(int(math.floor(2 * self.eps * self.count)) - 1, 0)
        self._entries.insert(i, [x, 1, delta])
        self._keys.insert(i, x)
        self._since_compress += 1
        if self._since_compress >= self._period:
            self._compress()
            self._since_compress = 0

    def _compress(self) -> None:
        limit = 2 * self.eps * self.count
        ent = self._entries
        i = len(ent) - 2
        merged = False
        while i >= 1:
            a, b = ent[i], ent[i + 1]
            if a[1] + b[1] + b[2] <= limit:
                b[1] += a[1]
                del ent[i]
                del self._keys[i]
                merged = True
            i -= 1
        if merged:
            self._exact = False

    def query(self, q: float) -> float:
        """The ε-approximate q-quantile (exact while uncompressed)."""
        if not self._entries:
            return 0.0
        if self._exact:
            return _interp_sorted(self._keys, q)
        n = self.count
        target = max(1, min(n, int(math.ceil(q * n))))
        tol = self.eps * n
        rmin = 0
        for v, g, delta in self._entries:
            rmin += g
            if target - rmin <= tol and (rmin + delta) - target <= tol:
                return v
        return self._entries[-1][0]

    @property
    def space(self) -> int:
        return len(self._entries)


# --------------------------------------------------------------- pipeline
class StreamingPipeline:
    """Recorder sink: per-app latency sketches, rolling goodput/SLO
    attainment + burn rate, queue-depth and KV-occupancy gauges, and the
    embedded per-request assembler behind the ``attribution`` block.

    ``window`` sizes the rolling SLO window when the pipeline owns its
    tracker; a substrate running ``shed_on_slo`` binds the shed
    controller's own tracker instead (and keeps noting into it at the
    same points it always did — the pipeline then only READS it)."""

    def __init__(self, *, window: int = 64, eps: float = 0.001,
                 slo_target: float = 0.9):
        self.assembler = RequestAssembler(self._on_lifecycle)
        self.tracker = SloTracker(window)
        self._owns_tracker = True
        self.slo_target = slo_target
        self.eps = eps
        #: app -> metric -> GKSketch
        self.sketches: dict[str, dict[str, GKSketch]] = {}
        self.issued = 0
        self.slo_ok = 0
        self.completed = 0
        self.t_max = 0.0
        # gauges
        self._waiting: set = set()     # (app, rid) arrived, not yet resident
        self.queue_depth_peak = 0
        self._kv_last: dict[str, float] = {}       # counter -> last value
        self._kv_peak: dict[str, float] = {}

    # ------------------------------------------------------------- sink
    def on_event(self, ev: TraceEvent) -> None:
        if ev.t1 > self.t_max:
            self.t_max = ev.t1
        kind = ev.kind
        key = (ev.app, ev.request_id)
        if kind == "arrive":
            self.issued += 1
            self._waiting.add(key)
            if len(self._waiting) > self.queue_depth_peak:
                self.queue_depth_peak = len(self._waiting)
        elif kind == "admit":
            self._waiting.discard(key)
        elif kind in ("evict", "replay"):
            # back to the queue: re-admission re-discards it
            self._waiting.add(key)
        elif kind in TERMINAL_KINDS:
            self._waiting.discard(key)
        self.assembler.on_event(ev)

    def on_counter(self, name: str, t: float, value: float) -> None:
        if t > self.t_max:
            self.t_max = t
        if name.startswith("kv_pages"):
            self._kv_last[name] = value
            if value > self._kv_peak.get(name, 0.0):
                self._kv_peak[name] = value

    def _on_lifecycle(self, lc: RequestLifecycle) -> None:
        self.completed += 1
        if lc.ok:
            self.slo_ok += 1
        if self._owns_tracker and lc.terminal in ("finish", "cancel"):
            # mirrors the substrates' own accounting: completions note
            # their SLO verdict, cancels note a miss, sheds never note
            self.tracker.note(lc.app, lc.ok)
        sk = self.sketches.get(lc.app)
        if sk is None:
            sk = self.sketches[lc.app] = {
                m: GKSketch(self.eps) for m in SKETCH_METRICS}
        if lc.ttft_s is not None:
            sk["ttft"].add(lc.ttft_s)
        if lc.tpot_s is not None:
            sk["tpot"].add(lc.tpot_s)
        if lc.e2e_s is not None:
            sk["e2e"].add(lc.e2e_s)
        if lc.itl_samples_s:
            itl = sk["itl"]
            for s in lc.itl_samples_s:
                itl.add(s)

    # ---------------------------------------------------------- tracking
    def bind_tracker(self, tracker: SloTracker) -> None:
        """Share the shed controller's rolling-SLO tracker: the substrate
        keeps noting into it; the pipeline stops noting (no double
        counting) and its burn-rate monitor reads the shared window."""
        self.tracker = tracker
        self._owns_tracker = False

    def burn_rate(self, app: str) -> float:
        """Rolling SLO burn rate for ``app``."""
        return self.tracker.burn_rate(app, self.slo_target)

    # ---------------------------------------------------------- derived
    def quantile(self, app: str, metric: str, q: float) -> Optional[float]:
        sk = self.sketches.get(app, {}).get(metric)
        if sk is None or sk.count == 0:
            return None
        return sk.query(q)

    def goodput_rps(self) -> float:
        return self.slo_ok / self.t_max if self.t_max > 0 else 0.0

    def attribution_block(self) -> dict:
        return self.assembler.block(self.t_max)

    def snapshot(self) -> dict:
        """Point-in-time streaming metrics — per-app sketch quantiles,
        rolling attainment/burn rate, gauges. Safe to call mid-run."""
        apps = {}
        for app in sorted(self.sketches):
            sk = self.sketches[app]
            st: dict = {}
            for m in SKETCH_METRICS:
                if sk[m].count:
                    st[f"{m}_p50"] = sk[m].query(0.50)
                    st[f"{m}_p99"] = sk[m].query(0.99)
                    st[f"{m}_n"] = sk[m].count
            st["rolling_attainment"] = self.tracker.rolling(app)
            st["burn_rate"] = self.burn_rate(app)
            apps[app] = st
        return {
            "issued": self.issued,
            "completed": self.completed,
            "slo_ok": self.slo_ok,
            "goodput_rps": self.goodput_rps(),
            "queue_depth": len(self._waiting),
            "queue_depth_peak": self.queue_depth_peak,
            "kv_pages": dict(sorted(self._kv_last.items())),
            "kv_pages_peak": dict(sorted(self._kv_peak.items())),
            "apps": apps,
        }
