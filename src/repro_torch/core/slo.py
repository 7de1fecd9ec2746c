# Copy of src/repro/core/slo.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Service-Level Objectives and attainment accounting (paper §3, Table 1).

SLO kinds:
  ttft          — time to first token (s)         [Chatbot: 1.0]
  tpot          — time per output token (s)       [Chatbot: 0.25]
  step          — per-iteration time (s)          [ImageGen: 1.0/denoise step]
  segment       — per-audio-segment latency (s)   [LiveCaptions: 2.0]
  e2e           — whole-request latency (s)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class SLO:
    ttft: Optional[float] = None
    tpot: Optional[float] = None
    step: Optional[float] = None
    segment: Optional[float] = None
    e2e: Optional[float] = None

    def is_null(self) -> bool:
        return all(v is None for v in
                   (self.ttft, self.tpot, self.step, self.segment, self.e2e))

    @staticmethod
    def parse(obj) -> "SLO":
        """Accept YAML forms: '1s', 2.0, [ '1s', '0.25s' ], {'ttft': 1, ...}."""
        if obj is None:
            return SLO()
        if isinstance(obj, SLO):
            return obj
        if isinstance(obj, dict):
            return SLO(**{k: _seconds(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            vals = [_seconds(v) for v in obj]
            if len(vals) == 2:
                return SLO(ttft=vals[0], tpot=vals[1])
            return SLO(e2e=vals[0])
        return SLO(e2e=_seconds(obj))


def _seconds(v) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip().lower()
    if s.endswith("ms"):
        return float(s[:-2]) / 1e3
    if s.endswith("s"):
        return float(s[:-1])
    return float(s)


@dataclass
class RequestRecord:
    app: str
    request_id: int
    arrival_s: float
    ttft_s: Optional[float] = None        # first-token latency
    tpot_s: Optional[float] = None        # mean inter-token time
    step_times_s: list = field(default_factory=list)
    e2e_s: Optional[float] = None
    #: individual inter-token gaps (s) — the raw samples behind the
    #: schema-1.7 ``itl_p99`` per-app stat. Engine runs take diffs of the
    #: real per-token timestamps; simulator runs take diffs of decode-item
    #: completion times. Empty = fall back to per-request tpot means.
    itl_samples_s: list = field(default_factory=list)

    def violations(self, slo: SLO) -> dict[str, bool]:
        """kind -> violated?  (only kinds present in the SLO)."""
        out = {}
        if slo.ttft is not None and self.ttft_s is not None:
            out["ttft"] = self.ttft_s > slo.ttft
        if slo.tpot is not None and self.tpot_s is not None:
            out["tpot"] = self.tpot_s > slo.tpot
        if slo.step is not None and self.step_times_s:
            out["step"] = max(self.step_times_s) > slo.step
        if slo.segment is not None and self.e2e_s is not None:
            out["segment"] = self.e2e_s > slo.segment
        if slo.e2e is not None and self.e2e_s is not None:
            out["e2e"] = self.e2e_s > slo.e2e
        return out

    def meets_slo(self, slo: SLO) -> bool:
        return not any(self.violations(slo).values())


@dataclass
class SLOReport:
    app: str
    slo: SLO
    records: list[RequestRecord] = field(default_factory=list)

    @property
    def attainment(self) -> float:
        if not self.records:
            return 1.0
        ok = sum(1 for r in self.records if r.meets_slo(self.slo))
        return ok / len(self.records)

    def latency_stats(self) -> dict:
        import numpy as np
        lat = [r.e2e_s for r in self.records if r.e2e_s is not None]
        if not lat:
            return {}
        a = np.asarray(lat)
        return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "p99": float(np.percentile(a, 99)), "max": float(a.max()),
                "n": len(a)}

    def token_latency_stats(self) -> dict:
        """Schema 1.7 per-app token-latency percentiles (TTFT / TPOT /
        inter-token latency), computed from the SAME RequestRecords the
        SLO accounting reads — no second metrics path. Keys appear only
        when samples exist, so non-token apps (imagegen) stay unchanged."""
        import numpy as np
        out = {}
        ttft = [r.ttft_s for r in self.records if r.ttft_s is not None]
        tpot = [r.tpot_s for r in self.records if r.tpot_s is not None]
        if ttft:
            a = np.asarray(ttft)
            out["ttft_p50"] = float(np.percentile(a, 50))
            out["ttft_p99"] = float(np.percentile(a, 99))
        if tpot:
            a = np.asarray(tpot)
            out["tpot_p50"] = float(np.percentile(a, 50))
            out["tpot_p99"] = float(np.percentile(a, 99))
        itl = [s for r in self.records for s in r.itl_samples_s] or tpot
        if itl:
            out["itl_p99"] = float(np.percentile(np.asarray(itl), 99))
        return out

    def normalized_latency(self) -> float:
        """Mean latency normalized to the SLO bound (paper Fig. 3/5 y-axis)."""
        bound = self.slo.e2e or self.slo.segment or self.slo.step or self.slo.ttft
        st = self.latency_stats()
        if not bound or not st:
            return 0.0
        return st["mean"] / bound
