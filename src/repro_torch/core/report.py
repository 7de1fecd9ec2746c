# Copy of src/repro/core/report.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Benchmark report generation (paper §3.2 step 4)."""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.simulator import SimResult


def render_report(result: SimResult, *, title: str = "ConsumerBench report",
                  extra: Optional[dict] = None) -> str:
    s = result.summary()
    lines = [f"# {title}", "",
             f"strategy={s['strategy']} chips={result.total_chips} "
             f"({result.chip.name})",
             f"makespan={s['makespan_s']:.2f}s "
             f"utilization={s['utilization'] * 100:.1f}% "
             f"energy={s['energy_kj']:.1f}kJ", "",
             f"{'app':<28} {'SLO%':>6} {'norm-lat':>9} {'mean':>8} "
             f"{'p95':>8} {'n':>5}"]
    for name, a in s["apps"].items():
        lines.append(
            f"{name:<28} {a['slo_attainment'] * 100:>5.1f}% "
            f"{a.get('normalized_latency', 0):>9.2f} "
            f"{a.get('mean', 0):>8.3f} {a.get('p95', 0):>8.3f} "
            f"{a.get('n', 0):>5}")
    if extra:
        lines += ["", "## extra", json.dumps(extra, indent=1, default=str)]
    return "\n".join(lines)


def summary_row(result: SimResult, app: str) -> dict:
    a = result.summary()["apps"][app]
    return {"app": app, "strategy": result.strategy,
            "slo": a["slo_attainment"], "norm_lat": a.get("normalized_latency"),
            "mean_s": a.get("mean"), "p95_s": a.get("p95")}
