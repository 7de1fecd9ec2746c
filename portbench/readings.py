"""Arithmetic the metric readers share (``metrics/<name>.py``)."""
from __future__ import annotations

import math

import numpy as np

from portbench import roofline


def percentile(values, q: float) -> float | None:
    return float(np.percentile(np.asarray(values, float), q)) if len(values) else None


def in_window(run, t: float) -> bool:
    return run.w0 <= t < run.w1


def ttft_s(run, r) -> float:
    """Arrival to first token; a request with none by the drain's end
    counts as waiting until then (a lower bound of its TTFT)."""
    end = r.t_first_token if r.t_first_token is not None else run.t_end
    return end - r.arrival_s


def token_gaps_s(run) -> list:
    """Every gap between consecutive tokens of a request whose later token
    was emitted in the window."""
    out = []
    for r in run.requests:
        t = r.t_tokens
        out.extend(b - a for a, b in zip(t, t[1:]) if in_window(run, b))
    return out


def window_steps(run) -> set:
    """Indices of the steps begun in the window, the traced slice left
    out (the profiler slows it)."""
    return {i for i, (t0, _, traced) in enumerate(run.steps)
            if in_window(run, t0) and not traced}


def step_mfu(run) -> float | None:
    """Model FLOPs of the window's steps over their host wall times at the
    card's dense bfloat16 peak, in %."""
    if run.peaks is None:
        return None
    keep = window_steps(run)
    wall = sum(run.steps[i][1] - run.steps[i][0] for i in keep)
    flops = sum(run.ref.dispatch_flops(run.model,
                                        [(s, n) for s, n, _ in d["rows"]],
                                        d["kind"] == "decode", run.vocab)
                for d in run.dispatches if d["step"] in keep)
    if wall <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (wall * run.peaks["bf16_mma_flops_per_s"])


def device_idle(run) -> float | None:
    t = (run.traced or {}).get("device")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _table_bytes(rows, page: int, extra: int) -> int:
    return sum(4 * math.ceil((s + n + extra) / page) for s, n, _ in rows)


def kernel_roofline(run, kind: str, needle: str) -> float | None:
    """Sum of the least times of the device slice's launches of one paged
    kernel over the profiler's device time of the same launches, in %.
    None where the trace holds none, or other launches than the slice's
    dispatches account for (one a layer each)."""
    from portbench import trace
    t, pk = (run.traced or {}).get("device"), run.peaks
    if not t or pk is None:
        return None
    m = run.model
    h, kv, d = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    disp = [x for x in run.dispatches if x["traced"] == "device"
            and x["kind"] == kind and x["rows"]]
    secs, launches = trace.kernel_time(t, needle)
    if not disp or launches != len(disp) * m["num_layers"] or secs <= 0:
        return None
    bound = 0.0
    for x in disp:
        rows = x["rows"]
        if kind == "decode":
            bound += roofline.decode_bound_s(
                pk, len(rows), [s + 1 for s, _, _ in rows], h, kv, d,
                _table_bytes(rows, x["page"], 0))
        else:
            bound += roofline.prefill_bound_s(
                pk, [(s, n) for s, n, _ in rows], h, kv, d,
                _table_bytes(rows, x["page"], 0))
    return 100.0 * bound * m["num_layers"] / secs
