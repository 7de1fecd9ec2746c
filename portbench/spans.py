"""The program's own scopes in a ``--trace 1`` run, and what the host
slice's trace says of them.

The port's ``TraceRecorder`` records the engine's scopes (``engine.step``
and, inside it, ``engine.admit``, ``engine.prefill``, ``engine.decode``,
``engine.sync``, ``engine.book``) on the engine clock; while a profiler
collects, each scope, and each of the model step's (``model.embed``,
``model.attn.*``, ``model.ffn``, ``model.head``), also opens a host range
named ``rt.<name>``. :func:`scopes` finds the run's scopes for the metric
readers; :func:`read` lays the ``rt.*`` ranges over a stopped profiler's
device operations: the device seconds each innermost range launched
(``device_by_span``, and the longest kernels of each: ``kernels_by_span``),
and each idle gap labelled by the harness's ``pb.*``
span and the innermost ``rt.*`` range open at its middle
(``decode_enqueue/model.attn.kernel``; ``/-`` where none is open).

Run as a script, it makes one traced run of a cell through ``run.py
--trace 1`` and prints both on a line after the result line:

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>
"""
from __future__ import annotations

import statistics
import sys
from pathlib import Path

PB, RT = "pb.", "rt."


# ------------------------------------------------------------------ scopes

def scopes(run) -> list | None:
    """The run's scopes (``Run.scopes`` where the harness gives them, else
    those of the newest recorder of the process, the run's own), or None
    where the program records none."""
    have = getattr(run, "scopes", None)
    if have is None:
        from repro_torch.telemetry import recorder
        latest = getattr(recorder, "latest", None)
        rec = latest() if latest is not None else None
        have = getattr(rec, "scopes", None)
    return None if have is None else list(have)


def window_scopes(run, name: str, untraced: bool = False) -> list | None:
    """The scopes named ``name`` begun in the window; ``untraced`` leaves
    out those of the profiled slices' steps, as ``readings.window_steps``
    leaves out the steps."""
    from portbench import readings
    found = scopes(run)
    if found is None:
        return None
    out = [s for s in found
           if s.name == name and s.t1 is not None
           and readings.in_window(run, s.t0)]
    if untraced:
        traced = [(t0, t1) for t0, t1, tr in run.steps if tr is not None]
        out = [s for s in out
               if not any(a <= s.t0 <= b for a, b in traced)]
    return out


def median_ms(run, name: str) -> float | None:
    """Median duration of the window's untraced ``name`` scopes, in ms."""
    found = window_scopes(run, name, untraced=True)
    if not found:
        return None
    return 1e3 * statistics.median(s.t1 - s.t0 for s in found)


# ------------------------------------------------------------------- trace

def innermost(ranges, points) -> list:
    """For each point, the label of the innermost of ``ranges`` ((start,
    end, label), nested or disjoint) that holds it, or None."""
    rs = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out = [None] * len(points)
    stack: list = []
    j = 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        t = points[k]
        while j < len(rs) and rs[j][0] <= t:
            while stack and stack[-1][1] < rs[j][0]:
                stack.pop()
            stack.append(rs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def _longest(seconds: dict) -> list:
    return sorted(([k, v] for k, v in seconds.items()), key=lambda x: -x[1])


def read(prof) -> dict:
    """From a stopped profiler that traced the host and the device:
    ``device_by_span`` (innermost ``rt.*`` range -> device seconds of the
    operations launched inside it, each found through the correlation id
    of its launching runtime call; ``-`` outside every range; ``?`` where
    the launch was not traced), ``kernels_by_span`` (range -> its four
    longest kernels by name, with their seconds) and ``idle_gaps`` (``<pb
    span>/<rt range>`` -> idle seconds, the gaps as ``trace.read`` cuts
    them). Empty without device operations or ``rt.*`` ranges."""
    import torch

    from portbench.trace import _union
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev, pb, rt, launch = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            if not name.startswith((PB, RT)):       # ranges' shadows
                dev.append((a, b, e.correlation_id(), name))
        elif e.device_type() == cpu:
            if name.startswith(PB):
                pb.append((a, b, name[len(PB):]))
            elif name.startswith(RT):
                rt.append((a, b, name[len(RT):]))
            elif name.startswith("cu"):        # the runtime's calls
                launch.setdefault(e.correlation_id(), a)
    if not dev or not rt:
        return {}
    by_span: dict = {}
    kernels: dict = {}
    at = [launch.get(d[2]) for d in dev]
    found = innermost(rt, [t if t is not None else -1.0 for t in at])
    for (a, b, _, kname), t, name in zip(dev, at, found):
        key = (name or "-") if t is not None else "?"
        by_span[key] = by_span.get(key, 0.0) + (b - a) / 1e6
        k = kernels.setdefault(key, {})
        k[kname] = k.get(kname, 0.0) + (b - a) / 1e6
    busy = _union((d[0], d[1]) for d in dev)
    lo = min([busy[0][0]] + [r[0] for r in pb])
    hi = max([busy[-1][1]] + [r[1] for r in pb])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in gaps]
    idle: dict = {}
    for (a, b), p, r in zip(gaps, innermost(pb, mids), innermost(rt, mids)):
        key = f"{p or 'other'}/{r or '-'}"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
    return {"device_by_span": _longest(by_span),
            "kernels_by_span": {k: [[n[:120], v] for n, v in _longest(d)[:4]]
                                for k, d in kernels.items()},
            "idle_gaps": _longest(idle)}


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    """``run.py --trace 1`` with :func:`read` beside ``trace.read`` on each
    profiled slice; a last line with the host slice's spans."""
    import json
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]
    from portbench import run as bench_run
    from portbench import trace
    read_slice = trace.read
    found: list = []

    def read_both(prof, wall_s):
        found.append(read(prof))
        return read_slice(prof, wall_s)

    trace.read = read_both
    try:
        rc = bench_run.main(list(sys.argv[1:] if argv is None else argv)
                            + ["--trace", "1"])
    finally:
        trace.read = read_slice
    print(json.dumps(next((f for f in found if f), {})), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
