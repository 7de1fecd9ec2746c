"""The traced slice of a ``--trace 1`` run: host spans, the profiler, and
what is read from its trace.

The harness marks what the host is doing with ``record_function`` ranges
named ``pb.<label>`` (admission, prefill_enqueue, decode_enqueue,
argmax_wait, client), from outside the program (the program is not
edited). A fixed number of
engine steps inside the window runs under ``torch.profiler``; its device
events give the busy time, the kernels' times and the idle gaps, each gap
labelled by the host span open at its middle.
"""
from __future__ import annotations

import bisect

import torch

PREFIX = "pb."


class Spans:
    """One open host span at a time (``enter`` closes the last); nothing
    at all unless ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self._cur = None

    def enter(self, label: str) -> None:
        if not self.on:
            return
        self.close()
        self._cur = torch.profiler.record_function(PREFIX + label)
        self._cur.__enter__()

    def close(self) -> None:
        if self._cur is not None:
            self._cur.__exit__(None, None, None)
            self._cur = None


#: the two slices a traced run profiles, back to back: ``device`` traces
#: the card alone (busy time, kernels, idle share: tracing every host op
#: would slow the host and add idle time of its own), ``host`` adds the
#: host's ops and ranges (what the host did in each gap)
SLICES = ("device", "host")


def start(device: torch.device, which: str):
    from torch.profiler import ProfilerActivity, profile
    acts = []
    if which == "host" or device.type != "cuda":
        acts.append(ProfilerActivity.CPU)
    if device.type == "cuda":
        torch.cuda.synchronize()
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_ranges(prof):
    cpu = torch.autograd.DeviceType.CPU
    return (e for e in prof.profiler.kineto_results.events()
            if e.device_type() == cpu and e.name().startswith(PREFIX))


def read(prof, wall_s: float) -> dict:
    """A slice's numbers from a stopped profiler: ``busy_s`` (union of
    device operations), ``window_s`` (``wall_s``, the slice's length on
    the host clock, from a synchronize to a synchronize), ``kernels`` (name
    -> [seconds, launches]), ``kernel_s`` (their sum), and where the host
    was traced ``idle`` (host span -> idle seconds between device
    operations)."""
    dev = []
    kernels: dict = {}
    cuda = torch.autograd.DeviceType.CUDA
    # the device's operations straight from the profiler's raw events
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != cuda or name.startswith(PREFIX):
            continue                    # host ops, and the ranges' shadows
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        dev.append((a, b))
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) / 1e6
        k[1] += 1
    host = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
             e.name()[len(PREFIX):]) for e in _host_ranges(prof)]
    if not dev:
        return {}
    busy = _union(dev)
    out = {"busy_s": sum(b - a for a, b in busy) / 1e6, "window_s": wall_s,
           "kernels": kernels,
           "kernel_s": sum(v[0] for v in kernels.values()), "idle": {}}
    if not host:
        return out
    lo = min(busy[0][0], min(a for a, _, _ in host))
    hi = max(busy[-1][1], max(b for _, b, _ in host))
    host.sort()
    starts = [h[0] for h in host]
    idle = out["idle"]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = (host[i][2] if i >= 0 and host[i][0] <= mid <= host[i][1]
                 else "other")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return out


def breakdown(traced: dict) -> dict:
    """The device slice's ten longest kernels, and the host slice's idle
    time by what the host was doing."""
    ops = sorted(((n, v[0]) for n, v in traced["device"]["kernels"].items()),
                 key=lambda x: -x[1])[:10]
    idle = sorted(traced.get("host", {}).get("idle", {}).items(),
                  key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def kernel_time(t: dict, needle: str) -> tuple[float, int]:
    """Seconds and launches of the kernels whose name contains ``needle``."""
    s = n = 0
    for name, (sec, cnt) in t["kernels"].items():
        if needle in name:
            s += sec
            n += cnt
    return s, n
