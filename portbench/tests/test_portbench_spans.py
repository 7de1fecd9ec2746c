"""The program's scopes in the benchmark: ``spans.read`` on a synthetic
profiler trace (device seconds by the innermost ``rt.*`` range, idle gaps
labelled ``pb/rt``), ``trace.read`` unmoved by the program's host ranges,
and the two readers of the engine's scopes on tiny runs."""
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from portbench import readings, spans, trace
from portbench.tests.tiny import few_threads, tiny_root  # noqa: F401

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, a_us, b_us, corr=0):
        self._v = (name, dev, int(a_us * 1e3), int((b_us - a_us) * 1e3), corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


HOST = [Ev("pb.decode_enqueue", CPU, 0, 100),
        Ev("pb.argmax_wait", CPU, 100, 150)]
RANGES = [Ev("rt.engine.decode", CPU, 5, 98, 1),
          Ev("rt.model.attn.qkv", CPU, 10, 30, 2),
          Ev("rt.model.attn.kernel", CPU, 40, 60, 3),
          Ev("rt.model.ffn", CPU, 70, 95, 4)]
RUNTIME = [Ev("cudaMemcpyAsync", CPU, 7, 7.5, 100),
           Ev("cudaLaunchKernel", CPU, 12, 13, 101),
           Ev("cudaLaunchKernelExC", CPU, 45, 46, 102),
           Ev("cuLaunchKernel", CPU, 75, 76, 103),
           Ev("aten::mm", CPU, 11, 14, 101)]     # an op id, not a launch
DEVICE = [Ev("Memcpy HtoD", CUDA, 8, 9, 100),
          Ev("sgemm", CUDA, 20, 35, 101),
          Ev("paged_decode_kernel", CUDA, 50, 52, 102),
          Ev("sgemm", CUDA, 80, 130, 103),
          Ev("elementwise", CUDA, 140, 141, 999)]   # launch not traced


def _close(got, want):
    assert sorted(k for k, _ in got) == sorted(want)
    for k, v in got:
        assert v == pytest.approx(want[k], rel=1e-9, abs=1e-12), k


def test_device_time_and_idle_gaps_by_span():
    # a user annotation's shadow on the device, as record_function leaves
    shadow = [Ev("rt.engine.decode", CUDA, 8, 130, 1)]
    got = spans.read(_prof(HOST + RANGES + RUNTIME + DEVICE + shadow))
    _close(got["device_by_span"],
           {"engine.decode": 1e-6, "model.attn.qkv": 15e-6,
            "model.attn.kernel": 2e-6, "model.ffn": 50e-6, "?": 1e-6})
    assert got["kernels_by_span"]["model.attn.kernel"] == [
        ["paged_decode_kernel", pytest.approx(2e-6)]]
    assert got["kernels_by_span"]["engine.decode"] == [
        ["Memcpy HtoD", pytest.approx(1e-6)]]
    _close(got["idle_gaps"],
           {"decode_enqueue/-": 8e-6, "decode_enqueue/model.attn.qkv": 11e-6,
            "decode_enqueue/model.attn.kernel": 15e-6,
            "decode_enqueue/engine.decode": 28e-6,
            "argmax_wait/-": 19e-6})
    assert spans.read(_prof(HOST + RUNTIME + DEVICE)) == {}


def test_trace_read_is_unmoved_by_the_program_ranges():
    """The program's ranges are host ops with no device shadow: the
    harness's reading of a slice is the same with them as without."""
    base = HOST + RUNTIME + DEVICE
    with_ranges = trace.read(_prof(base + RANGES), 1.0)
    assert with_ranges == trace.read(_prof(base), 1.0)
    assert not any(k.startswith("rt.") for k in with_ranges["kernels"])
    assert with_ranges["idle"] == pytest.approx(
        {"decode_enqueue": 62e-6, "argmax_wait": 19e-6})
    # the gaps split by span add up to the harness's gaps
    by_pb = Counter()
    for k, v in spans.read(_prof(base + RANGES))["idle_gaps"]:
        by_pb[k.split("/")[0]] += v
    assert dict(by_pb) == pytest.approx(with_ranges["idle"])


def test_innermost_range_of_each_point():
    ranges = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 9, "d"),
              (20, 30, "e")]
    points = [25, 3.5, 1, 4.5, 7, 9.5, 15, 31, 2]
    assert spans.innermost(ranges, points) == [
        "e", "c", "a", "b", "d", "a", None, None, "b"]


def _reading(root, cell):
    """A traced tiny run's result, its ``Run`` and its scopes (read while
    the run is on, as the readers read them)."""
    seen = {}
    from portbench import harness
    c = harness.load_cell(cell, root, root / "portbench")
    out = harness.execute(c, 2**31 + 11, 2.0, True, "cpu",
                          log=lambda s: None,
                          on_run=lambda run, r: seen.update(
                              run=run, scopes=spans.scopes(run)))
    return out, seen["run"], seen["scopes"]


def test_prefill_row_use_reads_the_engine_scopes(tiny_root, few_threads):
    out, run, scopes = _reading(tiny_root, "t.open")
    got = out["metrics"]["prefill_row_use"]["value"]
    assert 0 < got <= 100
    # the scopes' counts are the harness's own record of each dispatch
    pf = [s for s in scopes if s.name == "engine.prefill"
          and s.t0 >= run.steps[0][0]]
    assert Counter((s.counts["rows"], s.counts["width"], s.counts["useful"])
                   for s in pf) == Counter(
        (d["B"], d["C"], sum(n for _, n, _ in d["rows"]))
        for d in run.dispatches if d["kind"] == "prefill")
    win = [s for s in pf if run.w0 <= s.t0 < run.w1]
    assert got == pytest.approx(
        100 * sum(s.counts["useful"] for s in win)
        / sum(s.counts["rows"] * s.counts["width"] for s in win))


def test_decode_issue_ms_reads_the_engine_scopes(tiny_root, few_threads):
    out, run, scopes = _reading(tiny_root, "t.dense")
    got = out["metrics"]["decode_issue_ms"]["value"]
    # the median decode issue lies inside the window's untraced steps
    walls = [run.steps[i][1] - run.steps[i][0]
             for i in readings.window_steps(run)]
    assert 0 < got < 1e3 * max(walls)
    assert sum(s.name == "engine.decode" for s in scopes) \
        >= len(walls)
    assert "prefill_row_use" not in out["metrics"]      # not this cell's


def test_readers_read_nothing_where_the_program_has_no_scopes(monkeypatch):
    from portbench import harness
    from repro_torch.telemetry import recorder
    monkeypatch.delattr(recorder, "latest")    # as on a program without
    run = SimpleNamespace(w0=0.0, w1=10.0, steps=[])
    for name in ("prefill_row_use", "decode_issue_ms"):
        assert harness.load_reader(name)(run) is None
