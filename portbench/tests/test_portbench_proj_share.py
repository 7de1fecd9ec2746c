"""``decode_proj_kernel_share`` on hand-made scopes and on a tiny traced
run: the engine's ``engine.decode`` scopes count the model step's
projections and those that took the skinny GEMM kernel, and the reader
divides the one by the other over the window."""
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests.test_portbench_spans import _reading
from portbench.tests.tiny import few_threads, tiny_root  # noqa: F401


def _scope(t0, name="engine.decode", **counts):
    return SimpleNamespace(name=name, t0=t0, t1=t0 + 0.5, counts=counts)


def _run(scopes):
    return SimpleNamespace(w0=0.0, w1=10.0, steps=[], scopes=scopes)


def test_share_of_the_window_decode_projections():
    read = harness.load_reader("decode_proj_kernel_share")
    scopes = [_scope(1.0, rows=8, proj_kernel=49, proj_calls=49),
              _scope(2.0, rows=4, proj_kernel=0, proj_calls=49),
              _scope(3.0, name="engine.prefill", rows=8, width=4, useful=4),
              _scope(12.0, rows=8, proj_kernel=0, proj_calls=49)]  # after
    assert read(_run(scopes)) == pytest.approx(50.0)


def test_reads_nothing_where_the_scopes_lack_proj_calls():
    """As on a program without the kernel's route, whose decode scopes
    count the rows alone; or where no projection ran."""
    read = harness.load_reader("decode_proj_kernel_share")
    assert read(_run([_scope(1.0, rows=8)])) is None
    assert read(_run([_scope(1.0, rows=8, proj_kernel=49, proj_calls=49),
                      _scope(2.0, rows=8)])) is None
    assert read(_run([_scope(1.0, rows=8, proj_kernel=0,
                             proj_calls=0)])) is None
    assert read(_run([])) is None


def test_tiny_cpu_run_counts_every_projection_on_the_plain_route(
        tiny_root, few_threads):
    """On the CPU every projection takes the plain route: the scopes count
    them (one fused qkv, wo, gate and up, down a layer, and the head) and
    the share reads 0."""
    out, run, scopes = _reading(tiny_root, "t.dense")
    win = [s for s in scopes if s.name == "engine.decode"
           and run.w0 <= s.t0 < run.w1]
    assert win
    for s in win:
        assert s.counts["proj_kernel"] == 0
        assert s.counts["proj_calls"] == 4 * run.model["num_layers"] + 1
    assert out["metrics"]["decode_proj_kernel_share"]["value"] == 0.0
    assert "decode_proj_kernel_share" not in _reading(tiny_root, "t.open")[
        0]["metrics"]                                # not this cell's
