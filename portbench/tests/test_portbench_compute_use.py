"""``prefill_compute_use`` on a tiny traced run: the engine's
``engine.prefill`` scopes count the rows the model computed, and the
reader divides the real tokens by those rows' cells."""
from types import SimpleNamespace

import pytest

from portbench.tests.test_portbench_spans import _reading
from portbench.tests.tiny import few_threads, tiny_root  # noqa: F401


def test_prefill_compute_use_reads_the_engine_scopes(tiny_root,
                                                     few_threads):
    out, run, scopes = _reading(tiny_root, "t.open")
    got = out["metrics"]["prefill_compute_use"]["value"]
    win = [s for s in scopes if s.name == "engine.prefill"
           and run.w0 <= s.t0 < run.w1]
    assert win and 0 < got <= 100
    assert got == pytest.approx(
        100 * sum(s.counts["useful"] for s in win)
        / sum(s.counts["computed"] * s.counts["width"] for s in win))
    # the tiny cell's bundle packs its rows: fewer computed than recorded
    assert all(s.counts["computed"] <= s.counts["rows"] for s in win)
    assert got > out["metrics"]["prefill_row_use"]["value"]
    assert "prefill_compute_use" not in _reading(tiny_root, "t.dense")[0][
        "metrics"]                                   # not this cell's


def test_reads_nothing_where_the_scopes_lack_computed():
    """As on a program whose dispatch runs every slot's row."""
    from portbench import harness
    scope = SimpleNamespace(name="engine.prefill", t0=1.0, t1=2.0,
                            counts={"rows": 8, "width": 4, "useful": 4})
    run = SimpleNamespace(w0=0.0, w1=10.0, steps=[], scopes=[scope])
    assert harness.load_reader("prefill_compute_use")(run) is None
    assert harness.load_reader("prefill_row_use")(run) == 12.5
