"""The port's scopes: the serving engine's per-step scope tree in the
``TraceRecorder``, the model step's profiler ranges, and their mirror on
the profiler's clock (``rt.<name>`` host ranges).

A two-layer reduced tinyllama on the CPU, paged, under the ``mixed``
policy. The schedule of ``test_prefill_counts_follow_the_plan`` is worked
out by hand in the test.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import CONFIGS
from repro_torch.models.factory import build_model
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.request import Request
from repro_torch.telemetry import recorder as rec_mod
from repro_torch.telemetry.recorder import TraceRecorder

ENGINE_CHILDREN = {"engine.admit", "engine.prefill", "engine.decode",
                   "engine.sync", "engine.book"}
MODEL_RANGES = {"model.embed", "model.attn.qkv", "model.attn.kv_write",
                "model.attn.kernel", "model.attn.out", "model.ffn",
                "model.head"}


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    cfg = dataclasses.replace(CONFIGS["tinyllama-1.1b"].reduced(),
                              num_layers=2)
    m = build_model(cfg, "cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _engine(model, recorder, **kw):
    m, params = model
    opts = dict(max_slots=4, max_seq=32, policy="mixed", prefill_chunk=8,
                page_size=8)
    opts.update(kw)
    eng = InferenceEngine(m, recorder=recorder, **opts)
    eng.load_params(params)
    return eng


def _requests(lengths, max_new=3):
    rng = np.random.default_rng(3)
    return [Request(i, rng.integers(0, 200, n).astype(np.int32), max_new)
            for i, n in enumerate(lengths)]


def _serve(eng, reqs, steps=None):
    for r in reqs:
        eng.submit(r)
    n = 0
    while (eng.waiting or any(a is not None for a in eng.active)) and (
            steps is None or n < steps):
        eng.step()
        n += 1
    return n


def test_step_scopes_hold_their_children(model):
    rec = TraceRecorder()
    eng = _engine(model, rec)
    steps = _serve(eng, _requests([11, 3, 17, 6, 9], max_new=4))
    by_id = {s.id: s for s in rec.scopes}
    tops = [s for s in rec.scopes if s.parent is None]
    assert [s.name for s in tops] == ["engine.step"] * steps
    kids = [s for s in rec.scopes if s.parent is not None]
    assert kids and {s.name for s in kids} == ENGINE_CHILDREN
    for s in rec.scopes:
        assert s.t1 is not None and s.t0 <= s.t1
    for s in kids:
        parent = by_id[s.parent]
        assert parent.name == "engine.step"      # one level under a step
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    # in each step: admission first, a decode's sync and bookkeeping
    # follow it, and the children do not overlap
    for top in tops:
        mine = [s for s in kids if s.parent == top.id]
        assert mine[0].name == "engine.admit"
        names = [s.name for s in mine]
        if "engine.decode" in names:
            i = names.index("engine.decode")
            assert names[i:] == ["engine.decode", "engine.sync",
                                 "engine.book"]
        for a, b in zip(mine, mine[1:]):
            assert a.t1 <= b.t0
    assert sum(s.name == "engine.prefill" for s in kids) \
        == eng.stats.prefill_dispatches
    assert sum(s.name == "engine.sync" for s in kids) \
        == eng.stats.decode_syncs
    assert sum(s.counts["rows"] for s in kids if s.name == "engine.decode") \
        == eng.stats.decode_tokens


def test_prefill_counts_follow_the_plan(model):
    """4 slots, chunk 8, ``mixed``: a step's prefill budget is
    round(2 x 8 x 0.5) = 8 tokens. Prompts of 11 and 3 tokens arrive
    together. Step 1 splits 8 over the two (4 each, capped at what is left:
    4 and 3) and gives the one token left to the first: pieces 5 and 3, one
    dispatch of 4 rows x 5, 8 useful. Step 2 finishes the first prompt's 6
    in one piece: 4 rows x 6, 6 useful. Then only decode. The bundle
    packs the active rows (``packs_prefill_rows``): the model computes 2
    rows, then 1."""
    rec = TraceRecorder()
    eng = _engine(model, rec)
    reqs = _requests([11, 3])
    _serve(eng, reqs)
    pf = [s for s in rec.scopes if s.name == "engine.prefill"]
    assert [s.counts for s in pf] == [
        {"rows": 4, "width": 5, "useful": 8, "computed": 2},
        {"rows": 4, "width": 6, "useful": 6, "computed": 1}]
    step_of = {s.id: s.parent for s in rec.scopes}
    tops = [s.id for s in rec.scopes if s.parent is None]
    assert [tops.index(step_of[s.id]) for s in pf] == [0, 1]
    # the wall clock: both rows of the batched dispatch carry its span,
    # which begins inside the dispatch's scope, before the model call
    rows = [e for e in rec.events if e.kind == "prefill"]
    assert [(e.request_id, e.tokens) for e in rows] == [(0, 5), (1, 3),
                                                       (0, 6)]
    assert rows[0].t0 == rows[1].t0
    for e, s in ((rows[0], pf[0]), (rows[1], pf[0]), (rows[2], pf[1])):
        assert s.t0 <= e.t0 <= s.t1 <= e.t1


def test_prefill_computes_every_row_without_packing():
    """A MoE bundle keeps today's dispatch: the plan of step 1 falls back
    to per-slot dispatches (pieces 5 and 3), then the first prompt's 6,
    and the model computes every slot's row in each."""
    cfg = dataclasses.replace(CONFIGS["moonshot-v1-16b-a3b"].reduced(),
                              num_layers=2)
    m = build_model(cfg, "cpu")
    assert not m.packs_prefill_rows()
    rec = TraceRecorder()
    eng = _engine((m, m.init(torch.Generator().manual_seed(0))), rec)
    _serve(eng, _requests([11, 3]))
    pf = [s for s in rec.scopes if s.name == "engine.prefill"]
    assert [s.counts for s in pf] == [
        {"rows": 4, "width": 5, "useful": 5, "computed": 4},
        {"rows": 4, "width": 3, "useful": 3, "computed": 4},
        {"rows": 4, "width": 6, "useful": 6, "computed": 4}]


def _ranges(prof):
    cpu = torch.autograd.DeviceType.CPU
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[3:])
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cpu and e.name().startswith("rt.")]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _parents(ranges):
    """Index of the innermost range around each (None at the top)."""
    out = []
    for i, (a, b, _) in enumerate(ranges):
        around = [j for j in range(i) if ranges[j][0] <= a
                  and b <= ranges[j][1]]
        out.append(around[-1] if around else None)
    return out


def test_scopes_are_mirrored_on_the_profiler(model):
    rec = TraceRecorder()
    eng = _engine(model, rec)
    reqs = _requests([11, 3, 17], max_new=3)
    for r in reqs:
        eng.submit(r)
    eng.step()                       # admission and the first piece
    n0 = len(rec.scopes)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            eng.step()
    scopes = list(rec.scopes)[n0:]
    ranges = _ranges(prof)
    eng_ranges = [r for r in ranges if r[2].startswith("engine.")]
    assert [r[2] for r in eng_ranges] == [s.name for s in scopes]
    # the same nesting: each range's parent is its scope's parent's range
    index = {s.id: i for i, s in enumerate(scopes)}
    par = _parents(eng_ranges)
    assert par == [index.get(s.parent) for s in scopes]
    for (a, b, _), s in zip(eng_ranges, scopes):
        dur, want = (b - a) / 1e9, s.t1 - s.t0
        assert abs(dur - want) <= max(0.1 * want, 50e-6), (s.name, dur, want)
    # the model step's ranges, inside the dispatches' scopes
    model_r = [r for r in ranges if r[2].startswith("model.")]
    assert {r[2] for r in model_r} == MODEL_RANGES
    allp = _parents(ranges)
    for i, r in enumerate(ranges):
        if r[2].startswith("model."):
            j = allp[i]
            while ranges[j][2].startswith("model."):
                j = allp[j]
            assert ranges[j][2] in ("engine.prefill", "engine.decode")
    layers = model[0].cfg.num_layers
    decodes = sum(s.name == "engine.decode" for s in scopes)
    prefills = sum(s.name == "engine.prefill" for s in scopes)
    count = {n: sum(r[2] == n for r in model_r) for n in MODEL_RANGES}
    dispatches = decodes + prefills
    assert count == {"model.embed": dispatches, "model.head": dispatches,
                     "model.attn.qkv": 2 * layers * dispatches,
                     "model.attn.kv_write": (layers + 1) * dispatches,
                     "model.attn.kernel": layers * dispatches,
                     "model.attn.out": layers * dispatches,
                     "model.ffn": layers * dispatches}


def test_no_range_without_a_profiler_and_no_scope_without_a_recorder(
        model, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    idle = rec_mod.scope("model.ffn")
    assert idle is rec_mod.scope("model.head")       # one shared no-op
    assert not isinstance(idle, torch._C._profiler._RecordFunctionFast)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(rec_mod.scope("model.ffn"),
                          torch._C._profiler._RecordFunctionFast)
    def refuse(*args, **kwargs):
        raise AssertionError("a scope recorded without a recorder")

    opened = []
    monkeypatch.setattr(TraceRecorder, "scope", refuse)
    import repro_torch.models.transformer as tr
    monkeypatch.setattr(tr, "scope",
                        lambda name: opened.append(name) or idle)
    eng = _engine(model, None)
    assert eng._scope("engine.step") is engine_mod._NO_SCOPE
    reqs = _requests([5, 9])
    _serve(eng, reqs)
    assert all(len(r.tokens_out) == 3 for r in reqs)
    assert opened and set(opened) == MODEL_RANGES   # the model's alone


def test_scopes_stay_out_of_events_counters_and_sinks(model):
    class Sink:
        seen = []

        def on_event(self, e):
            self.seen.append(e.kind)

    rec = TraceRecorder()
    rec.subscribe(Sink())
    eng = _engine(model, rec)
    _serve(eng, _requests([7, 4]))
    assert rec.scopes
    assert set(Sink.seen) <= set(rec_mod.EVENT_KINDS)
    assert len(Sink.seen) == len(rec.events)
    assert all(not k.startswith("engine.") for k in rec.counts())
    assert all(k.startswith("kv_pages") for k in rec.counters)
    ring = TraceRecorder(ring=5)
    for i in range(8):
        with ring.scope("s", rows=i):
            pass
    assert [s.id for s in ring.scopes] == [3, 4, 5, 6, 7]
    assert rec_mod.latest() is ring
