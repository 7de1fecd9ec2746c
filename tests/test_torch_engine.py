"""The port's InferenceEngine against the JAX engine.

Same weights (JAX initialiser, carried across by ``params_from_jax``),
same ``chat_trace`` requests, same geometry (``page_size`` and
``prefill_chunk`` given, so neither engine consults an autotuner). On the
paged cache, four configurations: plain paged, eviction under a small
pool, prefix cache with copy-on-write forks, and the ``mixed`` step-budget
policy. On the contiguous cache, tinyllama with ``paged=False`` and
reduced mamba2 (whose recurrent state never pages), each under the
``chunked`` and ``mixed`` policies. Token streams must be identical, and
so must the EngineStats counters. The options the Scenario runner drives
(virtual clock, time warp, crash, abort, stolen pages, watermarks,
``prefix_peek``) run both engines in lockstep: clock, stats, finished
requests and recorder events equal after every step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.registry import CONFIGS  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.request import Request, chat_trace  # noqa: E402
from repro.telemetry.recorder import TraceRecorder as JRecorder  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402
from repro_torch.telemetry.recorder import \
    TraceRecorder as TRecorder  # noqa: E402

torch.set_num_threads(2)

STATS = ("steps", "prefill_tokens", "decode_tokens", "prefill_dispatches",
         "evictions", "recompute_tokens", "prefix_hit_tokens", "cow_forks",
         "pages_in_use")


@pytest.fixture(scope="module")
def mamba():
    """Reduced mamba2 with 2 layers (tests/test_serving.py's
    test_engine_ssm_family)."""
    jcfg = dataclasses.replace(CONFIGS["mamba2-1.3b"].reduced(),
                               num_layers=2)
    tcfg = dataclasses.replace(TCONFIGS["mamba2-1.3b"].reduced(),
                               num_layers=2)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = tbuild(tcfg, "cpu")
    return jm, jparams, tm, params_from_jax(_flatten(jparams), "cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(CONFIGS["tinyllama-1.1b"].reduced(),
                               num_layers=2)
    tcfg = dataclasses.replace(TCONFIGS["tinyllama-1.1b"].reduced(),
                               num_layers=2)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = tbuild(tcfg, "cpu")
    return jm, jparams, tm, params_from_jax(_flatten(jparams), "cpu")


def _chat(cfg, n=6, max_new=6):
    return chat_trace(n, cfg.vocab_size, mean_prompt=14, max_new=max_new,
                      seed=11)


def _shared_prefix(cfg, n=4, sys_len=12, tail_len=5, max_new=4):
    """Requests sharing a literal system prompt: what prefix sharing is for."""
    rng = np.random.default_rng(7)
    sys_block = rng.integers(0, cfg.vocab_size, sys_len)
    return [Request(i, np.concatenate(
        [sys_block, rng.integers(0, cfg.vocab_size, tail_len)]
    ).astype(np.int32), max_new) for i in range(n)]


def _serve(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, **kw)
    eng.load_params(params)
    for r in reqs:
        eng.submit(request_cls(r.request_id, np.array(r.prompt),
                               r.max_new_tokens, arrival_s=r.arrival_s))
    done = {r.request_id: list(r.tokens_out) for r in eng.run()}
    assert len(done) == len(reqs)
    return done, eng.stats


CONFIGS_UNDER_TEST = {
    "paged": (_chat, dict(max_slots=4, max_seq=64, policy="chunked",
                          prefill_chunk=8, page_size=8)),
    "eviction": (_chat, dict(max_slots=4, max_seq=64, policy="chunked",
                             prefill_chunk=4, page_size=4, kv_pages=8)),
    "prefix_cache": (_shared_prefix, dict(max_slots=2, max_seq=64,
                                          policy="chunked", prefill_chunk=4,
                                          page_size=8, prefix_cache=True)),
    "mixed": (_chat, dict(max_slots=4, max_seq=64, policy="mixed",
                          prefill_chunk=4, page_size=4)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS_UNDER_TEST))
def test_engine_streams_and_stats_match_jax(models, name):
    jm, jparams, tm, tparams = models
    trace, kw = CONFIGS_UNDER_TEST[name]
    reqs = trace(jm.cfg)
    want, jstats = _serve(JEngine, Request, jm, jparams, reqs, paged=True,
                          **kw)
    got, tstats = _serve(TEngine, TRequest, tm, tparams, reqs, **kw)
    assert got == want
    for field in STATS:
        assert getattr(tstats, field) == getattr(jstats, field), field
    # each configuration exercises what it is named for
    if name == "eviction":
        assert tstats.evictions > 0 and tstats.recompute_tokens > 0
    if name == "prefix_cache":
        assert tstats.prefix_hit_tokens > 0 and tstats.cow_forks > 0
    if name == "mixed":
        assert tstats.mixed_steps == jstats.mixed_steps > 0


CONTIGUOUS = {
    "chunked": dict(max_slots=4, max_seq=64, policy="chunked",
                    prefill_chunk=8),
    "mixed": dict(max_slots=4, max_seq=64, policy="mixed", prefill_chunk=4),
}


@pytest.mark.parametrize("policy", sorted(CONTIGUOUS))
def test_contiguous_engine_streams_and_stats_match_jax(models, policy):
    """tinyllama on the contiguous KV cache (``paged=False``)."""
    jm, jparams, tm, tparams = models
    kw = CONTIGUOUS[policy]
    reqs = _chat(jm.cfg)
    want, jstats = _serve(JEngine, Request, jm, jparams, reqs, paged=False,
                          **kw)
    got, tstats = _serve(TEngine, TRequest, tm, tparams, reqs, paged=False,
                         **kw)
    assert got == want
    for field in STATS + ("decode_syncs", "mixed_steps", "budget_enabled"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    assert tstats.pages_in_use == 0
    if policy == "mixed":
        assert tstats.mixed_steps > 0


SSM_CONFIGS = {
    "chunked": dict(max_slots=2, max_seq=64, policy="chunked",
                    prefill_chunk=4),
    "mixed": dict(max_slots=4, max_seq=64, policy="mixed", prefill_chunk=4),
}


@pytest.mark.parametrize("policy", sorted(SSM_CONFIGS))
def test_ssm_engine_streams_and_stats_match_jax(mamba, policy):
    """Reduced mamba2: its state is slot-resident, so both engines serve
    it on the contiguous path by themselves (``cache_pages()`` is False);
    mixed batching pads rows under ``valid`` (dt = 0 on pads)."""
    jm, jparams, tm, tparams = mamba
    kw = SSM_CONFIGS[policy]
    reqs = chat_trace(5, jm.cfg.vocab_size, mean_prompt=8, max_new=4, seed=3)
    want, jstats = _serve(JEngine, Request, jm, jparams, reqs, **kw)
    got, tstats = _serve(TEngine, TRequest, tm, tparams, reqs, **kw)
    assert got == want
    for field in STATS + ("decode_syncs", "mixed_steps", "budget_enabled"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    if policy == "mixed":
        assert tstats.mixed_steps > 0


def test_engine_refuses_what_is_not_ported(models, mamba, tmp_path,
                                           monkeypatch):
    """What stays refused: the paged cache for mamba2 (as in JAX; the
    other families' refusals are in tests/test_torch_families.py). An
    engine built without ``page_size`` and ``prefill_chunk`` starts:
    it takes the tuner's picks, which are the JAX engine's (each package's
    tuner on its own empty cache file)."""
    from repro.kernels import autotune as jtune
    from repro_torch.kernels import autotune as ttune
    jm, _, tm, _ = models
    _, _, sm, _ = mamba
    for tune, name in ((jtune, "jax.json"), (ttune, "torch.json")):
        monkeypatch.setattr(tune, "cache_path",
                            lambda name=name: str(tmp_path / name))
        tune.reset()
    for kw in (dict(max_slots=2, max_seq=32), dict(max_slots=4, max_seq=512),
               dict(max_slots=2, max_seq=32, paged=False)):
        te, je = TEngine(tm, **kw), JEngine(jm, **kw)
        assert (te.paged, te.prefill_chunk, te.page_size) == \
            (je.paged, je.prefill_chunk, je.page_size), kw
        if te.paged:
            assert te.allocator.page_size == je.allocator.page_size
    assert (tmp_path / "torch.json").exists()
    jtune.reset()
    ttune.reset()
    with pytest.raises(ValueError, match="cannot page"):
        TEngine(sm, max_slots=2, max_seq=32, paged=True, page_size=4,
                prefill_chunk=4)
    with pytest.raises(ValueError, match="no KV to page"):
        sm.init_paged_cache(4, 4, 2, 32)
    with pytest.raises(ValueError, match="prefix sharing needs"):
        TEngine(sm, max_slots=2, max_seq=32, prefill_chunk=4,
                prefix_cache=True)
    # a page budget the contiguous cache's up-front reservation exceeds
    with pytest.raises(ValueError, match="exceeding the page budget"):
        TEngine(tm, max_slots=4, max_seq=64, prefill_chunk=4, paged=False,
                kv_pages=8, page_size=4)


@pytest.mark.parametrize("name", ["eviction", "mixed", "prefix_cache"])
def test_engine_trace_events_match_jax(models, name):
    """With a recorder attached, both engines emit the same events: the
    same count of each kind, the same event sequence, and the same
    KV-occupancy samples (times aside: both read the wall clock)."""
    jm, jparams, tm, tparams = models
    trace, kw = CONFIGS_UNDER_TEST[name]
    reqs = trace(jm.cfg)
    jrec, trec = JRecorder(), TRecorder()
    _serve(JEngine, Request, jm, jparams, reqs, paged=True, recorder=jrec,
           **kw)
    _serve(TEngine, TRequest, tm, tparams, reqs, recorder=trec, **kw)
    assert trec.counts() == jrec.counts()
    assert [(e.kind, e.request_id, e.tokens) for e in trec.events] == \
        [(e.kind, e.request_id, e.tokens) for e in jrec.events]
    assert {k: [v for _, v in pts] for k, pts in trec.counters.items()} == \
        {k: [v for _, v in pts] for k, pts in jrec.counters.items()}
    kinds = {"eviction": "evict", "mixed": "preempt",
             "prefix_cache": "cow_fork"}
    assert trec.counts()[kinds[name]] > 0


# ------------------------------------------------- the Scenario's options
def _cost(req, kind, tokens):
    """Per-request virtual costs (the runner's request_cost_s shape): each
    request its own rates, a prefix gather cheaper than a prefill."""
    rate = {"prefill": 1e-3, "decode": 4e-3, "prefix_gather": 1e-4}[kind]
    return rate * tokens * (1 + req.request_id % 3)


def _work(req, kind, tokens):
    return (1e9 * tokens * (1 + req.request_id % 2), 1e6 * tokens)


def _step_cost(kind, tokens):
    return {"prefill": 2e-3, "decode": 3e-3}[kind] * tokens


def _warp(t0, nominal):
    """A stall window: work issued in [0.05, 0.08) waits until 0.08."""
    return max(t0, 0.08) + nominal if 0.05 <= t0 < 0.08 else t0 + nominal


def _spaced(cfg, n=6, max_new=5):
    """Chat requests arriving over time, two apps, so the virtual clock
    idles between arrivals (advance_to) and spans carry their app."""
    reqs = chat_trace(n, cfg.vocab_size, mean_prompt=12, max_new=max_new,
                      seed=5)
    for i, r in enumerate(reqs):
        r.arrival_s = 0.03 * i * (i % 3 != 1)
        r.app = "chat" if i % 2 else "captions"
    return reqs


def _event_rows(rec):
    return [dataclasses.astuple(e) for e in rec.events]


def _lockstep(models, reqs, kw, hooks=None):
    """Step a JAX engine and the port's in lockstep (``run(max_steps=1)``:
    the run loop's idle jump, then one step) on the same weights and
    requests; after every step ``now()``, the EngineStats, the finished
    requests and the recorder's events and counters must be equal.
    ``hooks[i](engine)`` runs on both engines before tick ``i``; its
    results must be equal too. Returns both engines and the hooks'
    results by tick."""
    jm, jparams, tm, tparams = models
    jrec, trec = JRecorder(), TRecorder()
    engines = []
    for cls, req_cls, model, params, rec, extra in (
            (JEngine, Request, jm, jparams, jrec, dict(paged=True)),
            (TEngine, TRequest, tm, tparams, trec, {})):
        eng = cls(model, recorder=rec, **extra, **kw)
        eng.load_params(params)
        for r in reqs:
            eng.submit(req_cls(r.request_id, np.array(r.prompt),
                               r.max_new_tokens, arrival_s=r.arrival_s,
                               app=r.app))
        engines.append(eng)
    je, te = engines
    hooks = hooks or {}
    results = {}
    for tick in range(2000):
        if tick in hooks:
            results[tick] = hooks[tick](te)
            assert results[tick] == hooks[tick](je), tick
        jd, td = je.run(max_steps=1), te.run(max_steps=1)
        assert te.now() == je.now(), tick
        assert dataclasses.asdict(te.stats) == dataclasses.asdict(je.stats)
        assert [(r.request_id, r.tokens_out, r.t_tokens, r.t_prefill)
                for r in td] == [(r.request_id, r.tokens_out, r.t_tokens,
                                  r.t_prefill) for r in jd], tick
        assert _event_rows(trec) == _event_rows(jrec), tick
        assert trec.counters == jrec.counters, tick
        if not je.waiting and all(a is None for a in je.active):
            break
    assert not te.waiting and all(a is None for a in te.active)
    assert len(te.done) == len(reqs)
    return je, te, results


GEOMETRY = dict(max_slots=2, max_seq=64, policy="chunked", prefill_chunk=4,
                page_size=4)


def test_virtual_clock_request_costs_and_telemetry_match_jax(models):
    """request_cost_s, request_work, time_warp, recorder_chips and the
    recorder label: the clock, every span's work and the labelled
    ``kv_pages@<label>`` counter equal the JAX engine's after every step,
    and the clock idles forward to late arrivals (advance_to)."""
    reqs = _spaced(models[0].cfg)
    je, te, got = _lockstep(models, reqs, dict(
        GEOMETRY, request_cost_s=_cost, request_work=_work, time_warp=_warp,
        recorder_chips=8, recorder_label="part0"))
    assert te.now() > 0.08 and "kv_pages@part0" in te._recorder.counters
    assert {e.chips for e in te._recorder.events if e.phase == "X"} == {8}


def test_virtual_clock_step_costs_match_jax(models):
    """step_cost_s: a decode step costs its batch once (not per row), and
    the decode spans split the step."""
    je, te, got = _lockstep(models, _spaced(models[0].cfg),
                       dict(GEOMETRY, policy="mixed", step_cost_s=_step_cost))
    assert te.stats.mixed_steps > 0 and te.now() > 0


def test_crash_replays_match_jax(models):
    """crash_active mid-run: every in-flight request is evicted as a
    replay (stats.replays, ``replay`` instants) and re-prefills the cache
    it held; streams, clock and stats stay equal to the JAX engine's."""
    reqs = _spaced(models[0].cfg)
    hooks = {6: lambda e: e.crash_active(), 14: lambda e: e.crash_active()}
    je, te, got = _lockstep(models, reqs, dict(GEOMETRY, request_cost_s=_cost),
                       hooks)
    assert got[6] > 0 and got[14] > 0
    assert te.stats.replays == got[6] + got[14] and te.stats.evictions == 0
    assert te._recorder.counts()["replay"] == te.stats.replays


def test_abort_matches_jax(models):
    """abort() of an active and of a waiting request frees the slot's
    pages without publishing them; the caller resubmits the request."""
    reqs = _spaced(models[0].cfg)

    def abort_and_resubmit(rid):
        def hook(e):
            r = e.abort(rid)
            if r is None:
                return None
            got = (r.request_id, list(r.tokens_out))
            e.submit(type(r)(r.request_id, np.array(r.prompt),
                             r.max_new_tokens, arrival_s=r.arrival_s,
                             app=r.app))
            return got
        return hook

    hooks = {5: abort_and_resubmit(0), 6: abort_and_resubmit(5),
             7: lambda e: e.abort(999)}
    je, te, got = _lockstep(models, reqs, dict(GEOMETRY, prefix_cache=True,
                                          request_cost_s=_cost), hooks)
    assert got[5] is not None and got[6] is not None and got[7] is None
    assert te.prefix.stats.lookups == je.prefix.stats.lookups


def test_stolen_pages_match_jax(models):
    """steal_pages under a small pool with a warm prefix cache: free pages
    first, then cold prefixes, then LRU slots; release_stolen gives them
    back. Returns, stats and streams equal the JAX engine's."""
    reqs = _shared_prefix(models[0].cfg, n=5, sys_len=12, tail_len=6)
    hooks = {0: lambda e: e.steal_pages(4), 9: lambda e: e.steal_pages(6),
             12: lambda e: e.release_stolen(),
             13: lambda e: e.release_stolen()}
    je, te, got = _lockstep(models, reqs, dict(GEOMETRY, kv_pages=14,
                                          prefix_cache=True,
                                          request_cost_s=_cost), hooks)
    assert got[0] == 4 and got[9] == 6 and got[12] == 10 and got[13] == 0
    assert te.stats.evictions > 0 or te.stats.recompute_tokens > 0
    assert te.allocator.reserved_pages == 0


def test_watermark_eviction_matches_jax(models):
    """evict_high/low_watermark: once the pool passes the high mark, LRU
    slots are evicted down to the low one (_rebalance), and admission
    holds below the high mark."""
    je, te, got = _lockstep(models, _chat(models[0].cfg, n=4), dict(
        GEOMETRY, max_slots=4, kv_pages=12, evict_high_watermark=0.75,
        evict_low_watermark=0.5, request_cost_s=_cost))
    assert te.stats.evictions > 0 and te.stats.pages_in_use <= 12


@pytest.mark.parametrize("chunk,page", [(4, 8), (8, 4), (3, 4)])
def test_prefix_peek_and_chunk_floor_match_jax(models, chunk, page):
    """The router's probe: prefix_peek floors the trie's match to the
    prefill-chunk grid exactly as an admission does (_floor_to_chunk), has
    no side effect, and gives the JAX engine's answers."""
    cfg = models[0].cfg
    reqs = _shared_prefix(cfg, n=3, sys_len=13, tail_len=5)
    probes = [list(reqs[0].prompt), list(reqs[1].prompt[:13]),
              list(reqs[2].prompt[:6]) + [1, 2, 3], [], None]

    def peek(e):
        before = (e.prefix.stats.lookups, e.prefix.stats.hits)
        got = [e.prefix_peek(p) for p in probes]
        assert (e.prefix.stats.lookups, e.prefix.stats.hits) == before
        return got

    je, te, got = _lockstep(models, reqs, dict(
        GEOMETRY, max_slots=1, prefill_chunk=chunk, page_size=page,
        prefix_cache=True, request_cost_s=_cost),
        {i: peek for i in range(0, 40, 3)})
    assert peek(te) == peek(je)
    assert peek(te)[0] == te._floor_to_chunk(len(reqs[0].prompt)) > 0
    assert all(n % chunk == 0 for n in peek(te) if n)
    assert [te._floor_to_chunk(m) for m in range(20)] == \
        [je._floor_to_chunk(m) for m in range(20)]
