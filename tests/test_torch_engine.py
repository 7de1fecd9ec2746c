"""The port's InferenceEngine against the JAX engine.

Same weights (JAX initialiser, carried across by ``params_from_jax``),
same ``chat_trace`` requests, same geometry (``page_size`` and
``prefill_chunk`` given, so neither engine consults an autotuner). On the
paged cache, four configurations: plain paged, eviction under a small
pool, prefix cache with copy-on-write forks, and the ``mixed`` step-budget
policy. On the contiguous cache, tinyllama with ``paged=False`` and
reduced mamba2 (whose recurrent state never pages), each under the
``chunked`` and ``mixed`` policies. Token streams must be identical, and
so must the EngineStats counters.
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


def test_engine_refuses_what_is_not_ported(models, mamba):
    """What stays refused: an engine without the geometry the autotuner
    would pick, the paged cache for mamba2 (as in JAX), and the families
    whose serving path is not ported (moe, vlm, hybrid, encdec)."""
    _, _, tm, _ = models
    _, _, sm, _ = mamba
    with pytest.raises(ValueError, match="must be given"):
        TEngine(tm, max_slots=2, max_seq=32)
    with pytest.raises(ValueError, match="must be given"):
        TEngine(tm, max_slots=2, max_seq=32, paged=False)
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
    dense = TCONFIGS["tinyllama-1.1b"].reduced()
    for cfg in (dataclasses.replace(dense, family="moe", num_experts=4,
                                    num_experts_per_token=2),
                dataclasses.replace(dense, family="vlm"),
                dataclasses.replace(sm.cfg, family="hybrid"),
                dataclasses.replace(dense, family="encdec")):
        with pytest.raises(NotImplementedError, match="not ported"):
            tbuild(cfg, "cpu")


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
