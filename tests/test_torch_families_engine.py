"""The port's InferenceEngine against the JAX engine on the vlm, moe,
hybrid and encdec families.

chameleon-34b, moonshot-v1-16b-a3b, jamba-v0.1-52b and
seamless-m4t-large-v2 at their ``.reduced()`` widths (2 layers, or
jamba's two periods), weights from one JAX ``init`` carried across by
``params_from_jax``, the same ``chat_trace`` requests and geometry
(``page_size`` and ``prefill_chunk`` given). Four configurations: the
paged default under ``chunked``, the contiguous cache, the ``mixed``
step-budget policy (multi-slot batched prefill where the family allows
it; per-slot dispatches for MoE and jamba, whose routing couples rows)
and eviction with re-prefill under a small pool. Token streams must be
identical, and so must the EngineStats counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.request import Request, chat_trace  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402
from test_torch_families import pair  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["chameleon-34b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b",
         "seamless-m4t-large-v2"]
STATS = ("steps", "prefill_tokens", "decode_tokens", "prefill_dispatches",
         "decode_syncs", "evictions", "recompute_tokens", "pages_in_use",
         "mixed_steps", "budget_enabled")

CONFIGS_UNDER_TEST = {
    "paged": dict(max_slots=3, max_seq=48, policy="chunked",
                  prefill_chunk=8, page_size=8),
    "contiguous": dict(max_slots=3, max_seq=48, policy="chunked",
                       prefill_chunk=8, paged=False),
    "mixed": dict(max_slots=3, max_seq=48, policy="mixed", prefill_chunk=4,
                  page_size=4),
    "eviction": dict(max_slots=3, max_seq=48, policy="chunked",
                     prefill_chunk=4, page_size=4, kv_pages=7),
}


def _serve(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, **kw)
    eng.load_params(params)
    for r in reqs:
        eng.submit(request_cls(r.request_id, np.array(r.prompt),
                               r.max_new_tokens, arrival_s=r.arrival_s))
    done = {r.request_id: list(r.tokens_out) for r in eng.run()}
    assert len(done) == len(reqs)
    return done, eng.stats


@pytest.mark.parametrize("name", sorted(CONFIGS_UNDER_TEST))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_engine_streams_and_stats_match_jax(arch, name):
    jm, tm, jparams, tparams = pair(arch)
    kw = CONFIGS_UNDER_TEST[name]
    reqs = chat_trace(4, jm.cfg.vocab_size, mean_prompt=10, max_new=4,
                      seed=11)
    want, jstats = _serve(JEngine, Request, jm, jparams, reqs, **kw)
    got, tstats = _serve(TEngine, TRequest, tm, tparams, reqs, **kw)
    assert got == want
    for field in STATS:
        assert getattr(tstats, field) == getattr(jstats, field), field
    if name == "eviction":
        assert tstats.evictions > 0 and tstats.recompute_tokens > 0
    if name == "mixed":
        assert tstats.mixed_steps > 0
