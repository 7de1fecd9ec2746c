"""The hint layer (``distributed/hints.py``) on the port against the JAX
package under the same hints.

Reduced configs with 2 layers (jamba: its two periods), weights from one
JAX ``init`` carried across by ``params_from_jax``; the hints set in both
packages at once (each keeps its own process-global table).

* the hints API: the port's table is its own and behaves as JAX's;
* ``attn_impl="repeat_kv"``: forward logits within 1e-5 of the port
  without the hint and within 1e-4 of JAX under it, on the naive path
  (S 64) and the block-causal one (S 2048); the cache keeps the
  un-repeated K/V;
* ``attn_logits_bf16``: the port's ``flash_attention_jnp`` within 1e-2 of
  the largest output of JAX's under the hint, and within 2e-2 of
  ``naive_attention`` (JAX's own bound);
* ``kv_cache_dtype="int8"``: ``prefill_chunk`` (an inactive row, a
  tail-padded row) and ``decode_step`` (an inactive row) on the
  contiguous cache. The int8 values and the bf16 scales equal JAX's but
  for single-unit flips where the two packages' float32 projections
  differ in the last ulp at a rounding tie; flips are counted and held
  to 0.1% of the entries, none larger than one unit. Logits within 1e-3
  of the largest; against the bf16 cache within JAX's 5e-2;
* ``moe_impl="shardmap"``, ``attn_kv_replicated``, ``residual_replicated``
  off a device mesh: logits bitwise equal to no hint, and JAX's within
  1e-4;
* the engine under the int8 hint: tinyllama under ``chunked``, ``mixed``
  and replays (``crash_active``, ``abort``), and chameleon, moonshot,
  jamba and seamless: the contiguous cache (int8 with its scales for the
  transformer families, bf16 for hybrid and enc-dec, as in JAX), token
  streams and EngineStats identical to the JAX engine's, ``paged=True``
  refused.

The ``gpu`` cases (skipped without a card) run kernel #6 at one query
head a KV head (the ``repeat_kv`` geometry) against its plain version,
and the int8 engine on the card against the CPU.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.distributed import hints as jhints  # noqa: E402
from repro.models.attention import \
    flash_attention_jnp as jflash  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.request import Request, chat_trace  # noqa: E402
from repro_torch.distributed import hints as thints  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402
from test_torch_families import pair  # noqa: E402

torch.set_num_threads(2)

B, MAX_SEQ = 3, 32
STATS = ("steps", "prefill_tokens", "decode_tokens", "prefill_dispatches",
         "decode_syncs", "evictions", "replays", "recompute_tokens",
         "pages_in_use", "mixed_steps", "budget_enabled")


@pytest.fixture(autouse=True)
def _reset_hints():
    yield
    jhints.reset()
    thints.reset()


@contextlib.contextmanager
def both(**kw):
    """The same hints in both packages' tables."""
    with jhints.hints(**kw), thints.hints(**kw):
        yield


def _tokens(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return toks.astype(np.int32)


def _forward(arch, toks):
    jm, tm, jparams, tparams = pair(arch)
    jl, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
    return np.asarray(jl), tl.detach()


# -------------------------------------------------------------------- API
def test_hints_api_matches_the_original():
    assert thints._DEFAULTS == jhints._DEFAULTS
    with thints.hints(moe_impl="shardmap", attn_logits_bf16=True):
        assert thints.get("moe_impl") == "shardmap"
        assert thints.get("attn_logits_bf16") is True
        assert jhints.get("moe_impl") == "scatter"     # a table of its own
    assert thints.get("moe_impl") == "scatter"
    with pytest.raises(KeyError):
        thints.set_hint("bogus", 1)
    thints.set_hint("attn_logits_bf16", "true")
    assert thints.get("attn_logits_bf16") is True
    thints.reset()
    assert thints._ACTIVE == thints._DEFAULTS


# ------------------------------------------------------- attention hints
@pytest.mark.parametrize("b,s", [(2, 64), (1, 2048)])
def test_repeat_kv_matches_no_hint_and_jax(b, s):
    """Below FLASH_MIN_SEQ the CPU takes naive_attention, from it on
    flash_attention_jnp, as JAX's hint does; the cache captured by the
    forward keeps the KV heads."""
    jm, tm, jparams, tparams = pair("tinyllama-1.1b")
    toks = _tokens(jm.cfg, b, s, seed=s)
    tt = torch.from_numpy(toks)
    base, _, base_kv = ttf.forward(tparams, tt, tm.cfg, remat="none",
                                   return_cache=True)
    with both(attn_impl="repeat_kv"):
        jl, tl = _forward("tinyllama-1.1b", toks)
        _, _, kv = ttf.forward(tparams, tt, tm.cfg, remat="none",
                               return_cache=True)
    np.testing.assert_allclose(tl.numpy(), base.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=0)
    assert kv["k"].shape[3] == tm.cfg.num_kv_heads
    assert torch.equal(kv["k"], base_kv["k"])
    assert torch.equal(kv["v"], base_kv["v"])


@pytest.mark.parametrize("causal", [True, False])
def test_attn_logits_bf16_matches_jax(causal):
    """tests/test_hints_variants.py's shapes: GQA 8 over 4 heads of 32,
    256 positions in blocks of 64."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 256, h, 32)).astype(np.float32)
               for h in (8, 4, 4))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = tattn.flash_attention_jnp(tq, tk, tv, causal=causal,
                                      q_block=64, kv_block=64)
    with both(attn_logits_bf16=True):
        want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, q_block=64,
                                 kv_block=64))
        got = tattn.flash_attention_jnp(tq, tk, tv, causal=causal,
                                        q_block=64, kv_block=64)
    ref = tattn.naive_attention(tq, tk, tv, causal=causal).numpy()
    top = np.abs(ref).max()
    assert np.abs(got.numpy() - want).max() <= 1e-2 * top
    assert np.abs(got.numpy() - ref).max() <= 2e-2 * top
    assert not torch.equal(got, plain)            # the hint acts


# ------------------------------------------------------------- int8 KV
def _unit_flips(got: np.ndarray, want: np.ndarray, what: str) -> int:
    """Entries that differ; each by one unit at most (int8 values, or the
    last bit of a bf16 scale read as an integer)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max(initial=0) <= 1, (what, int(diff.max()))
    return int((diff > 0).sum())


def _int8_leaves_close(jc, tc, what):
    """The int8 cache's leaves against JAX's over the first ``MAX_SEQ``
    positions (the port's drop position past them is its own). Returns
    (flips, entries)."""
    flips = entries = 0
    for key in ("k", "v", "k_scale", "v_scale"):
        want = np.asarray(jc[key])
        got = tc[key][:, :, :MAX_SEQ]
        if key.endswith("_scale"):
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            want = want.view(np.int16)
            got = got.view(torch.int16)
        else:
            assert got.dtype == torch.int8 and want.dtype == np.int8
        flips += _unit_flips(got.numpy(), want, f"{what} {key}")
        entries += want.size
    return flips, entries


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "chameleon-34b",
                                  "moonshot-v1-16b-a3b"])
def test_int8_serving_steps_match_jax(arch, capsys):
    """Chunk A (row 2 inactive, row 1 tail-padded to 3 tokens), chunk B
    (every row from its own start), a decode step (row 1 inactive), on the
    int8 cache in both packages and on the port's bf16 cache."""
    jm, tm, jparams, tparams = pair(arch)
    with both(kv_cache_dtype="int8"):
        jc, tc = jm.init_cache(B, MAX_SEQ), tm.init_cache(B, MAX_SEQ)
    bf = tm.init_cache(B, MAX_SEQ)
    assert sorted(tc) == sorted(jc) == ["k", "k_scale", "v", "v_scale"]
    assert tc["k_scale"].shape == (*tc["k"].shape[:-1],)
    assert "k_scale" not in bf and bf["k"].dtype == torch.bfloat16
    vocab, rng = jm.cfg.vocab_size, np.random.default_rng(4)
    flips = entries = 0
    steps = [(np.zeros(B, np.int32), 6, np.array([True, True, False]),
              np.array([6, 3, 6], np.int32)),
             (np.array([6, 3, 0], np.int32), 5, np.ones(B, bool), None)]
    for n, (start, c, active, valid) in enumerate(steps):
        toks = rng.integers(0, vocab, (B, c)).astype(np.int32)
        tv = None if valid is None else torch.from_numpy(valid)
        jl, jc = jm.prefill_chunk(jparams, jc, jnp.asarray(toks),
                                  jnp.asarray(start), jnp.asarray(active),
                                  None if valid is None
                                  else jnp.asarray(valid))
        targs = (torch.from_numpy(toks), torch.from_numpy(start),
                 torch.from_numpy(active), tv)
        tl, _ = tm.prefill_chunk(tparams, tc, *targs)
        bl, _ = tm.prefill_chunk(tparams, bf, *targs)
        real = [(i, valid[i] if valid is not None else c)
                for i in range(B) if active[i]]
        jl = np.asarray(jl)
        for i, m in real:
            top = np.abs(jl[i, :m]).max()
            assert np.abs(tl[i, :m].numpy() - jl[i, :m]).max() <= 1e-3 * top
            assert np.abs(tl[i, :m].numpy() - bl[i, :m].numpy()).max() \
                <= 5e-2 * top
        f, e = _int8_leaves_close(jc, tc, f"chunk {n}")
        flips, entries = flips + f, entries + e
    lengths = np.array([11, 8, 5], np.int32)
    active = np.array([True, False, True])
    tok1 = rng.integers(0, vocab, (B, 1)).astype(np.int32)
    jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok1),
                            jnp.asarray(lengths), jnp.asarray(active))
    targs = (torch.from_numpy(tok1), torch.from_numpy(lengths),
             torch.from_numpy(active))
    tl, _ = tm.decode_step(tparams, tc, *targs)
    bl, _ = tm.decode_step(tparams, bf, *targs)
    jl, tl, bl = np.asarray(jl)[active], tl.numpy()[active], bl.numpy()[active]
    top = np.abs(jl).max()
    assert np.abs(tl - jl).max() <= 1e-3 * top
    assert np.abs(tl - bl).max() <= 5e-2 * top
    f, e = _int8_leaves_close(jc, tc, "decode")
    flips, entries = flips + f, entries + e
    with capsys.disabled():
        print(f"\n{arch}: {flips} single-unit flips in {entries} int8 "
              "cache entries (values and scales) against JAX")
    assert flips <= 1e-3 * entries


def test_int8_slot_slices_match_the_jax_bundle():
    """slice_cache / set_cache_slice move a slot's scales with its values;
    the drop position is left out of a slice and left alone by a write."""
    jm, tm, jparams, tparams = pair("tinyllama-1.1b")
    with both(kv_cache_dtype="int8"):
        jc, tc = jm.init_cache(B, MAX_SEQ), tm.init_cache(B, MAX_SEQ)
    for key, leaf in tc.items():
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape) % 97)
    jc = {k: jnp.asarray(v[:, :, :MAX_SEQ].float().numpy()).astype(
        jc[k].dtype) for k, v in tc.items()}
    got, want = tm.slice_cache(tc, 1), jm.slice_cache(jc, 1)
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32))
    drop = {k: v[:, :, MAX_SEQ].clone() for k, v in tc.items()}
    piece = {k: torch.full_like(v, 3) for k, v in got.items()}
    tm.set_cache_slice(tc, 2, piece)
    jc = jm.set_cache_slice(jc, 2, {k: jnp.asarray(v.float().numpy())
                                    for k, v in piece.items()})
    assert {k: v.dtype for k, v in jc.items()} == \
        {k: jnp.dtype(str(v.dtype).split(".")[-1]) for k, v in tc.items()}
    for key, leaf in tc.items():
        np.testing.assert_array_equal(
            leaf[:, :, :MAX_SEQ].float().numpy(),
            np.asarray(jc[key], np.float32))
        assert torch.equal(leaf[:, :, MAX_SEQ], drop[key])


# ------------------------------------------------- hints that change nothing
@pytest.mark.parametrize("arch,hint", [
    ("moonshot-v1-16b-a3b", dict(moe_impl="shardmap")),
    ("tinyllama-1.1b", dict(attn_kv_replicated=True)),
    ("tinyllama-1.1b", dict(residual_replicated=True)),
])
def test_mesh_hints_change_nothing_off_a_mesh(arch, hint):
    """JAX drops these off a device mesh (shard_map falls back to the
    scatter MoE; the sharding constraints are swallowed); the port has no
    mesh yet and gives the same logits bit for bit."""
    jm, tm, jparams, tparams = pair(arch)
    toks = _tokens(jm.cfg, 2, 32, seed=1)
    _, base = _forward(arch, toks)
    with both(**hint):
        jl, tl = _forward(arch, toks)
    assert torch.equal(tl, base)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ engine
def _engine(engine_cls, request_cls, model, params, reqs, kw):
    eng = engine_cls(model, **kw)
    eng.load_params(params)
    for r in reqs:
        eng.submit(request_cls(r.request_id, np.array(r.prompt),
                               r.max_new_tokens, arrival_s=r.arrival_s))
    return eng


def _resubmit_after_abort(rid):
    def hook(e):
        r = e.abort(rid)
        if r is not None:
            e.submit(type(r)(r.request_id, np.array(r.prompt),
                             r.max_new_tokens, arrival_s=r.arrival_s))
        return None if r is None else r.request_id
    return hook


ENGINES = {
    "tinyllama chunked": ("tinyllama-1.1b", dict(policy="chunked",
                                                 prefill_chunk=8), {}),
    "tinyllama mixed": ("tinyllama-1.1b", dict(policy="mixed",
                                               prefill_chunk=4), {}),
    "tinyllama replays": ("tinyllama-1.1b", dict(policy="chunked",
                                                 prefill_chunk=4), {
        4: lambda e: e.crash_active(), 7: _resubmit_after_abort(2),
        11: lambda e: e.crash_active()}),
    "chameleon": ("chameleon-34b", dict(policy="chunked", prefill_chunk=8),
                  {}),
    "moonshot": ("moonshot-v1-16b-a3b", dict(policy="mixed",
                                             prefill_chunk=4), {}),
    "jamba": ("jamba-v0.1-52b", dict(policy="mixed", prefill_chunk=4), {}),
    "seamless": ("seamless-m4t-large-v2", dict(policy="mixed",
                                               prefill_chunk=4), {}),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_int8_engine_streams_and_stats_match_jax(name):
    """Both engines built under the hint (``paged=None``), stepped in
    lockstep with the hooks run on both before their tick: the
    EngineStats counters equal after every step (the wall-clock fields
    aside), token streams equal at the end."""
    arch, kw, hooks = ENGINES[name]
    jm, tm, jparams, tparams = pair(arch)
    reqs = chat_trace(4, jm.cfg.vocab_size, mean_prompt=10, max_new=4,
                      seed=11)
    kw = dict(max_slots=3, max_seq=48, **kw)
    with both(kv_cache_dtype="int8"):
        je = _engine(JEngine, Request, jm, jparams, reqs, kw)
        te = _engine(TEngine, TRequest, tm, tparams, reqs, kw)
        for model in (jm, tm):
            with pytest.raises(ValueError, match="int8 KV hint"):
                type(te if model is tm else je)(model, paged=True, **kw)
    assert not je.paged and not te.paged
    assert sorted(te.cache) == sorted(je.cache)
    for key, leaf in te.cache.items():
        if not isinstance(leaf, dict):
            assert str(leaf.dtype).split(".")[-1] == str(je.cache[key].dtype)
    assert ("k_scale" in te.cache) == (jm.cfg.family in ("dense", "moe",
                                                         "vlm"))
    for tick in range(500):
        if tick in hooks:
            assert hooks[tick](te) == hooks[tick](je), tick
        je.run(max_steps=1)
        te.run(max_steps=1)
        assert [getattr(te.stats, f) for f in STATS] == \
            [getattr(je.stats, f) for f in STATS], tick
        if not je.waiting and all(a is None for a in je.active):
            break
    want = {r.request_id: list(r.tokens_out) for r in je.done}
    assert {r.request_id: list(r.tokens_out) for r in te.done} == want
    assert len(want) == len(reqs)
    if name == "tinyllama replays":
        assert te.stats.replays > 0 and te.stats.recompute_tokens > 0
    if kw["policy"] == "mixed":
        assert te.stats.mixed_steps > 0


# -------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_at_one_head_a_kv_head(cuda_device, dtype):
    """Kernel #6 and its backward at the repeat_kv geometry (32 query
    heads over 32 KV heads of 64, causal) against their plain versions,
    at the dtype's tolerance (float32 2e-5 + 2e-5·|plain|, bfloat16
    2e-2)."""
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((2, 32, 256, 64), generator=gen,
                           device=cuda_device).to(getattr(torch, dtype))
               for _ in range(3))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    torch.testing.assert_close(
        o.float(), tref.flash_attention_ref(q, k, v, causal=True).float(),
        atol=tol, rtol=tol)
    do = torch.randn(o.shape, generator=gen, device=cuda_device).to(q.dtype)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_cuda_int8_engine_matches_the_cpu(cuda_device):
    """Reduced tinyllama under the int8 hint on the card (kernels #3 and
    #4 on the dequantized cache) and on the CPU, one set of weights: the
    same token streams."""
    from repro_torch.configs.registry import CONFIGS as TCONFIGS
    from repro_torch.models.factory import build_model
    from torch.utils._pytree import tree_map
    cfg = dataclasses.replace(TCONFIGS["tinyllama-1.1b"].reduced(),
                              num_layers=2)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    reqs = chat_trace(4, cfg.vocab_size, mean_prompt=10, max_new=4, seed=11)
    streams = []
    for dev in ("cpu", "cuda"):
        with thints.hints(kv_cache_dtype="int8"):
            eng = _engine(TEngine, TRequest, build_model(cfg, dev),
                          tree_map(lambda t: t.to(dev), params), reqs,
                          dict(max_slots=3, max_seq=48, policy="chunked",
                               prefill_chunk=8))
        assert eng.cache["k"].dtype == torch.int8 and not eng.paged
        streams.append({r.request_id: list(r.tokens_out)
                        for r in eng.run()})
    assert streams[0] == streams[1]
