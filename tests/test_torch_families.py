"""The port's vlm, moe, hybrid and encdec families against the JAX package.

chameleon-34b (vlm), moonshot-v1-16b-a3b and kimi-k2-1t-a32b (moe),
jamba-v0.1-52b (hybrid) and seamless-m4t-large-v2 (encdec) at their
``.reduced()`` widths (2 layers, or jamba's two periods of 2 sublayers),
weights from one JAX ``init`` carried across by ``params_from_jax``:

* the same leaves, and the port's own initialiser makes the same shapes;
* ``forward`` logits and aux within 1e-4 (float32), with the vlm
  ``embeds`` in place of tokens, enc-dec frames, and ``return_cache``;
* whole-prompt ``prefill`` caches (and mamba2's ``forward``/``prefill``,
  ported beside them);
* two prefill chunks (an inactive row, a tail-padded ``valid`` row) and a
  decode step (an inactive row) on the contiguous cache and on the page
  pool, from the same non-zero slot-resident state: logits within 2e-5 +
  2e-5·|x| (float32), caches within 2e-2 (bfloat16) and 2e-5 (the float32
  SSM state);
* ``moe_ffn`` with a capacity small enough that tokens are dropped and a
  ``token_mask``, and top-k ties;
* what stays refused, as in JAX: prefix sharing for moe, hybrid and
  encdec, paging for ssm, and (on the card) gradients through the SSD.

Engine token streams and ``EngineStats`` for each family are in
tests/test_torch_families_engine.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["chameleon-34b", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b",
         "jamba-v0.1-52b", "seamless-m4t-large-v2"]
F32 = 2e-5          # float32 logits and SSM state
BF16 = 2e-2         # bfloat16 caches: one rounding step
B, MAX_SEQ, PAGE, NB = 3, 32, 4, 8
POOL = B * NB


def reduced(name, cfgs):
    """Two layers, or hybrid's two periods (the reduced config's own)."""
    cfg = cfgs[name].reduced()
    if cfg.family != "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=2)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, num_encoder_layers=2,
                                  num_decoder_layers=2)
    return cfg


_PAIRS = {}


def pair(arch):
    """(JAX bundle, port bundle, JAX params, port params), built once."""
    if arch not in _PAIRS:
        jcfg, tcfg = reduced(arch, CONFIGS), reduced(arch, TCONFIGS)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
        jparams = jm.init(jax.random.key(0))
        _PAIRS[arch] = (jm, tm, jparams,
                        params_from_jax(_flatten(jparams), "cpu"))
    return _PAIRS[arch]


def _tflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_tflat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


# ------------------------------------------------------------- parameters
@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_with_same_leaves(arch):
    jm, tm, jparams, tparams = pair(arch)
    jflat, tflat = _flatten(jparams), _tflat(tparams)
    assert sorted(jflat) == sorted(tflat)
    for path, arr in jflat.items():
        assert tflat[path].dtype == torch.float32, path
        np.testing.assert_array_equal(arr, tflat[path].numpy(), err_msg=path)
    own = _tflat(tm.init(torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(a.shape) for k, a in jflat.items()}


@pytest.mark.parametrize("name", sorted(TCONFIGS))
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_every_config_builds(name, size):
    """build_model takes every config in the registry, full and reduced;
    the bundle answers the JAX bundle's questions about it."""
    cfg = TCONFIGS[name] if size == "full" else TCONFIGS[name].reduced()
    jcfg = CONFIGS[name] if size == "full" else CONFIGS[name].reduced()
    tm, jm = tbuild(cfg, "cpu"), jbuild(jcfg)
    assert tm.device.type == "cpu"
    for q in ("cache_pages", "prefix_shareable", "multi_slot_batchable",
              "kv_bytes_per_token"):
        assert getattr(tm, q)() == getattr(jm, q)(), q


# ---------------------------------------------------------------- forward
def _batch(cfg, rng, b=2, s=24):
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, 10, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: None if v is None else jnp.asarray(v)
             for k, v in batch.items()},
            {k: None if v is None else torch.from_numpy(v)
             for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS + ["mamba2-1.3b"])
def test_forward_and_loss_match_jax(arch):
    jm, tm, jparams, tparams = pair(arch)
    rng = np.random.default_rng(0)
    jb, tb = _both(_batch(jm.cfg, rng))
    jl, ja = jm.forward(jparams, jb, remat="none")
    tl, ta = tm.forward(tparams, tb, remat="none")
    _close(tl.numpy(), jl, 1e-4)
    assert abs(float(ta) - float(ja)) <= 1e-4 * max(1.0, abs(float(ja)))
    if jm.cfg.is_moe:
        assert float(ta) > 0.5          # the balance term is there
    _close(float(tm.loss_fn(tparams, tb, remat="full")),
           float(jm.loss_fn(jparams, jb, remat="full")), 1e-4)


def test_vlm_embeds_replace_the_token_embedding():
    jm, tm, jparams, tparams = pair("chameleon-34b")
    rng = np.random.default_rng(1)
    embeds = rng.standard_normal((2, 16, jm.cfg.d_model)).astype(np.float32)
    jb, tb = _both({"tokens": None, "embeds": embeds})
    jl, _ = jm.forward(jparams, jb, remat="none")
    tl, _ = tm.forward(tparams, tb, remat="none")
    assert tl.shape == (2, 16, jm.cfg.padded_vocab)
    _close(tl.numpy(), jl, 1e-4)
    jl, jc = jm.prefill(jparams, jb, max_seq=20)
    tl, tc = tm.prefill(tparams, tb, max_seq=20)
    _close(tl.numpy(), jl, 1e-4)
    for key in ("k", "v"):
        _close(tc[key][:, :, :20].float().numpy(),
               jc[key].astype(jnp.float32), BF16)


@pytest.mark.parametrize("arch", ["chameleon-34b", "moonshot-v1-16b-a3b",
                                  "jamba-v0.1-52b", "seamless-m4t-large-v2"])
def test_forward_return_cache_matches_jax(arch):
    """The family module's ``forward(return_cache=True)``: the rotated
    keys, the values (and hybrid's SSD states, enc-dec's cross-KV) in the
    activations' dtype."""
    import importlib
    jm, tm, jparams, tparams = pair(arch)
    fam = {"hybrid": "hybrid", "encdec": "encdec"}.get(jm.cfg.family,
                                                      "transformer")
    jmod = importlib.import_module(f"repro.models.{fam}")
    tmod = importlib.import_module(f"repro_torch.models.{fam}")
    batch = _batch(jm.cfg, np.random.default_rng(2))
    jb, tb = _both(batch)
    args = ((jb["frames"], jb["tokens"]) if fam == "encdec"
            else (jb["tokens"],))
    targs = ((tb["frames"], tb["tokens"]) if fam == "encdec"
             else (tb["tokens"],))
    jl, ja, jc = jmod.forward(jparams, *args, jm.cfg, remat="none",
                              return_cache=True)
    tl, ta, tc = tmod.forward(tparams, *targs, tm.cfg, remat="none",
                              return_cache=True)
    _close(tl.numpy(), jl, 1e-4)
    jflat, tflat = _flatten(jc), _tflat(tc)
    assert sorted(jflat) == sorted(tflat)
    for path, arr in jflat.items():
        assert tuple(tflat[path].shape) == arr.shape, path
        _close(tflat[path].numpy(), arr, 1e-4, path)


def _jleaves(cache):
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in
            _flatten(jax.tree.map(lambda a: a.astype(jnp.float32),
                                  cache)).items()}


def _caches_close(jc, tc, what=""):
    """Every leaf JAX has. The port's contiguous KV carries one more
    position and its pools one more page (the drop slots), which JAX does
    not have; SSM states (float32) at F32, everything else at BF16."""
    tflat = _tflat(tc)
    jflat = _jleaves(jc)
    assert sorted(jflat) == sorted(tflat)
    for path, want in jflat.items():
        got = tflat[path]
        if path in ("k", "v"):
            got = got[:, :, :want.shape[2]]
        elif path in ("k_pages", "v_pages"):
            got = got[:, :want.shape[1]]
        tol = F32 if path in ("ssm", "ssm/ssm") else BF16
        assert tuple(got.shape) == want.shape, path
        _close(got.float().numpy(), want, tol, f"{what} {path}")


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2", "mamba2-1.3b"])
def test_prefill_caches_match_jax(arch):
    """ModelBundle.prefill: the prompt's cache, padded to max_seq (the
    port's drop position past it is zero); mamba2's per-layer states."""
    jm, tm, jparams, tparams = pair(arch)
    jb, tb = _both(_batch(jm.cfg, np.random.default_rng(3), s=12))
    jl, jc = jm.prefill(jparams, jb, max_seq=MAX_SEQ)
    tl, tc = tm.prefill(tparams, tb, max_seq=MAX_SEQ)
    _close(tl.numpy(), jl, 1e-4)
    _caches_close(jc, tc, "prefill")
    if "k" in tc:
        assert not tc["k"][:, :, MAX_SEQ:].any()


# --------------------------------------------------------- serving steps
def _seed_slots(jc, tc, rng):
    """The same non-zero slot-resident state in both (the SSM states, the
    enc-dec cross-KV); KV stays zero and is written by the steps."""
    jnew = dict(jc)
    for key in ("ssm", "cross_k", "cross_v"):
        if key not in jc:
            continue
        if isinstance(jc[key], dict):
            sub = {}
            for n, leaf in jc[key].items():
                arr = (0.3 * rng.standard_normal(leaf.shape)).astype(
                    np.float32)
                sub[n] = jnp.asarray(arr).astype(leaf.dtype)
                tc[key][n].copy_(torch.from_numpy(arr))
            jnew[key] = sub
        else:
            arr = (0.3 * rng.standard_normal(jc[key].shape)).astype(
                np.float32)
            jnew[key] = jnp.asarray(arr).astype(jc[key].dtype)
            tc[key].copy_(torch.from_numpy(arr))
    return jnew, tc


def _tables(rng):
    return rng.permutation(POOL).astype(np.int32).reshape(B, NB)


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_steps_match_jax(arch, cache):
    """Chunk A (start 0; row 2 inactive, row 1 tail-padded to 3 real
    tokens), chunk B (every row, from its own start; it crosses a page),
    then a decode step with row 1 inactive."""
    jm, tm, jparams, tparams = pair(arch)
    rng = np.random.default_rng(4)
    paged = cache == "paged"
    if paged:
        jc = jm.init_paged_cache(POOL, PAGE, B, MAX_SEQ)
        tc = tm.init_paged_cache(POOL, PAGE, B, MAX_SEQ)
        bt = _tables(rng)
    else:
        jc, tc = jm.init_cache(B, MAX_SEQ), tm.init_cache(B, MAX_SEQ)
    jc, tc = _seed_slots(jc, tc, rng)
    vocab = jm.cfg.vocab_size

    def chunk(jc, start, toks, active, valid):
        jargs = [jnp.asarray(toks), jnp.asarray(start)]
        targs = [torch.from_numpy(toks), torch.from_numpy(start)]
        if paged:
            jargs.append(jnp.asarray(bt))
            targs.append(torch.from_numpy(bt))
        jmask = [jnp.asarray(active),
                 None if valid is None else jnp.asarray(valid)]
        tmask = [torch.from_numpy(active),
                 None if valid is None else torch.from_numpy(valid)]
        jfn = jm.prefill_chunk_paged if paged else jm.prefill_chunk
        tfn = tm.prefill_chunk_paged if paged else tm.prefill_chunk
        jl, jc = jfn(jparams, jc, *jargs, *jmask)
        tl, tc2 = tfn(tparams, tc, *targs, *tmask)
        assert tc2 is tc
        return np.asarray(jl), tl.numpy(), jc

    # chunk A
    toks = rng.integers(0, vocab, (B, 6)).astype(np.int32)
    jl, tl, jc = chunk(jc, np.zeros(B, np.int32), toks,
                       np.array([True, True, False]),
                       np.array([6, 3, 6], np.int32))
    _close(tl[0], jl[0], F32, "chunk A row 0")
    _close(tl[1, :3], jl[1, :3], F32, "chunk A row 1")
    _caches_close(jc, tc, "chunk A")
    # chunk B
    start = np.array([6, 3, 0], np.int32)
    toks = rng.integers(0, vocab, (B, 5)).astype(np.int32)
    jl, tl, jc = chunk(jc, start, toks, np.ones(B, bool), None)
    _close(tl, jl, F32, "chunk B")
    _caches_close(jc, tc, "chunk B")
    # decode
    lengths = start + 5
    active = np.array([True, False, True])
    tok1 = rng.integers(0, vocab, (B, 1)).astype(np.int32)
    jargs = [jnp.asarray(tok1), jnp.asarray(lengths)]
    targs = [torch.from_numpy(tok1), torch.from_numpy(lengths)]
    if paged:
        jl, jc = jm.decode_step_paged(jparams, jc, *jargs, jnp.asarray(bt),
                                      jnp.asarray(active))
        tl, _ = tm.decode_step_paged(tparams, tc, *targs,
                                     torch.from_numpy(bt),
                                     torch.from_numpy(active))
    else:
        jl, jc = jm.decode_step(jparams, jc, *jargs, jnp.asarray(active))
        tl, _ = tm.decode_step(tparams, tc, *targs, torch.from_numpy(active))
    _close(tl.numpy()[active], np.asarray(jl)[active], F32, "decode")
    _caches_close(jc, tc, "decode")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "seamless-m4t-large-v2"])
def test_slot_slices_match_the_jax_bundle(arch):
    """slice_cache / set_cache_slice on both caches: hybrid's SSM states
    carry their batch on axis 2, enc-dec's cross-KV on axis 1; page leaves
    pass through."""
    jm, tm, _, _ = pair(arch)
    rng = np.random.default_rng(5)
    for paged in (False, True):
        if paged:
            jc = jm.init_paged_cache(POOL, PAGE, B, MAX_SEQ)
            tc = tm.init_paged_cache(POOL, PAGE, B, MAX_SEQ)
        else:
            jc, tc = jm.init_cache(B, MAX_SEQ), tm.init_cache(B, MAX_SEQ)
        jc, tc = _seed_slots(jc, tc, rng)
        jpiece, tpiece = jm.slice_cache(jc, 1), tm.slice_cache(tc, 1)
        _caches_close(jpiece, tpiece, "slice")
        fresh = tm.slice_cache(tm.init_cache(1, MAX_SEQ), 0) if not paged \
            else tm.slice_cache(tm.init_paged_cache(1, PAGE, 1, MAX_SEQ), 0)
        tm.set_cache_slice(tc, 1, fresh)
        jc = jm.set_cache_slice(jc, 1, jm.slice_cache(
            jm.init_cache(1, MAX_SEQ) if not paged
            else jm.init_paged_cache(1, PAGE, 1, MAX_SEQ), 0))
        _caches_close(jc, tc, "set_cache_slice")


# ---------------------------------------------------------------------- MoE
@pytest.mark.parametrize("masked", [False, True])
def test_moe_ffn_drops_tokens_like_jax(masked):
    """Capacity 8 for 48 routed choices over 4 experts: tokens are
    dropped, and which ones must agree; masked rows take no capacity."""
    jcfg = dataclasses.replace(reduced("moonshot-v1-16b-a3b", CONFIGS),
                               capacity_factor=0.25)
    tcfg = dataclasses.replace(reduced("moonshot-v1-16b-a3b", TCONFIGS),
                               capacity_factor=0.25)
    jp = jmoe.init_moe(jax.random.key(3), jcfg)
    tp = params_from_jax(_flatten(jp), "cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, jcfg.d_model)).astype(np.float32)
    mask = np.array([True, False, True, True]) if masked else None
    t = x.shape[0] * x.shape[1]
    assert jmoe.capacity(jcfg, t) == tmoe.capacity(tcfg, t) == 8
    assert jcfg.num_experts_per_token * t > 8 * jcfg.num_experts
    jy, ja = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg,
                          None if mask is None else jnp.asarray(mask))
    ty, ta = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg,
                          None if mask is None else torch.from_numpy(mask))
    _close(ty.numpy(), jy, 1e-4)
    _close(float(ta), float(ja), 1e-4)
    full = tmoe.moe_ffn(
        tp, torch.from_numpy(x),
        dataclasses.replace(tcfg, capacity_factor=8.0))[0]
    assert not torch.allclose(ty, full, atol=1e-4)   # something was dropped
    if masked:                     # a masked row gets the shared expert only
        _close(ty[1].numpy(),
               tmoe.layers.mlp(tp["shared"], torch.from_numpy(x[1])).numpy(),
               1e-6)


def test_top_k_breaks_ties_like_jax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tmoe.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------- what stays refused
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_prefix_sharing_is_refused_as_in_jax(arch):
    """Hybrid keeps slot-resident SSM state, enc-dec slot-resident
    cross-KV, and MoE routing is batch-coupled: neither engine shares
    their prefixes."""
    jm, tm, _, _ = pair(arch)
    assert not tm.prefix_shareable() and not jm.prefix_shareable()
    kw = dict(max_slots=2, max_seq=32, prefill_chunk=4, page_size=4,
              prefix_cache=True)
    for engine, model in ((JEngine, jm), (TEngine, tm)):
        with pytest.raises(ValueError, match="cannot share prefixes"):
            engine(model, **kw)


def test_paging_is_refused_for_ssm_as_in_jax():
    cfg = dataclasses.replace(TCONFIGS["mamba2-1.3b"].reduced(),
                              num_layers=2)
    jcfg = dataclasses.replace(CONFIGS["mamba2-1.3b"].reduced(),
                               num_layers=2)
    tm, jm = tbuild(cfg, "cpu"), jbuild(jcfg)
    for engine, model in ((JEngine, jm), (TEngine, tm)):
        with pytest.raises(ValueError, match="cannot page"):
            engine(model, max_slots=2, max_seq=32, paged=True, page_size=4,
                   prefill_chunk=4)
        with pytest.raises(ValueError, match="no KV to page"):
            model.init_paged_cache(4, 4, 2, 32)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_family_matches_cpu(cuda_device, arch):
    """forward (the flash kernel, causal or not; the SSD) and a paged
    prefill chunk + decode step (kernels 1, 2 and 5) on the card against
    the CPU path on the same weights."""
    _, tm, _, tparams = pair(arch)
    cm = tbuild(tm.cfg, cuda_device)
    cparams = _to(tparams, cuda_device)
    batch = _batch(tm.cfg, np.random.default_rng(7))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        want, _ = tm.forward(tparams, tb, remat="none")
        got, _ = cm.forward(cparams, _to(tb, cuda_device), remat="none")
    _close(got.cpu().numpy(), want.numpy(), 1e-3)
    rng = np.random.default_rng(8)
    bt = torch.from_numpy(_tables(rng))
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (B, 6))
                            .astype(np.int32))
    start = torch.zeros(B, dtype=torch.int32)
    act = torch.ones(B, dtype=torch.bool)
    outs = []
    for model, params, dev in ((tm, tparams, "cpu"),
                               (cm, cparams, cuda_device)):
        cache = model.init_paged_cache(POOL, PAGE, B, MAX_SEQ)
        pf, _ = model.prefill_chunk_paged(params, cache, toks.to(dev),
                                          start.to(dev), bt.to(dev),
                                          act.to(dev))
        dec, _ = model.decode_step_paged(params, cache, toks[:, :1].to(dev),
                                         (start + 6).to(dev), bt.to(dev),
                                         act.to(dev))
        outs.append(torch.cat([pf.flatten(), dec.flatten()]).cpu())
    _close(outs[1].numpy(), outs[0].numpy(), BF16)


@pytest.mark.gpu
def test_cuda_ssd_refuses_gradients(cuda_device):
    """The SSD kernel has no backward: a forward on the card that would
    need gradients through it raises instead of returning outputs
    without them."""
    _, tm, _, tparams = pair("jamba-v0.1-52b")
    cm = tbuild(tm.cfg, cuda_device)
    cparams = _to(tparams, cuda_device)
    for leaf in _tflat(cparams).values():
        leaf.requires_grad_(True)
    tokens = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="SSD backward"):
        cm.loss_fn(cparams, {"tokens": tokens})
