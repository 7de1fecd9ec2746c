"""The port's contiguous-cache path against the JAX package.

* The plain versions of the contiguous decode and prefill-chunk kernels
  (``repro_torch.kernels.ref``, which the wrappers compute on a CPU
  tensor) against the JAX Pallas kernels in interpret mode and against
  ``repro.kernels.ref``, on the same seeded numpy inputs: GQA / MQA / MHA,
  RoPE on and off, a cache length S that the Pallas kernel's s_block does
  not divide, garbage past every row's length, and the cache handed over
  as the head-major view of the model layout that the port passes.
* The dense transformer's contiguous ``prefill_chunk`` / ``decode_step``
  against JAX on the same weights (reduced tinyllama, 2 layers), with an
  inactive row and a tail-padded ``valid`` row; dropped writes land only
  in the spare drop position.
* ``slice_cache`` / ``set_cache_slice`` give the JAX bundle's slices.

Tolerances: 2e-5 in float32, 2e-2 with bfloat16 caches
(tests/test_kernels.py); logits 1e-4 (float32 through two layers).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.prefill_attention import \
    prefill_attention as pallas_prefill  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention  # noqa: E402
from repro_torch.kernels.prefill_attention import \
    prefill_attention  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GARBAGE = 50.0
S_BLOCK = 8            # the Pallas kernels' tile; S below is not a multiple


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _caches(rng, b, s, kv, d, filled, dtype):
    """Model-layout caches (B, S + 1, KV, d) — the port's, with its drop
    position — holding garbage past ``filled[i]`` positions of row i;
    returns the JAX kernel's head-major (B, KV, S, d) arrays and the
    port's head-major views of its own first S positions."""
    k = rng.standard_normal((b, s + 1, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s + 1, kv, d)).astype(np.float32)
    for i, n in enumerate(filled):
        k[i, n:], v[i, n:] = GARBAGE, -GARBAGE
    tk = torch.from_numpy(k).to(getattr(torch, dtype))
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    jk = jnp.asarray(k[:, :s].transpose(0, 2, 1, 3)).astype(getattr(jnp,
                                                                    dtype))
    jv = jnp.asarray(v[:, :s].transpose(0, 2, 1, 3)).astype(getattr(jnp,
                                                                    dtype))
    return (jk, jv), (tk[:, :s].transpose(1, 2), tv[:, :s].transpose(1, 2))


# (b, h, kv, d): GQA, MQA, MHA
SHAPES = [(3, 8, 2, 32), (2, 4, 1, 16), (2, 4, 4, 16)]
S = 21


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rope_theta", [None, 1e4])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_jax_ref(shape, rope_theta,
                                                 cache_dtype):
    b, h, kv, d = shape
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, S + 1, size=b).astype(np.int32)
    lengths[0] = S                                 # the whole cache
    (jk, jv), (tk, tv) = _caches(rng, b, S, kv, d, lengths, cache_dtype)
    q = rng.standard_normal((b, h, d)).astype(np.float32)

    want = pallas_decode(jnp.asarray(q), jk, jv, jnp.asarray(lengths),
                         s_block=S_BLOCK, rope_theta=rope_theta,
                         interpret=True)
    oracle = jref.decode_attention_ref(jnp.asarray(q), jk, jv,
                                       jnp.asarray(lengths),
                                       rope_theta=rope_theta)
    got = tref.decode_attention_ref(torch.from_numpy(q), tk, tv,
                                    torch.from_numpy(lengths),
                                    rope_theta=rope_theta)
    _close(got, want, cache_dtype)
    _close(got, oracle, cache_dtype)

    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = decode_attention.launches
    wrapped = decode_attention(torch.from_numpy(q), tk, tv,
                               torch.from_numpy(lengths),
                               rope_theta=rope_theta)
    assert torch.equal(wrapped, got)
    assert decode_attention.launches == before


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rope_theta", [None, 1e4])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_plain_matches_pallas_and_jax_ref(shape, rope_theta,
                                                  cache_dtype):
    b, h, kv, d = shape
    c = 5
    rng = np.random.default_rng(1)
    start = rng.integers(0, S - c + 1, size=b).astype(np.int32)
    start[0] = S - c                                # horizon at the last row
    (jk, jv), (tk, tv) = _caches(rng, b, S, kv, d, start + c, cache_dtype)
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)

    want = pallas_prefill(jnp.asarray(q), jk, jv, jnp.asarray(start),
                          s_block=S_BLOCK, rope_theta=rope_theta,
                          interpret=True)
    oracle = jref.prefill_attention_ref(jnp.asarray(q), jk, jv,
                                        jnp.asarray(start),
                                        rope_theta=rope_theta)
    got = tref.prefill_attention_ref(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(start),
                                     rope_theta=rope_theta)
    _close(got, want, cache_dtype)
    _close(got, oracle, cache_dtype)

    before = prefill_attention.launches
    wrapped = prefill_attention(torch.from_numpy(q), tk, tv,
                                torch.from_numpy(start),
                                rope_theta=rope_theta)
    assert torch.equal(wrapped, got)
    assert prefill_attention.launches == before


def test_cpu_dispatch_matches_plain_kernels():
    """ops on the CPU (models.attention, the JAX jnp lowering, on the
    model layout) and the kernels' plain versions (head-major) compute the
    same function."""
    b, h, kv, d, s, c = 2, 8, 2, 16, 12, 4
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.standard_normal((b, s, kv, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kv, d))
                         .astype(np.float32))
    lengths = torch.tensor([7, 12], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))
    got = ops.attention_decode(q, k, v, lengths, rope_theta=1e4)
    want = tref.decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                     v.transpose(1, 2), lengths, 1e4)
    torch.testing.assert_close(got[:, 0], want, atol=2e-5, rtol=2e-5)

    start = torch.tensor([3, 8], dtype=torch.int32)
    qc = torch.from_numpy(rng.standard_normal((b, c, h, d))
                          .astype(np.float32))
    got = ops.attention_prefill_chunk(qc, k, v, start, rope_theta=1e4)
    want = tref.prefill_attention_ref(qc.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), start, 1e4)
    torch.testing.assert_close(got.transpose(1, 2), want, atol=2e-5,
                               rtol=2e-5)


def test_contiguous_wrappers_reject_bad_operands():
    """Checks run before any launch: feed a meta tensor, which is neither
    CPU nor CUDA."""
    q = torch.empty((1, 4, 16), device="meta")
    k = torch.empty((1, 2, 8, 16), device="meta")
    ln = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        decode_attention(q, k, k, ln)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        prefill_attention(q[:, :, None], k, k, ln)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(CONFIGS["tinyllama-1.1b"].reduced(),
                               num_layers=2)
    tcfg = dataclasses.replace(TCONFIGS["tinyllama-1.1b"].reduced(),
                               num_layers=2)
    jparams = jbuild(jcfg).init(jax.random.key(0))
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), "cpu")


MAX_SEQ = 16


def _history(cfg, rng, b):
    """The same random bfloat16 history in both caches; the port's carries
    one more position per row, the drop position."""
    shape = (cfg.num_layers, b, MAX_SEQ, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    k = rng.standard_normal(shape).astype(np.float32) * 0.3
    v = rng.standard_normal(shape).astype(np.float32) * 0.3
    jc = {"k": jnp.asarray(k).astype(jnp.bfloat16),
          "v": jnp.asarray(v).astype(jnp.bfloat16)}
    tc = ttf.init_cache(cfg, b, MAX_SEQ, torch.device("cpu"))
    tc["k"][:, :, :MAX_SEQ] = torch.from_numpy(k).to(torch.bfloat16)
    tc["v"][:, :, :MAX_SEQ] = torch.from_numpy(v).to(torch.bfloat16)
    return jc, tc


def _caches_close(jc, tc):
    for key in ("k", "v"):
        np.testing.assert_allclose(
            np.asarray(jc[key].astype(jnp.float32)),
            tc[key].float().numpy()[:, :, :MAX_SEQ], atol=2e-2, rtol=2e-2)


def test_contiguous_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(0)
    b, c = 3, 6
    jc, tc = _history(jcfg, rng, b)
    start = np.array([2, 5, 1], np.int32)
    active = np.array([True, True, False])
    valid = np.array([6, 3, 6], np.int32)           # row 1 tail-padded
    tokens = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)

    jl, jc = jtf.prefill_chunk(jparams, jc, jnp.asarray(tokens),
                               jnp.asarray(start), jcfg, jnp.asarray(active),
                               jnp.asarray(valid))
    tl, tc2 = ttf.prefill_chunk(tparams, tc, torch.from_numpy(tokens),
                                torch.from_numpy(start), tcfg,
                                torch.from_numpy(active),
                                torch.from_numpy(valid))
    assert tc2 is tc                                # caches written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _caches_close(jc, tc)

    # decode: row 0 at the last position of its slot, row 1 after its
    # valid tokens, row 2 inactive
    lengths = np.array([MAX_SEQ - 1, 8, 3], np.int32)
    tok1 = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jc = jtf.decode_step(jparams, jc, jnp.asarray(tok1),
                             jnp.asarray(lengths), jcfg, jnp.asarray(active))
    tl, _ = ttf.decode_step(tparams, tc, torch.from_numpy(tok1),
                            torch.from_numpy(lengths), tcfg,
                            torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _caches_close(jc, tc)


def test_dropped_writes_land_only_in_the_drop_position(pair):
    """JAX's ``mode="drop"`` made real: inactive rows, tail pads and
    positions past ``max_seq`` write only the spare position past each
    row's slot; every other position stays bit-identical."""
    _, tcfg, _, tparams = pair
    rng = np.random.default_rng(1)
    _, tc = _history(tcfg, rng, 3)
    before = {k: v.clone() for k, v in tc.items()}
    tokens = torch.from_numpy(rng.integers(0, 256, (3, 4)).astype(np.int32))
    # row 0: 2 valid tokens at 0..1; row 1 inactive; row 2 runs past the
    # slot end (positions 14, 15 kept; 16, 17 dropped)
    ttf.prefill_chunk(tparams, tc, tokens,
                      torch.tensor([0, 0, MAX_SEQ - 2], dtype=torch.int32),
                      tcfg, torch.tensor([True, False, True]),
                      torch.tensor([2, 4, 4], dtype=torch.int32))
    changed = (tc["k"] != before["k"]).any(dim=(0, 3, 4))     # (B, S + 1)
    want = torch.zeros_like(changed)
    want[0, :2] = True
    want[2, MAX_SEQ - 2:MAX_SEQ] = True
    want[:, MAX_SEQ] = True
    assert torch.equal(changed, want)


def test_slices_match_the_jax_bundle(pair):
    """``slice_cache`` gives the JAX bundle's slot slice (the drop
    position left out); ``set_cache_slice`` writes it back in place."""
    jcfg, tcfg, _, _ = pair
    rng = np.random.default_rng(2)
    jc, tc = _history(jcfg, rng, 3)
    jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
    for key, jleaf in jm.slice_cache(jc, 1).items():
        tleaf = tm.slice_cache(tc, 1)[key]
        assert tuple(tleaf.shape) == tuple(jleaf.shape)
        np.testing.assert_array_equal(tleaf.float().numpy(),
                                      np.asarray(jleaf.astype(jnp.float32)))
    fresh = tm.slice_cache(tm.init_cache(1, MAX_SEQ), 0)
    assert tm.set_cache_slice(tc, 1, fresh) is tc
    jc = jm.set_cache_slice(jc, 1, jm.init_cache(1, MAX_SEQ))
    _caches_close(jc, tc)
    assert not tc["k"][:, 1, :MAX_SEQ].any()


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


# (G, d, q dtype, cache dtype, C, S, odd): G of 1-32, d of 16-256, q and
# caches in both dtypes, chunks of 1, 7 and 16, slots of 256, 300 and
# 2,065 positions (the whole-prompt path's: 65 decode tiles, 9 a rank of
# the cluster, the last rank 2); the serving shape first. ``odd`` reads the
# cache and the chunk's q through views whose base and strides are one
# element off 16 bytes (the last d of d + 1 columns): copies of 4 bytes
# in float32, of 2 in bfloat16.
CARD_CASES = [
    (8, 64, "float32", "bfloat16", 16, 256, False),
    (8, 64, "float32", "float32", 16, 256, False),
    (8, 64, "float32", "bfloat16", 1, 2065, False),
    (1, 18, "float32", "float32", 7, 300, True),
    (1, 18, "bfloat16", "bfloat16", 7, 300, True),
    (4, 80, "bfloat16", "float32", 1, 300, False),
    (32, 128, "float32", "bfloat16", 7, 256, False),
    (2, 256, "float32", "float32", 16, 2065, False),
    (16, 16, "bfloat16", "bfloat16", 16, 2065, True),
    (4, 160, "bfloat16", "bfloat16", 16, 256, False),
]


def _card_caches(rng, b, s, kv, d, filled, dtype, odd, dev):
    """Model-layout caches (B, S + 1, KV, d) on the card, garbage from
    position ``filled[i]`` of row i on (the drop position at S included),
    as the head-major views of their first S positions that the kernels
    read in place; with ``odd`` each is the last d columns of a
    (B, S + 1, KV, d + 1) tensor."""
    w = d + 1 if odd else d
    k = rng.standard_normal((b, s + 1, kv, w)).astype(np.float32)
    v = rng.standard_normal((b, s + 1, kv, w)).astype(np.float32)
    for i, n in enumerate(filled):
        k[i, n:], v[i, n:] = GARBAGE, -GARBAGE
    return tuple(torch.from_numpy(x).to(dev, getattr(torch, dtype))
                 [..., w - d:][:, :s].transpose(1, 2) for x in (k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_contiguous_kernels_match_plain_versions(cuda_device, case):
    """The hand-written kernels against their plain versions on the card,
    reading the model-layout cache in place through its strides: garbage
    in the drop position and past every row's length; decode lengths 0, 1,
    31, 32, 33 and S (a length-0 row, which the kernel zeroes and the plain
    version does not, is compared with 0); prefill starts whose horizons
    cross 32-position tiles, and two chunks that run past S (their rows
    clipped there); q as a strided model-layout view; the same call twice,
    bitwise equal. Tolerance 2e-5 + 2e-5·|plain|, or 2e-2 where the output
    is bfloat16."""
    g, d, q_dtype, cache_dtype, c, s, odd = case
    kv, dev = 2, cuda_device
    h = g * kv
    tol = TOL[q_dtype]
    qdt = getattr(torch, q_dtype)
    rng = np.random.default_rng(4)
    w = d + 1 if odd else d

    lengths = np.array([0, 1, 31, 32, 33, s], np.int32)
    tk, tv = _card_caches(rng, len(lengths), s, kv, d, lengths, cache_dtype,
                          odd, dev)
    ln = torch.from_numpy(lengths).to(dev)
    # every other head of a wider tensor: row and head strides of q
    q = torch.from_numpy(rng.standard_normal((len(lengths), 2 * h, d))
                         .astype(np.float32)).to(dev, qdt)[:, ::2]
    got = decode_attention(q, tk, tv, ln, rope_theta=1e4)
    again = decode_attention(q, tk, tv, ln, rope_theta=1e4)
    want = tref.decode_attention_ref(q, tk, tv, ln, 1e4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[1:], want[1:], atol=tol, rtol=tol)
    assert torch.all(got[0] == 0)
    assert torch.equal(got, again)

    starts = np.array([0, 30 - c // 2, 63, s - c, s - c // 2, s],
                      np.int32)
    tk, tv = _card_caches(rng, len(starts), s, kv, d,
                          np.minimum(starts + c, s), cache_dtype, odd, dev)
    start = torch.from_numpy(starts).to(dev)
    qc = torch.from_numpy(rng.standard_normal((len(starts), c, h, w))
                          .astype(np.float32)).to(dev, qdt)[..., w - d:]
    qc = qc.transpose(1, 2)
    got = prefill_attention(qc, tk, tv, start, rope_theta=1e4)
    again = prefill_attention(qc, tk, tv, start, rope_theta=1e4)
    want = tref.prefill_attention_ref(qc, tk, tv, start, 1e4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.equal(got, again)
