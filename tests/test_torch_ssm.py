"""The port's Mamba2 family against the JAX package.

* The SSD kernel's plain version (``repro_torch.kernels.ref.ssd_chunk_ref``,
  which the wrapper computes on a CPU tensor) against the JAX Pallas kernel
  in interpret mode and against ``repro.kernels.ref.ssd_chunk_ref``, on the
  same seeded numpy inputs: chunk lengths Q of 1, 7, 16 and 64 (where
  exp(cum_i - cum_j) overflows above the diagonal), a head count the head
  block does not divide.
* ``ssd_forward``'s CPU path (the JAX jnp lowering) and its card path
  (the chunks flattened through ``ops.ssd_intra_chunk``) compute the same
  function.
* Mamba2 ``prefill_chunk`` / ``decode_step`` against JAX on the same
  weights (reduced mamba2, 2 layers, several chunks per dispatch), from a
  non-zero starting state, with an inactive row and a tail-padded
  ``valid`` row; the caches keep the JAX bundle's dtypes.
* ``params_from_jax`` carries the Mamba2 leaves across.

Tolerances: 2e-5 for the float32 kernel (tests/test_kernels.py); 1e-4 for
logits and the float32 SSM state through two layers; 2e-2 for the
bfloat16 conv states (one rounding step of a value near a tie).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import CONFIGS  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunk_scan as pallas_ssd  # noqa: E402
from repro.models.factory import build_model as jbuild  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs.registry import CONFIGS as TCONFIGS  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk_scan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.factory import build_model as tbuild  # noqa: E402

torch.set_num_threads(2)


def ssd_inputs(rng, m, q, h, p, n):
    """SSD chunk inputs shaped as the model makes them: dt > 0, A < 0, so
    cum falls along the chunk and exp(cum_i - cum_j) overflows above the
    diagonal once Q is long enough."""
    x = rng.standard_normal((m, q, h, p)).astype(np.float32)
    dt = rng.uniform(0.3, 1.0, (m, q, h)).astype(np.float32)
    a = -rng.uniform(0.5, 1.5, (h,)).astype(np.float32)
    cum = np.cumsum(dt * a, axis=1).astype(np.float32)
    b_ = (0.3 * rng.standard_normal((m, q, n))).astype(np.float32)
    c_ = (0.3 * rng.standard_normal((m, q, n))).astype(np.float32)
    return x, dt, cum, b_, c_


@pytest.mark.parametrize("q", [1, 7, 16, 64])
def test_ssd_plain_matches_pallas_and_jax_ref(q):
    m, h, p, n = 2, 6, 8, 16
    rng = np.random.default_rng(q)
    arrays = ssd_inputs(rng, m, q, h, p, n)
    # head block 4 does not divide 6 heads: Pallas falls back to blocks of 3
    want_y, want_st = pallas_ssd(*map(jnp.asarray, arrays), head_block=4,
                                 interpret=True)
    oracle_y, oracle_st = jax.vmap(jref.ssd_chunk_ref)(
        *map(jnp.asarray, arrays))
    got_y, got_st = tref.ssd_chunk_ref(*map(torch.from_numpy, arrays))
    assert got_y.shape == (m, q, h, p) and got_st.shape == (m, h, p, n)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_st).all()
    for got, want in ((got_y, want_y), (got_y, oracle_y), (got_st, want_st),
                      (got_st, oracle_st)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)

    # one chunk at a time gives the same, as the JAX oracle takes it
    y1, st1 = tref.ssd_chunk_ref(*(torch.from_numpy(a[1]) for a in arrays))
    torch.testing.assert_close(y1, got_y[1], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(st1, got_st[1], atol=1e-6, rtol=1e-6)

    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = ssd_chunk_scan.launches
    wy, wst = ssd_chunk_scan(*map(torch.from_numpy, arrays))
    assert torch.equal(wy, got_y) and torch.equal(wst, got_st)
    assert ssd_chunk_scan.launches == before


def test_ssd_forward_cpu_and_card_paths_agree():
    """The inline jnp lowering the CPU runs and the kernel path the card
    runs (chunks flattened to M = B * nc, ``ops.ssd_intra_chunk``, here
    its plain version) give the same chunk outputs and states."""
    b, nc, q, h, p, n = 2, 3, 5, 4, 8, 16
    rng = np.random.default_rng(5)
    x, dt, cum, b_, c_ = ssd_inputs(rng, b * nc, q, h, p, n)
    args = (torch.from_numpy(x).reshape(b, nc, q, h, p),
            torch.from_numpy(dt).reshape(b, nc, q, h),
            torch.from_numpy(cum).reshape(b, nc, q, h),
            torch.from_numpy(b_).reshape(b, nc, q, n),
            torch.from_numpy(c_).reshape(b, nc, q, n))
    y, st = tssm._intra_chunk(*args)
    ky, kst = tssm._intra_chunk_kernel(*args)
    torch.testing.assert_close(ky, y, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(kst, st, atol=2e-5, rtol=2e-5)


def test_ssd_wrapper_rejects_bad_operands():
    x = torch.empty((1, 4, 2, 8), device="meta")
    t = torch.empty((1, 4, 2), device="meta")
    bn = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ssd_chunk_scan(x, t, t, bn, bn)


def test_largest_divisor_matches_jax():
    from repro.kernels.autotune import largest_divisor
    for n in range(1, 70):
        for cap in (1, 4, 16, 256):
            assert tssm.largest_divisor(n, cap) == largest_divisor(n, cap)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def pair():
    """Reduced mamba2 with 2 layers and a 4-token SSD chunk, so a 6-token
    prefill dispatch runs two chunks and the inter-chunk recurrence."""
    jcfg = dataclasses.replace(CONFIGS["mamba2-1.3b"].reduced(),
                               num_layers=2, ssm_chunk=4)
    tcfg = dataclasses.replace(TCONFIGS["mamba2-1.3b"].reduced(),
                               num_layers=2, ssm_chunk=4)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
    jparams = jm.init(jax.random.key(0))
    return jm, tm, jparams, params_from_jax(_flatten(jparams), "cpu")


def _state(jm, tm, rng, b):
    """The same non-zero starting state in both, in the serving dtypes
    (conv states bfloat16, SSM state float32)."""
    jc = jm.init_cache(b, 0)
    tc = tm.init_cache(b, 0)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tc.items()}
    new = {}
    for k, v in jc.items():
        arr = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        new[k] = jnp.asarray(arr).astype(v.dtype)
        tc[k].copy_(torch.from_numpy(arr))
    return new, tc


def _states_close(jc, tc):
    for k, v in jc.items():
        assert tc[k].dtype == getattr(torch, str(v.dtype))
        tol = 1e-4 if k == "ssm" else 2e-2
        np.testing.assert_allclose(tc[k].float().numpy(),
                                   np.asarray(v.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


def test_mamba_prefill_and_decode_match_jax(pair):
    jm, tm, jparams, tparams = pair
    rng = np.random.default_rng(0)
    b, c = 3, 6
    jc, tc = _state(jm, tm, rng, b)
    start = np.array([4, 0, 9], np.int32)          # unused by the family
    active = np.array([True, True, False])
    valid = np.array([6, 3, 6], np.int32)           # row 1 tail-padded
    tokens = rng.integers(0, jm.cfg.vocab_size, (b, c)).astype(np.int32)

    jl, jc = jm.prefill_chunk(jparams, jc, jnp.asarray(tokens),
                              jnp.asarray(start), jnp.asarray(active),
                              jnp.asarray(valid))
    before = {k: v.clone() for k, v in tc.items()}
    tl, tc2 = tm.prefill_chunk(tparams, tc, torch.from_numpy(tokens),
                               torch.from_numpy(start),
                               torch.from_numpy(active),
                               torch.from_numpy(valid))
    assert tc2 is tc                                # state written in place
    keep = [(0, slice(None)), (1, slice(0, 3))]     # real tokens only
    for i, cols in keep:
        np.testing.assert_allclose(tl[i, cols].numpy(),
                                   np.asarray(jl)[i, cols], atol=1e-4,
                                   rtol=1e-4)
    _states_close(jc, tc)
    for k in tc:                                    # the inactive row
        assert torch.equal(tc[k][:, 2], before[k][:, 2])

    tok1 = rng.integers(0, jm.cfg.vocab_size, (b, 1)).astype(np.int32)
    lengths = np.array([10, 3, 9], np.int32)
    jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok1),
                            jnp.asarray(lengths), jnp.asarray(active))
    tl, _ = tm.decode_step(tparams, tc, torch.from_numpy(tok1),
                           torch.from_numpy(lengths),
                           torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               atol=1e-4, rtol=1e-4)
    _states_close(jc, tc)


def test_mamba_slices_match_the_jax_bundle(pair):
    jm, tm, _, _ = pair
    rng = np.random.default_rng(1)
    jc, tc = _state(jm, tm, rng, 3)
    for key, jleaf in jm.slice_cache(jc, 2).items():
        tleaf = tm.slice_cache(tc, 2)[key]
        np.testing.assert_array_equal(tleaf.float().numpy(),
                                      np.asarray(jleaf.astype(jnp.float32)))
    tm.set_cache_slice(tc, 2, tm.slice_cache(tm.init_cache(1, 0), 0))
    assert all(not v[:, 2].any() and v[:, 1].any() for v in tc.values())


def test_mamba_params_carry_over_with_same_leaves(pair):
    jm, tm, jparams, tparams = pair
    jflat = _flatten(jparams)
    tflat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                tflat[path] = v
    walk(tparams, "")
    assert sorted(jflat) == sorted(tflat)
    assert "layers/ssm/A_log" in tflat and "layers/ssm/gate_norm" in tflat
    for path, arr in jflat.items():
        assert tuple(arr.shape) == tuple(tflat[path].shape), path
        np.testing.assert_array_equal(arr, tflat[path].numpy())
    # the port's own initialiser makes the same leaves and shapes
    own = tm.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in own["layers"]["ssm"].items()} == \
        {k: v.shape for k, v in tparams["layers"]["ssm"].items()}
    assert own["embedding"].shape == tparams["embedding"].shape


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q", [16, 13, 1, 256])
def test_cuda_ssd_kernel_matches_plain_version(cuda_device, q):
    """The hand-written kernel against its plain version on the card, at
    mamba2-1.3b's widths (64 heads of 64, state 128), 4 chunks."""
    rng = np.random.default_rng(q)
    arrays = [torch.from_numpy(a).to(cuda_device)
              for a in ssd_inputs(rng, 4, q, 64, 64, 128)]
    y, st = ssd_chunk_scan(*arrays)
    want_y, want_st = tref.ssd_chunk_ref(*arrays)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(st, want_st, atol=2e-5, rtol=2e-5)
