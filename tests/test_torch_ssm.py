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


@pytest.mark.parametrize("q,h,head_block", [(17, 6, 4), (33, 6, 4),
                                          (16, 3, 2)])
def test_ssd_plain_matches_pallas_at_ragged_chunks_and_head_blocks(
        q, h, head_block):
    """Chunks that are not a multiple of the CUDA kernel's 16-position
    tile (17, 33), and 3 heads asked for in blocks of 2 (the Pallas kernel
    falls back to blocks of 1 there; the ragged head block of the CUDA
    kernel is held only on the card, by the gpu cases with H = 3)."""
    m, p, n = 2, 8, 16
    arrays = ssd_inputs(np.random.default_rng(100 + q), m, q, h, p, n)
    want_y, want_st = pallas_ssd(*map(jnp.asarray, arrays),
                                 head_block=head_block, interpret=True)
    oracle_y, oracle_st = jax.vmap(jref.ssd_chunk_ref)(
        *map(jnp.asarray, arrays))
    got_y, got_st = tref.ssd_chunk_ref(*map(torch.from_numpy, arrays))
    for got, want in ((got_y, want_y), (got_y, oracle_y), (got_st, want_st),
                      (got_st, oracle_st)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


def _split_einsum(eq, a, b, terms):
    """``einsum(eq, a, b)`` with every product formed from the operands'
    TF32 splits: big·big + big·small + small·big (terms = 3, the kernel's
    route), or big·big alone (terms = 1), summed in float32."""
    ab, asm = tref.tf32_split(a)
    bb, bsm = tref.tf32_split(b)
    out = torch.einsum(eq, ab, bb)
    if terms == 3:
        out = out + (torch.einsum(eq, ab, bsm) + torch.einsum(eq, asm, bb))
    return out


def _split_ssd(x, dt, cum, b_, c_, terms):
    """``ref.ssd_chunk_ref`` with its three products through _split_einsum,
    as csrc/ssd_chunk_scan.cu forms them on the tensor cores: C·Bᵀ; the
    scores (from that C·Bᵀ, in float32) times x; x ⊙ w times B."""
    q = x.shape[-3]
    cb = _split_einsum("mqn,mkn->mqk", c_, b_, terms)
    seg = cum[:, :, None, :] - cum[:, None, :, :]
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    decay = torch.where(tri[:, :, None], torch.exp(seg), torch.tensor(0.0))
    scores = cb[..., None] * decay * dt[:, None, :, :]
    y = _split_einsum("mqkh,mkhp->mqhp", scores, x, terms)
    xw = x * (torch.exp(cum[:, -1:, :] - cum) * dt)[..., None]
    state = _split_einsum("mqhp,mqn->mhpn", xw, b_, terms)
    return y, state


@pytest.mark.parametrize("q", [16, 256])
def test_3xtf32_ssd_products_keep_the_float32_tolerance(q):
    """The precision plan of the SSD kernel, on the CPU at mamba2-1.3b's
    widths (64 heads of 64, state 128): with C·Bᵀ, the scores' product with
    x and the state's product each formed as big·big + big·small +
    small·big, y and the state stay within 2e-5 + 2e-5·|plain| of the plain
    version at the serving chunk (Q = 16) and the whole-prompt chunk
    (Q = 256); with big·big alone (one TF32 product) they do not."""
    arrays = [torch.from_numpy(a) for a in
              ssd_inputs(np.random.default_rng(200 + q), 1, q, 64, 64, 128)]
    want = tref.ssd_chunk_ref(*arrays)

    def within(got, ref_):
        return bool(((got - ref_).abs() <= 2e-5 + 2e-5 * ref_.abs()).all())

    assert all(within(g, w) for g, w in zip(_split_ssd(*arrays, terms=3),
                                            want))
    assert not all(within(g, w) for g, w in zip(_split_ssd(*arrays, terms=1),
                                                want))


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


@pytest.mark.parametrize("m,q,want", [(4, 16, 32), (1, 16, 16),
                                      (4, 64, 32), (4, 256, 64),
                                      (1, 256, 16)])
def test_ssd_plan_and_shared_memory_reckoning(m, q, want):
    """The wrapper's launch plan and its reckoning of a CTA's shared memory
    (pure Python; the card checks the reckoning against the kernel's C
    entry). At mamba2-1.3b's widths (two heads a CTA) the P slice gives
    1.5 CTAs an SM for a chunk staged whole (Q <= 64), half a CTA an SM
    for a streamed one; every plan over ragged shapes names a kernel
    instance and fits a CTA's shared memory."""
    from repro_torch.kernels import common
    from repro_torch.kernels.ssd_scan import MAX_N, SLICES, plan
    assert plan(m, q, 64, 64) == want
    for mm, qq, h, p, n in [(1, 1, 1, 16, 16), (9, 13, 3, 16, 16),
                            (2, 33, 5, 20, 12), (1, 256, 64, 64, MAX_N),
                            (3, 100, 7, 48, 100), (1, 16, 5, 7, 9)]:
        ps = plan(mm, qq, h, p)
        assert ps in SLICES and (ps < 2 * p or ps == SLICES[-1])
        assert common.ssd_smem(qq, ps, n) <= common.MAX_SMEM_BYTES
    # Q = 16: C rows (16 x 132 floats), one tile (B 16 x 132, x of two
    # heads 2 x 16 x 36, cum and dt 2 x 2 x 16) and its C·Bᵀ fragments
    # (one tile pair, two column halves, two depth parts, 128 floats each)
    assert common.ssd_smem(16, 32, 128) == 4 * (
        16 * 132 + (16 * 132 + 2 * 16 * 36 + 64) + 2 * 2 * 128)
    # Q = 256: 8 tiles of C rows and a ring of 4 tiles
    assert common.ssd_smem(256, 64, 128) == 4 * (
        128 * 132 + 4 * (16 * 132 + 2 * 16 * 68 + 64))
    # N = 256 at Q = 256: a ring of 4 would not fit, 2 does
    assert common.ssd_smem(256, 64, 256) == 4 * (
        128 * 260 + 2 * (16 * 260 + 2 * 16 * 68 + 64))


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


#: (M, Q, H, P, N, steep, offset): every chunk length the kernel tiles
#: differently (1, 7, 13 pad one tile; 16 the serving chunk; 17, 33, 100
#: ragged; 255, 256 streamed), one to nine rows, head counts that the head
#: block of 2 leaves a tail of, the reduced configs' widths and
#: mamba2-1.3b's, a steep decay at Q = 256 (most of exp(cum_i - cum_j)
#: underflows); P and N odd or not multiples of 4, and operands in a
#: contiguous view 1 float (4 bytes) off 16 (the kernel's 4-byte copies
#: and single-float stores)
CUDA_SSD_CASES = [(1, 1, 1, 16, 16, False, 0), (4, 7, 3, 64, 128, False, 0),
                  (9, 13, 64, 16, 16, False, 0),
                  (4, 16, 64, 64, 128, False, 0),
                  (1, 16, 3, 64, 128, False, 0),
                  (9, 17, 1, 64, 128, False, 0),
                  (4, 33, 3, 16, 16, False, 0),
                  (1, 100, 64, 64, 128, False, 0),
                  (4, 255, 3, 64, 128, False, 0),
                  (1, 256, 64, 64, 128, True, 0),
                  (9, 256, 3, 16, 16, True, 0),
                  (2, 33, 3, 18, 30, False, 0), (1, 16, 5, 7, 9, False, 0),
                  (3, 256, 5, 33, 17, False, 0),
                  (4, 16, 64, 64, 128, False, 1),
                  (2, 100, 3, 33, 17, False, 1)]


def _offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t`` copied into a contiguous view ``offset`` elements into its
    allocation."""
    base = torch.empty(offset + t.numel(), dtype=t.dtype, device=t.device)
    base[offset:].copy_(t.flatten())
    return base[offset:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CUDA_SSD_CASES)
def test_cuda_ssd_kernel_cases(cuda_device, case):
    """The kernel against its plain version at every case above, through
    the wrapper's plan and through every P slice the kernel is
    instantiated for; outputs finite, each call twice bitwise equal; the
    wrapper's shared-memory reckoning against the kernel's C entry."""
    from repro_torch.kernels import build, common
    from repro_torch.kernels.ssd_scan import SLICES, launch
    m, q, h, p, n, steep, offset = case
    x, dt, cum, b_, c_ = ssd_inputs(np.random.default_rng(q), m, q, h, p, n)
    if steep:
        cum = cum * 8
    arrays = [_offset_view(torch.from_numpy(a).to(cuda_device), offset)
              for a in (x, dt, cum, b_, c_)]
    if offset:
        assert all(a.data_ptr() % 16 == 4 * offset for a in arrays)
    want_y, want_st = tref.ssd_chunk_ref(*arrays)
    runs = [lambda: ssd_chunk_scan(*arrays)]
    runs += [lambda ps=ps: launch(*arrays, ps) for ps in SLICES]
    for run in runs:
        y, st = run()
        torch.cuda.synchronize()
        assert torch.isfinite(y).all() and torch.isfinite(st).all()
        torch.testing.assert_close(y, want_y, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(st, want_st, atol=2e-5, rtol=2e-5)
        y2, st2 = run()
        assert torch.equal(y, y2) and torch.equal(st, st2)
    smem = build.load("ssd_chunk_scan").ssd_chunk_scan_smem
    smem.argtypes = [build.ctypes.c_int] * 3
    smem.restype = build.ctypes.c_longlong
    for ps in SLICES:
        assert smem(q, ps, n) == common.ssd_smem(q, ps, n)
