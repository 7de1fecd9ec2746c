"""The port's full-sequence attention and RMSNorm against the JAX package.

* ``ref.flash_attention_ref`` and ``ops.attention_prefill`` (the CPU path:
  ``naive_attention`` below 2048 positions, ``flash_attention_jnp`` at or
  above) against the Pallas ``flash_attention`` in interpret mode, JAX's
  ``naive_attention`` and ``flash_attention_jnp``: GQA / MQA / MHA, causal
  and not, Sq != Skv (both positions counted from 0), S below and at 2048.
  Tolerance 2e-5 (float32; tests/test_kernels.py).
* ``flash_attention_bwd_ref`` and the ``FlashAttention`` autograd wrapper's
  CPU route against ``jax.grad`` of JAX's jnp attention, on the same
  cotangent. Tolerance 2e-5 absolute + 2e-5 relative: both sides sum in
  float32 in another order over at most 64 positions.
* ``rmsnorm_ref`` / ``ops.fused_rmsnorm`` against the Pallas ``rmsnorm``
  in interpret mode: 2e-5 in float32, 2e-2 in bfloat16 (one rounding step
  of the output).
* The precision plan of the flash kernels' float32 route, on the CPU:
  ``ref.tf32_split`` and the plain forward and backward with every product
  formed in 3xTF32 stay within 2e-5 + 2e-5·|plain| at S = 2048; one TF32
  product does not.

The CUDA kernels are held against the same plain versions on the card
(the ``gpu`` tests below, and chip_smoke.py):
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention, flash_attention_bwd)
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _qkv(rng, b, sq, skv, h, kv, d):
    """Model-layout (B, S, heads, d) float32 q, k, v."""
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32))


def _head_major(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


# (b, sq, skv, h, kv, d): GQA, MQA, MHA; Sq < Skv and Sq > Skv
SHAPES = [(2, 24, 24, 8, 2, 16), (2, 20, 20, 4, 1, 32), (1, 16, 16, 4, 4, 16),
          (2, 8, 24, 4, 2, 16), (1, 24, 8, 4, 1, 16)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_jax(shape, causal):
    b, sq, skv, h, kv, d = shape
    q, k, v = _qkv(np.random.default_rng(0), b, sq, skv, h, kv, d)
    qh, kh, vh = _head_major(q), _head_major(k), _head_major(v)
    got = tref.flash_attention_ref(torch.from_numpy(qh), torch.from_numpy(kh),
                                   torch.from_numpy(vh), causal=causal)
    want = jref.flash_attention_ref(jnp.asarray(qh), jnp.asarray(kh),
                                    jnp.asarray(vh), causal=causal)
    _close(got, want)
    pallas = pallas_flash(jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh),
                          causal=causal, q_block=8, kv_block=8,
                          interpret=True)
    _close(got, pallas)
    # the model-layout CPU path and JAX's jnp lowerings
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o = ops.attention_prefill(tq, tk, tv, causal=causal)
    _close(o.transpose(1, 2), got)
    _close(o, jattn.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal))
    if sq == skv or not causal:
        blocks = dict(q_block=8, kv_block=8)
        _close(tattn.flash_attention_jnp(tq, tk, tv, causal=causal, **blocks),
               jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         **blocks))


@pytest.mark.parametrize("q_offset", [0, 5])
def test_naive_attention_q_offset_matches_jax(q_offset):
    q, k, v = _qkv(np.random.default_rng(1), 2, 6, 12, 4, 2, 16)
    got = tattn.naive_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                q_offset=q_offset)
    want = jattn.naive_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                 q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("h,kv", [(4, 1), (2, 2)])
def test_cpu_path_at_2048_takes_the_block_causal_lowering(h, kv):
    """At S = 2048 the CPU path is ``flash_attention_jnp`` (blocks of 1024,
    a diagonal mask on the last), held against JAX's and the Pallas
    kernel."""
    q, k, v = _qkv(np.random.default_rng(2), 1, 2048, 2048, h, kv, 16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    assert tq.shape[1] >= ops.FLASH_MIN_SEQ
    got = ops.attention_prefill(tq, tk, tv)
    _close(got, tattn.flash_attention_jnp(tq, tk, tv))
    _close(got, jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v)))
    pallas = pallas_flash(jnp.asarray(_head_major(q)),
                          jnp.asarray(_head_major(k)),
                          jnp.asarray(_head_major(v)), q_block=512,
                          kv_block=512, interpret=True)
    _close(got.transpose(1, 2), pallas)


def test_flash_jnp_falls_back_to_naive_when_blocks_do_not_divide():
    q, k, v = _qkv(np.random.default_rng(3), 1, 20, 20, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tattn.flash_attention_jnp(tq, tk, tv, q_block=8, kv_block=8)
    _close(got, tattn.naive_attention(tq, tk, tv))
    _close(got, jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), q_block=8,
                                          kv_block=8))


# ---------------------------------------------------------------- backward
def _jax_grads(q, k, v, do, causal):
    """jax.grad of <naive_attention(q, k, v), do> in model layout."""
    def f(q, k, v):
        return jnp.sum(jattn.naive_attention(q, k, v, causal=causal) * do)
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_plain_matches_jax_grad(shape, causal):
    b, sq, skv, h, kv, d = shape
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, b, sq, skv, h, kv, d)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    want = _jax_grads(q, k, v, jnp.asarray(do), causal)
    th = [torch.from_numpy(_head_major(x)) for x in (q, k, v, do)]
    o = tref.flash_attention_ref(th[0], th[1], th[2], causal=causal)
    lse = tref.flash_attention_lse_ref(th[0], th[1], causal=causal)
    got = tref.flash_attention_bwd_ref(th[0], th[1], th[2], o, lse, th[3],
                                       causal)
    for g, w in zip(got, want):
        _close(g.transpose(1, 2), w)
    # the autograd wrapper's CPU route (forward and backward kernels'
    # plain versions) through torch.autograd
    leaves = [t.clone().requires_grad_(True) for t in th[:3]]
    out = FlashAttention.apply(*leaves, causal)
    grads = torch.autograd.grad(out, leaves, th[3])
    for g, w in zip(grads, want):
        _close(g.transpose(1, 2), w)


def test_flash_lse_is_the_row_logsumexp():
    q, k, _ = _qkv(np.random.default_rng(5), 1, 8, 8, 4, 2, 16)
    tq, tk = (torch.from_numpy(_head_major(x)) for x in (q, k))
    lse = tref.flash_attention_lse_ref(tq, tk)
    o, lse2 = flash_attention(tq, tk, tk, return_lse=True)
    torch.testing.assert_close(lse, lse2)
    # row 0 sees key 0 only: its lse is its one scaled logit
    want = (tq[0, :, 0] * tk[0].repeat_interleave(2, 0)[:, 0]).sum(-1) / 4.0
    torch.testing.assert_close(lse[0, :, 0], want)


# ------------------------------------------------------- 3xTF32 precision
def test_tf32_split_rounds_to_nearest():
    """``ref.tf32_split``: big keeps 10 mantissa bits (nearest, ties away
    from zero, as cvt.rna.tf32.f32), small the remainder with its 13 low
    bits dropped (as the tensor cores read it), and big + small is x within
    2^-21 of |x|."""
    x = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -12,
                      3.0e-3, 0.0])
    big, small = tref.tf32_split(x)
    assert big.tolist()[:4] == [1.0, 1 + 2 ** -10, -(1 + 2 ** -10),
                                1 + 2 ** -10]
    assert small[0] == 0 and small[5] == 0 and big[5] == 0
    r = torch.from_numpy(np.random.default_rng(7).standard_normal(
        100_000).astype(np.float32))
    big, small = tref.tf32_split(r)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((big - r).abs() <= 2 ** -11 * r.abs()).all()
    assert ((big + small - r).abs() <= 2 ** -21 * r.abs()).all()


def _split_einsum(eq, a, b, terms):
    """``einsum(eq, a, b)`` with every product formed from the operands'
    TF32 splits: big·big + big·small + small·big (terms = 3, the kernels'
    float32 route), or big·big alone (terms = 1), summed in float32."""
    ab, asm = tref.tf32_split(a)
    bb, bsm = tref.tf32_split(b)
    out = torch.einsum(eq, ab, bb)
    if terms == 3:
        out = out + (torch.einsum(eq, ab, bsm) + torch.einsum(eq, asm, bb))
    return out


def _split_flash(q, k, v, do, terms):
    """The plain causal forward and backward (``flash_attention_ref``,
    ``flash_attention_bwd_ref``) with all seven products — q·kᵀ, p·v, and
    the backward's pᵀ·dO, dO·vᵀ, dS·k, dSᵀ·q — through _split_einsum.
    -> (o, (dq, dk, dv))."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, s, d)
    dog = do.reshape(qg.shape)
    scale = 1.0 / np.sqrt(d)
    logits = _split_einsum("bkgqd,bksd->bkgqs", qg, k, terms) * scale
    visible = torch.ones((s, s), dtype=torch.bool).tril()
    logits = torch.where(visible, logits, torch.tensor(tref.NEG_INF))
    p = torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True))
    o = _split_einsum("bkgqs,bksd->bkgqd", p, v, terms)
    dv = _split_einsum("bkgqs,bkgqd->bksd", p, dog, terms)
    dp = _split_einsum("bkgqd,bksd->bkgqs", dog, v, terms)
    ds = p * (dp - (dog * o).sum(-1, keepdim=True)) * scale
    dq = _split_einsum("bkgqs,bksd->bkgqd", ds, k, terms)
    dk = _split_einsum("bkgqs,bkgqd->bksd", ds, qg, terms)
    return o.reshape(q.shape), (dq.reshape(q.shape), dk, dv)


def _within(got, want, tol=TOL["float32"]):
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_products_keep_the_float32_tolerance(d):
    """The precision plan of the flash kernels' float32 route, on the CPU:
    with every product formed as big·big + big·small + small·big, the
    forward and backward at S = 2048 (GQA, causal) stay within 2e-5 +
    2e-5·|plain| of the plain versions; with big·big alone (one TF32
    product) they do not, which is why the kernels pay for three."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(_head_major(x))
               for x in _qkv(rng, 1, 2048, 2048, 2, 1, d))
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    o = tref.flash_attention_ref(q, k, v)
    lse = tref.flash_attention_lse_ref(q, k)
    grads = tref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    o3, grads3 = _split_flash(q, k, v, do, terms=3)
    assert _within(o3, o)
    for g3, g in zip(grads3, grads):
        assert _within(g3, g)
    o1, grads1 = _split_flash(q, k, v, do, terms=1)
    assert not _within(o1, o)
    assert not all(_within(g1, g) for g1, g in zip(grads1, grads))


# ----------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((32, 48)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = pallas_rmsnorm(jx, jnp.asarray(w), row_block=8, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tref.rmsnorm_ref(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype
    _close(got.float(), np.asarray(want.astype(jnp.float32)), TOL[dtype])
    _close(rmsnorm(tx, torch.from_numpy(w)).float(), got.float(), 0.0)
    # the entry point takes any leading shape and any row count
    x3 = rng.standard_normal((3, 5, 48)).astype(np.float32)
    got3 = ops.fused_rmsnorm(torch.from_numpy(x3).to(tx.dtype),
                             torch.from_numpy(w), 1e-6)
    want3 = jref.rmsnorm_ref(jnp.asarray(x3).astype(getattr(jnp, dtype)),
                             jnp.asarray(w), 1e-6)
    assert got3.shape == x3.shape
    _close(got3.float(), np.asarray(want3.astype(jnp.float32)), TOL[dtype])


#: (dtype, d, offset in elements of a contiguous view, copy bytes):
#: aligned rows take 16 bytes; a view 1, 2 or 4 elements off 16, or a row
#: whose d * element size is not a multiple of 16, the widest width that
#: every row still allows
RMS_COPY_CASES = [("float32", 2048, 0, 16), ("float32", 2048, 1, 4),
                  ("float32", 2048, 2, 8), ("float32", 2047, 0, 4),
                  ("float32", 2, 0, 8), ("bfloat16", 2048, 0, 16),
                  ("bfloat16", 2048, 1, 2), ("bfloat16", 2048, 2, 4),
                  ("bfloat16", 2048, 4, 8), ("bfloat16", 7, 0, 2)]


@pytest.mark.parametrize("dtype,d,offset,want", RMS_COPY_CASES)
def test_rmsnorm_plan_takes_the_widest_aligned_copy(dtype, d, offset, want):
    """The wrapper's launch plan (pure Python): the copy width from the
    base addresses of x and out and the row's bytes, on aligned and offset
    contiguous views; warps a row from D (0: the streaming variant);
    evict-first copies where x and the output outgrow the L2 (an H100's
    50 MB here)."""
    from repro_torch.kernels.rmsnorm import MAX_REGISTER_D, plan
    base = torch.randn(3 * d + 8, generator=torch.Generator().manual_seed(
        d)).to(getattr(torch, dtype))
    assert base.data_ptr() % 16 == 0
    x = base[offset:offset + 3 * d].view(3, d)
    out = torch.empty_like(x)
    l2 = 50 * 2**20
    got = plan(x.data_ptr(), out.data_ptr(), 3, d, x.element_size(), l2)
    assert got == (want, 1, False)
    assert (x.data_ptr() | out.data_ptr() | d * x.element_size()) % got[0] \
        == 0
    for dd, team in ((1, 1), (2048, 1), (2049, 2), (8192, 4),
                     (MAX_REGISTER_D, 8), (MAX_REGISTER_D + 1, 0),
                     (20000, 0)):
        assert plan(0, 0, 1, dd, 4, l2)[1] == team
    # 4096 x 2048: 67 MB in float32 (evict-first), 34 MB in bfloat16
    assert plan(0, 0, 4096, 2048, 4, l2)[2]
    assert not plan(0, 0, 4096, 2048, 2, l2)[2]
    # the CPU path takes the same view as the plain version
    w = torch.ones(d)
    torch.testing.assert_close(rmsnorm(x.float().contiguous(), w),
                               tref.rmsnorm_ref(x.float(), w))


def test_flash_and_rmsnorm_wrappers_reject_bad_operands():
    q = torch.empty((1, 4, 8, 16), device="meta")
    k = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        flash_attention_bwd(q, k, k, q, q[..., 0], q)
    with pytest.raises(ValueError, match="q must be"):
        flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        rmsnorm(q[0, 0], torch.empty((16,), device="meta"))


# -------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


#: (b, sq, skv, h, kv, d): a ragged GQA block and Sq < Skv at d = 64, the
#: registry's other head dims (16 reduced, 80 stablelm-3b, 128 qwen3-14b,
#: 160 stablelm-12b), Sq of 1, 63, 65 and 200, and Sq > Skv
CUDA_FLASH_SHAPES = [(2, 200, 200, 32, 4, 64), (1, 64, 130, 8, 8, 64),
                     (1, 1, 77, 4, 2, 16), (1, 63, 63, 4, 1, 80),
                     (2, 65, 65, 8, 2, 128), (1, 200, 96, 4, 2, 160),
                     (1, 130, 64, 4, 4, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CUDA_FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float32/bfloat16"])
def test_cuda_flash_matches_plain_versions(cuda_device, shape, causal, dtype):
    """Forward, lse and backward kernels against their plain versions on
    the card: q and k/v both float32 (the 3xTF32 route), both bfloat16
    (the bf16 route) or q float32 with k/v bfloat16; the backward run twice
    is bitwise equal (no atomics); in float32 the autograd wrapper's dq,
    dk, dv against torch.autograd of the plain forward. Each output's
    tolerance is its dtype's (float32: 2e-5 + 2e-5·|plain|; bfloat16:
    2e-2)."""
    dev = cuda_device
    qname, _, kname = dtype.partition("/")
    kname = kname or qname
    qt, kt = getattr(torch, qname), getattr(torch, kname)
    tq, tk = TOL[qname], TOL[kname]
    gen = torch.Generator(device=dev).manual_seed(0)
    b, sq, skv, h, kv, d = shape
    q, k, v = (torch.randn((b, n, hh, d), generator=gen, device=dev)
               .to(dt).transpose(1, 2)
               for n, hh, dt in ((sq, h, qt), (skv, kv, kt), (skv, kv, kt)))
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(
        o.float(), tref.flash_attention_ref(q, k, v, causal=causal).float(),
        atol=tq, rtol=tq)
    torch.testing.assert_close(
        lse, tref.flash_attention_lse_ref(q, k, causal=causal),
        atol=tq, rtol=tq)
    do = torch.randn(o.shape, generator=gen, device=dev).to(qt)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    for g, w, tol in zip(got, want, (tq, tk, tk)):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    if qname == kname == "float32":
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(FlashAttention.apply(*leaves, causal),
                                    leaves, do)
        ref_leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
        ref_grads = torch.autograd.grad(
            tref.flash_attention_ref(*ref_leaves, causal=causal),
            ref_leaves, do)
        for g, w in zip(grads, ref_grads):
            torch.testing.assert_close(g, w, atol=tq, rtol=tq)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_matches_plain_version(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    w = 1 + 0.1 * torch.randn((2048,), generator=gen, device=cuda_device)
    for rows in (4096, 4095, 1):
        x = torch.randn((rows, 2048), generator=gen, device=cuda_device).to(dt)
        torch.testing.assert_close(rmsnorm(x, w).float(),
                                   tref.rmsnorm_ref(x, w).float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 7, 2047, 2048, 8192, 20000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_every_variant(cuda_device, d, dtype):
    """Every variant and copy width against the plain version: D of 1, 7
    and 2047 (4- or 2-byte copies), 2048 and 8192 (one and four warps a
    row), 20000 (past the register variant: the streaming one); R of 1,
    4095 and 4096; the rows of a contiguous view 1 element off the
    allocation (4- or 2-byte copies); each call twice, bitwise equal."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    w = 1 + 0.1 * torch.randn((d,), generator=gen, device=cuda_device)
    for rows in (1, 4095, 4096):
        for offset in (0, 1):
            base = torch.randn((rows * d + offset,), generator=gen,
                               device=cuda_device).to(dt)
            x = base[offset:].view(rows, d)
            got = rmsnorm(x, w)
            torch.testing.assert_close(got.float(),
                                       tref.rmsnorm_ref(x, w).float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])
            assert torch.isfinite(got).all()
            assert torch.equal(got, rmsnorm(x, w))
    torch.cuda.synchronize()
