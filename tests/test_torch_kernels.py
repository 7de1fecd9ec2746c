"""The port's paged attention kernels: plain versions vs the JAX package.

Each plain PyTorch version (``repro_torch.kernels.ref``, which the kernel
wrappers compute on a CPU tensor) is held against the JAX Pallas kernel in
interpret mode and against ``repro.kernels.ref`` on the same seeded numpy
inputs: GQA / MQA / MHA, RoPE on and off, garbage in the sentinel page
and past every row's length, prefill horizons crossing page boundaries.
Tolerances: 2e-5 in float32, 2e-2 with bfloat16 pools
(tests/test_kernels.py). The arithmetic plans of the CUDA kernels that
paged_attention.cuh gives both cache layouts (the prefill's two or three
TF32 products, the decode's 8-rank combine) are held against the plain
versions on the CPU, paged and contiguous, and every serving wrapper's
shared-memory reckoning is checked before any launch. The paged CUDA
kernels themselves are held
against the same plain versions on the card (the ``gpu`` tests below, and
chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_decode  # noqa: E402
from repro.kernels.paged_prefill_attention import \
    paged_prefill_attention as pallas_prefill  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention  # noqa: E402
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import \
    paged_prefill_attention  # noqa: E402
from repro_torch.kernels.prefill_attention import \
    prefill_attention  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GARBAGE = 50.0


def _pool(rng, b, kv, d, page, nb, need_pages):
    """Pools with garbage in the sentinel page 0; block tables map the
    first ``need_pages[i]`` blocks of row i to distinct real pages and the
    rest to the sentinel."""
    num_pages = 1 + int(sum(need_pages)) + 2
    k = rng.standard_normal((num_pages, page, kv, d)).astype(np.float32)
    v = rng.standard_normal((num_pages, page, kv, d)).astype(np.float32)
    k[0], v[0] = GARBAGE, -GARBAGE
    ids = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((b, nb), np.int32)
    at = 0
    for i, n in enumerate(need_pages):
        bt[i, :n] = ids[at:at + n]
        at += n
    return k, v, bt


def _both(x, dtype):
    """The same float32 numpy array as a JAX and a torch array of dtype."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


# (b, h, kv, d, page, nb): GQA, MQA, MHA
SHAPES = [(3, 8, 2, 32, 8, 4), (2, 4, 1, 16, 4, 5), (2, 4, 4, 16, 8, 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rope_theta", [None, 1e4])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_matches_pallas_and_jax_ref(shape, rope_theta,
                                                       pool_dtype):
    b, h, kv, d, page, nb = shape
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, nb * page + 1, size=b).astype(np.int32)
    lengths[0] = page + 3                      # crosses a page boundary
    need = [int(np.ceil(n / page)) for n in lengths]
    k, v, bt = _pool(rng, b, kv, d, page, nb, need)
    # garbage past each row's length inside its own last page
    for i, n in enumerate(lengths):
        last = bt[i, (n - 1) // page]
        k[last, n % page or page:] = -GARBAGE
        v[last, n % page or page:] = GARBAGE
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    jk, tk = _both(k, pool_dtype)
    jv, tv = _both(v, pool_dtype)

    want = pallas_decode(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                         jnp.asarray(lengths), rope_theta=rope_theta,
                         interpret=True)
    oracle = jref.paged_decode_attention_ref(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lengths),
        rope_theta=rope_theta)
    got = tref.paged_decode_attention_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
        torch.from_numpy(lengths), rope_theta=rope_theta)
    _close(got, want, pool_dtype)
    _close(got, oracle, pool_dtype)

    # the wrapper on a CPU tensor is the plain version, and launches nothing
    before = paged_decode_attention.launches
    wrapped = paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
        torch.from_numpy(lengths), rope_theta=rope_theta)
    assert torch.equal(wrapped, got)
    assert paged_decode_attention.launches == before


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rope_theta", [None, 1e4])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_prefill_plain_matches_pallas_and_jax_ref(shape, rope_theta,
                                                        pool_dtype):
    b, h, kv, d, page, nb = shape
    c = page + 1                               # every chunk spans 2+ pages
    rng = np.random.default_rng(1)
    start = rng.integers(0, nb * page - c + 1, size=b).astype(np.int32)
    start[0] = page - 2                        # horizon crosses a boundary
    need = [int(np.ceil((s + c) / page)) for s in start]
    k, v, bt = _pool(rng, b, kv, d, page, nb, need)
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    jk, tk = _both(k, pool_dtype)
    jv, tv = _both(v, pool_dtype)

    want = pallas_prefill(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                          jnp.asarray(start), rope_theta=rope_theta,
                          interpret=True)
    oracle = jref.paged_prefill_attention_ref(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(start),
        rope_theta=rope_theta)
    got = tref.paged_prefill_attention_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
        torch.from_numpy(start), rope_theta=rope_theta)
    _close(got, want, pool_dtype)
    _close(got, oracle, pool_dtype)

    before = paged_prefill_attention.launches
    wrapped = paged_prefill_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
        torch.from_numpy(start), rope_theta=rope_theta)
    assert torch.equal(wrapped, got)
    assert paged_prefill_attention.launches == before


def test_plain_versions_ignore_unowned_pages():
    """Garbage in the sentinel page and past a row's length cannot leak
    into the output."""
    b, h, kv, d, page, nb = 1, 4, 2, 16, 4, 4
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((8, page, kv, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((8, page, kv, d))
                         .astype(np.float32))
    bt = torch.tensor([[3, 5, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([6], dtype=torch.int32)
    out1 = tref.paged_decode_attention_ref(q, k, v, bt, lengths, 1e4)
    k2, v2 = k.clone(), v.clone()
    k2[0], v2[0] = 999.0, -999.0
    k2[5, 2:], v2[5, 2:] = -999.0, 999.0
    out2 = tref.paged_decode_attention_ref(q, k2, v2, bt, lengths, 1e4)
    torch.testing.assert_close(out1, out2, atol=1e-6, rtol=0)


def test_cpu_dispatch_path_matches_plain_kernels():
    """ops on CPU (gather + models.attention, the JAX jnp lowering) and the
    kernels' plain versions compute the same function."""
    b, h, kv, d, page, nb, c = 2, 8, 2, 16, 4, 4, 5
    rng = np.random.default_rng(3)
    k, v, bt = _pool(rng, b, kv, d, page, nb, [4, 4])
    k, v, bt = map(torch.from_numpy, (k, v, bt))
    lengths = torch.tensor([7, 16], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))
    got = ops.attention_decode_paged(q, k, v, bt, lengths, rope_theta=1e4)
    want = tref.paged_decode_attention_ref(q[:, 0], k, v, bt, lengths, 1e4)
    torch.testing.assert_close(got[:, 0], want, atol=2e-5, rtol=2e-5)

    start = torch.tensor([3, 9], dtype=torch.int32)
    qc = torch.from_numpy(rng.standard_normal((b, c, h, d))
                          .astype(np.float32))
    got = ops.attention_prefill_chunk_paged(qc, k, v, bt, start,
                                            rope_theta=1e4)
    want = tref.paged_prefill_attention_ref(qc.transpose(1, 2), k, v, bt,
                                            start, 1e4)
    torch.testing.assert_close(got.transpose(1, 2), want, atol=2e-5,
                               rtol=2e-5)
    gathered = tattn.gather_pages(k, bt)
    assert gathered.shape == (b, nb * page, kv, d)


def test_kernel_wrappers_reject_bad_operands():
    """Checks run before any launch: a CUDA-only path cannot be reached
    here, so feed a meta tensor, which is neither CPU nor CUDA."""
    q = torch.empty((1, 4, 16), device="meta")
    k = torch.empty((2, 4, 2, 16), device="meta")
    bt = torch.empty((1, 2), dtype=torch.int32, device="meta")
    ln = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        paged_decode_attention(q, k, k, bt, ln)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        paged_prefill_attention(q[:, :, None], k, k, bt, ln)


#: each serving wrapper, and its kernel's reckoning of a CTA's shared
#: memory at G = 8, d = 256, q and cache float32
SMEM_WRAPPERS = {
    "paged_decode_attention": (
        paged_decode_attention, lambda c: c.decode_smem(8, 256, 4)),
    "paged_prefill_attention": (
        paged_prefill_attention, lambda c: c.paged_prefill_smem(256, 4, 4)),
    "decode_attention": (decode_attention, lambda c: c.decode_smem(8, 256, 4)),
    "prefill_attention": (
        prefill_attention, lambda c: c.prefill_smem(256, 4, 4)),
}


@pytest.mark.parametrize("name", SMEM_WRAPPERS)
def test_shared_memory_reckoning_refuses_before_any_launch(monkeypatch,
                                                           name):
    """Each serving wrapper checks its kernel's own shared-memory reckoning
    (common.decode_smem, prefill_smem, paged_prefill_smem) before the
    device: with the CTA's budget cut below what a launch needs, it raises
    on meta tensors and launches nothing. With the real budget every
    operand the wrappers take fits — neither the page nor the cache's
    length enters the reckoning, so a page of 128 or a 4096-position cache
    at d = 256 is taken."""
    from repro_torch.kernels import common
    for g in (1, 8, 32):
        for d in range(2, common.MAX_HEAD_DIM + 1, 2):
            for kv_elt in (2, 4):
                assert common.decode_smem(g, d, kv_elt) \
                    <= common.MAX_SMEM_BYTES
                for q_elt in (2, 4):
                    assert common.paged_prefill_smem(d, q_elt, kv_elt) \
                        <= common.MAX_SMEM_BYTES
    fn, reckoning = SMEM_WRAPPERS[name]
    q = torch.empty((1, 8, 256), device="meta")
    ln = torch.empty((1,), dtype=torch.int32, device="meta")
    if name.startswith("paged"):
        k = torch.empty((2, 128, 1, 256), device="meta")
        rest = (torch.empty((1, 2), dtype=torch.int32, device="meta"), ln)
    else:
        k = torch.empty((1, 1, 4096, 256), device="meta")
        rest = (ln,)
    if "prefill" in name:
        q = q[:, :, None]
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        fn(q, k, k, *rest)
    monkeypatch.setattr(common, "MAX_SMEM_BYTES", reckoning(common) - 1)
    before = fn.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fn(q, k, k, *rest)
    assert fn.launches == before


# the serving shapes of chip_smoke.py: B, H, KV, d, page, nb, C
SERVING = (4, 32, 4, 64, 16, 16, 16)


def _serving_pool(rng, need):
    """bfloat16 pools at the serving shapes (values exact in float32 and in
    TF32) with sentinel garbage, as float32 tensors, and the block table."""
    b, h, kv, d, page, nb, _ = SERVING
    k, v, bt = _pool(rng, b, kv, d, page, nb, need)
    k, v = (torch.from_numpy(x).to(torch.bfloat16).float() for x in (k, v))
    return k, v, torch.from_numpy(bt)


def _plan_cache(rng, layout, s, filled, cache_dtype):
    """K/V at the serving widths, head-major (B, KV, S, d) as float32
    tensors, and the plain version's view of them: the paged pool through
    its block table (S = nb·page, bfloat16 values), or the contiguous
    model-layout cache (B, S + 1, KV, d) in ``cache_dtype`` with garbage in
    the drop position and past ``filled[i]`` of row i."""
    b, h, kv, d, page, nb, _ = SERVING
    if layout == "paged":
        k, v, bt = _serving_pool(rng, [int(np.ceil(n / page))
                                       for n in filled])
        view = (k, v, bt)
        return tuple(tref._gather_head_major(x, bt) for x in (k, v)), view
    k = rng.standard_normal((b, s + 1, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s + 1, kv, d)).astype(np.float32)
    for i, n in enumerate(filled):
        k[i, n:], v[i, n:] = GARBAGE, -GARBAGE
    k, v = (torch.from_numpy(x).to(getattr(torch, cache_dtype)).float()
            [:, :s].transpose(1, 2) for x in (k, v))
    return (k, v), (k, v)


def _tf32_products(q_rot, k, v, valid, products):
    """softmax(q·kᵀ/√d masked) · v with the tensor-core prefill's products,
    each float32 operand split into ref.tf32_split's big + small: q·k as
    big·big (products = 1), + q_small·k_big (2: exact where the cache is
    bfloat16, whose small part is 0), + q_big·k_small (3: a float32
    cache); P·v the same with P for q and v for k. q_rot (B, KV, G, C, d);
    k, v (B, KV, S, d); valid (B, C, S)."""
    qb, qs = tref.tf32_split(q_rot)
    kb, ks = tref.tf32_split(k)
    logits = torch.einsum("bkgcd,bksd->bkgcs", qb, kb)
    if products >= 2:
        logits = logits + torch.einsum("bkgcd,bksd->bkgcs", qs, kb)
    if products == 3:
        logits = logits + torch.einsum("bkgcd,bksd->bkgcs", qb, ks)
    logits = logits / np.sqrt(q_rot.shape[-1])
    logits = torch.where(valid[:, None, None], logits,
                         torch.tensor(tref.NEG_INF))
    p = torch.softmax(logits, dim=-1)
    pb, ps = tref.tf32_split(p)
    vb, vs = tref.tf32_split(v)
    o = torch.einsum("bkgcs,bksd->bkgcd", pb, vb)
    if products >= 2:
        o = o + torch.einsum("bkgcs,bksd->bkgcd", ps, vb)
    if products == 3:
        o = o + torch.einsum("bkgcs,bksd->bkgcd", pb, vs)
    return o


def _within(got, want, tol=TOL["float32"]):
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


# (layout, cache dtype, positions S, chunk starts, the products a float32
# product takes): the paged serving case (q float32, bfloat16 pool: two),
# and the contiguous cache in float32 (three), its last row's chunk running
# past S so that its horizons are clipped there
PREFILL_PLANS = [
    ("paged", "bfloat16", 256, [0, 7, 200, 240], 2),
    ("contiguous", "float32", 256, [0, 7, 200, 248], 3),
]


@pytest.mark.parametrize("plan", PREFILL_PLANS, ids=lambda p: p[0])
def test_tensor_core_prefill_products_keep_the_float32_tolerance(plan):
    """The precision plan of the tensor-core prefill kernels (q float32),
    on the CPU at the serving shapes: with q, and a float32 cache, split
    into ref.tf32_split's big and small parts (a bfloat16 cache is exact in
    TF32), the kernel's two or three TF32 products each for q·kᵀ and P·v
    stay within 2e-5 + 2e-5·|plain| of the plain version; the big parts
    alone do not, which is why the kernel pays for the rest."""
    layout, cache_dtype, s, starts, products = plan
    b, h, kv, d, _, _, c = SERVING
    rng = np.random.default_rng(9)
    starts = torch.tensor(starts, dtype=torch.int32)
    (kg, vg), view = _plan_cache(rng, layout, s,
                                 [min(x + c, s) for x in starts.tolist()],
                                 cache_dtype)
    q = torch.from_numpy(rng.standard_normal((b, h, c, d))
                         .astype(np.float32))
    if layout == "paged":
        want = tref.paged_prefill_attention_ref(q, *view, starts, 1e4)
    else:
        want = tref.prefill_attention_ref(q, *view, starts, 1e4)
    pos = starts[:, None] + torch.arange(c)
    assert (pos.max() >= s) == (layout == "contiguous")
    q_rot = tref.rope_ref(q, pos[:, None, :], 1e4).reshape(
        b, kv, h // kv, c, d)
    valid = torch.arange(s)[None, None, :] <= pos[:, :, None]
    for n, holds in ((products, True), (1, False)):
        o = _tf32_products(q_rot, kg, vg, valid, n).reshape(want.shape)
        assert _within(o, want) is holds


# (layout, positions S, lengths): the paged serving table, and the
# contiguous cache of the whole-prompt path, 2,065 positions — 65 tiles,
# 9 a rank, the last rank 2
DECODE_PLANS = [
    ("paged", 256, [37, 256, 1, 0]),
    ("contiguous", 2065, [2065, 2048, 33, 0]),
]


@pytest.mark.parametrize("plan", DECODE_PLANS, ids=lambda p: p[0])
def test_decode_split_plan_keeps_the_float32_tolerance(plan):
    """The arithmetic plan of the decode kernels, on the CPU at the serving
    widths: each of 8 ranks takes a contiguous run of the row's
    32-position tiles, keeps (m, l, acc) over it in float32 (exact
    products of float32 q and bfloat16 K/V, on the SIMT units), and the
    output combines the 8 partials in rank order, weighted by exp(m_r - M).
    It stays within 2e-5 + 2e-5·|plain| of the plain version on the active
    rows and gives exactly 0 on a length-0 row, where every rank is
    empty."""
    layout, s, lengths = plan
    b, h, kv, d, _, _, _ = SERVING
    g, split, tile = h // kv, 8, 32
    rng = np.random.default_rng(10)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    (kg, vg), view = _plan_cache(rng, layout, s, lengths.tolist(),
                                 "bfloat16")
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    if layout == "paged":
        want = tref.paged_decode_attention_ref(q, *view, lengths, 1e4)
    else:
        want = tref.decode_attention_ref(q, *view, lengths, 1e4)
    q_rot = tref.rope_ref(q, (lengths - 1)[:, None], 1e4) / np.sqrt(d)
    got = torch.zeros_like(q)
    for i, n in enumerate(lengths.tolist()):
        ntiles = -(-n // tile)
        per = -(-ntiles // split)
        if n == 2065:
            assert [max(0, min(per, ntiles - r * per))
                    for r in range(split)] == [9] * 7 + [2]
        qi = q_rot[i].reshape(kv, g, d)
        parts = []
        for r in range(split):
            lo, hi = r * per * tile, min((r + 1) * per * tile, n)
            if lo >= hi:
                parts.append((torch.full((kv, g), tref.NEG_INF),
                              torch.zeros(kv, g), torch.zeros(kv, g, d)))
                continue
            s_ = torch.einsum("kgd,ksd->kgs", qi, kg[i, :, lo:hi])
            m = s_.max(-1).values
            p = torch.exp(s_ - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgs,ksd->kgd", p, vg[i, :, lo:hi])))
        mx = torch.stack([m for m, _, _ in parts]).max(0).values
        lsum = torch.zeros(kv, g)
        acc = torch.zeros(kv, g, d)
        for m, l_, a in parts:
            w = torch.exp(m - mx)
            lsum = lsum + l_ * w
            acc = acc + a * w[..., None]
        got[i] = (acc / lsum.clamp_min(1e-30)[..., None]).reshape(h, d)
    assert _within(got[:3], want[:3])
    assert torch.all(got[3] == 0)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


# (page, G, d, q dtype, pool dtype, C, positions in the table): every page
# of 4-32, G of 1-32, d of 16-256, q and pools in both dtypes; the serving
# shape first; 1280 positions give each of the 8 decode CTAs of a row five
# 32-position tiles (more than its ring holds) and each prefill CTA 40.
CARD_CASES = [
    (16, 8, 64, "float32", "bfloat16", 16, 256),
    (16, 8, 64, "float32", "float32", 16, 256),
    (4, 1, 16, "float32", "float32", 7, 300),
    (8, 4, 80, "bfloat16", "bfloat16", 1, 96),
    (32, 32, 128, "float32", "bfloat16", 7, 256),
    (8, 8, 256, "float32", "float32", 16, 200),
    (4, 4, 256, "bfloat16", "float32", 16, 128),
    (32, 1, 64, "bfloat16", "bfloat16", 16, 1280),
    (16, 32, 16, "bfloat16", "bfloat16", 7, 64),
    (4, 8, 128, "float32", "bfloat16", 1, 1280),
    # the Scenario vehicle (4 heads of 16 over 2 KV heads, chunk 8, bf16
    # pool) at the pages the tuner picks for it
    (64, 2, 16, "float32", "bfloat16", 8, 256),
    (128, 2, 16, "float32", "bfloat16", 8, 512),
    (256, 2, 16, "float32", "bfloat16", 8, 1024),
    # full-width tinyllama-1.1b in the Scenario (G 8, d 64, chunk 8) at
    # the page the tuner picks for it
    (256, 8, 64, "float32", "bfloat16", 8, 1024),
]


def _card_close(got, want, tol):
    """|got - want| <= tol + tol·|want| (chip_smoke.py's check)."""
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= tol + tol * want.float().abs()).all()), \
        f"max abs err {err.max().item():.3e} (tol {tol})"


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_cuda_kernels_match_plain_versions(cuda_device, case):
    """The hand-written kernels against their plain versions on the card:
    sentinel garbage; decode lengths 0, 1, page - 1, page, page + 1 and the
    full table (a length-0 row, which the kernel zeroes and the plain
    version does not, is compared with 0); prefill starts whose horizons
    cross 32-position tiles and pages; q as a strided model-layout view;
    the same call twice, bitwise equal. Tolerance 2e-5 + 2e-5·|plain|, or
    2e-2 where the output is bfloat16."""
    page, g, d, q_dtype, pool_dtype, c, positions = case
    kv, dev = 2, cuda_device
    h, nb = g * kv, positions // page
    tol = TOL[q_dtype]
    rng = np.random.default_rng(4)
    pdt, qdt = getattr(torch, pool_dtype), getattr(torch, q_dtype)

    def pools(need):
        k, v, bt = _pool(rng, len(need), kv, d, page, nb, need)
        return (torch.from_numpy(k).to(dev, pdt),
                torch.from_numpy(v).to(dev, pdt), torch.from_numpy(bt).to(dev))

    lengths = np.array([0, 1, page - 1, page, page + 1, nb * page], np.int32)
    tk, tv, tbt = pools([int(np.ceil(n / page)) for n in lengths])
    ln = torch.from_numpy(lengths).to(dev)
    # every other head of a wider tensor: row and head strides of q
    q = torch.from_numpy(rng.standard_normal((len(lengths), 2 * h, d))
                         .astype(np.float32)).to(dev, qdt)[:, ::2]
    got = paged_decode_attention(q, tk, tv, tbt, ln, rope_theta=1e4)
    again = paged_decode_attention(q, tk, tv, tbt, ln, rope_theta=1e4)
    want = tref.paged_decode_attention_ref(q, tk, tv, tbt, ln, 1e4)
    torch.cuda.synchronize()
    _card_close(got[1:], want[1:], tol)
    assert torch.all(got[0] == 0)
    assert torch.equal(got, again)

    starts = np.minimum([0, 30 - c // 2, 63, nb * page - c],
                        nb * page - c).astype(np.int32)
    tk, tv, tbt = pools([int(np.ceil((s + c) / page)) for s in starts])
    start = torch.from_numpy(starts).to(dev)
    qc = torch.from_numpy(rng.standard_normal((len(starts), c, h, d))
                          .astype(np.float32)).to(dev, qdt).transpose(1, 2)
    got = paged_prefill_attention(qc, tk, tv, tbt, start, rope_theta=1e4)
    again = paged_prefill_attention(qc, tk, tv, tbt, start, rope_theta=1e4)
    want = tref.paged_prefill_attention_ref(qc, tk, tv, tbt, start, 1e4)
    torch.cuda.synchronize()
    _card_close(got, want, tol)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_shared_memory_reckoning_matches_the_kernels(cuda_device):
    """common's reckoning of the serving kernels' shared memory is the one
    the launches use (the C entries beside each kernel), paged and
    contiguous."""
    from repro_torch.kernels import build, common
    dec = {n: getattr(build.load(n), f"{n}_smem")
           for n in ("paged_decode_attention", "decode_attention")}
    pre = {n: getattr(build.load(n), f"{n}_smem")
           for n in ("paged_prefill_attention", "prefill_attention")}
    for fn in (*dec.values(), *pre.values()):
        fn.argtypes = [build.ctypes.c_int] * 3
        fn.restype = build.ctypes.c_longlong
    for d in (16, 64, 80, 128, 160, 256):
        for kv_elt in (2, 4):
            for g in (1, 8, 32):
                for fn in dec.values():
                    assert fn(g, d, int(kv_elt == 2)) == \
                        common.decode_smem(g, d, kv_elt)
            for q_elt in (2, 4):
                args = (d, int(q_elt == 2), int(kv_elt == 2))
                assert pre["paged_prefill_attention"](*args) == \
                    common.paged_prefill_smem(d, q_elt, kv_elt)
                assert pre["prefill_attention"](*args) == \
                    common.prefill_smem(d, q_elt, kv_elt)


def test_build_names_libraries_by_sources_and_flags(monkeypatch, tmp_path):
    """A library is named by a hash of its sources and nvcc flags, so an
    edited kernel is never served from a stale build; without nvcc the
    build raises instead of falling back."""
    from repro_torch.kernels import build
    assert build.sources() == ["decode_attention", "flash_attention",
                               "flash_attention_bwd",
                               "paged_decode_attention",
                               "paged_prefill_attention",
                               "prefill_attention", "rmsnorm",
                               "skinny_gemm", "ssd_chunk_scan"]
    # every header is hashed into every library's name
    assert sorted(p.name for p in build.CSRC.glob("*.cuh")) == [
        "attention.cuh", "flash_mma.cuh", "paged_attention.cuh"]
    a = build.library_path("paged_decode_attention")
    assert a == build.library_path("paged_decode_attention")
    assert a != build.library_path("paged_prefill_attention")
    assert a.parent == build.BUILD_DIR
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("paged_decode_attention") != a
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
