"""The port's paged attention kernels: plain versions vs the JAX package.

Each plain PyTorch version (``repro_torch.kernels.ref``, which the kernel
wrappers compute on a CPU tensor) is held against the JAX Pallas kernel in
interpret mode and against ``repro.kernels.ref`` on the same seeded numpy
inputs: GQA / MQA / MHA, RoPE on and off, garbage in the sentinel page
and past every row's length, prefill horizons crossing page boundaries.
Tolerances: 2e-5 in float32, 2e-2 with bfloat16 pools
(tests/test_kernels.py). The CUDA kernels themselves are held against the
same plain versions on the card (the ``gpu`` test below, and
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
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import \
    paged_prefill_attention  # noqa: E402
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


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(cuda_device, pool_dtype):
    """The hand-written kernels against their plain versions on the card
    (q float32; sentinel garbage; a length-0 row, which the kernel zeroes
    and the plain version does not — compared on active rows only)."""
    b, h, kv, d, page, nb, c = 4, 32, 4, 64, 16, 16, 16
    rng = np.random.default_rng(4)
    lengths = np.array([37, 256, 1, 0], np.int32)
    need = [int(np.ceil(n / page)) for n in lengths]
    k, v, bt = _pool(rng, b, kv, d, page, nb, need)
    dev = cuda_device
    tk = torch.from_numpy(k).to(dev, getattr(torch, pool_dtype))
    tv = torch.from_numpy(v).to(dev, getattr(torch, pool_dtype))
    tbt = torch.from_numpy(bt).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    ln = torch.from_numpy(lengths).to(dev)
    got = paged_decode_attention(q.to(dev), tk, tv, tbt, ln, rope_theta=1e4)
    want = tref.paged_decode_attention_ref(q.to(dev), tk, tv, tbt, ln, 1e4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:3], want[:3], atol=2e-5, rtol=2e-5)
    assert torch.all(got[3] == 0)

    starts = np.array([0, 7, 200, 240], np.int32)
    k, v, bt = _pool(rng, b, kv, d, page, nb,
                     [int(np.ceil((s + c) / page)) for s in starts])
    tk = torch.from_numpy(k).to(dev, getattr(torch, pool_dtype))
    tv = torch.from_numpy(v).to(dev, getattr(torch, pool_dtype))
    tbt = torch.from_numpy(bt).to(dev)
    start = torch.from_numpy(starts).to(dev)
    qc = torch.randn((b, h, c, d), device=dev)
    got = paged_prefill_attention(qc, tk, tv, tbt, start, rope_theta=1e4)
    want = tref.paged_prefill_attention_ref(qc, tk, tv, tbt, start, 1e4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


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
                               "ssd_chunk_scan"]
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
