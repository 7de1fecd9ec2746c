"""Argument checks and launch helpers shared by the kernel wrappers."""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import rope_freqs

Q_DTYPES = (torch.float32, torch.bfloat16)
CACHE_DTYPES = (torch.bfloat16, torch.float32)
#: the widest head the kernels are instantiated for (csrc/flash_mma.cuh
#: ``dispatch_dp``)
MAX_HEAD_DIM = 256
#: dynamic shared memory a Hopper CTA may use
MAX_SMEM_BYTES = 232_448
#: head widths the tensor-core kernels are instantiated for: d is padded to
#: the least that holds it (csrc/flash_mma.cuh ``dispatch_dp``)
PADDED_HEAD_DIMS = (32, 64, 96, 128, 160, 256)


def _check_heads(name: str, q: torch.Tensor, *, heads: int, kv: int,
                 d: int) -> None:
    """Head dim (even, at most MAX_HEAD_DIM, q's equal to the cache's) and
    GQA grouping (H % KV == 0, H / KV <= 32)."""
    if q.shape[-1] != d or d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]} vs cache {d}; it "
                         f"must be even and at most {MAX_HEAD_DIM}")
    if heads % kv or heads // kv > 32:
        raise ValueError(f"{name}: {heads} query heads over {kv} KV heads "
                         "(need H % KV == 0 and H / KV <= 32)")


def _check_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, lens: torch.Tensor, *, heads: int,
                     kv: int, d: int) -> None:
    """What both cache layouts share: device, dtypes, head counts, head
    dim, q's unit stride along d."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must lie on the CPU or a CUDA device, "
                         f"got {q.device}")
    for t in (k, v, lens):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and {q.device}")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in CACHE_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"{name}: caches must both be bfloat16 or float32, "
                        f"got {k.dtype}/{v.dtype}")
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        raise TypeError(f"{name}: lengths must be contiguous int32")
    _check_heads(name, q, heads=heads, kv=kv, d=d)
    if q.stride(-1) != 1:
        raise ValueError(f"{name}: q needs unit stride along the head dim")


def _check_smem(name: str, q: torch.Tensor, *, heads: int, kv: int, d: int,
                smem: Callable[[int, int], int]) -> None:
    """Head dim and grouping, then ``smem(G, d)`` — the kernel's own
    reckoning of a CTA's shared memory, in bytes — against the CTA's
    budget."""
    _check_heads(name, q, heads=heads, kv=kv, d=d)
    need = smem(heads // kv, d)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: {heads // kv} heads a group at head dim "
                         f"{d} need {need} bytes of shared memory; a CTA "
                         f"has {MAX_SMEM_BYTES}")


def check_paged_operands(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         lens: torch.Tensor, *, heads: int, batch: int,
                         smem: Callable[[int, int], int]) -> None:
    """Raise on anything the paged kernels do not take: shape, shared
    memory (``smem(G, d)``, the kernel's own reckoning in bytes, against
    the CTA's budget; checked before the device), device, dtype,
    contiguity. ``heads``/``batch`` are q's H and B."""
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: pools must be (P, page, KV, d) of one "
                         f"shape, got {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    _, page, kv, d = k_pages.shape
    _check_smem(name, q, heads=heads, kv=kv, d=d, smem=smem)
    _check_attention(name, q, k_pages, v_pages, lens, heads=heads, kv=kv,
                     d=d)
    if block_tables.device != q.device or block_tables.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables must be int32 on {q.device}")
    if (block_tables.dim() != 2 or block_tables.shape[0] != batch
            or lens.shape != (batch,)):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} "
                         f"/ lengths {tuple(lens.shape)} vs batch {batch}")
    if not all(t.is_contiguous() for t in (k_pages, v_pages, block_tables)):
        raise ValueError(f"{name}: pools and block_tables must be "
                         "contiguous")
    if page < 1:
        raise ValueError(f"{name}: empty pages")


def check_cache_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, lens: torch.Tensor, *, heads: int,
                         batch: int, smem: Callable[[int, int], int]) -> None:
    """Raise on anything the contiguous-cache kernels do not take: shape,
    shared memory (``smem(G, d)``, as for the paged kernels; checked before
    the device), device, dtype, strides. k/v are (B, KV, S, d) views with
    any strides but one per axis shared by both and unit stride along d —
    the model's (B, S, KV, d) cache seen head-major, read in place."""
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != batch:
        raise ValueError(f"{name}: caches must be (B, KV, S, d) of one "
                         f"shape with B = {batch}, got {tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    _, kv, s, d = k.shape
    _check_smem(name, q, heads=heads, kv=kv, d=d, smem=smem)
    _check_attention(name, q, k, v, lens, heads=heads, kv=kv, d=d)
    if lens.shape != (batch,):
        raise ValueError(f"{name}: lengths {tuple(lens.shape)} vs batch "
                         f"{batch}")
    if k.stride() != v.stride() or k.stride(-1) != 1:
        raise ValueError(f"{name}: k and v need the same strides and unit "
                         f"stride along d, got {k.stride()}/{v.stride()}")
    if s < 1:
        raise ValueError(f"{name}: empty cache")


def check_flash_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    """Raise on anything the flash-attention kernels do not take. q:
    (B, H, Sq, d), k/v: (B, KV, Skv, d), each with any strides but unit
    stride along d (head-major views of the model's (B, S, heads, d)
    tensors); k and v share one dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q must be (B, H, Sq, d) and k/v one "
                         f"(B, KV, Skv, d) shape, got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k/v "
                         f"{tuple(k.shape)}: batch and head dim must agree")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must lie on the CPU or a CUDA device, "
                         f"got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: operands on {k.device}/{v.device} and "
                         f"{q.device}")
    if q.dtype not in Q_DTYPES or k.dtype not in Q_DTYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"{name}: q and k/v must be float32 or bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    kv = k.shape[1]
    if d % 2 or d > MAX_HEAD_DIM or kv < 1 or h % kv:
        raise ValueError(f"{name}: head dim {d} (even, at most "
                         f"{MAX_HEAD_DIM}) and {h} query heads over {kv} "
                         "KV heads (H % KV == 0)")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError(f"{name}: empty sequence ({sq} queries, "
                         f"{k.shape[2]} keys)")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride() != k.stride():
        raise ValueError(f"{name}: unit stride along d, and one stride "
                         f"pattern for k and v, got {q.stride()}/"
                         f"{k.stride()}/{v.stride()}")


def padded_head_dim(d: int) -> int:
    """The head width a tensor-core kernel is instantiated for."""
    return next(dp for dp in PADDED_HEAD_DIMS if d <= dp)


def _tile_bytes(rows: int, dp: int, elt: int) -> int:
    """A staged tile of ``rows`` rows of dp elements, each row padded by 16
    bytes (csrc/flash_mma.cuh ``pitch``)."""
    return rows * (dp * elt + 16)


def decode_smem(groups: int, d: int, kv_elt: int) -> int:
    """Dynamic shared memory of one decode CTA, paged or contiguous
    (csrc/paged_attention.cuh ``DecodeTiles::smem``): a ring of 4 stages of
    a 32-position K and V tile (2 where 4 would not leave room for 32
    heads), then the rotated query of each of the ``groups`` heads in
    float32. Independent of the page and of the cache's length."""
    dp = padded_head_dim(d)
    stage = 2 * _tile_bytes(32, dp, kv_elt)
    stages = 4 if 4 * stage + 32 * dp * 4 <= MAX_SMEM_BYTES else 2
    return stages * stage + groups * dp * 4


#: the paged prefill's block table staged in static shared memory
#: (csrc/paged_attention.cuh ``kTableCache`` int32 entries)
TABLE_CACHE_BYTES = 1024 * 4


def prefill_smem(d: int, q_elt: int, kv_elt: int) -> int:
    """Dynamic shared memory of one prefill CTA, paged or contiguous
    (csrc/paged_attention.cuh ``PrefillTiles::kSmem``): 64 rotated query
    rows in q's dtype, 128 RoPE frequencies and 1024 (sin, cos) pairs, then
    a ring of 4 stages of a 32-position K and V tile (3 or 2 where 4 do not
    fit beside the rest and the block table). Independent of G, the page
    and the cache's length."""
    dp = padded_head_dim(d)
    fixed = _tile_bytes(64, dp, q_elt) + 128 * 4 + 1024 * 8
    stage = 2 * _tile_bytes(32, dp, kv_elt)
    stages = next((n for n in (4, 3) if fixed + TABLE_CACHE_BYTES
                   + n * stage <= MAX_SMEM_BYTES), 2)
    return fixed + stages * stage


def paged_prefill_smem(d: int, q_elt: int, kv_elt: int) -> int:
    """Shared memory of one paged-prefill CTA: :func:`prefill_smem` and
    the block table staged beside it."""
    return prefill_smem(d, q_elt, kv_elt) + TABLE_CACHE_BYTES


#: the SSD kernel's tile of positions, warps a CTA (and C rows staged: a
#: tile a warp), heads a CTA, the longest chunk staged whole (in tiles),
#: the ring a longer chunk streams through, the most parts a short chunk's
#: C·Bᵀ depth is split into, and the warps that form it
#: (csrc/ssd_chunk_scan.cu)
SSD_TILE, SSD_WARPS, SSD_HEADS, SSD_RESIDENT_TILES, SSD_RING = \
    16, 8, 2, 4, 4
SSD_MAX_SPLIT, SSD_CB_WARPS = 4, 4


def ssd_cb_split(nt: int) -> int:
    """Parts the depth of a staged chunk's C·Bᵀ tiles is split into, so
    that its (tile pair, column half, part) units keep the 4 warps that
    form it busy (csrc/ssd_chunk_scan.cu ``cb_split``)."""
    kc = 1
    while kc < SSD_MAX_SPLIT and nt * (nt + 1) * kc * 2 <= SSD_CB_WARPS:
        kc *= 2
    return kc


def ssd_smem(q: int, ps: int, n: int) -> int:
    """Dynamic shared memory of one SSD CTA (csrc/ssd_chunk_scan.cu
    ``Layout``), in bytes: C rows for up to 8 tiles of 16 positions, then
    the staged tiles — all of them for Q <= 64, else a ring of 4 (2 where 4
    would not fit) — each B, x of the two heads' ``ps``-column slice,
    cum and dt; a staged chunk adds its C·Bᵀ fragments (a tile pair at or
    below the diagonal, two column halves, its depth parts, 128 floats
    each). Rows of B and C are N padded to 8 plus 4 floats, rows of x
    ``ps`` plus 4."""
    nt = -(-q // SSD_TILE)
    ldn = -(-n // 8) * 8 + 4
    ldp = ps + 4
    crows = SSD_TILE * min(nt, SSD_WARPS)
    stage = SSD_TILE * ldn + SSD_HEADS * SSD_TILE * (ldp + 2)
    if nt <= SSD_RESIDENT_TILES:
        stages, cb = nt, nt * (nt + 1) * ssd_cb_split(nt) * 128
    elif 4 * (crows * ldn + SSD_RING * stage) <= MAX_SMEM_BYTES:
        stages, cb = SSD_RING, 0
    else:
        stages, cb = 2, 0
    return 4 * (crows * ldn + stages * stage + cb)


@functools.lru_cache(maxsize=16)
def rope_table(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """The d/2 RoPE inverse frequencies the kernels rotate with — the same
    float32 values the plain versions compute (``layers.rope_freqs``)."""
    return rope_freqs(d, theta, device).contiguous()


def launch(lib_name: str, entry: str, argtypes: list, args: list) -> None:
    """Call a C entry of ``csrc/<lib_name>.cu`` and raise on its CUDA
    error code."""
    lib = build.load(lib_name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:              # ctypes caches fn on the library
        fn.argtypes = argtypes
        fn.restype = build.ctypes.c_int
    build.check(lib, fn(*args), f"{lib_name}.{entry}")
