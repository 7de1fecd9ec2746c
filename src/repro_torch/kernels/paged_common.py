"""Argument checks and launch helpers shared by the paged kernel wrappers."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import rope_freqs

Q_DTYPES = (torch.float32, torch.bfloat16)
POOL_DTYPES = (torch.bfloat16, torch.float32)
#: per-lane accumulator registers in csrc/paged_attention.cuh
MAX_HEAD_DIM = 256
#: dynamic shared memory a Hopper CTA may use
MAX_SMEM_BYTES = 232_448


def check_operands(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, block_tables: torch.Tensor,
                   lens: torch.Tensor, *, heads: int, batch: int) -> None:
    """Raise on anything the kernel does not take: device, dtype, shape,
    contiguity. ``heads``/``batch`` are q's H and B."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must lie on the CPU or a CUDA device, "
                         f"got {q.device}")
    for t in (k_pages, v_pages, block_tables, lens):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and {q.device}")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype not in POOL_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{name}: pools must both be bfloat16 or float32, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and lengths must be int32")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: pools must be (P, page, KV, d) of one "
                         f"shape, got {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    _, page, kv, d = k_pages.shape
    if q.shape[-1] != d or d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]} vs pool {d}; it "
                         f"must be even and at most {MAX_HEAD_DIM}")
    if heads % kv or heads // kv > 32:
        raise ValueError(f"{name}: {heads} query heads over {kv} KV heads "
                         "(need H % KV == 0 and H / KV <= 32)")
    if (block_tables.dim() != 2 or block_tables.shape[0] != batch
            or lens.shape != (batch,)):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} "
                         f"/ lengths {tuple(lens.shape)} vs batch {batch}")
    if not all(t.is_contiguous() for t in (k_pages, v_pages, block_tables,
                                           lens)):
        raise ValueError(f"{name}: pools, block_tables and lengths must be "
                         "contiguous")
    if q.stride(-1) != 1:
        raise ValueError(f"{name}: q needs unit stride along the head dim")
    if page < 1:
        raise ValueError(f"{name}: empty pages")


def check_smem(name: str, nwarps: int, page: int, d: int) -> None:
    """The CTA stages one K and one V page plus a row per warp in shared
    memory (csrc/paged_attention.cuh ``smem_floats``)."""
    need = 4 * (2 * page * (d + 1) + nwarps * (d + page))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: page {page} x head dim {d} needs {need} "
                         f"bytes of shared memory; a CTA has "
                         f"{MAX_SMEM_BYTES}")


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
