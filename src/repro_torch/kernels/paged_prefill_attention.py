"""Paged prefill-chunk attention: a C-token chunk against the paged pool.

Wrapper of the hand-written Hopper kernel
``csrc/paged_prefill_attention.cu`` (the port of
``repro.kernels.paged_prefill_attention``): one launch, 64 query rows of a
(row, KV head) a CTA, both products on the tensor cores. On a CUDA tensor
it launches the kernel or raises; on a CPU tensor it computes the plain
version, :func:`repro_torch.kernels.ref.paged_prefill_attention_ref`.

Layout: q (B, H, C, d) head-major (any strides, unit stride along d);
k/v pools (P, page, KV, d) — the MODEL layout, read in place; block_tables
(B, nb) int32; start_len (B,) int32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import common, ref

_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            start_len: torch.Tensor, *,
                            rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, H, C, d); k/v pools: (P, page, KV, d) read in place, the
    chunk's keys/values already scattered into the rows' pages;
    block_tables: (B, nb) int32 page ids; start_len: (B,) int32 ->
    (B, H, C, d) in q's dtype, contiguous.

    ``rope_theta``: fuse rotary embedding of chunk query j at absolute
    position ``start_len + j``; query j attends positions up to the same.
    """
    if q.device.type == "cpu":
        return ref.paged_prefill_attention_ref(q, k_pages, v_pages,
                                               block_tables, start_len,
                                               rope_theta=rope_theta)
    name = "paged_prefill_attention"
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, C, d), got "
                         f"{tuple(q.shape)}")
    b, h, c, d = q.shape
    common.check_paged_operands(
        name, q, k_pages, v_pages, block_tables, start_len, heads=h, batch=b,
        smem=lambda g, dk: common.paged_prefill_smem(
            dk, q.element_size(), k_pages.element_size()))
    _, page, kv, _ = k_pages.shape
    out = torch.empty((b, h, c, d), dtype=q.dtype, device=q.device)
    inv = (common.rope_table(d, float(rope_theta), q.device)
           if rope_theta is not None else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common.launch(name, name, _ARGTYPES, [
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            start_len.data_ptr(), None if inv is None else inv.data_ptr(),
            out.data_ptr(),
            b, h, kv, c, d, page, block_tables.shape[1],
            int(q.dtype == torch.bfloat16),
            int(k_pages.dtype == torch.bfloat16),
            1.0 / math.sqrt(d), stream])
        paged_prefill_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
paged_prefill_attention.launches = 0
