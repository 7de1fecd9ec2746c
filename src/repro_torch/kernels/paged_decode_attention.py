"""Paged flash-decode: one query token against the paged KV pool.

Wrapper of the hand-written Hopper kernel ``csrc/paged_decode_attention.cu``
(the port of ``repro.kernels.paged_decode_attention``): one launch, a
cluster of 8 CTAs per (row, KV head) that split the row's positions and
combine their partial softmaxes on chip. On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it computes the plain version,
:func:`repro_torch.kernels.ref.paged_decode_attention_ref`.

Layout: q (B, H, d); k/v pools (P, page, KV, d) — the MODEL layout, read in
place; block_tables (B, nb) int32; lengths (B,) int32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import common, ref

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
             + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, H, d); k/v pools: (P, page, KV, d) read in place;
    block_tables: (B, nb) int32 page ids; lengths: (B,) int32 -> (B, H, d)
    in q's dtype.

    ``rope_theta``: fuse rotary embedding of q at position ``lengths - 1``.
    A row with ``lengths == 0`` gives 0 on the card (the plain version
    gives the mean of V); such rows are inactive and their output unused.
    """
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, lengths,
                                              rope_theta=rope_theta)
    name = "paged_decode_attention"
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (B, H, d), got {tuple(q.shape)}")
    b, h, d = q.shape
    common.check_paged_operands(
        name, q, k_pages, v_pages, block_tables, lengths, heads=h, batch=b,
        smem=lambda g, dk: common.decode_smem(g, dk, k_pages.element_size()))
    _, page, kv, _ = k_pages.shape
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    inv = (common.rope_table(d, float(rope_theta), q.device)
           if rope_theta is not None else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common.launch(name, name, _ARGTYPES, [
            q.data_ptr(), q.stride(0), q.stride(1),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), None if inv is None else inv.data_ptr(),
            out.data_ptr(),
            b, h, kv, d, page, block_tables.shape[1],
            int(q.dtype == torch.bfloat16),
            int(k_pages.dtype == torch.bfloat16),
            1.0 / math.sqrt(d), stream])
        paged_decode_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
paged_decode_attention.launches = 0
