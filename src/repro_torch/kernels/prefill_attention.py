"""Prefill-chunk attention against the contiguous KV cache.

Wrapper of the hand-written Hopper kernel ``csrc/prefill_attention.cu``
(the port of ``repro.kernels.prefill_attention``): one launch, 64 query
rows of a (row, KV head) a CTA, both products on the tensor cores
(``csrc/paged_attention.cuh``, the paged prefill's body over a strided
addressing). On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it computes the plain version,
:func:`repro_torch.kernels.ref.prefill_attention_ref`.

Layout: q (B, H, C, d) head-major (any strides, unit along d); k/v
(B, KV, S, d) head-major views of the model's (B, S, KV, d) cache, read in
place (any strides, unit along d); start_len (B,) int32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import common, ref

_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      start_len: torch.Tensor, *,
                      rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, H, C, d); k/v: (B, KV, S, d) views, the chunk's keys/values
    already written at ``start_len .. start_len + C - 1``; start_len: (B,)
    int32 -> (B, H, C, d) in q's dtype, contiguous.

    ``rope_theta``: fuse rotary embedding of chunk query j at absolute
    position ``start_len + j``; query j attends positions up to the same.
    """
    if q.device.type == "cpu":
        return ref.prefill_attention_ref(q, k, v, start_len,
                                         rope_theta=rope_theta)
    name = "prefill_attention"
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, C, d), got "
                         f"{tuple(q.shape)}")
    b, h, c, d = q.shape
    common.check_cache_operands(
        name, q, k, v, start_len, heads=h, batch=b,
        smem=lambda g, dk: common.prefill_smem(dk, q.element_size(),
                                               k.element_size()))
    kv, s = k.shape[1], k.shape[2]
    out = torch.empty((b, h, c, d), dtype=q.dtype, device=q.device)
    inv = (common.rope_table(d, float(rope_theta), q.device)
           if rope_theta is not None else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common.launch(name, name, _ARGTYPES, [
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            start_len.data_ptr(), None if inv is None else inv.data_ptr(),
            out.data_ptr(),
            b, h, kv, c, s, d,
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            1.0 / math.sqrt(d), stream])
        prefill_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
prefill_attention.launches = 0
