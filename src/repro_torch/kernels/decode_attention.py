"""Flash-decode against the contiguous KV cache: one query token per row.

Wrapper of the hand-written Hopper kernel ``csrc/decode_attention.cu`` (the
port of ``repro.kernels.decode_attention``): one launch, a cluster of 8
CTAs per (row, KV head) that split the row's positions and combine their
partial softmaxes on chip (``csrc/paged_attention.cuh``, the paged
decode's body over a strided addressing). On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it computes the plain version,
:func:`repro_torch.kernels.ref.decode_attention_ref`.

Layout: q (B, H, d); k/v (B, KV, S, d) head-major as in the JAX kernel,
with any strides (unit along d): the model's (B, S, KV, d) cache is passed
as a transposed view and read in place, never copied or padded.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import common, ref

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
             + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, H, d); k/v: (B, KV, S, d) views; lengths: (B,) int32 ->
    (B, H, d) in q's dtype.

    ``rope_theta``: fuse rotary embedding of q at position ``lengths - 1``.
    Row b attends positions ``< lengths[b]``. A row with ``lengths == 0``
    gives 0 on the card (the plain version gives the mean of V); such rows
    are inactive and their output unused.
    """
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths,
                                        rope_theta=rope_theta)
    name = "decode_attention"
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (B, H, d), got {tuple(q.shape)}")
    b, h, d = q.shape
    common.check_cache_operands(
        name, q, k, v, lengths, heads=h, batch=b,
        smem=lambda g, dk: common.decode_smem(g, dk, k.element_size()))
    kv, s = k.shape[1], k.shape[2]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    inv = (common.rope_table(d, float(rope_theta), q.device)
           if rope_theta is not None else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common.launch(name, name, _ARGTYPES, [
            q.data_ptr(), q.stride(0), q.stride(1),
            k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            lengths.data_ptr(), None if inv is None else inv.data_ptr(),
            out.data_ptr(),
            b, h, kv, s, d,
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            1.0 / math.sqrt(d), stream])
        decode_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
decode_attention.launches = 0
