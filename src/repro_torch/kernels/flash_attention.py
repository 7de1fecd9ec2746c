"""Full-sequence flash attention, forward and backward.

Wrappers of the hand-written Hopper kernels ``csrc/flash_attention.cu``
(the port of ``repro.kernels.flash_attention``) and
``csrc/flash_attention_bwd.cu`` (its gradient, which the JAX package does
not have: it trains on its jnp lowering), and :class:`FlashAttention`, the
``torch.autograd.Function`` that joins them. On a CUDA tensor each wrapper
launches its kernel or raises; on a CPU tensor it computes the plain
version in :mod:`repro_torch.kernels.ref`.

Layout: q (B, H, Sq, d); k/v (B, KV, Skv, d) — head-major views of the
model's (B, S, heads, d) tensors, read in place (any strides, unit along
d). Causal: key position <= query position, both counted from 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import common, ref

_FWD_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
                 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                 + [ctypes.c_void_p] * 2
                 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
                 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                 + [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q: (B, H, Sq, d); k/v: (B, KV, Skv, d) -> o (B, H, Sq, d) in q's
    dtype, contiguous; with ``return_lse`` also the (B, H, Sq) float32
    log-sum-exp of each row's scaled logits (what the backward needs)."""
    if q.device.type == "cpu":
        o = ref.flash_attention_ref(q, k, v, causal=causal)
        if return_lse:
            return o, ref.flash_attention_lse_ref(q, k, causal=causal)
        return o
    name = "flash_attention"
    common.check_flash_operands(name, q, k, v)
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common.launch(name, name, _FWD_ARGTYPES, [
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, h, kv, sq, skv, d, int(causal),
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            1.0 / math.sqrt(d), stream])
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_attention` from its output ``o`` and
    ``lse`` and the output's gradient ``do`` (B, H, Sq, d, any strides):
    -> (dq (B, H, Sq, d) in q's dtype, dk and dv (B, KV, Skv, d) in k's
    dtype), contiguous. Deterministic: no atomics."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    name = "flash_attention_bwd"
    common.check_flash_operands(name, q, k, v)
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    if (o.shape != q.shape or o.dtype != q.dtype or not o.is_contiguous()
            or lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"{name}: o and lse must be the forward's "
                         f"contiguous outputs, got {tuple(o.shape)} "
                         f"{o.dtype} / {tuple(lse.shape)} {lse.dtype}")
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"{name}: dO {tuple(do.shape)} on {do.device} vs "
                         f"q {tuple(q.shape)} on {q.device}")
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, kv, skv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common.launch(name, name, _BWD_ARGTYPES, [
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), do.stride(0), do.stride(1), do.stride(2),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, kv, sq, skv, d, int(causal),
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
            1.0 / math.sqrt(d), stream])
        flash_attention_bwd.launches += 1
    return dq, dk, dv


#: kernel launches (one call runs its three entries) since the count was
#: last set to 0
flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, saving
    (q, k, v, o, lse); the backward kernel on PyTorch's current stream.
    ``FlashAttention.apply(q, k, v, causal)`` with the layouts of
    :func:`flash_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal)
        return dq, dk, dv, None
