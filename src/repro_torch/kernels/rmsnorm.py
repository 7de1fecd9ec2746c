"""Fused RMSNorm over rows.

Wrapper of the hand-written Hopper kernel ``csrc/rmsnorm.cu`` (the port of
``repro.kernels.rmsnorm``). On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it computes the plain version,
:func:`repro_torch.kernels.ref.rmsnorm_ref`. Any number of rows: the TPU
kernel's ``R % row_block == 0`` assert is gone (the kernel masks the tail).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common, ref

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D) float32 or bfloat16, contiguous; w: (D,) float32 ->
    (R, D) in x's dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    name = "rmsnorm"
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name}: x must lie on the CPU or a CUDA device, "
                         f"and w beside it; got {x.device}/{w.device}")
    if x.dtype not in common.Q_DTYPES or w.dtype != torch.float32:
        raise TypeError(f"{name}: x float32 or bfloat16 and w float32, got "
                        f"{x.dtype}/{w.dtype}")
    if x.dim() != 2 or w.shape != (x.shape[1],) or x.shape[1] < 1:
        raise ValueError(f"{name}: x (R, D) and w (D,), got "
                         f"{tuple(x.shape)}/{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    r, d = x.shape
    out = torch.empty_like(x)
    if r == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        common.launch(name, name, _ARGTYPES, [
            x.data_ptr(), w.data_ptr(), out.data_ptr(), r, d, float(eps),
            int(x.dtype == torch.bfloat16), stream])
        rmsnorm.launches += 1
    return out


#: kernel launches since the count was last set to 0
rmsnorm.launches = 0
