"""Fused RMSNorm over rows.

Wrapper of the hand-written Hopper kernel ``csrc/rmsnorm.cu`` (the port of
``repro.kernels.rmsnorm``). On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it computes the plain version,
:func:`repro_torch.kernels.ref.rmsnorm_ref`. Any number of rows: the TPU
kernel's ``R % row_block == 0`` assert is gone (the kernel masks the tail).

Any D >= 1. Rows of up to MAX_REGISTER_D elements are read once and kept
in registers (a warp a 2048-element part of the row); longer rows take
the kernel's streaming variant, which reads x twice. :func:`plan`, the
one place where the launch is decided, chooses the variant, the copy
width and the cache policy; the kernel's C entry takes them as given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common, ref

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])

#: elements a warp keeps in registers (csrc/rmsnorm.cu ``kWarpElems``)
WARP_ELEMS = 2048
#: the longest row of the one-read register variant: 8 warps a row
MAX_REGISTER_D = 8 * WARP_ELEMS


def plan(x_ptr: int, out_ptr: int, rows: int, d: int, elt: int,
         l2_bytes: int) -> tuple[int, int, bool]:
    """(copy bytes, warps a row, evict) for ``rows`` rows of ``d``
    elements of ``elt`` bytes at addresses ``x_ptr`` and ``out_ptr``: the
    widest of 16, 8, 4 and 2 bytes (not below one element) that both base
    addresses and a row's d * elt bytes are multiples of, so that every
    row's copies are aligned; warps a row 0 selects the streaming variant;
    evict selects evict-first loads and stores where x and the output
    together outgrow the card's ``l2_bytes`` of L2, so that the call's
    lines, which it touches once, go first."""
    bits = x_ptr | out_ptr | d * elt
    vb = next(cb for cb in (16, 8, 4, elt) if bits % cb == 0)
    warps = 0 if d > MAX_REGISTER_D else -(-d // WARP_ELEMS)
    return vb, warps, 2 * rows * d * elt > l2_bytes


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
    vb, warps, evict = plan(
        x.data_ptr(), out.data_ptr(), r, d, x.element_size(),
        torch.cuda.get_device_properties(x.device).L2_cache_size)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        common.launch(name, name, _ARGTYPES, [
            x.data_ptr(), w.data_ptr(), out.data_ptr(), r, d, float(eps),
            int(x.dtype == torch.bfloat16), vb, warps, int(evict), stream])
        rmsnorm.launches += 1
    return out


#: kernel launches since the count was last set to 0
rmsnorm.launches = 0
