"""Mamba2 SSD intra-chunk scan: the chunk's quadratic output and its state.

Wrapper of the hand-written Hopper kernel ``csrc/ssd_chunk_scan.cu`` (the
port of ``repro.kernels.ssd_scan.ssd_chunk_scan``). On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it computes the plain
version, :func:`repro_torch.kernels.ref.ssd_chunk_ref`.

Layouts, float32 and contiguous: x (M, Q, H, P); dt/cum (M, Q, H); b_/c_
(M, Q, N) with ngroups = 1, M = batch * chunks. Outputs: y (M, Q, H, P)
and state (M, H, P, N).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common, ref

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

#: limits of csrc/ssd_chunk_scan.cu: accumulators a thread keeps
MAX_P, MAX_N, MAX_PN = 128, 256, 8192


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                   b_: torch.Tensor, c_: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (M, Q, H, P); dt/cum: (M, Q, H); b_/c_: (M, Q, N) ->
    (y (M, Q, H, P), state (M, H, P, N)), float32.

    ``cum`` is the within-chunk cumulative sum of ``dt * A``. Any chunk
    length Q >= 1 is taken."""
    if x.device.type == "cpu":
        return ref.ssd_chunk_ref(x, dt, cum, b_, c_)
    name = "ssd_chunk_scan"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must lie on the CPU or a CUDA device, "
                         f"got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (M, Q, H, P), got "
                         f"{tuple(x.shape)}")
    m, q, h, p = x.shape
    n = b_.shape[-1]
    shapes = {"dt": (dt, (m, q, h)), "cum": (cum, (m, q, h)),
              "b_": (b_, (m, q, n)), "c_": (c_, (m, q, n))}
    for arg, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {arg} must be {want}, got "
                             f"{tuple(t.shape)}")
    for t in (x, dt, cum, b_, c_):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name}: every operand must be float32 on "
                            f"{x.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if q < 1 or p > MAX_P or n > MAX_N or p * n > MAX_PN:
        raise ValueError(f"{name}: Q={q}, P={p}, N={n}; the kernel takes "
                         f"Q >= 1, P <= {MAX_P}, N <= {MAX_N} and "
                         f"P*N <= {MAX_PN}")
    y = torch.empty_like(x)
    state = torch.empty((m, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        common.launch(name, name, _ARGTYPES, [
            x.data_ptr(), dt.data_ptr(), cum.data_ptr(), b_.data_ptr(),
            c_.data_ptr(), y.data_ptr(), state.data_ptr(),
            m, q, h, p, n, stream])
        ssd_chunk_scan.launches += 1
    return y, state


#: kernel launches since the count was last set to 0
ssd_chunk_scan.launches = 0
