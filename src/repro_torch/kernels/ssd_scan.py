"""Mamba2 SSD intra-chunk scan: the chunk's quadratic output and its state.

Wrapper of the hand-written Hopper kernel ``csrc/ssd_chunk_scan.cu`` (the
port of ``repro.kernels.ssd_scan.ssd_chunk_scan``). On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it computes the plain
version, :func:`repro_torch.kernels.ref.ssd_chunk_ref`.

Layouts, float32 and contiguous: x (M, Q, H, P); dt/cum (M, Q, H); b_/c_
(M, Q, N) with ngroups = 1, M = batch * chunks. Outputs: y (M, Q, H, P)
and state (M, H, P, N).

Limits: any M, Q, H and P of at least 1; N <= MAX_N (the shared memory a
CTA stages B and C in). A CTA takes a block of HEAD_BLOCK heads (C·Bᵀ is
formed once for both) and a slice of ``ps`` of the P columns; :func:`plan`
chooses the slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common, ref

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

#: the widest state N the kernel stages (common.ssd_smem stays within a
#: CTA's shared memory up to here)
MAX_N = 256
#: the P slices the kernel is instantiated for, widest first
SLICES = (64, 32, 16)
#: streaming multiprocessors of an H100 SXM
SMS = 132


def plan(m: int, q: int, h: int, p: int) -> int:
    """The width of a CTA's slice of P: the widest that still gives 1.5
    CTAs an SM when the chunk is staged whole (Q <= 64: two CTAs fit on an
    SM, and one's staging overlaps the other's state stores), half a CTA an
    SM for a longer chunk (each CTA forms C·Bᵀ over the whole lower
    triangle, so fewer, wider CTAs form it fewer times); the narrowest
    slice where none does. No slice wider than twice P is taken."""
    target = 3 * SMS // 2 if q <= common.SSD_TILE * \
        common.SSD_RESIDENT_TILES else SMS // 2
    fits = [ps for ps in SLICES if ps < 2 * p or ps == SLICES[-1]]
    blocks = m * -(-h // common.SSD_HEADS)
    for ps in fits:
        if blocks * -(-p // ps) >= target:
            return ps
    return fits[-1]


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                   b_: torch.Tensor, c_: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (M, Q, H, P); dt/cum: (M, Q, H); b_/c_: (M, Q, N) ->
    (y (M, Q, H, P), state (M, H, P, N)), float32.

    ``cum`` is the within-chunk cumulative sum of ``dt * A``. Any chunk
    length Q >= 1 is taken."""
    if x.device.type == "cpu":
        return ref.ssd_chunk_ref(x, dt, cum, b_, c_)
    m, q, h, p = _check(x, dt, cum, b_, c_)
    return launch(x, dt, cum, b_, c_, plan(m, q, h, p))


def _check(x, dt, cum, b_, c_) -> tuple[int, int, int, int]:
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
    if min(m, q, h, p, n) < 1 or n > MAX_N:
        raise ValueError(f"{name}: M={m}, Q={q}, H={h}, P={p}, N={n}; the "
                         f"kernel takes each >= 1 and N <= {MAX_N}")
    return m, q, h, p


def launch(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
           b_: torch.Tensor, c_: torch.Tensor, ps: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel with an explicit P slice ``ps`` (operands as
    :func:`ssd_chunk_scan` checks them)."""
    m, q, h, p = x.shape
    n = b_.shape[-1]
    if ps not in SLICES:
        raise ValueError(f"ssd_chunk_scan: P slice {ps}; the kernel is "
                         f"instantiated for {SLICES}")
    need = common.ssd_smem(q, ps, n)
    if need > common.MAX_SMEM_BYTES:
        raise ValueError(f"ssd_chunk_scan: N={n} at ps={ps} needs {need} "
                         f"bytes of shared memory; a CTA has "
                         f"{common.MAX_SMEM_BYTES}")
    y = torch.empty_like(x)
    state = torch.empty((m, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        common.launch("ssd_chunk_scan", "ssd_chunk_scan", _ARGTYPES, [
            x.data_ptr(), dt.data_ptr(), cum.data_ptr(), b_.data_ptr(),
            c_.data_ptr(), y.data_ptr(), state.data_ptr(),
            m, q, h, p, n, ps, stream])
        ssd_chunk_scan.launches += 1
    return y, state


#: kernel launches since the count was last set to 0
ssd_chunk_scan.launches = 0
