"""Skinny float32 GEMM: at most 16 rows against row-major weights.

Wrapper of the hand-written Hopper kernel ``csrc/skinny_gemm.cu``, which
replaces no TPU kernel: the JAX package leaves its projections to XLA. A
serving decode step multiplies one row a slot against every float32 weight
of the model, so the product is bound by the weights' bytes (K · N · 4 at
3.35 TB/s); the kernel streams each weight once, in its stored layout,
through a ring of asynchronous copies a warp, and a cluster of CTAs
combines the split-K partials on chip (see the source's note). On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it computes the
plain version, :func:`skinny_gemm_ref`.

Operands: x (M, K) float32 with unit stride along K; ``ws`` 1-3 weights
(K, N_i) float32 with unit stride along N_i; outputs (M, N_i) contiguous.
``gated``: two weights of one width, and the one output silu(x · w0) ·
(x · w1). :func:`takes` says whether the kernel takes given operands
(:func:`fits`: their shapes and layout alone);
:func:`plan`, the one place the launch is decided, derives the split of K
from K, the column tiles and the card's SM count.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import common

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p] * 3
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])

#: columns a CTA, the most rows of X, the most weights a launch
#: (csrc/skinny_gemm.cu kBN, kMaxSegs)
BN, MAX_M, MAX_WEIGHTS = 128, 16, 3
#: the splits of K a launch may take: CTAs a cluster. Clusters of 3, 5, 6
#: or 7 CTAs fill the card's GPCs unevenly: at 8 rows of chameleon-34b's
#: products on an H100 none streamed faster than the best of these by more
#: than 0.5%, and most were 2-15% slower
SPLITS = (1, 2, 4, 8)
#: the fewest rows of K a CTA streams once K is split: below it the
#: cluster's combine outweighs the rows
MIN_SLICE = 256
#: what each further CTA an SM costs beyond its bytes, as a share of the
#: launch: its start, its combine and its wait at the cluster barrier
CTA_COST = 0.005


def tiles(ns, gated: bool) -> int:
    """Column tiles of a launch: each weight's, one set for gate and up."""
    return -(-ns[0] // BN) if gated else sum(-(-n // BN) for n in ns)


@functools.lru_cache(maxsize=256)
def plan(k: int, n_tiles: int, sms: int) -> int:
    """The split of K (CTAs a cluster, one of SPLITS, each CTA at least
    MIN_SLICE rows of K where it splits) for ``n_tiles`` column tiles on a
    card of ``sms`` SMs. A launch streams its weights once whatever the
    split, and the SM that holds the most CTAs, ceil(CTAs / sms) of them,
    ends it: an SM streams at about the same rate whether it holds one
    CTA or two. So a split scores the share of its SMs' places that hold
    a CTA (CTAs / (sms · that most)), less CTA_COST for each CTA the
    busiest SM holds; the best score wins, the smaller split on a tie."""
    best, best_score = 1, float("-inf")
    for s in SPLITS:
        if s > 1 and k < s * MIN_SLICE:
            break
        ctas = n_tiles * s
        most = -(-ctas // sms)
        score = ctas / (sms * most) - CTA_COST * most
        if score > best_score + 1e-9:
            best, best_score = s, score
    return best


@functools.lru_cache(maxsize=8)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _rows_ok(t: torch.Tensor) -> bool:
    """A (rows, n) float32 operand the kernel's 16-byte copies read: unit
    stride along n, n and the row stride multiples of 4 floats, 16-byte
    aligned."""
    rows, n = t.shape
    s0, s1 = t.stride()
    return (t.dtype is torch.float32 and s1 == 1 and n % 4 == 0 and n >= 4
            and (rows == 1 or (s0 % 4 == 0 and s0 >= n))
            and t.data_ptr() % 16 == 0)


def fits(x: torch.Tensor, ws, gated: bool = False) -> bool:
    """Whether the kernel's shapes and layout hold for these operands, on
    any device: x (M, K) and each weight (K, N_i) float32, 1 <= M <=
    MAX_M, at most MAX_WEIGHTS weights (two of one width where
    ``gated``), each laid out as :func:`_rows_ok` asks."""
    if (x.dim() != 2 or not 1 <= x.shape[0] <= MAX_M
            or not 1 <= len(ws) <= MAX_WEIGHTS or not _rows_ok(x)):
        return False
    if gated and (len(ws) != 2 or ws[0].shape != ws[1].shape):
        return False
    k = x.shape[1]
    for w in ws:
        if w.dim() != 2 or w.shape[0] != k or not _rows_ok(w):
            return False
    return True


def takes(x: torch.Tensor, ws, gated: bool = False) -> bool:
    """Whether the kernel takes these operands: all on one CUDA device,
    and :func:`fits`."""
    if not x.is_cuda:
        return False
    dev = x.get_device()
    for w in ws:
        if w.get_device() != dev:
            return False
    return fits(x, ws, gated)


def skinny_gemm_ref(x: torch.Tensor, ws, gated: bool = False):
    """The plain version: ``x @ w`` for each weight (a tuple), or
    ``silu(x @ w0) * (x @ w1)`` where ``gated``."""
    if gated:
        return F.silu(x @ ws[0]) * (x @ ws[1])
    return tuple(x @ w for w in ws)


def skinny_gemm(x: torch.Tensor, ws, gated: bool = False):
    """x (M, K) float32, M <= 16; ws: 1-3 weights (K, N_i) float32, read
    against the same x -> a tuple of (M, N_i) outputs, or where ``gated``
    the one (M, N) output silu(x · w0) · (x · w1)."""
    if x.device.type == "cpu":
        return skinny_gemm_ref(x, ws, gated)
    if not takes(x, ws, gated):
        raise ValueError(
            f"skinny_gemm: x {tuple(x.shape)} {x.dtype} on {x.device} against "
            f"{[(tuple(w.shape), w.dtype, w.stride()) for w in ws]} "
            f"(gated={gated}): need float32 on one CUDA device, 1-{MAX_M} "
            f"rows, 1-{MAX_WEIGHTS} weights (K, N) with K and N multiples "
            "of 4, unit stride along N, rows 16-byte aligned")
    return launch(x, ws, gated)


@functools.lru_cache(maxsize=256)
def _split(device_index: int, k: int, ns: tuple, gated: bool) -> int:
    return plan(k, tiles(ns, gated), _sms(device_index))


def launch(x: torch.Tensor, ws, gated: bool = False):
    """:func:`skinny_gemm` on operands that :func:`takes` has accepted,
    without checking them again (the C entry still refuses what it cannot
    read)."""
    m, k = x.shape
    dev = x.get_device()
    ns = tuple(w.shape[1] for w in ws)
    outs = [torch.empty((m, n), dtype=torch.float32, device=x.device)
            for n in (ns[:1] if gated else ns)]
    args = [x.data_ptr(), x.stride(0) if m > 1 else k, m, k]
    for i in range(MAX_WEIGHTS):
        if i < len(ws):
            w = ws[i]
            args += [w.data_ptr(), w.stride(0), ns[i],
                     outs[0 if gated else i].data_ptr()]
        else:
            args += [None, 0, 0, None]
    args += [len(ws), int(gated), _split(dev, k, ns, gated),
             torch._C._cuda_getCurrentRawStream(dev)]
    name = "skinny_gemm"
    if dev == torch.cuda.current_device():
        common.launch(name, name, _ARGTYPES, args)
    else:
        with torch.cuda.device(dev):
            common.launch(name, name, _ARGTYPES, args)
    skinny_gemm.launches += 1
    return outs[0] if gated else tuple(outs)


#: kernel launches since the count was last set to 0
skinny_gemm.launches = 0
