#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

  python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits nonzero; nothing is caught and passed over):

1. device   — requires torch.cuda.is_available(); prints the card's name
              and power limit as nvidia-smi reports them.
2. build    — compiles every kernel under src/repro_torch/kernels/csrc with
              nvcc (one process per source, all started together) and
              prints the seconds and ptxas's report: registers, shared
              memory and spills of every kernel instance.
3. kernels  — each kernel's wrapper at the serving paths' shapes against
              its plain PyTorch version on the same card:
              * paged decode / prefill (tinyllama-1.1b, 4 slots, page 16,
                256-token table, chunk 16): ragged lengths, garbage in the
                sentinel page and past every length, an idle slot, prefill
                horizons crossing pages; each called twice, bitwise equal
                (the cluster combines run in a fixed order), and the
                wrappers' shared-memory reckoning against the kernels';
              * contiguous decode / prefill (the same widths, a 256-position
                slot; the same bodies, paged_attention.cuh, over a strided
                addressing): decode lengths 37/256/1/0, prefill starts
                0/7/200/240, the model-layout cache read in place through
                its strides with garbage in the drop position and past
                every length; each called twice, bitwise equal, and the
                reckonings checked; the decode again at the whole-prompt
                path's shape (4 rows of 2,048 tokens in a 2,065-position
                bfloat16 cache), timed beside SDPA;
              * the SSD chunk scan at mamba2-1.3b's widths (64 heads of 64,
                state 128), 4 chunks of Q = 16, 13, 1 and 256, and at 14
                more cases (SSD_CASES: Q 1-256, M 1/2/4/9, H 1/3/5/64, P x
                N 16 x 16, 64 x 128 and odd or ragged widths, operands 4
                bytes off 16, a steep decay at Q = 256); each
                called twice, bitwise equal; the wrapper's shared-memory
                reckoning against the kernel's; timed at Q = 16 and 256;
              * full-sequence flash attention at the training and
                prefill shapes (B = 4, H = 32, KV = 4, d = 64): S = 2048
                and 1024 causal in float32 and bfloat16, a ragged S = 1000,
                and Sq = 256 against Skv = 2048 without the mask; the
                forward's log-sum-exp; the backward kernel's dq, dk, dv at
                S = 1024 (float32, bfloat16; both timed), and the autograd
                wrapper's against torch.autograd of the plain forward;
              * RMSNorm at D 1, 7, 2047, 2048, 8192 and 20000 (every
                variant and copy width), R 1, 4095 and 4096, both dtypes,
                rows aligned and 1 element off; each called twice, bitwise
                equal; timed at 4096 x 2048 in float32 and bfloat16;
              serving attention in q float32 with caches bfloat16 (the
              serving dtypes) and float32. Tolerance: 2e-5 absolute + 2e-5
              relative (both sides compute in float32 on identical inputs;
              they differ in summation order), 2e-2 where the output is
              bfloat16 (one rounding step). Then times kernel, plain
              version and one PyTorch call computing the same function (a
              yardstick only: the port never calls it):
              scaled_dot_product_attention on the pre-rotated,
              head-expanded view (forward + backward for the backward
              kernel), F.rms_norm (with the weight in x's dtype); no single
              PyTorch call computes the SSD chunk. Bound: the larger of
              bytes / 3.35 TB/s and float32 flops / 67 TFLOP/s (the SIMT
              rate the other kernels run at);
              for the kernels that run their products on the tensor cores
              (the two flash kernels, both prefills, the SSD), the largest of
              bytes / 3.35 TB/s, matrix flops at the rate of their route —
              989 TFLOP/s bf16, 494.7 / 3 TFLOP/s for 3xTF32, the card's
              float32-accurate tensor-core route, 494.7 / 2 for q float32
              against a bfloat16 cache (bfloat16 is exact in TF32: two
              products) — and one exp a visible pair / 3.9e12 (the
              special-function units): a bound at the SIMT rate would be
              beaten by a tensor-core kernel, which no bound may allow.
4. serve    — repro_torch.launch.serve.main at full width, 8 chat requests,
              4 slots, max-seq 256, 16 new tokens, chunk 16, policy
              chunked, random float32 weights from seed 0, on three paths:
              tinyllama-1.1b on the paged pool (page 16), tinyllama-1.1b on
              the contiguous cache (paged=False), and mamba2-1.3b (its
              recurrent state is slot-resident). Each path runs once to
              warm up, then measured with every kernel's launch count set
              to 0 just before and read just after: every request must
              finish, and each kernel of the path must have run exactly
              (layers x its dispatches) times, the others not at all.
              Profiled dispatches (paged tinyllama, mamba2) show where a
              dispatch's time goes. Then one prefill chunk and one decode
              step of each path at full width on the card and, with the
              same weights and caches, on the CPU path (mamba2 cut to 8
              layers on both): logits must agree within 1e-3 absolute with
              float32 caches and 2e-2 with the bfloat16 serving caches
              (card_vs_cpu says why).
5. training — at full tinyllama-1.1b width, random float32 weights from
              seed 0, each path between a zero of every launch count and
              an exact check of them all:
              * ops.fused_rmsnorm (the RMSNorm kernel's one entry point)
                on 4 x 1024 activations, float32 and bfloat16;
              * make_prefill_step on 4 x 2048 prompt tokens (the flash
                kernel, once a layer), then 16 greedy decode steps on the
                cache it returns (the contiguous decode kernel);
              * repro_torch.launch.train, 8 AdamW steps of 4 x 1024 tokens
                with remat full (the flash kernel twice a layer a step,
                the backward kernel once): finite, decreasing losses; step
                time, tokens/s and peak memory; a profiled step;
              then, cut to 2 layers, forward logits and loss_fn gradients
              on the card against the CPU path, and a checkpoint written
              on the card, restored on the CPU, whose next step agrees.
6. report   — a JSON line of per-kernel numbers (launches summed over the
              measured runs of every path), the nvidia-smi line, and last
              a JSON line naming the device.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_MMA_FLOPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
TF32_MMA_FLOPS_PER_S = 494.7e12  # H100 SXM TF32 tensor cores, dense
EXP_PER_S = 3.9e12               # 16 exp a clock on each of 132 SMs
ATOL = RTOL = 2e-5
BF16_TOL = 2e-2

# serving-path shapes: tinyllama-1.1b, 4 slots, page 16, max-seq 256
B, H, KV, D, PAGE, NB, C, POOL = 4, 32, 4, 64, 16, 16, 16, 64
S = NB * PAGE
DECODE_LENGTHS = [37, 256, 1, 0]   # row 2: one token; row 3: idle slot
PREFILL_STARTS = [0, 7, 200, 240]
ROPE_THETA = 10_000.0
# mamba2-1.3b's SSD widths: heads, head dim, state; rows x chunks
SSD_H, SSD_P, SSD_N, SSD_M = 64, 64, 128, 4
SSD_Q = [16, 13, 1, 256]           # 16: the serving chunk (timed)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# ------------------------------------------------------------------ phase 1
def device_phase(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device {torch.cuda.get_device_name(0)} "
        f"(capability {torch.cuda.get_device_capability(0)}); "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvidia-smi: {smi_line}")
    return smi_line


# ------------------------------------------------------------------ phase 2
def build_phase(build):
    t0 = time.monotonic()
    seconds = build.build()
    log(f"built {sorted(seconds) or 'nothing (cached)'} in "
        f"{time.monotonic() - t0:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in seconds.items())})")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                log(f"ptxas {name}: {line.strip()}")


# ------------------------------------------------------------------ phase 3
def timed_ms(torch, fn, iters: int = 50) -> float:
    """Device time per call: CUDA events around ``iters`` back-to-back
    calls, enqueued behind a GPU spin so that the host's issue rate does not
    leave the card idle between them."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)     # ~50 ms of spinning at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_pool(torch, gen, dev, need_pages, pool_dtype):
    """Pools with garbage in the sentinel page 0 and past every row's
    valid positions; row i maps ``need_pages[i]`` distinct real pages."""
    k = torch.randn((POOL, PAGE, KV, D), generator=gen, device=dev)
    v = torch.randn((POOL, PAGE, KV, D), generator=gen, device=dev)
    k[0], v[0] = 50.0, -50.0
    ids = torch.randperm(POOL - 1, generator=gen, device=dev) + 1
    bt = torch.zeros((B, NB), dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(need_pages):
        bt[i, :n] = ids[at:at + n].to(torch.int32)
        at += n
    return k.to(pool_dtype), v.to(pool_dtype), bt


def make_cache(torch, gen, dev, filled, cache_dtype):
    """Model-layout caches (B, S + 1, KV, d) — the serving cache with its
    drop position — holding garbage from position ``filled[i]`` of row i
    on, drop position included; returns the head-major (B, KV, S, d) views
    of the first S positions that the kernels read in place."""
    k = torch.randn((B, S + 1, KV, D), generator=gen, device=dev)
    v = torch.randn((B, S + 1, KV, D), generator=gen, device=dev)
    for i, n in enumerate(filled):
        k[i, n:], v[i, n:] = 50.0, -50.0
    k, v = k.to(cache_dtype), v.to(cache_dtype)
    return k[:, :S].transpose(1, 2), v[:, :S].transpose(1, 2)


def check_close(name, got, want, tol=ATOL):
    """Max abs error of ``got`` against ``want``; fails beyond ``tol``
    absolute + ``tol`` relative (2e-5 in float32; bfloat16 outputs get
    BF16_TOL, one rounding step of a value of order 1)."""
    import torch
    err = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite kernel output")
    over = err - tol * want.float().abs()
    if over.max().item() > tol:
        fail(f"{name}: kernel vs plain max abs err {err.max().item():.3e} "
             f"exceeds {tol} + {tol}*|plain|")
    return err.max().item()


def decode_bound(lengths, table_bytes):
    n = sum(lengths)
    byts = (B * H * D * 4 + n * KV * D * 2 * 2 + table_bytes + B * 4
            + B * H * D * 4)
    flops = 4 * D * H * n
    return byts, flops


def prefill_bound(starts, table_bytes):
    visible = sum(s + C for s in starts)
    byts = (B * H * C * D * 4 + visible * KV * D * 2 * 2 + table_bytes + B * 4
            + B * H * C * D * 4)
    # row (b, h, c) attends s + c + 1 positions: 2 flops each for q.k and p.v
    flops = sum(4 * D * H * (C * (s + 1) + C * (C - 1) // 2) for s in starts)
    return byts, flops


def prefill_pairs(starts):
    """Visible (query row, position) pairs of one head: chunk token c of a
    row starting at s sees s + c + 1 positions."""
    return sum(C * (s + 1) + C * (C - 1) // 2 for s in starts)


def ssd_bound(m, q, h, p, n):
    """The SSD chunk's least time (flash_bound_entry): bytes, every input
    read once (x, dt, cum, B, C) and both outputs written once (y, state),
    float32, at 3.35 TB/s; the matrix products — C·Bᵀ on the lower
    triangle once per row m (2N a pair), per head y (2P a pair) and the
    state (2PN a position) — at the 3xTF32 rate the kernel forms them at;
    per head an exp a score and a state weight."""
    tri = q * (q + 1) // 2
    byts = 4 * (2 * m * q * h * p + 2 * m * q * h + 2 * m * q * n
                + m * h * p * n)
    flops = m * (tri * 2 * n + h * (tri * 2 * p + q * 2 * p * n))
    return flash_bound_entry(byts, flops, m * h * (tri + q), False)


def bound_entry(byts, flops):
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def prefill_bound_entry(starts, table_bytes):
    """The prefill's least time on the tensor cores (paged or contiguous):
    q float32 against a bfloat16 cache forms each product as two TF32
    products (a bfloat16 value is exact in TF32), so its matrix flops run
    at 494.7 / 2 TFLOP/s; one exp a visible pair and head."""
    byts, flops = prefill_bound(starts, table_bytes)
    return flash_bound_entry(byts, flops, H * prefill_pairs(starts), False,
                             products=2)


def reckoning_check(torch, layout):
    """The wrappers' shared-memory reckoning (common.decode_smem, and
    paged_prefill_smem or prefill_smem) against the kernels' own (the C
    entries beside them), at the serving shape and the extremes of G, d and
    the dtypes; ``layout`` "paged" or "contiguous"."""
    from repro_torch.kernels import build, common
    prefix = "paged_" if layout == "paged" else ""
    dec = getattr(build.load(f"{prefix}decode_attention"),
                  f"{prefix}decode_attention_smem")
    pre = getattr(build.load(f"{prefix}prefill_attention"),
                  f"{prefix}prefill_attention_smem")
    pre_smem = (common.paged_prefill_smem if layout == "paged"
                else common.prefill_smem)
    for fn in (dec, pre):
        fn.argtypes = [build.ctypes.c_int] * 3
        fn.restype = build.ctypes.c_longlong
    for d in (16, D, 80, 256):
        for kv_elt in (2, 4):
            for g in (1, H // KV, 32):
                if dec(g, d, int(kv_elt == 2)) != \
                        common.decode_smem(g, d, kv_elt):
                    fail(f"{layout} decode_smem(G={g}, d={d}) differs from "
                         "the kernel's")
            for q_elt in (2, 4):
                if pre(d, int(q_elt == 2), int(kv_elt == 2)) != \
                        pre_smem(d, q_elt, kv_elt):
                    fail(f"{pre_smem.__name__}(d={d}) differs from the "
                         "kernel's")
    log(f"{layout}: shared memory a CTA at the serving shape: decode "
        f"{common.decode_smem(H // KV, D, 2)} B, prefill "
        f"{pre_smem(D, 4, 2)} B (reckonings agree)")


def check_repeat(torch, name, fn, got):
    """A second call on the same inputs must give the same bits."""
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"{name}: two calls on the same inputs differ")


def sdpa_ms(torch, F, q_rot, k_hm, v_hm, mask):
    """One scaled_dot_product_attention call on the pre-rotated query and
    the head-expanded (B, H, S, d) cache view: a yardstick, never called
    by the port."""
    kg = k_hm.repeat_interleave(H // KV, 1)
    vg = v_hm.repeat_interleave(H // KV, 1)
    return timed_ms(torch, lambda: F.scaled_dot_product_attention(
        q_rot.to(kg.dtype), kg, vg, attn_mask=mask))


def row(err, ms, plain_ms, bound, library_ms):
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms)


def paged_kernel_phase(torch, F, K, ref, gen, dev, out):
    reckoning_check(torch, "paged")
    # ---------------------------------------------------------- decode
    # the idle row 3 maps no page: its table is all sentinel
    need = [math.ceil(n / PAGE) for n in DECODE_LENGTHS]
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    active = [i for i, n in enumerate(DECODE_LENGTHS) if n > 0]
    fn = K["paged_decode_attention"]
    for pool_dtype in (torch.bfloat16, torch.float32):
        k, v, bt = make_pool(torch, gen, dev, need, pool_dtype)
        got = fn(q, k, v, bt, lengths, rope_theta=ROPE_THETA)
        want = ref.paged_decode_attention_ref(q, k, v, bt, lengths,
                                              rope_theta=ROPE_THETA)
        torch.cuda.synchronize()
        err = check_close(f"paged_decode_attention[{pool_dtype}]",
                          got[active], want[active])
        if not torch.all(got[3] == 0):
            fail("paged_decode_attention: a length-0 row must give 0")
        check_repeat(torch, f"paged_decode_attention[{pool_dtype}]",
                     lambda: fn(q, k, v, bt, lengths, rope_theta=ROPE_THETA),
                     got)
        log(f"paged_decode_attention q=float32 pools={pool_dtype}: "
            f"max abs err {err:.3e} (tol {ATOL} + {RTOL}*|plain|)")
        if pool_dtype == torch.bfloat16:
            ms = timed_ms(torch, lambda: fn(q, k, v, bt, lengths,
                                            rope_theta=ROPE_THETA))
            plain_ms = timed_ms(torch, lambda: ref.paged_decode_attention_ref(
                q, k, v, bt, lengths, rope_theta=ROPE_THETA))
            qr = ref.rope_ref(q, (lengths - 1)[:, None], ROPE_THETA)
            mask = (torch.arange(S, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            lib_ms = sdpa_ms(torch, F, qr[:, :, None],
                             ref._gather_head_major(k, bt),
                             ref._gather_head_major(v, bt), mask)
            out["paged_decode_attention"] = row(
                err, ms, plain_ms,
                bound_entry(*decode_bound(DECODE_LENGTHS, B * NB * 4)),
                lib_ms)

    # --------------------------------------------------------- prefill
    need = [math.ceil((s + C) / PAGE) for s in PREFILL_STARTS]
    start = torch.tensor(PREFILL_STARTS, dtype=torch.int32, device=dev)
    # model layout (B, C, H, d) seen head-major, as ops passes it
    qc = torch.randn((B, C, H, D), generator=gen, device=dev).transpose(1, 2)
    fn = K["paged_prefill_attention"]
    for pool_dtype in (torch.bfloat16, torch.float32):
        k, v, bt = make_pool(torch, gen, dev, need, pool_dtype)
        got = fn(qc, k, v, bt, start, rope_theta=ROPE_THETA)
        want = ref.paged_prefill_attention_ref(qc, k, v, bt, start,
                                               rope_theta=ROPE_THETA)
        torch.cuda.synchronize()
        err = check_close(f"paged_prefill_attention[{pool_dtype}]", got, want)
        check_repeat(torch, f"paged_prefill_attention[{pool_dtype}]",
                     lambda: fn(qc, k, v, bt, start, rope_theta=ROPE_THETA),
                     got)
        log(f"paged_prefill_attention q=float32 pools={pool_dtype}: "
            f"max abs err {err:.3e} (tol {ATOL} + {RTOL}*|plain|)")
        if pool_dtype == torch.bfloat16:
            ms = timed_ms(torch, lambda: fn(qc, k, v, bt, start,
                                            rope_theta=ROPE_THETA))
            plain_ms = timed_ms(torch, lambda: ref.paged_prefill_attention_ref(
                qc, k, v, bt, start, rope_theta=ROPE_THETA))
            pos = start[:, None] + torch.arange(C, device=dev)
            qr = ref.rope_ref(qc, pos[:, None, :], ROPE_THETA)
            mask = (torch.arange(S, device=dev)[None, None, :]
                    <= pos[:, :, None])[:, None]
            lib_ms = sdpa_ms(torch, F, qr, ref._gather_head_major(k, bt),
                             ref._gather_head_major(v, bt), mask)
            out["paged_prefill_attention"] = row(
                err, ms, plain_ms,
                prefill_bound_entry(PREFILL_STARTS, B * NB * 4),
                lib_ms)


def contiguous_kernel_phase(torch, F, K, ref, gen, dev, out):
    reckoning_check(torch, "contiguous")
    # ---------------------------------------------------------- decode
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    active = [i for i, n in enumerate(DECODE_LENGTHS) if n > 0]
    fn = K["decode_attention"]
    for cache_dtype in (torch.bfloat16, torch.float32):
        k, v = make_cache(torch, gen, dev, DECODE_LENGTHS, cache_dtype)
        got = fn(q, k, v, lengths, rope_theta=ROPE_THETA)
        want = ref.decode_attention_ref(q, k, v, lengths,
                                        rope_theta=ROPE_THETA)
        torch.cuda.synchronize()
        err = check_close(f"decode_attention[{cache_dtype}]", got[active],
                          want[active])
        if not torch.all(got[3] == 0):
            fail("decode_attention: a length-0 row must give 0")
        check_repeat(torch, f"decode_attention[{cache_dtype}]",
                     lambda: fn(q, k, v, lengths, rope_theta=ROPE_THETA),
                     got)
        log(f"decode_attention q=float32 cache={cache_dtype}: max abs err "
            f"{err:.3e} (tol {ATOL} + {RTOL}*|plain|)")
        if cache_dtype == torch.bfloat16:
            ms = timed_ms(torch, lambda: fn(q, k, v, lengths,
                                            rope_theta=ROPE_THETA))
            plain_ms = timed_ms(torch, lambda: ref.decode_attention_ref(
                q, k, v, lengths, rope_theta=ROPE_THETA))
            qr = ref.rope_ref(q, (lengths - 1)[:, None], ROPE_THETA)
            mask = (torch.arange(S, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            lib_ms = sdpa_ms(torch, F, qr[:, :, None], k, v, mask)
            out["decode_attention"] = row(
                err, ms, plain_ms,
                bound_entry(*decode_bound(DECODE_LENGTHS, 0)), lib_ms)
    out[WHOLE_PROMPT_ROW] = whole_prompt_decode_row(
        torch, F, fn, ref, gen, dev)

    # --------------------------------------------------------- prefill
    start = torch.tensor(PREFILL_STARTS, dtype=torch.int32, device=dev)
    qc = torch.randn((B, C, H, D), generator=gen, device=dev).transpose(1, 2)
    fn = K["prefill_attention"]
    for cache_dtype in (torch.bfloat16, torch.float32):
        k, v = make_cache(torch, gen, dev, [s + C for s in PREFILL_STARTS],
                          cache_dtype)
        got = fn(qc, k, v, start, rope_theta=ROPE_THETA)
        want = ref.prefill_attention_ref(qc, k, v, start,
                                         rope_theta=ROPE_THETA)
        torch.cuda.synchronize()
        err = check_close(f"prefill_attention[{cache_dtype}]", got, want)
        check_repeat(torch, f"prefill_attention[{cache_dtype}]",
                     lambda: fn(qc, k, v, start, rope_theta=ROPE_THETA),
                     got)
        log(f"prefill_attention q=float32 cache={cache_dtype}: max abs err "
            f"{err:.3e} (tol {ATOL} + {RTOL}*|plain|)")
        if cache_dtype == torch.bfloat16:
            ms = timed_ms(torch, lambda: fn(qc, k, v, start,
                                            rope_theta=ROPE_THETA))
            plain_ms = timed_ms(torch, lambda: ref.prefill_attention_ref(
                qc, k, v, start, rope_theta=ROPE_THETA))
            pos = start[:, None] + torch.arange(C, device=dev)
            qr = ref.rope_ref(qc, pos[:, None, :], ROPE_THETA)
            mask = (torch.arange(S, device=dev)[None, None, :]
                    <= pos[:, :, None])[:, None]
            lib_ms = sdpa_ms(torch, F, qr, k, v, mask)
            out["prefill_attention"] = row(
                err, ms, plain_ms, prefill_bound_entry(PREFILL_STARTS, 0),
                lib_ms)


#: the log's name of decode_attention's second timed row (not a kernel of
#: the kernels line: the same kernel at the whole-prompt path's shape)
WHOLE_PROMPT_ROW = "decode_attention (whole prompt)"


def whole_prompt_decode_row(torch, F, fn, ref, gen, dev):
    """The contiguous decode kernel ``fn`` at the shape of phase 5's decode
    steps: B rows holding a PREFILL_S-token prompt in the bfloat16 cache
    that make_prefill_step returns, (B, PREFILL_S + DECODE_STEPS + 1, KV, d)
    with its drop position, read over all but that position (garbage past
    each row's length). Checked against the plain version and repeated
    bitwise, then timed beside the plain version and SDPA; chip_ab.py runs
    it on both trees it compares."""
    s = PREFILL_S + DECODE_STEPS
    lengths = [PREFILL_S] * B
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    k = torch.randn((B, s + 1, KV, D), generator=gen, device=dev)
    v = torch.randn((B, s + 1, KV, D), generator=gen, device=dev)
    k[:, PREFILL_S:], v[:, PREFILL_S:] = 50.0, -50.0
    k, v = (x.to(torch.bfloat16)[:, :s].transpose(1, 2) for x in (k, v))
    call = (lambda: fn(q, k, v, ln, rope_theta=ROPE_THETA))
    got = call()
    want = ref.decode_attention_ref(q, k, v, ln, rope_theta=ROPE_THETA)
    torch.cuda.synchronize()
    what = f"decode_attention[B={B} S={s} lengths {PREFILL_S}]"
    err = check_close(what, got, want)
    check_repeat(torch, what, call, got)
    ms = timed_ms(torch, call)
    plain_ms = timed_ms(torch, lambda: ref.decode_attention_ref(
        q, k, v, ln, rope_theta=ROPE_THETA))
    qr = ref.rope_ref(q, (ln - 1)[:, None], ROPE_THETA)
    mask = (torch.arange(s, device=dev)[None, :]
            < ln[:, None])[:, None, None, :]
    lib_ms = sdpa_ms(torch, F, qr[:, :, None], k, v, mask)
    log(f"{what}: max abs err {err:.3e} (tol {ATOL} + {RTOL}*|plain|)")
    return row(err, ms, plain_ms, bound_entry(*decode_bound(lengths, 0)),
               lib_ms)


def ssd_inputs(torch, gen, dev, q, m=None, h=None, p=None, n=None,
               steep=False, offset=0):
    """SSD chunk inputs shaped as mamba2 makes them (mamba2-1.3b's widths
    and SSD_M rows unless given): dt > 0 and A < 0, so cum falls along the
    chunk and exp(cum_i - cum_j) overflows above the diagonal at Q = 256;
    ``steep`` takes A 8x larger, so that most of the decay underflows;
    ``offset`` floats puts each operand in a contiguous view that many
    floats into its allocation (1: 4 bytes off 16)."""
    m, h, p, n = m or SSD_M, h or SSD_H, p or SSD_P, n or SSD_N
    x = torch.randn((m, q, h, p), generator=gen, device=dev)
    dt = 0.3 + 0.7 * torch.rand((m, q, h), generator=gen, device=dev)
    a = -(0.5 + torch.rand((h,), generator=gen, device=dev))
    cum = torch.cumsum(dt * a * (8.0 if steep else 1.0), dim=1)
    b_ = 0.3 * torch.randn((m, q, n), generator=gen, device=dev)
    c_ = 0.3 * torch.randn((m, q, n), generator=gen, device=dev)
    if not offset:
        return x, dt, cum, b_, c_

    def shifted(t):
        base = torch.empty(offset + t.numel(), device=dev)
        base[offset:].copy_(t.flatten())
        return base[offset:].view(t.shape)
    return tuple(map(shifted, (x, dt, cum, b_, c_)))


#: (M, Q, H, P, N, steep, offset): the serving chunk's neighbours and
#: ragged chunks Q 1-256, one to nine rows, head counts that the head
#: block of 2 leaves a tail of, the reduced configs' widths (16, 16) and
#: mamba2-1.3b's; P and N odd or not multiples of 4, and operands 4 bytes
#: off 16 (the kernel's 4-byte copies and single-float stores)
SSD_CASES = [(1, 1, 1, 16, 16, False, 0), (4, 7, 3, 64, 128, False, 0),
             (9, 13, 3, 16, 16, False, 0), (1, 16, 64, 64, 128, False, 0),
             (4, 17, 3, 64, 128, False, 0), (9, 33, 64, 16, 16, False, 0),
             (1, 100, 3, 64, 128, False, 0), (4, 255, 1, 16, 16, False, 0),
             (9, 256, 3, 64, 128, True, 0), (1, 256, 64, 64, 128, True, 0),
             (2, 33, 3, 18, 30, False, 0), (1, 16, 5, 7, 9, False, 0),
             (4, 16, 64, 64, 128, False, 1), (2, 100, 3, 33, 17, False, 1)]


def ssd_reckoning_check():
    """common.ssd_smem against the kernel's own reckoning (its C entry),
    over chunk lengths staged whole and streamed, every P slice and N
    9-256."""
    from repro_torch.kernels import build, common
    fn = build.load("ssd_chunk_scan").ssd_chunk_scan_smem
    fn.argtypes = [build.ctypes.c_int] * 3
    fn.restype = build.ctypes.c_longlong
    for q in (1, 16, 17, 64, 65, 256):
        for ps in (16, 32, 64):
            for n in (9, 16, 100, SSD_N, 256):
                if fn(q, ps, n) != common.ssd_smem(q, ps, n):
                    fail(f"ssd_smem(Q={q}, ps={ps}, N={n}) differs from "
                         "the kernel's")
    log(f"ssd_chunk_scan: shared memory a CTA: Q=16 "
        f"{common.ssd_smem(16, 32, SSD_N)} B, Q=256 "
        f"{common.ssd_smem(256, 64, SSD_N)} B (reckonings agree)")


def ssd_rows(torch, fn, ref, gen, dev):
    """The SSD kernel ``fn`` at mamba2-1.3b's widths, SSD_M rows, at the
    serving chunk (Q = 16) and the whole-prompt chunk (Q = 256): max abs
    error against the plain version, kernel and plain times, bound.
    chip_ab.py runs it on both trees it compares."""
    out = {}
    for q in (16, 256):
        args = ssd_inputs(torch, gen, dev, q)
        y, st = fn(*args)
        want_y, want_st = ref.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        err = max(check_close(f"ssd_chunk_scan y [Q={q}]", y, want_y),
                  check_close(f"ssd_chunk_scan state [Q={q}]", st, want_st))
        out[q] = row(err, timed_ms(torch, lambda: fn(*args)),
                     timed_ms(torch, lambda: ref.ssd_chunk_ref(*args)),
                     ssd_bound(SSD_M, q, SSD_H, SSD_P, SSD_N), None)
    return out


def ssd_kernel_phase(torch, K, ref, gen, dev, out):
    ssd_reckoning_check()
    fn = K["ssd_chunk_scan"]
    errs = []
    for q in SSD_Q:
        args = ssd_inputs(torch, gen, dev, q)
        y, st = fn(*args)
        want_y, want_st = ref.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        errs.append(max(
            check_close(f"ssd_chunk_scan y [Q={q}]", y, want_y),
            check_close(f"ssd_chunk_scan state [Q={q}]", st, want_st)))
        check_repeat(torch, f"ssd_chunk_scan [Q={q}]",
                     lambda: torch.cat([t.flatten() for t in fn(*args)]),
                     torch.cat([y.flatten(), st.flatten()]))
    for m, q, h, p, n, steep, offset in SSD_CASES:
        args = ssd_inputs(torch, gen, dev, q, m, h, p, n, steep, offset)
        y, st = fn(*args)
        want_y, want_st = ref.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        what = (f"[M={m} Q={q} H={h} P={p} N={n}{' steep' if steep else ''}"
                f"{f' offset {offset}' if offset else ''}]")
        errs.append(max(check_close(f"ssd_chunk_scan y {what}", y, want_y),
                        check_close(f"ssd_chunk_scan state {what}", st,
                                    want_st)))
        check_repeat(torch, f"ssd_chunk_scan {what}",
                     lambda: torch.cat([t.flatten() for t in fn(*args)]),
                     torch.cat([y.flatten(), st.flatten()]))
    log(f"ssd_chunk_scan: {len(SSD_Q) + len(SSD_CASES)} cases within "
        f"{max(errs):.3e} (tol {ATOL} + {RTOL}*|plain|), each called twice, "
        "bitwise equal")
    rows = ssd_rows(torch, fn, ref, gen, dev)
    for q, r in rows.items():
        log(f"ssd_chunk_scan M={SSD_M} Q={q} H={SSD_H} P={SSD_P} "
            f"N={SSD_N}: max abs err {r['max_abs_err']:.3e} | kernel "
            f"{r['ms']:.5f} ms | plain {r['plain_ms']:.4f} ms | bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    out["ssd_chunk_scan"] = dict(rows[16], max_abs_err=max(
        errs + [r["max_abs_err"] for r in rows.values()]))


def kernel_phase(torch, F, K, ref):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    out = {}
    paged_kernel_phase(torch, F, K, ref, gen, dev, out)
    contiguous_kernel_phase(torch, F, K, ref, gen, dev, out)
    ssd_kernel_phase(torch, K, ref, gen, dev, out)
    flash_kernel_phase(torch, F, K, ref, gen, dev, out)
    rmsnorm_kernel_phase(torch, F, K, ref, gen, dev, out)
    for name, r in out.items():
        lib = ("—" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"{name}: kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms"
            f" | sdpa yardstick {lib} | bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
    return out


# full-sequence attention at the training / prefill shapes: (Sq, Skv,
# causal, dtype); the first is the row of the kernels line (prefill, S=2048)
FLASH_CASES = [(2048, 2048, True, "float32"), (2048, 2048, True, "bfloat16"),
               (1024, 1024, True, "float32"), (1024, 1024, True, "bfloat16"),
               (1000, 1000, True, "float32"), (256, 2048, False, "float32")]
FLASH_BWD_S = 1024                  # the training sequence length
RMS_R, RMS_D = 4096, 2048       # the timed RMSNorm shape


def flash_pairs(sq, skv, causal):
    """Visible (query, key) pairs of one head: kpos <= qpos from 0."""
    if not causal:
        return sq * skv
    return sum(min(i + 1, skv) for i in range(sq))


def flash_bound(sq, skv, causal, elt, lse=False):
    """Bytes: q, k, v read once, o written once (and lse); matrix flops: q·k
    and p·v, 2·d each, per visible pair and head; one exp a visible pair
    and head."""
    byts = elt * (B * H * sq * D * 2 + 2 * B * KV * skv * D)
    byts += 4 * B * H * sq if lse else 0
    pairs = B * H * flash_pairs(sq, skv, causal)
    return byts, 4 * D * pairs, pairs


def flash_bwd_bound(sq, skv, causal, elt):
    """Bytes: q, k, v, o, dO and lse read once, dq, dk, dv written once;
    matrix flops: q·k again, dO·v, Pᵀ dO, dSᵀ q and dS k, 2·d each, per
    visible pair and head — 2.5× the forward's; one exp a visible pair and
    head (P once)."""
    byts = (elt * (B * H * sq * D * 4 + 4 * B * KV * skv * D)
            + 4 * B * H * sq)
    pairs = B * H * flash_pairs(sq, skv, causal)
    return byts, 10 * D * pairs, pairs


def flash_bound_entry(byts, flops, exps, bf16, products=3):
    """The least time of a kernel on the tensor cores: bytes at 3.35 TB/s,
    matrix flops at its route's rate (bf16 when q and k/v are bfloat16,
    else ``products`` TF32 products a float32 product — 3xTF32), exps at
    3.9e12 a second; the largest of the three."""
    rate = (BF16_MMA_FLOPS_PER_S if bf16
            else TF32_MMA_FLOPS_PER_S / products)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / rate, exps / EXP_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def flash_bwd_f64(torch, q, k, v, o, lse, do):
    """flash_attention_bwd_ref's formulas (causal) evaluated in float64 on
    the same inputs: the yardstick of how far the kernel and the float32
    plain version each are from the exact gradients."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    sp = (lambda t: t.double().reshape(b, kv, h // kv, s, -1))
    logits = torch.einsum("bkgqd,bksd->bkgqs", sp(q), k.double()) / math.sqrt(d)
    visible = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(torch.where(visible, logits, torch.tensor(
        -1e30, dtype=torch.float64, device=q.device)) - sp(lse))
    dog = sp(do)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.double())
    ds = p * (dp - (dog * sp(o)).sum(-1, keepdim=True)) / math.sqrt(d)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.double()).reshape(q.shape)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, sp(q))
    return dq, dk, dv


def tol_share(torch, got, want, tol=ATOL):
    """The largest |got - want| / (tol + tol·|want|): 1 is the tolerance."""
    err = (got.double() - want.double()).abs()
    return (err / (tol + tol * want.double().abs())).max().item()


def flash_inputs(torch, gen, dev, sq, skv, dtype):
    """q, k, v in the model's layout (B, S, heads, d), seen head-major as
    ops.attention_prefill passes them."""
    def one(n, heads):
        return (torch.randn((B, n, heads, D), generator=gen, device=dev)
                .to(dtype).transpose(1, 2))
    return one(sq, H), one(skv, KV), one(skv, KV)


def sdpa_full(torch, F, q, k, v, causal):
    """SDPA on the head-expanded view: a yardstick the port never calls."""
    return F.scaled_dot_product_attention(
        q, k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1),
        is_causal=causal)


def flash_kernel_phase(torch, F, K, ref, gen, dev, out):
    fwd, bwd = K["flash_attention"], K["flash_attention_bwd"]
    for sq, skv, causal, dname in FLASH_CASES:
        dtype = getattr(torch, dname)
        tol = ATOL if dname == "float32" else BF16_TOL
        q, k, v = flash_inputs(torch, gen, dev, sq, skv, dtype)
        o, lse = fwd(q, k, v, causal=causal, return_lse=True)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        want_lse = ref.flash_attention_lse_ref(q, k, causal=causal)
        torch.cuda.synchronize()
        what = f"flash_attention[Sq={sq} Skv={skv} causal={causal} {dname}]"
        err = check_close(what, o, want, tol)
        lse_err = check_close(what + " lse", lse, want_lse)
        del want, want_lse
        line = (f"{what}: max abs err {err:.3e} (tol {tol} + {tol}*|plain|)"
                f", lse {lse_err:.3e}")
        if (sq, skv, causal) in ((2048, 2048, True), (1024, 1024, True)):
            ms = timed_ms(torch, lambda: fwd(q, k, v, causal=causal), 10)
            plain_ms = timed_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, causal=causal), 5)
            lib_ms = timed_ms(torch, lambda: sdpa_full(torch, F, q, k, v,
                                                       causal), 10)
            bound = flash_bound_entry(
                *flash_bound(sq, skv, causal, q.element_size()),
                bf16=dname == "bfloat16")
            line += (f" | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                     f"sdpa {lib_ms:.4f} ms | bound {bound[0]:.4f} ms "
                     f"({bound[1]})")
            if (sq, dname) == (2048, "float32"):
                out["flash_attention"] = row(err, ms, plain_ms, bound, lib_ms)
        log(line)
        del q, k, v, o, lse
        torch.cuda.empty_cache()

    # backward at the training shape, float32 and bfloat16: the kernel
    # against the plain backward, and the autograd wrapper against
    # torch.autograd of the plain forward
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        tol = ATOL if dname == "float32" else BF16_TOL
        s = FLASH_BWD_S
        q, k, v = flash_inputs(torch, gen, dev, s, s, dtype)
        o, lse = fwd(q, k, v, causal=True, return_lse=True)
        do = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
        got = bwd(q, k, v, o, lse, do, causal=True)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        errs = [check_close(f"flash_attention_bwd {n} [S={s} {dname}]",
                            g, w, tol)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)]
        line = (f"flash_attention_bwd S={s} causal {dname}: max abs err dq "
                f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol {tol}"
                f" + {tol}*|plain|)")
        if dname == "float32":
            exact = flash_bwd_f64(torch, q, k, v, o, lse, do)
            share = [[tol_share(torch, a, e) for a, e in zip(side, exact)]
                     for side in (got, want)]
            del exact
            line += ("; share of the tolerance against float64 gradients: "
                     "kernel dq/dk/dv " + "/".join(f"{x:.3f}" for x in share[0])
                     + ", plain float32 " + "/".join(f"{x:.3f}"
                                                      for x in share[1]))
        del got, want
        if dname == "float32":
            from repro_torch.kernels.flash_attention import FlashAttention
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
            grads = torch.autograd.grad(
                FlashAttention.apply(*leaves, True), leaves, do)
            rleaves = [t.detach().clone().requires_grad_(True)
                       for t in (q, k, v)]
            rgrads = torch.autograd.grad(
                ref.flash_attention_ref(*rleaves, causal=True), rleaves, do)
            torch.cuda.synchronize()
            auto = [check_close(f"FlashAttention autograd {n}", g, w)
                    for n, g, w in zip(("dq", "dk", "dv"), grads, rgrads)]
            del grads, rgrads, leaves, rleaves
            errs += auto
            line += (f"; autograd wrapper vs torch.autograd of the plain "
                     f"forward: dq {auto[0]:.3e} dk {auto[1]:.3e} dv "
                     f"{auto[2]:.3e}")
        ms = timed_ms(torch, lambda: bwd(q, k, v, o, lse, do, causal=True),
                      10)
        plain_ms = timed_ms(torch, lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, lse, do, True), 5)
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lib_ms = timed_ms(torch, lambda: torch.autograd.grad(
            sdpa_full(torch, F, ql, kl, vl, True), (ql, kl, vl), do), 10)
        bound = flash_bound_entry(
            *flash_bwd_bound(s, s, True, q.element_size()),
            bf16=dname == "bfloat16")
        line += (f" | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                 f"sdpa fwd+bwd {lib_ms:.4f} ms | bound {bound[0]:.4f} "
                 f"ms ({bound[1]})")
        if dname == "float32":
            out["flash_attention_bwd"] = row(max(errs), ms, plain_ms, bound,
                                             lib_ms)
        log(line)
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()


#: (rows, D): widths of the one-read variant with 4- or 2-byte copies (1,
#: 7, 2047), one and four warps a row (2048, 8192), and past it (20000, the
#: streaming variant); one row, an odd row count, the timed shape
RMS_CASES = [(r, d) for d in (1, 7, 2047, 2048, 8192, 20000)
             for r in (1, 4095, 4096)]


def rmsnorm_rows(torch, F, fn, ref, gen, dev):
    """The RMSNorm kernel ``fn`` at 4096 x 2048 in float32 and bfloat16:
    max abs error against the plain version, kernel and plain times,
    F.rms_norm's (the yardstick: the weight cast to x's dtype, as
    F.rms_norm takes it) and the bound (bytes: x read once, y written
    once, the weight). chip_ab.py runs it on both trees it compares."""
    out = {}
    w = 1 + 0.1 * torch.randn((RMS_D,), generator=gen, device=dev)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        x = torch.randn((RMS_R, RMS_D), generator=gen,
                        device=dev).to(dt)
        got = fn(x, w)
        torch.cuda.synchronize()
        tol = ATOL if dname == "float32" else BF16_TOL
        err = check_close(f"rmsnorm[R={RMS_R} {dname}]", got,
                          ref.rmsnorm_ref(x, w), tol)
        wd = w.to(dt)
        out[dname] = row(
            err, timed_ms(torch, lambda: fn(x, w)),
            timed_ms(torch, lambda: ref.rmsnorm_ref(x, w)),
            bound_entry(2 * x.numel() * x.element_size() + RMS_D * 4,
                        3 * x.numel()),
            timed_ms(torch, lambda: F.rms_norm(x, (RMS_D,), wd, 1e-5)))
    return out


def rmsnorm_kernel_phase(torch, F, K, ref, gen, dev, out):
    fn = K["rmsnorm"]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for rows, d in RMS_CASES:
        w = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
        for dname, tol in (("float32", ATOL), ("bfloat16", BF16_TOL)):
            dt = getattr(torch, dname)
            for offset in (0, 1):     # a contiguous view 1 element off 16
                base = torch.randn((rows * d + offset,), generator=gen,
                                   device=dev).to(dt)
                x = base[offset:].view(rows, d)
                got = fn(x, w)
                torch.cuda.synchronize()
                what = f"rmsnorm[R={rows} D={d} {dname} offset {offset}]"
                errs[dname] = max(errs[dname], check_close(
                    what, got, ref.rmsnorm_ref(x, w), tol))
                check_repeat(torch, what, lambda: fn(x, w), got)
    log(f"rmsnorm: {len(RMS_CASES) * 4} cases (D 1-20000, R 1/4095/4096, "
        f"both dtypes, aligned and 1 element off) within "
        f"{errs['float32']:.3e} float32 (tol {ATOL} + {RTOL}*|plain|), "
        f"{errs['bfloat16']:.3e} bfloat16 (tol {BF16_TOL}); each called "
        "twice, bitwise equal")
    rows = rmsnorm_rows(torch, F, fn, ref, gen, dev)
    for dname, r in rows.items():
        log(f"rmsnorm R={RMS_R} D={RMS_D} {dname}: max abs err "
            f"{r['max_abs_err']:.3e} | kernel {r['ms']:.5f} ms | plain "
            f"{r['plain_ms']:.4f} ms | F.rms_norm {r['library_ms']:.5f} ms "
            f"| bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    out["rmsnorm"] = dict(rows["float32"], max_abs_err=max(
        errs["float32"], rows["float32"]["max_abs_err"]))


# ------------------------------------------------------------------ phase 4
SERVE_ARGV = ["--arch", "tinyllama-1.1b", "--requests", "8", "--slots", "4",
              "--max-seq", "256", "--max-new", "16", "--prefill-chunk", "16",
              "--page-size", "16", "--policy", "chunked", "--device", "cuda",
              "--seed", "0"]
MAMBA_ARGV = ["--arch", "mamba2-1.3b"] + SERVE_ARGV[2:]

#: each serving path: its CLI and ``paged`` argument, the cache it must
#: serve on, the width it must run at, and which kernel runs once per
#: layer in which of its dispatches
PATHS = {
    "paged tinyllama-1.1b": dict(
        argv=SERVE_ARGV, paged=None, cache="paged", layers=22, d_model=2048,
        kernels={"paged_decode_attention": "decode_syncs",
                 "paged_prefill_attention": "prefill_dispatches"}),
    "contiguous tinyllama-1.1b": dict(
        argv=SERVE_ARGV, paged=False, cache="contiguous", layers=22,
        d_model=2048,
        kernels={"decode_attention": "decode_syncs",
                 "prefill_attention": "prefill_dispatches"}),
    "mamba2-1.3b": dict(
        argv=MAMBA_ARGV, paged=None, cache="contiguous", layers=48,
        d_model=2048,
        kernels={"ssd_chunk_scan": "prefill_dispatches"}),
}


def serve_phase(torch, serve, K, path):
    """A warm-up run (cuBLAS heuristics, lazy module loading: paid once per
    process and shape, not per request), then the measured run with every
    kernel's launch count set to 0 just before it and read just after."""
    spec = PATHS[path]
    t0 = time.monotonic()
    serve.main(spec["argv"], paged=spec["paged"])
    torch.cuda.synchronize()
    log(f"{path}: warm-up serve run (same trace) took "
        f"{time.monotonic() - t0:.2f}s")
    zero_counts(K)
    engine = serve.main(spec["argv"], paged=spec["paged"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in K.items()}
    st = engine.stats
    layers = engine.cfg.num_layers
    if engine.cfg.d_model != spec["d_model"] or layers != spec["layers"]:
        fail(f"{path}: served {engine.cfg.name} is not at full width")
    if engine.paged != (spec["cache"] == "paged"):
        fail(f"{path}: the engine did not serve on the {spec['cache']} "
             "cache")
    if len(engine.done) != 8 or any(len(r.tokens_out) != 16
                                    for r in engine.done):
        fail(f"{path}: {len(engine.done)}/8 requests finished with 16 "
             "tokens")
    for name, n in launches.items():
        stat = spec["kernels"].get(name)
        want = 0 if stat is None else layers * getattr(st, stat)
        if stat is not None and n <= 0:
            fail(f"{path}: {name} was launched {n} times on the serving "
                 "path")
        if n != want:
            fail(f"{path}: {name} launches {n} != {want}"
                 + (f" = {layers} x {getattr(st, stat)} {stat}"
                    if stat else ""))
    ttft = sorted(r.ttft for r in engine.done)
    tpot = sorted(r.tpot for r in engine.done)
    log(f"{path}: served 8/8 on {engine.cfg.name}: TTFT median "
        f"{ttft[len(ttft) // 2]:.4f}s max {ttft[-1]:.4f}s | TPOT median "
        f"{tpot[len(tpot) // 2]:.5f}s max {tpot[-1]:.5f}s | launches "
        f"{ {k: launches[k] for k in spec['kernels']} }")
    log(f"{path}: EngineStats {json.dumps(dataclasses.asdict(st))}")
    return engine, {k: launches[k] for k in spec["kernels"]}


def profile_dispatches(torch, what, calls, n=10):
    """Host wall time per dispatch, the device time the profiler sees in
    the same calls, and the kernels that take most of it (``n`` calls
    each, after warm-up)."""
    from torch.profiler import ProfilerActivity, profile
    for name, fn in calls.items():
        for _ in range(min(n, 3)):
            fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            # device-side events only: the CPU ops that launched them carry
            # the same time again
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if t > 0:
                rows.append((t / n / 1e3, e.count // n, e.key))
        rows.sort(reverse=True)
        dev_ms = sum(r[0] for r in rows)
        log(f"profile {what} {name} (full width, B={B}): host wall "
            f"{wall_ms:.3f} ms/dispatch, device busy {dev_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f}% of wall), "
            f"{sum(r[1] for r in rows)} kernels")
        # the eight largest, then the repository's own kernels below them
        for i, (t, cnt, key) in enumerate(rows):
            if i < 8 or "(anonymous namespace)" in key:
                log(f"  {t:.4f} ms  x{cnt}  {key[:90]}")


def dispatch_inputs(torch, vocab, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    ln = torch.tensor([40, 50, 60, 63], dtype=torch.int32, device=dev)
    act = torch.ones((B,), dtype=torch.bool, device=dev)
    tok1 = torch.randint(0, vocab, (B, 1), generator=gen, device=dev,
                         dtype=torch.int32)
    tokc = torch.randint(0, vocab, (B, C), generator=gen, device=dev,
                         dtype=torch.int32)
    return ln, act, tok1, tokc


def profile_phase(torch, paged_engine, mamba_engine):
    """Where one full-width dispatch spends its time: a decode step and a
    16-token prefill chunk (4 rows, 40-63 cached tokens) on the paged
    tinyllama path and on mamba2."""
    dev = torch.device("cuda")
    model, params = paged_engine.model, paged_engine.params
    cache = model.init_paged_cache(1 + 4 * NB, PAGE, B, S)
    bt = torch.arange(1, 1 + B * NB, dtype=torch.int32,
                      device=dev).reshape(B, NB)
    ln, act, tok1, tokc = dispatch_inputs(torch, paged_engine.cfg.vocab_size,
                                          dev)
    profile_dispatches(torch, "paged tinyllama-1.1b", {
        "decode step": lambda: model.decode_step_paged(
            params, cache, tok1, ln, bt, act),
        "prefill chunk": lambda: model.prefill_chunk_paged(
            params, cache, tokc, ln, bt, act, None),
    })
    model, params = mamba_engine.model, mamba_engine.params
    cache = model.init_cache(B, S)
    ln, act, tok1, tokc = dispatch_inputs(torch, mamba_engine.cfg.vocab_size,
                                          dev)
    profile_dispatches(torch, "mamba2-1.3b", {
        "decode step": lambda: model.decode_step(params, cache, tok1, ln,
                                                 act),
        "prefill chunk": lambda: model.prefill_chunk(params, cache, tokc, ln,
                                                     act, None),
    })


CARD_VS_CPU_ATOL = {"float32": 1e-3, "bfloat16": 2e-2}


def card_vs_cpu(torch, what, run, card_params):
    """One prefill chunk and one decode step at full width, on the card and
    on the CPU path, from the same weights, with the cache in float32 and
    in the serving dtype bfloat16. With float32 caches both sides compute
    in float32 and differ only in summation order. A bfloat16 cache rounds
    each cached value once; a value within float32 noise of a rounding tie
    lands on the other side on one device, and the layers carry that
    1-ulp (0.4%) step to the logits — its size is printed beside the size
    of the whole bfloat16-vs-float32 storage effect on the CPU."""
    t0 = time.monotonic()
    cpu_params = _tree(card_params, lambda t: t.cpu())
    cpu = {}
    for name in ("float32", "bfloat16"):
        cache_dtype = getattr(torch, name)
        card = run(card_params, torch.device("cuda"), cache_dtype)
        cpu[name] = run(cpu_params, torch.device("cpu"), cache_dtype)
        if not torch.isfinite(card).all():
            fail(f"{what}: card logits are not finite ({name} cache)")
        err = (card - cpu[name]).abs().max().item()
        if err > CARD_VS_CPU_ATOL[name]:
            fail(f"{what}: card vs CPU logits differ by {err:.3e} > "
                 f"{CARD_VS_CPU_ATOL[name]} ({name} cache)")
        log(f"card vs CPU, {what}, prefill chunk + decode step, {name} "
            f"cache: max abs logit err {err:.3e} (tol "
            f"{CARD_VS_CPU_ATOL[name]}; |logits| <= "
            f"{cpu[name].abs().max().item():.3f})")
    effect = (cpu["bfloat16"] - cpu["float32"]).abs().max().item()
    log(f"{what}: bfloat16-vs-float32 cache on the CPU alone moves logits "
        f"by up to {effect:.3e}; checks took {time.monotonic() - t0:.1f}s")


def step_inputs(torch, vocab):
    """A 16-token prefill chunk of 4 rows (row 2 tail-padded to 9 real
    tokens) from an empty cache, then a decode step with row 3 idle."""
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, vocab, (B, C), generator=gen,
                           dtype=torch.int32)
    valid = torch.tensor([C, C, 9, C], dtype=torch.int32)
    nxt = torch.randint(0, vocab, (B, 1), generator=gen, dtype=torch.int32)
    act_dec = torch.tensor([True, True, True, False])
    return tokens, valid, nxt, act_dec


def real_logits(torch, pf, dec, valid, act_dec):
    """Real tokens only: prefill pads and the inactive decode row compute
    garbage that the engine discards."""
    keep = [pf[i, :valid[i]] for i in range(B)]
    keep += [dec[i:i + 1] for i in range(B) if act_dec[i]]
    return torch.cat(keep).float().cpu()


def card_vs_cpu_phase(torch, paged_engine, contiguous_engine, mamba_engine):
    from repro_torch.models import mamba_lm, transformer
    zeros = torch.zeros((B,), dtype=torch.int32)
    act_pf = torch.ones((B,), dtype=torch.bool)

    cfg = paged_engine.cfg
    tokens, valid, nxt, act_dec = step_inputs(torch, cfg.vocab_size)
    bt = torch.zeros((B, NB), dtype=torch.int32)
    bt[:, :2] = torch.arange(1, 2 * B + 1, dtype=torch.int32).reshape(B, 2)

    def paged(params, dev, cache_dtype):
        cache = transformer.init_paged_cache(cfg, 2 * B + 1, PAGE, dev,
                                             cache_dtype)
        on = (lambda t: t.to(dev))
        pf, _ = transformer.prefill_chunk_paged(
            params, cache, on(tokens), on(zeros), on(bt), cfg, on(act_pf),
            on(valid))
        dec, _ = transformer.decode_step_paged(
            params, cache, on(nxt), on(valid), on(bt), cfg, on(act_dec))
        return real_logits(torch, pf, dec, valid, act_dec)

    def contiguous(params, dev, cache_dtype):
        cache = transformer.init_cache(cfg, B, 4 * C, dev, cache_dtype)
        on = (lambda t: t.to(dev))
        pf, _ = transformer.prefill_chunk(params, cache, on(tokens),
                                          on(zeros), cfg, on(act_pf),
                                          on(valid))
        dec, _ = transformer.decode_step(params, cache, on(nxt), on(valid),
                                         cfg, on(act_dec))
        return real_logits(torch, pf, dec, valid, act_dec)

    card_vs_cpu(torch, "paged tinyllama-1.1b", paged, paged_engine.params)
    card_vs_cpu(torch, "contiguous tinyllama-1.1b", contiguous,
                contiguous_engine.params)

    # mamba2 at full width, cut to its first 8 layers on both sides
    mcfg = dataclasses.replace(mamba_engine.cfg, num_layers=8)
    mtok, mvalid, mnxt, mact = step_inputs(torch, mcfg.vocab_size)
    mparams = dict(mamba_engine.params)
    mparams["layers"] = _tree(mamba_engine.params["layers"],
                              lambda t: t[:mcfg.num_layers])

    def mamba(params, dev, cache_dtype):
        cache = mamba_lm.init_cache(mcfg, B, dev, cache_dtype)
        on = (lambda t: t.to(dev))
        pf, _ = mamba_lm.prefill_chunk(params, cache, on(mtok), on(zeros),
                                       mcfg, on(act_pf), on(mvalid))
        dec, _ = mamba_lm.decode_step(params, cache, on(mnxt), on(mvalid),
                                      mcfg, on(mact))
        return real_logits(torch, pf, dec, mvalid, mact)

    card_vs_cpu(torch, "mamba2-1.3b (8 of 48 layers)", mamba, mparams)


def _tree(node, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in node.items()}


# ------------------------------------------------------------------ phase 5
def zero_counts(K) -> None:
    for fn in K.values():
        fn.launches = 0


def check_launches(K, path, want: dict) -> dict:
    """Each kernel's launches since zero_counts: exactly ``want`` (0 for
    a kernel not named) and at least one for each named kernel."""
    got = {name: fn.launches for name, fn in K.items()}
    for name, n in got.items():
        if n != want.get(name, 0) or (name in want and n <= 0):
            fail(f"{path}: {name} launches {n} != {want.get(name, 0)}")
    log(f"{path}: launches {want} as expected")
    return {k: got[k] for k in want}


def rmsnorm_path_phase(torch, K):
    """The kernel's one entry point, ops.fused_rmsnorm (no model calls it,
    in the JAX package or here), on activations of the training shape:
    4 x 1024 rows of tinyllama's 2048, float32 then bfloat16."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((B, TRAIN_S, 2048), generator=gen, device=dev)
    w = 1 + 0.1 * torch.randn((2048,), generator=gen, device=dev)
    zero_counts(K)
    ys = [ops.fused_rmsnorm(x, w), ops.fused_rmsnorm(x.bfloat16(), w)]
    torch.cuda.synchronize()
    counts = check_launches(K, "ops.fused_rmsnorm", {"rmsnorm": 2})
    for y, tol in zip(ys, (ATOL, BF16_TOL)):
        check_close("ops.fused_rmsnorm", y, ref.rmsnorm_ref(
            x.to(y.dtype), w), tol)
    return counts


PREFILL_S, DECODE_STEPS = 2048, 16
# 8 steps: at full width 4 steps of the CLI's default schedule (lr 1e-3,
# 10 warm-up steps) do not lower the loss — the batches share almost no
# tokens (4 x 1024 of 32000), so only the output scale is learnt, and it
# takes the warm-up a few more steps than batch-to-batch noise (+-0.015)
TRAIN_S, TRAIN_STEPS = 1024, 8
TRAIN_ARGV = ["--arch", "tinyllama-1.1b", "--steps", str(TRAIN_STEPS),
              "--batch", str(B), "--seq", str(TRAIN_S), "--remat", "full",
              "--device", "cuda", "--seed", "0"]
#: card vs CPU gradients: per leaf, within this fraction of the leaf's
#: largest CPU gradient (float32 on both sides, summed in other orders)
GRAD_TOL = 1e-3


def tinyllama(torch, layers=None):
    """Full-width tinyllama-1.1b on the card with random float32 weights
    from seed 0, optionally cut to its first ``layers`` layers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.factory import build_model
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    if layers is None:
        return model, params
    cut = build_model(dataclasses.replace(cfg, num_layers=layers), "cuda")
    params["layers"] = _tree(params["layers"],
                             lambda t: t[:layers].clone())
    return cut, params


def prefill_phase(torch, K):
    """make_prefill_step on B x 2048 prompt tokens at full width, then 16
    greedy decode steps on the cache it returns (the contiguous decode
    kernel): one warm-up run, then the measured run between zero_counts
    and the count check; then the prefill and the last decode step
    profiled."""
    from repro_torch.training.train_step import (make_prefill_step,
                                                 make_serve_step)
    model, params = tinyllama(torch)
    cfg, dev = model.cfg, torch.device("cuda")
    prefill_step = make_prefill_step(model, PREFILL_S + DECODE_STEPS)
    serve_step = make_serve_step(model)
    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (B, PREFILL_S), generator=gen,
                           device=dev, dtype=torch.int32)

    def run():
        t0 = time.monotonic()
        logits, cache = prefill_step(params, {"tokens": tokens})
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t_prefill = time.monotonic() - t0
        if not torch.isfinite(logits).all():
            fail("prefill: non-finite logits")
        for key in ("k", "v"):
            if (cache[key].shape[2] != PREFILL_S + DECODE_STEPS + 1
                    or torch.any(cache[key][:, :, PREFILL_S:] != 0)):
                fail("prefill: the cache is not the contiguous layout with "
                     "zeros past the prompt")
        del logits
        lengths = torch.full((B,), PREFILL_S, dtype=torch.int32, device=dev)
        steps = []
        for i in range(DECODE_STEPS):
            t0 = time.monotonic()
            lg, cache = serve_step(params, cache, tok, lengths + i)
            tok = lg.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            steps.append(time.monotonic() - t0)
        if not torch.isfinite(lg).all():
            fail("decode after prefill: non-finite logits")
        return t_prefill, steps, cache, tok, lengths + DECODE_STEPS - 1

    run()
    zero_counts(K)
    t_prefill, steps, cache, tok, last = run()
    counts = check_launches(K, "prefill + decode", {
        "flash_attention": cfg.num_layers,
        "decode_attention": cfg.num_layers * DECODE_STEPS})
    profile_dispatches(torch, "tinyllama-1.1b", {
        f"prefill ({B} x {PREFILL_S} tokens)":
            lambda: prefill_step(params, {"tokens": tokens})}, n=3)
    # the last step again (it rewrites the position it wrote)
    profile_dispatches(torch, "tinyllama-1.1b", {
        f"decode step ({B} rows of {PREFILL_S + DECODE_STEPS - 1} cached "
        "tokens)": lambda: serve_step(params, cache, tok, last)})
    steps.sort()
    log(f"prefill + decode (tinyllama-1.1b, B={B}, {PREFILL_S}-token "
        f"prompts, float32 weights): prefill {t_prefill:.4f} s "
        f"({B * PREFILL_S / t_prefill:.0f} prompt tokens/s); decode step "
        f"median {steps[len(steps) // 2] * 1e3:.2f} ms, max "
        f"{steps[-1] * 1e3:.2f} ms")
    del params, cache
    torch.cuda.empty_cache()
    return counts


def train_phase(torch, K):
    """repro_torch.launch.train at full width: 8 AdamW steps, B x 1024
    tokens, remat full — the forward kernel runs twice a layer a step
    (forward, and recompute in the backward), the backward kernel once."""
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(K)
    run = train.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    layers = 22
    counts = check_launches(K, "train", {
        "flash_attention": 2 * layers * TRAIN_STEPS,
        "flash_attention_bwd": layers * TRAIN_STEPS})
    if not all(math.isfinite(x) for x in run.losses):
        fail(f"train: non-finite losses {run.losses}")
    if not run.losses[-1] < run.losses[0]:
        fail(f"train: loss did not decrease {run.losses}")
    warm = sorted(run.step_seconds[1:])
    step_s = warm[len(warm) // 2]
    log(f"train (tinyllama-1.1b full width, AdamW float32, B={B} x "
        f"{TRAIN_S}, remat full): losses {run.losses}; step seconds "
        f"{[round(x, 4) for x in run.step_seconds]} (first includes "
        f"warm-up); median of the rest {step_s:.4f} s = "
        f"{B * TRAIN_S / step_s:.0f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del run
    torch.cuda.empty_cache()
    # where a step's device time goes: the same step, outside the counted
    # run
    from repro_torch.training.optimizer import OptimizerConfig, adamw_init
    from repro_torch.training.train_step import make_train_step
    model, params = tinyllama(torch)
    _, step = make_train_step(
        model, OptimizerConfig(lr=1e-3, warmup_steps=10), remat="full")
    state = (params, adamw_init(params))
    batch = {"tokens": torch.randint(
        0, model.cfg.vocab_size, (B, TRAIN_S), dtype=torch.int32,
        generator=torch.Generator().manual_seed(2))}
    profile_dispatches(torch, "tinyllama-1.1b", {
        f"train step ({B} x {TRAIN_S}, remat full)":
            lambda: step(*state, batch)}, n=2)
    del model, params, state
    torch.cuda.empty_cache()
    return counts


def _grad_tree(torch, model, params, batch):
    """(loss, gradient tree) of model.loss_fn at ``params`` (copied)."""
    from repro_torch.training.tree import (tree_leaves, tree_map,
                                           tree_unflatten)
    tree = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(tree)
    loss = model.loss_fn(tree, batch, remat="full")
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(tree, list(grads))


def _leaf_errors(torch, card, cpu, absolute=()):
    """Per leaf: max |card - cpu| over max |cpu| — or, for leaves whose
    path starts with one of ``absolute``, the max abs difference itself."""
    from repro_torch.models.convert import flat_from_tree
    fc, fh = flat_from_tree(card), flat_from_tree(cpu)
    out = {}
    for k, want in fh.items():
        scale = (1.0 if k.startswith(tuple(absolute))
                 else max(float(abs(want).max()), 1e-30))
        out[k] = float(abs(fc[k].astype("float64") - want).max()) / scale
    return out


def training_card_vs_cpu_phase(torch):
    """tinyllama-1.1b at full width cut to 2 layers: forward logits
    (S = 256) and loss_fn gradients (batch 1 x 256) on the card against
    the CPU path from the same weights; then a checkpoint written on the
    card restores on the CPU and one more AdamW step agrees."""
    import shutil

    from repro_torch.models import transformer
    from repro_torch.models.factory import build_model
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.optimizer import OptimizerConfig, adamw_init
    from repro_torch.training.train_step import make_train_step
    t0 = time.monotonic()
    model, params = tinyllama(torch, layers=2)
    cfg = model.cfg
    cpu_model = build_model(cfg, "cpu")
    cpu_params = _tree(params, lambda t: t.cpu())
    gen = torch.Generator().manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                           dtype=torch.int32)
    with torch.no_grad():
        card = transformer.forward(params, tokens.cuda(), cfg,
                                   remat="none")[0].cpu()
        cpu = transformer.forward(cpu_params, tokens, cfg, remat="none")[0]
    err = (card - cpu).abs().max().item()
    if not torch.isfinite(card).all() or err > CARD_VS_CPU_ATOL["float32"]:
        fail(f"forward card vs CPU logits differ by {err:.3e}")
    log(f"card vs CPU, forward (2 of 22 layers, 2 x 256 tokens): max abs "
        f"logit err {err:.3e} (tol {CARD_VS_CPU_ATOL['float32']}; |logits|"
        f" <= {cpu.abs().max().item():.3f})")

    data = SyntheticTokens(DataConfig(cfg.vocab_size, 256, 1, seed=0))
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    lc, gc_ = _grad_tree(torch, model, params,
                         {k: v.cuda() for k, v in batch.items()})
    lh, gh = _grad_tree(torch, cpu_model, cpu_params, batch)
    errs = _leaf_errors(torch, gc_, gh)
    worst = max(errs, key=errs.get)
    if abs(lc.item() - lh.item()) > 1e-4 or errs[worst] > GRAD_TOL:
        fail(f"loss_fn card vs CPU: loss {lc.item()} vs {lh.item()}, "
             f"gradient {worst} off by {errs[worst]:.3e} of its max")
    log(f"card vs CPU, loss_fn gradients (2 layers, 1 x 256): loss "
        f"{lc.item():.6f} vs {lh.item():.6f}; worst leaf {worst} within "
        f"{errs[worst]:.3e} of its largest gradient (tol {GRAD_TOL})")
    del gc_, gh

    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=10)
    _, card_step = make_train_step(model, opt_cfg, remat="full")
    _, cpu_step = make_train_step(cpu_model, opt_cfg, remat="full")
    state = card_step(params, adamw_init(params), data.batch(0))[:2]
    ckdir = ROOT / "chip_smoke_ckpt"
    try:
        CheckpointManager(str(ckdir), device="cuda").save(1, state)
        step, restored, _ = CheckpointManager(str(ckdir),
                                              device="cpu").restore()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    *card_next, mc = card_step(*state, data.batch(1))
    *cpu_next, mh = cpu_step(*restored, data.batch(1))
    # the moments within GRAD_TOL of each leaf's largest value; the weights
    # within twice the step's learning rate: AdamW moves a weight by about
    # lr whatever its gradient's size, so where a gradient is within
    # rounding of 0 the two sides may step it either way
    lr2 = float(mc["lr"])
    errs = _leaf_errors(torch, tuple(card_next), tuple(cpu_next),
                        absolute=("__T0/", "__T1/master/"))
    weights = {k: e for k, e in errs.items()
               if k.startswith(("__T0/", "__T1/master/"))}
    moments = {k: e for k, e in errs.items() if k not in weights}
    w_worst = max(weights, key=weights.get)
    m_worst = max(moments, key=moments.get)
    dl = abs(mc["loss"].item() - mh["loss"].item())
    if (step != 1 or dl > 1e-4 or weights[w_worst] > 2 * lr2
            or moments[m_worst] > GRAD_TOL):
        fail(f"checkpoint card -> CPU: next-step loss off by {dl:.3e}, "
             f"{w_worst} by {weights[w_worst]:.3e} (lr {lr2:.1e}), "
             f"{m_worst} by {moments[m_worst]:.3e} of its max")
    log(f"checkpoint saved on the card, restored on the CPU: the next AdamW "
        f"step's loss agrees within {dl:.3e}; every weight within "
        f"{weights[w_worst]:.3e} ({w_worst}; tol 2 x lr = {2 * lr2:.1e}), "
        f"every moment within {moments[m_worst]:.3e} of its largest value "
        f"({m_worst}; tol {GRAD_TOL}); checks took "
        f"{time.monotonic() - t0:.1f}s")
    del model, params, state, card_next
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- main
KERNELS = {
    "paged_decode_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention.py:91"),
    "paged_prefill_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        replaces="src/repro/kernels/paged_prefill_attention.py:80"),
    "decode_attention": dict(
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:93"),
    "prefill_attention": dict(
        source="src/repro_torch/kernels/csrc/prefill_attention.cu",
        replaces="src/repro/kernels/prefill_attention.py:106"),
    "ssd_chunk_scan": dict(
        source="src/repro_torch/kernels/csrc/ssd_chunk_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:55"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:73"),
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="none: no TPU counterpart (the JAX package cannot "
                 "differentiate its Pallas flash kernel and trains on its "
                 "jnp lowering, src/repro/models/transformer.py:123)"),
    "rmsnorm": dict(
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:19"),
}


def wrappers():
    """Each kernel's wrapper (it carries the kernel's launch count)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.paged_prefill_attention import \
        paged_prefill_attention
    from repro_torch.kernels.prefill_attention import prefill_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    return {"paged_decode_attention": paged_decode_attention,
            "paged_prefill_attention": paged_prefill_attention,
            "decode_attention": decode_attention,
            "prefill_attention": prefill_attention,
            "ssd_chunk_scan": ssd_chunk_scan,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "rmsnorm": rmsnorm}


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def main() -> None:
    import torch
    smi_line = device_phase(torch)
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ref
    from repro_torch.launch import serve

    t_start = time.monotonic()
    resolve_device("cuda")            # TF32 off for every float32 matmul
    build_phase(build)
    K = wrappers()
    measured = kernel_phase(torch, F, K, ref)
    engines, launches = {}, {}
    for path in PATHS:
        engines[path], counts = serve_phase(torch, serve, K, path)
        add_counts(launches, counts)
    profile_phase(torch, engines["paged tinyllama-1.1b"],
                  engines["mamba2-1.3b"])
    card_vs_cpu_phase(torch, *engines.values())
    del engines
    torch.cuda.empty_cache()
    add_counts(launches, rmsnorm_path_phase(torch, K))
    add_counts(launches, prefill_phase(torch, K))
    add_counts(launches, train_phase(torch, K))
    training_card_vs_cpu_phase(torch)
    log(f"all phases passed in {time.monotonic() - t_start:.1f}s")

    rows = [dict(name=name, route="cuda", **KERNELS[name],
                 launches=launches[name], **measured[name])
            for name in KERNELS]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
