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
                again (one helper for every geometry) at each geometry the
                scenario phase runs them at, bf16 pools: the Scenario
                vehicle (4 heads of 16 over 2 KV heads, chunk 8) at the
                tuned pages 64, 128 and 256, and full-width tinyllama-1.1b
                at chunk 8 and page 256: rows shorter than a page, across
                pages and across the whole table;
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
              * the vlm, moe, hybrid and encdec families' geometry
                (FAMILY_SHAPES): paged and contiguous decode / prefill at
                chameleon-34b (64 heads over 8 KV heads of 128),
                moonshot-v1-16b-a3b (16 over 16 of 128), jamba-v0.1-52b
                (32 over 8 of 128) and seamless-m4t-large-v2 (16 over 16
                of 64) at chunk and page 16 over 256 positions, and the
                reduced configs' 4 over 4 of 16 at chunk 8, page 64; the
                SSD at jamba's widths (128 heads of 64, state 128; Q 16,
                13, 1, 256) and the reduced configs' (8 heads of 16, state
                16); the flash forward at every geometry the families'
                forward and prefill run it at (FAMILY_FLASH, f32): the
                seamless encoder without the mask (4 x 1000 frames, 16
                heads of 64; timed beside SDPA) and decoder (causal, S 64
                and 63), and the reduced configs' (S 24, 16 and 10, 4 heads
                of 16 over 2 or 4 KV heads, causal or not); each called
                twice, bitwise equal;
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
   hints    — the hint layer (repro_torch.distributed.hints): (a) the
              int8-KV path, tinyllama-1.1b at full width under
              kv_cache_dtype="int8" through the same CLI and trace (the
              engine takes the contiguous cache of int8 keys and values
              with bf16 scales; kernels #3 and #4 read it dequantized to
              float32, a dtype phase 3 checks at this geometry), launches
              exact, its cache's bytes against the bf16 cache's
              ((64 + 2) / 128 exactly), TTFT and TPOT beside phase 4's
              bf16 contiguous path, a decode step and a prefill chunk of
              each cache profiled; then kernels #3 and #4 at the reduced
              config's contiguous geometry on float32 caches, and the
              reduced config served under the hint on the card and the
              CPU (6 requests, mixed): equal token streams; (b) kernel #6
              and its backward at one query head a KV head (the
              attn_impl="repeat_kv" geometry: 32 heads of 64 over 32, S
              2048 causal in float32 and bfloat16, and 1 x 256 float32)
              against their plain versions, the forward timed beside the
              grouped call (KV 4), its plain version and SDPA; then 2
              AdamW steps at full width cut to 2 layers under
              best_hints(cfg, "train") (repeat_kv, bf16 flash logits,
              remat dots), launches exact, each loss within 1e-4 of the
              CPU's from the same weights.
   families — the same CLI and trace at full width on the vlm, moe,
              hybrid and encdec families, one at a time, each cut in depth
              only as far as one card forces and the cut printed:
              chameleon-34b (4 of 48 layers), moonshot-v1-16b-a3b (4 of
              48), jamba-v0.1-52b (one period: 8 of 32 sublayers, 1
              attention, 4 MoE of 16 experts; 53 GB of float32 weights) and
              seamless-m4t-large-v2 (all 24 + 24 layers) on the paged pool,
              all but chameleon under policy mixed; launches exactly as
              EngineStats and the prefill plans dictate (jamba: the SSD
              once an SSD sublayer a prefill dispatch; seamless: decode
              attention once a decoder layer a decode step and a step of
              its token-stepped prefill, a multi-slot dispatch stepping its
              widest row), at a geometry phase 3 checked, and the MoE
              paths' multi-slot plans falling back to per-slot
              dispatches; a decode step and a prefill chunk of each
              profiled, the MoE FFN's share printed. Then seamless whole
              at full width: the encoder on 4 x 1000 frames (flash
              without the mask, once a layer), the teacher-forced forward,
              prefill and a decode step that must match the forward's
              last position (2e-2 of the largest logit: the bf16 cache).
              Then each new family's reduced config (chameleon, moonshot,
              kimi, jamba, seamless) on the card and on the CPU from one
              set of weights: forward logits within 1e-3 (vlm embeds and
              enc-dec frames included; every flash forward at a FAMILY_FLASH
              geometry), and 6 requests served under mixed with equal token
              streams (seamless's through multi-slot dispatches with padded
              rows).
   scenario — the paper's three-app concurrent workload (chatbot 2,
              imagegen 2, live_captions 5 requests; 256 chips of the
              simulated tpu-v5e) as a repro_torch.bench.Scenario through
              engine_runner.run_scenario_on_engine: (a) the five fig5
              policies on the reference vehicle (tinyllama-1.1b reduced, 2
              layers, its pages tuned), on the card and again on the CPU in
              this process: the two result documents and every engine's
              token streams must be equal, the vehicle's weights on the
              card must equal the CPU's bit for bit, and one prefill chunk
              and decode step of it at page 256 must agree with the CPU's
              logits within phase 4's tolerances; (b)
              slo_aware at full tinyllama-1.1b width (the runner's
              engine_model substituted here): per-app latencies, SLO
              attainment and makespan must equal (a)'s, other differing
              fields are printed, and 10 steps are profiled for the
              device's idle share. Each run between a zero of the launch
              counts and an exact check: layers x decode dispatches of
              paged decode, layers x prefill dispatches of paged prefill;
              every engine at a geometry that phase 3 checked.
              The Scenario seconds are the virtual clock's (the simulated
              chip's model), not a measurement of the card.
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

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
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


@dataclasses.dataclass(frozen=True)
class PagedShape:
    """A geometry of the paged kernels, on B rows over a pool of POOL
    pages: query heads, KV heads, head dim, prefill chunk, page and
    block-table entries a row."""
    label: str
    h: int
    kv: int
    d: int
    c: int
    page: int
    nb: int

    @property
    def cap(self) -> int:
        return self.page * self.nb


#: the serving paths' geometry (phase 4)
SERVING = PagedShape("serving", H, KV, D, C, PAGE, NB)
#: every geometry the scenario phase runs the paged kernels at: the
#: runner's vehicle (engine_runner.engine_model: tinyllama-1.1b reduced to
#: 2 layers, 4 heads of 16 over 2 KV heads, chunk 8) at the pages the tuner
#: picks for it without a page budget (64 at max-seq 64, 128 at 128, 256
#: from 256 on; up to 5 table entries, static's max-seq 1088), and
#: full-width tinyllama-1.1b at chunk 8 and page 256 (max-seq 896: 4
#: entries); scenario_phase fails on an engine at any other geometry
SCENARIO_SHAPES = [PagedShape(f"vehicle, page {p}", 4, 2, 16, 8, p, 5)
                   for p in (64, 128, 256)] + [
    PagedShape("full width, page 256", H, KV, D, 8, 256, 4)]
#: the vlm, moe, hybrid and encdec families' serving geometry at full width
#: (phase 4: chunk and page 16, max-seq 256; the contiguous kernels over
#: the table's 256 positions), and the reduced configs' where no vehicle
#: shape covers it (card vs CPU: 4 heads of 16 over 4 KV heads, chunk 8,
#: page 64, max-seq 64)
FAMILY_SHAPES = [PagedShape("chameleon-34b", 64, 8, 128, C, PAGE, NB),
                 PagedShape("moonshot-v1-16b-a3b", 16, 16, 128, C, PAGE, NB),
                 PagedShape("jamba-v0.1-52b", 32, 8, 128, C, PAGE, NB),
                 PagedShape("seamless-m4t-large-v2", 16, 16, 64, C, PAGE,
                            NB),
                 PagedShape("reduced, KV 4", 4, 4, 16, 8, 64, 5)]
PAGED_SHAPES = [SERVING, *SCENARIO_SHAPES, *FAMILY_SHAPES]
#: the SSD widths (heads, head dim, state) phase 3 checks: mamba2-1.3b's,
#: jamba-v0.1-52b's, and the reduced configs' (SSD_CASES)
SSD_WIDTHS = [(SSD_H, SSD_P, SSD_N), (128, 64, 128), (8, 16, 16)]
#: the seamless encoder's attention: B rows of ENC_T frames (20 s of audio
#: at 50 frames a second), 16 heads of 64, no mask
ENC_T, ENC_H, ENC_D = 1000, 16, 64
#: the seamless whole-prompt path: B requests of ENC_T frames and
#: SEAMLESS_S target tokens
SEAMLESS_S = 64


@dataclasses.dataclass(frozen=True)
class FlashShape:
    """A geometry of the flash forward in float32: rows, sequence (queries
    and keys), the mask, query heads, KV heads and head dim."""
    label: str
    b: int
    s: int
    causal: bool
    h: int
    kv: int
    d: int


#: every geometry the families' forward and prefill run the flash forward
#: at: the seamless encoder (no mask) and decoder (the forward over
#: SEAMLESS_S tokens, the prefill over all but the last) at full width, and
#: the reduced configs' forwards on the card (2 rows of 24 tokens, of 16
#: embeddings for vlm, of 10 frames for the enc-dec encoder; 4 heads of 16
#: over 2 or 4 KV heads); flash_geometry fails on any other
FAMILY_FLASH = [
    FlashShape("seamless encoder", B, ENC_T, False, ENC_H, ENC_H, ENC_D),
    FlashShape("seamless decoder, forward", B, SEAMLESS_S, True, 16, 16, 64),
    FlashShape("seamless decoder, prefill", B, SEAMLESS_S - 1, True, 16, 16,
               64),
    FlashShape("reduced, KV 2", 2, 24, True, 4, 2, 16),
    FlashShape("reduced vlm embeds, KV 2", 2, 16, True, 4, 2, 16),
    FlashShape("reduced, KV 4", 2, 24, True, 4, 4, 16),
    FlashShape("reduced encoder", 2, 10, False, 4, 4, 16)]


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


def make_pool(torch, gen, dev, need_pages, pool_dtype, page=PAGE, kv=KV,
              d=D, nb=NB):
    """Pools with garbage in the sentinel page 0 and past every row's
    valid positions; row i maps ``need_pages[i]`` distinct real pages (the
    rest of its ``nb``-entry table is sentinel)."""
    k = torch.randn((POOL, page, kv, d), generator=gen, device=dev)
    v = torch.randn((POOL, page, kv, d), generator=gen, device=dev)
    k[0], v[0] = 50.0, -50.0
    ids = torch.randperm(POOL - 1, generator=gen, device=dev) + 1
    bt = torch.zeros((B, nb), dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(need_pages):
        bt[i, :n] = ids[at:at + n].to(torch.int32)
        at += n
    return k.to(pool_dtype), v.to(pool_dtype), bt


def make_cache(torch, gen, dev, filled, cache_dtype, kv=KV, d=D, s=S):
    """Model-layout caches (B, s + 1, KV, d) — the serving cache with its
    drop position — holding garbage from position ``filled[i]`` of row i
    on, drop position included; returns the head-major (B, KV, s, d) views
    of the first s positions that the kernels read in place."""
    k = torch.randn((B, s + 1, kv, d), generator=gen, device=dev)
    v = torch.randn((B, s + 1, kv, d), generator=gen, device=dev)
    for i, n in enumerate(filled):
        k[i, n:], v[i, n:] = 50.0, -50.0
    k, v = k.to(cache_dtype), v.to(cache_dtype)
    return k[:, :s].transpose(1, 2), v[:, :s].transpose(1, 2)


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
    for d in sorted({16, 80, 256} | {p.d for p in PAGED_SHAPES}):
        for kv_elt in (2, 4):
            for g in sorted({1, 32} | {p.h // p.kv for p in PAGED_SHAPES}):
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


def paged_decode_case(torch, K, ref, gen, dev, shape, lengths, pool_dtype):
    """Kernel #1 at ``shape`` on rows of ``lengths`` (a row of length 0 is
    idle: its table is all sentinel, and the kernel must give 0), against
    its plain version, and called twice (bitwise equal). Returns the max abs
    error and the call's inputs (q, k, v, tables, lengths)."""
    need = [math.ceil(n / shape.page) for n in lengths]
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((B, shape.h, shape.d), generator=gen, device=dev)
    k, v, bt = make_pool(torch, gen, dev, need, pool_dtype, page=shape.page,
                         kv=shape.kv, d=shape.d, nb=shape.nb)
    call = functools.partial(K["paged_decode_attention"], q, k, v, bt, ln,
                             rope_theta=ROPE_THETA)
    got = call()
    want = ref.paged_decode_attention_ref(q, k, v, bt, ln,
                                          rope_theta=ROPE_THETA)
    torch.cuda.synchronize()
    name = f"paged_decode_attention[{shape.label}, pools={pool_dtype}]"
    active = [i for i, n in enumerate(lengths) if n > 0]
    err = check_close(name, got[active], want[active])
    if not all(torch.all(got[i] == 0) for i, n in enumerate(lengths)
               if n == 0):
        fail(f"{name}: a length-0 row must give 0")
    check_repeat(torch, name, call, got)
    return err, (q, k, v, bt, ln)


def paged_prefill_case(torch, K, ref, gen, dev, shape, starts, pool_dtype):
    """Kernel #2 at ``shape``: a chunk of ``shape.c`` tokens a row from
    ``starts``, against its plain version, and called twice (bitwise
    equal). Returns the max abs error and the call's inputs (q, k, v,
    tables, starts)."""
    need = [math.ceil((s + shape.c) / shape.page) for s in starts]
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    # model layout (B, C, H, d) seen head-major, as ops passes it
    qc = torch.randn((B, shape.c, shape.h, shape.d), generator=gen,
                     device=dev).transpose(1, 2)
    k, v, bt = make_pool(torch, gen, dev, need, pool_dtype, page=shape.page,
                         kv=shape.kv, d=shape.d, nb=shape.nb)
    call = functools.partial(K["paged_prefill_attention"], qc, k, v, bt, st,
                             rope_theta=ROPE_THETA)
    got = call()
    want = ref.paged_prefill_attention_ref(qc, k, v, bt, st,
                                           rope_theta=ROPE_THETA)
    torch.cuda.synchronize()
    name = f"paged_prefill_attention[{shape.label}, pools={pool_dtype}]"
    err = check_close(name, got, want)
    check_repeat(torch, name, call, got)
    return err, (qc, k, v, bt, st)


def paged_kernel_phase(torch, F, K, ref, gen, dev, out):
    reckoning_check(torch, "paged")
    # ---------------------------------------------------------- decode
    for pool_dtype in (torch.bfloat16, torch.float32):
        err, (q, k, v, bt, lengths) = paged_decode_case(
            torch, K, ref, gen, dev, SERVING, DECODE_LENGTHS, pool_dtype)
        log(f"paged_decode_attention q=float32 pools={pool_dtype}: "
            f"max abs err {err:.3e} (tol {ATOL} + {RTOL}*|plain|)")
        if pool_dtype == torch.bfloat16:
            fn = K["paged_decode_attention"]
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
    for pool_dtype in (torch.bfloat16, torch.float32):
        err, (qc, k, v, bt, start) = paged_prefill_case(
            torch, K, ref, gen, dev, SERVING, PREFILL_STARTS, pool_dtype)
        log(f"paged_prefill_attention q=float32 pools={pool_dtype}: "
            f"max abs err {err:.3e} (tol {ATOL} + {RTOL}*|plain|)")
        if pool_dtype == torch.bfloat16:
            fn = K["paged_prefill_attention"]
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


def scenario_kernel_cases(torch, K, ref, gen, dev):
    """Kernels #1 and #2 at every geometry the Scenario runs them at
    (SCENARIO_SHAPES), bfloat16 pools: decode rows shorter than a page,
    across a page and across the whole table, and an idle row; prefill
    chunks from 0, across a page, past two pages and ending at the table's
    last position. The page does not enter the shared-memory reckoning,
    which reckoning_check holds at every G and d of these shapes."""
    errs = {"paged_decode_attention": [], "paged_prefill_attention": []}
    for shape in SCENARIO_SHAPES:
        dec, _ = paged_decode_case(
            torch, K, ref, gen, dev, shape,
            [5, shape.page + 3, shape.cap, 0], torch.bfloat16)
        pre, _ = paged_prefill_case(
            torch, K, ref, gen, dev, shape,
            [0, shape.page - 3, 2 * shape.page + 5, shape.cap - shape.c],
            torch.bfloat16)
        errs["paged_decode_attention"].append(dec)
        errs["paged_prefill_attention"].append(pre)
        log(f"paged kernels at the Scenario's {shape.label} (H {shape.h}, "
            f"KV {shape.kv}, d {shape.d}, chunk {shape.c}, {shape.nb} table "
            f"entries, bf16 pool): max abs err decode {dec:.3e}, prefill "
            f"{pre:.3e} (tol {ATOL} + {RTOL}*|plain|), repeats bitwise equal")
    return {name: max(e) for name, e in errs.items()}


def contiguous_decode_case(torch, K, ref, gen, dev, shape, lengths,
                           cache_dtype):
    """Kernel #3 at ``shape`` over a cache of ``shape.cap`` positions (its
    drop position and every position past a row's length garbage), rows
    of ``lengths`` (a row of length 0 must give 0), against its plain
    version, and called twice (bitwise equal). Returns the max abs error
    and the call's inputs (q, k, v, lengths)."""
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((B, shape.h, shape.d), generator=gen, device=dev)
    k, v = make_cache(torch, gen, dev, lengths, cache_dtype, shape.kv,
                      shape.d, shape.cap)
    call = functools.partial(K["decode_attention"], q, k, v, ln,
                             rope_theta=ROPE_THETA)
    got = call()
    want = ref.decode_attention_ref(q, k, v, ln, rope_theta=ROPE_THETA)
    torch.cuda.synchronize()
    name = f"decode_attention[{shape.label}, cache={cache_dtype}]"
    active = [i for i, n in enumerate(lengths) if n > 0]
    err = check_close(name, got[active], want[active])
    if not all(torch.all(got[i] == 0) for i, n in enumerate(lengths)
               if n == 0):
        fail(f"{name}: a length-0 row must give 0")
    check_repeat(torch, name, call, got)
    return err, (q, k, v, ln)


def contiguous_prefill_case(torch, K, ref, gen, dev, shape, starts,
                            cache_dtype):
    """Kernel #4 at ``shape``: a chunk of ``shape.c`` tokens a row from
    ``starts`` over a cache of ``shape.cap`` positions, against its plain
    version, and called twice (bitwise equal). Returns the max abs error
    and the call's inputs (q, k, v, starts)."""
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    qc = torch.randn((B, shape.c, shape.h, shape.d), generator=gen,
                     device=dev).transpose(1, 2)
    k, v = make_cache(torch, gen, dev, [s + shape.c for s in starts],
                      cache_dtype, shape.kv, shape.d, shape.cap)
    call = functools.partial(K["prefill_attention"], qc, k, v, st,
                             rope_theta=ROPE_THETA)
    got = call()
    want = ref.prefill_attention_ref(qc, k, v, st, rope_theta=ROPE_THETA)
    torch.cuda.synchronize()
    name = f"prefill_attention[{shape.label}, cache={cache_dtype}]"
    err = check_close(name, got, want)
    check_repeat(torch, name, call, got)
    return err, (qc, k, v, st)


def ssd_case(torch, fn, ref, args, what):
    """Kernel #5 on ``args`` against its plain version (y and the end
    state), called twice (bitwise equal); returns the max abs error."""
    y, st = fn(*args)
    want_y, want_st = ref.ssd_chunk_ref(*args)
    torch.cuda.synchronize()
    err = max(check_close(f"ssd_chunk_scan y {what}", y, want_y),
              check_close(f"ssd_chunk_scan state {what}", st, want_st))
    check_repeat(torch, f"ssd_chunk_scan {what}",
                 lambda: torch.cat([t.flatten() for t in fn(*args)]),
                 torch.cat([y.flatten(), st.flatten()]))
    return err


def family_kernel_cases(torch, F, K, ref, gen, dev):
    """The kernels at the vlm, moe, hybrid and encdec families' geometry:
    #1-#4 at every FAMILY_SHAPES shape, bfloat16 caches (the serving
    dtype) — decode rows shorter than a page, across a page and across the
    whole table, and an idle row; prefill chunks from 0, across a page,
    past two pages and ending at the table's last position; the contiguous
    kernels over a cache of the table's positions — then #5 at jamba's
    widths (SSD_Q chunks of SSD_M rows) and #6 without the mask at the
    seamless encoder's shape (f32, timed beside SDPA). Each against its
    plain version and called twice, bitwise equal. Returns the max abs
    error of each kernel."""
    errs: dict = {}

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)
        return err

    for shape in FAMILY_SHAPES:
        lengths = [5, shape.page + 3, shape.cap, 0]
        starts = [0, shape.page - 3, 2 * shape.page + 5,
                  shape.cap - shape.c]
        bf = torch.bfloat16
        e = [note("paged_decode_attention", paged_decode_case(
                 torch, K, ref, gen, dev, shape, lengths, bf)[0]),
             note("paged_prefill_attention", paged_prefill_case(
                 torch, K, ref, gen, dev, shape, starts, bf)[0]),
             note("decode_attention", contiguous_decode_case(
                 torch, K, ref, gen, dev, shape, lengths, bf)[0]),
             note("prefill_attention", contiguous_prefill_case(
                 torch, K, ref, gen, dev, shape, starts, bf)[0])]
        log(f"serving kernels at {shape.label} (H {shape.h}, KV {shape.kv}, "
            f"d {shape.d}, chunk {shape.c}, page {shape.page} x {shape.nb} "
            f"entries, bf16 caches): max abs err paged decode {e[0]:.3e}, "
            f"paged prefill {e[1]:.3e}, contiguous decode {e[2]:.3e}, "
            f"contiguous prefill {e[3]:.3e} (tol {ATOL} + {RTOL}*|plain|), "
            "repeats bitwise equal")
    fn = K["ssd_chunk_scan"]
    h, p, n = SSD_WIDTHS[2]
    for q in (8, 5, 24, 1):          # the reduced configs' chunks
        note("ssd_chunk_scan", ssd_case(
            torch, fn, ref, ssd_inputs(torch, gen, dev, q, SSD_M, h, p, n),
            f"[reduced M={SSD_M} Q={q} H={h} P={p} N={n}]"))
    h, p, n = SSD_WIDTHS[1]
    for q in SSD_Q:
        args = ssd_inputs(torch, gen, dev, q, SSD_M, h, p, n)
        err = note("ssd_chunk_scan", ssd_case(
            torch, fn, ref, args, f"[jamba M={SSD_M} Q={q} H={h} P={p} "
            f"N={n}]"))
        if q in (16, 256):
            log(f"ssd_chunk_scan at jamba's widths M={SSD_M} Q={q} H={h} "
                f"P={p} N={n}: max abs err {err:.3e} | kernel "
                f"{timed_ms(torch, lambda: fn(*args)):.5f} ms | plain "
                f"{timed_ms(torch, lambda: ref.ssd_chunk_ref(*args)):.4f} ms"
                f" | bound {ssd_bound(SSD_M, q, h, p, n)[0]:.6f} ms")
    fwd = K["flash_attention"]
    for fs in FAMILY_FLASH:
        err, (q, k, v) = flash_case(torch, K, ref, gen, dev, fs)
        note("flash_attention", err)
        line = (f"flash_attention at {fs.label} (B {fs.b}, S {fs.s}, H "
                f"{fs.h}, KV {fs.kv}, d {fs.d}, causal={fs.causal}, f32): "
                f"max abs err {err:.3e} (tol {ATOL} + {RTOL}*|plain|), "
                "repeats bitwise equal")
        if fs.label == "seamless encoder":
            # q, k, v read and o written once (f32); q·k and p·v, 2·d flops
            # each, and one exp, per pair and head
            pairs = fs.b * fs.h * fs.s * fs.s
            bound = flash_bound_entry(4 * 4 * fs.b * fs.h * fs.s * fs.d,
                                      4 * fs.d * pairs, pairs, False)
            ms = timed_ms(torch, lambda: fwd(q, k, v, causal=False), 10)
            plain_ms = timed_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, causal=False), 5)
            lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v), 10)
            line += (f" | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                     f"sdpa {lib_ms:.4f} ms | bound {bound[0]:.4f} ms "
                     f"({bound[1]})")
        log(line)
    return errs


def contiguous_kernel_phase(torch, F, K, ref, gen, dev, out):
    reckoning_check(torch, "contiguous")
    # ---------------------------------------------------------- decode
    fn = K["decode_attention"]
    for cache_dtype in (torch.bfloat16, torch.float32):
        err, (q, k, v, lengths) = contiguous_decode_case(
            torch, K, ref, gen, dev, SERVING, DECODE_LENGTHS, cache_dtype)
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
    fn = K["prefill_attention"]
    for cache_dtype in (torch.bfloat16, torch.float32):
        err, (qc, k, v, start) = contiguous_prefill_case(
            torch, K, ref, gen, dev, SERVING, PREFILL_STARTS, cache_dtype)
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
    errs = [ssd_case(torch, fn, ref, ssd_inputs(torch, gen, dev, q),
                     f"[Q={q}]") for q in SSD_Q]
    for m, q, h, p, n, steep, offset in SSD_CASES:
        args = ssd_inputs(torch, gen, dev, q, m, h, p, n, steep, offset)
        what = (f"[M={m} Q={q} H={h} P={p} N={n}{' steep' if steep else ''}"
                f"{f' offset {offset}' if offset else ''}]")
        errs.append(ssd_case(torch, fn, ref, args, what))
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
    for name, err in scenario_kernel_cases(torch, K, ref, gen, dev).items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    contiguous_kernel_phase(torch, F, K, ref, gen, dev, out)
    ssd_kernel_phase(torch, K, ref, gen, dev, out)
    flash_kernel_phase(torch, F, K, ref, gen, dev, out)
    rmsnorm_kernel_phase(torch, F, K, ref, gen, dev, out)
    for name, err in family_kernel_cases(torch, F, K, ref, gen,
                                         dev).items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
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


def flash_inputs(torch, gen, dev, sq, skv, dtype, b=B, h=H, kv=KV, d=D):
    """q, k, v in the model's layout (b, S, heads, d), seen head-major as
    ops.attention_prefill passes them."""
    def one(n, heads):
        return (torch.randn((b, n, heads, d), generator=gen, device=dev)
                .to(dtype).transpose(1, 2))
    return one(sq, h), one(skv, kv), one(skv, kv)


def flash_case(torch, K, ref, gen, dev, fs):
    """Kernel #6 at ``fs`` against its plain version, and called twice
    (bitwise equal). Returns the max abs error and the inputs (q, k, v)."""
    q, k, v = flash_inputs(torch, gen, dev, fs.s, fs.s, torch.float32,
                           b=fs.b, h=fs.h, kv=fs.kv, d=fs.d)
    call = functools.partial(K["flash_attention"], q, k, v,
                             causal=fs.causal)
    got = call()
    want = ref.flash_attention_ref(q, k, v, causal=fs.causal)
    torch.cuda.synchronize()
    what = (f"flash_attention[{fs.label}: B={fs.b} S={fs.s} H={fs.h} "
            f"KV={fs.kv} d={fs.d} causal={fs.causal}]")
    err = check_close(what, got, want)
    check_repeat(torch, what, call, got)
    return err, (q, k, v)


@contextlib.contextmanager
def flash_geometry(torch, what):
    """Records the geometry of every flash forward that ops launches
    inside, and fails on one that is not a FAMILY_FLASH shape (each held
    against its plain version in phase 3)."""
    from repro_torch.kernels import ops
    orig, seen = ops.flash_attention, set()

    def recorded(q, k, v, *, causal=True, **kwargs):
        seen.add((q.shape[0], q.shape[2], k.shape[2], causal, q.shape[1],
                  k.shape[1], q.shape[3], q.dtype, k.dtype))
        return orig(q, k, v, causal=causal, **kwargs)
    ops.flash_attention = recorded
    try:
        yield
    finally:
        ops.flash_attention = orig
    checked = {(f.b, f.s, f.s, f.causal, f.h, f.kv, f.d, torch.float32,
                torch.float32) for f in FAMILY_FLASH}
    for key in sorted(seen - checked, key=str):
        fail(f"{what}: the flash forward ran at (B, Sq, Skv, causal, H, KV, "
             f"d, dtypes) {key}, a geometry phase 3 did not check")


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
#: serve on and the width and depth it must run at (``cut``: the layers
#: kept, passed to serve.main; None keeps them all)
PATHS = {
    "paged tinyllama-1.1b": dict(
        argv=SERVE_ARGV, paged=None, cache="paged", layers=22, d_model=2048),
    "contiguous tinyllama-1.1b": dict(
        argv=SERVE_ARGV, paged=False, cache="contiguous", layers=22,
        d_model=2048),
    "mamba2-1.3b": dict(
        argv=MAMBA_ARGV, paged=None, cache="contiguous", layers=48,
        d_model=2048),
}


def family_argv(arch: str, policy: str) -> list:
    argv = ["--arch", arch] + SERVE_ARGV[2:]
    argv[argv.index("--policy") + 1] = policy
    return argv


#: the vlm, moe, hybrid and encdec families at full width, each cut in
#: depth only as far as one card forces (f32 weights: chameleon 15.4 GB at
#: 4 of 48 layers, moonshot 12.1 GB at 4 of 48, jamba 53.1 GB at one period
#: of 8 of 32 sublayers, seamless 8.1 GB whole); all but chameleon under
#: ``mixed``, whose multi-slot prefill falls back to per-slot dispatches
#: where MoE routing couples rows (``per_slot``) and pads its shorter rows
#: in enc-dec's token-stepped dispatches (``padded``); ``profile``: the calls
#: paged_profile takes of each dispatch (a seamless prefill chunk is 16
#: decode steps, 32,000 kernels: the profiler's own processing of 10 of
#: them would take minutes)
FAMILY_PATHS = {
    "paged chameleon-34b": dict(
        argv=family_argv("chameleon-34b", "chunked"), paged=None,
        cache="paged", cut=4, layers=4, d_model=8192, profile=10),
    "paged moonshot-v1-16b-a3b": dict(
        argv=family_argv("moonshot-v1-16b-a3b", "mixed"), paged=None,
        cache="paged", cut=4, layers=4, d_model=2048, per_slot=True,
        profile=10),
    "paged jamba-v0.1-52b": dict(
        argv=family_argv("jamba-v0.1-52b", "mixed"), paged=None,
        cache="paged", cut=8, layers=8, d_model=4096, per_slot=True,
        profile=10),
    "paged seamless-m4t-large-v2": dict(
        argv=family_argv("seamless-m4t-large-v2", "mixed"), paged=None,
        cache="paged", cut=None, layers=24, d_model=1024, padded=True,
        profile=3),
}


#: the int8-KV path (the ``kv_cache_dtype="int8"`` hint, set around the
#: engine's construction): tinyllama-1.1b on the contiguous cache of int8
#: keys and values with per-(token, head) bf16 scales, kernels #3 and #4
#: reading it dequantized to float32 — phase 4's contiguous geometry
HINT_PATHS = {
    "int8 tinyllama-1.1b": dict(
        argv=SERVE_ARGV, paged=None, cache="contiguous", layers=22,
        d_model=2048, hints={"kv_cache_dtype": "int8"}),
}


def serving_launches(engine, plans) -> dict:
    """Each kernel's launches that a run of ``engine`` must have made,
    from its EngineStats and its PrefillPlans ``plans``: one a layer per
    dispatch — decode attention a decode step (a decode sync), prefill
    attention and the SSD a prefill dispatch — with hybrid's one attention
    and ``attn_every - 1`` SSD sublayers a period, and enc-dec's
    token-stepped prefill (one decode step per token of a dispatch's widest
    row, so one decode attention a decoder layer and step)."""
    cfg, st = engine.cfg, engine.stats
    dec, pre = (("paged_decode_attention", "paged_prefill_attention")
                if engine.paged else ("decode_attention",
                                      "prefill_attention"))
    if cfg.family == "ssm":
        return {"ssd_chunk_scan": cfg.num_layers * st.prefill_dispatches}
    if cfg.family == "encdec":
        return {dec: cfg.num_decoder_layers
                * (st.decode_syncs + st.prefill_tokens - plans.steps_saved)}
    attn = (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
            else cfg.num_layers)
    want = {dec: attn * st.decode_syncs, pre: attn * st.prefill_dispatches}
    if cfg.family == "hybrid":
        want["ssd_chunk_scan"] = (cfg.num_layers - attn) \
            * st.prefill_dispatches
    return want


class PrefillPlans:
    """What an engine's budgeted prefill made of each plan of more than one
    slot (its ``_prefill_budget_plan``): ``per_slot``, the slots of plans
    that fell back to per-slot dispatches (``multi_slot_batchable`` False:
    MoE routing); ``multi``, the multi-slot dispatches, ``padded`` those
    of them with a row shorter than the widest (the ``valid`` mask), and
    ``steps_saved``, their tokens beyond their widths (the sum of a plan's
    pieces less its widest): enc-dec's token-stepped prefill steps each
    dispatch's widest row, so it steps prefill_tokens - steps_saved times."""

    def __init__(self, engine_cls):
        self.engine_cls = engine_cls
        self.per_slot = self.multi = self.padded = self.steps_saved = 0

    def __enter__(self):
        orig = self.orig = self.engine_cls._prefill_budget_plan

        def recorded(engine, *args):
            plan = orig(engine, *args)
            widths = [c for _, c in plan]
            if len(plan) > 1 and engine.model.multi_slot_batchable():
                self.multi += 1
                self.padded += len(set(widths)) > 1
                self.steps_saved += sum(widths) - max(widths)
            elif len(plan) > 1:
                self.per_slot += len(plan)
            return plan
        self.engine_cls._prefill_budget_plan = recorded
        return self

    def __exit__(self, *exc):
        self.engine_cls._prefill_budget_plan = self.orig


def serve_phase(torch, serve, K, path):
    """A warm-up run (cuBLAS heuristics, lazy module loading: paid once per
    process and shape, not per request), then the measured run with every
    kernel's launch count set to 0 just before it and read just after:
    exactly serving_launches' counts, at a geometry phase 3 checked."""
    from repro_torch.distributed import hints
    spec = {**PATHS, **FAMILY_PATHS, **HINT_PATHS}[path]

    def run():
        with hints.hints(**spec.get("hints", {})):
            return serve.main(spec["argv"], paged=spec["paged"],
                              layers=spec.get("cut"))
    t0 = time.monotonic()
    run()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{path}: warm-up serve run (same trace) took "
        f"{time.monotonic() - t0:.2f}s")
    zero_counts(K)
    with PrefillPlans(serve.InferenceEngine) as plans:
        engine = run()
    torch.cuda.synchronize()
    st = engine.stats
    if engine.cfg.d_model != spec["d_model"] or \
            engine.cfg.num_layers != spec["layers"]:
        fail(f"{path}: served {engine.cfg.name} is not at full width")
    if engine.paged != (spec["cache"] == "paged"):
        fail(f"{path}: the engine did not serve on the {spec['cache']} "
             "cache")
    if len(engine.done) != 8 or any(len(r.tokens_out) != 16
                                    for r in engine.done):
        fail(f"{path}: {len(engine.done)}/8 requests finished with 16 "
             "tokens")
    counts = check_launches(K, path, serving_launches(engine, plans))
    check_geometry(path, [engine])
    if spec.get("per_slot") and (plans.per_slot <= 0
                                 or not st.mixed_steps):
        fail(f"{path}: no multi-slot plan fell back to per-slot dispatches")
    if spec.get("padded") and plans.padded <= 0:
        fail(f"{path}: no multi-slot dispatch padded a shorter row")
    ttft = sorted(r.ttft for r in engine.done)
    tpot = sorted(r.tpot for r in engine.done)
    leaves: list = []
    _tree(engine.params, leaves.append)
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    cut = (f" (depth cut to {spec['cut']} layers, widths published)"
           if spec.get("cut") else "") + \
        f" with {gb:.1f} GB of {leaves[0].dtype} weights"
    log(f"{path}: served 8/8 on {engine.cfg.name}{cut}: TTFT median "
        f"{ttft[len(ttft) // 2]:.4f}s max {ttft[-1]:.4f}s | TPOT median "
        f"{tpot[len(tpot) // 2]:.5f}s max {tpot[-1]:.5f}s | launches "
        f"{counts} | prefill dispatches {st.prefill_dispatches}: "
        f"{plans.multi} multi-slot ({plans.padded} with padded rows), "
        f"{plans.per_slot} per-slot in place of multi-slot")
    log(f"{path}: EngineStats {json.dumps(dataclasses.asdict(st))}")
    return engine, counts


def medians(engine) -> tuple[float, float]:
    """TTFT and TPOT medians of an engine's finished requests, seconds."""
    ttft = sorted(r.ttft for r in engine.done)
    tpot = sorted(r.tpot for r in engine.done)
    return ttft[len(ttft) // 2], tpot[len(tpot) // 2]


def device_rows(torch, prof, n):
    """(ms a call, launches a call, name) of each kernel the profiler saw
    on the device over ``n`` calls, longest first."""
    rows = []
    for e in prof.key_averages():
        # device-side events only: the CPU ops that launched them carry
        # the same time again; a profiler range's device-side event spans
        # its kernels and the gaps between them
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key == MOE_RANGE:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t / n / 1e3, e.count // n, e.key))
    rows.sort(reverse=True)
    return rows


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
        rows = device_rows(torch, prof, n)
        dev_ms = sum(r[0] for r in rows)
        log(f"profile {what} {name} (full width, B={B}): host wall "
            f"{wall_ms:.3f} ms/dispatch, device busy {dev_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f}% of wall, idle "
            f"{100 * max(0.0, 1 - dev_ms / wall_ms):.1f}%), "
            f"{sum(r[1] for r in rows)} kernels")
        # the eight largest, then the repository's own kernels below them
        for i, (t, cnt, key) in enumerate(rows):
            if i < 8 or "(anonymous namespace)" in key:
                log(f"  {t:.4f} ms  x{cnt}  {key[:90]}")
        for e in prof.key_averages():
            # moe_annotated's range on the host: the device time of the
            # kernels launched inside it
            if e.key == MOE_RANGE and \
                    e.device_type == torch.autograd.DeviceType.CPU:
                moe_ms = getattr(e, "device_time_total", getattr(
                    e, "cuda_time_total", 0.0)) / n / 1e3
                log(f"  MoE FFN: {e.count // n} calls a dispatch, device "
                    f"{moe_ms:.3f} ms ({100 * moe_ms / dev_ms:.1f}% of "
                    f"busy); host {e.cpu_time_total / n / 1e3:.3f} ms "
                    "under the profiler")


#: the profiler range moe_annotated puts around every MoE FFN
MOE_RANGE = "moe_ffn"


@contextlib.contextmanager
def moe_annotated(torch):
    """Every ``moe.moe_dispatch`` call inside a profiler range, so that
    profile_dispatches can report the MoE FFN's share of a dispatch."""
    from repro_torch.models import moe
    orig = moe.moe_dispatch

    def annotated(*args, **kwargs):
        with torch.profiler.record_function(MOE_RANGE):
            return orig(*args, **kwargs)
    moe.moe_dispatch = annotated
    try:
        yield
    finally:
        moe.moe_dispatch = orig


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
    tinyllama path (10 calls each) and on mamba2 (5 calls each: ~4,100
    kernels a dispatch, whose events the profiler takes seconds to
    process)."""
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
    }, n=5)


CARD_VS_CPU_ATOL = {"float32": 1e-3, "bfloat16": 2e-2}


def paged_profile(torch, what, engine, n=10):
    """profile_dispatches on ``engine``'s model at full width, ``n`` calls
    each: a decode step and a 16-token prefill chunk of 4 rows (40-63
    cached tokens) on the paged cache, the MoE FFN in its own range."""
    dev = torch.device("cuda")
    model, params = engine.model, engine.params
    cache = model.init_paged_cache(1 + 4 * NB, PAGE, B, S)
    bt = torch.arange(1, 1 + B * NB, dtype=torch.int32,
                      device=dev).reshape(B, NB)
    ln, act, tok1, tokc = dispatch_inputs(torch, engine.cfg.vocab_size, dev)
    with moe_annotated(torch):
        profile_dispatches(torch, what, {
            "decode step": lambda: model.decode_step_paged(
                params, cache, tok1, ln, bt, act),
            "prefill chunk": lambda: model.prefill_chunk_paged(
                params, cache, tokc, ln, bt, act, None),
        }, n)


def family_serve_phase(torch, serve, K) -> dict:
    """The vlm, moe, hybrid and encdec paths of FAMILY_PATHS, one at a time
    (jamba's weights take 53 GB): served and counted by serve_phase, then
    a decode step and a prefill chunk profiled. Returns the launches."""
    launches: dict = {}
    for path in FAMILY_PATHS:
        engine, counts = serve_phase(torch, serve, K, path)
        add_counts(launches, counts)
        paged_profile(torch, path, engine, FAMILY_PATHS[path]["profile"])
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return launches


#: decode after prefill against the full forward's last position, relative
#: to the largest logit (tests/test_models_smoke.py's bound: the prefill's
#: bfloat16 cache rounds every cached value once)
DECODE_REL_TOL = 2e-2


def seamless_prefill_phase(torch, K) -> dict:
    """seamless-m4t-large-v2, whole, at full width (random float32 weights
    from seed 0): the encoder alone on B x ENC_T frames (the flash kernel
    without the mask, once an encoder layer), the teacher-forced forward
    over B x SEAMLESS_S tokens (encoder, then the decoder's causal flash,
    once a layer each), prefill of all but the last token and one decode
    step on its contiguous cache (decode attention once a decoder layer),
    whose logits must match the forward's last position; every flash
    forward at a FAMILY_FLASH geometry."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec
    from repro_torch.models.factory import build_model
    dev = torch.device("cuda")
    cfg = get_config("seamless-m4t-large-v2")
    model = build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    frames = torch.randn((B, ENC_T, cfg.d_model), generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, SEAMLESS_S), generator=gen,
                           device=dev, dtype=torch.int32)
    ne, nd = cfg.num_encoder_layers, cfg.num_decoder_layers
    launches: dict = {}
    with flash_geometry(torch, "seamless at full width"):
        zero_counts(K)
        t0 = time.monotonic()
        enc = encdec.encode(params, frames, cfg, remat="none")
        torch.cuda.synchronize()
        enc_s = time.monotonic() - t0
        add_counts(launches, check_launches(
            K, "seamless encode (causal=False)", {"flash_attention": ne}))
        if not torch.isfinite(enc).all():
            fail("seamless encode: non-finite encoder output")
        zero_counts(K)
        t0 = time.monotonic()
        full, _ = model.forward(params, {"frames": frames, "tokens": tokens},
                                remat="none")
        torch.cuda.synchronize()
        fwd_s = time.monotonic() - t0
        add_counts(launches, check_launches(
            K, "seamless forward", {"flash_attention": ne + nd}))
        zero_counts(K)
        _, cache = model.prefill(params, {"frames": frames,
                                          "tokens": tokens[:, :-1]},
                                 SEAMLESS_S)
        lengths = torch.full((B,), SEAMLESS_S - 1, dtype=torch.int32,
                             device=dev)
        dec, _ = model.decode_step(params, cache, tokens[:, -1:], lengths)
        torch.cuda.synchronize()
        add_counts(launches, check_launches(
            K, "seamless prefill + decode step",
            {"flash_attention": ne + nd, "decode_attention": nd}))
    want = full[:, -1]
    rel = ((dec - want).abs().max() / want.abs().max()).item()
    if not torch.isfinite(dec).all() or rel > DECODE_REL_TOL:
        fail(f"seamless: decode after prefill differs from the forward's "
             f"last position by {rel:.3e} of the largest logit (tol "
             f"{DECODE_REL_TOL})")
    log(f"seamless-m4t-large-v2 at full width ({ne} + {nd} layers, d_model "
        f"{cfg.d_model}): encode {B} x {ENC_T} frames {enc_s:.3f}s, "
        f"forward with {SEAMLESS_S} tokens {fwd_s:.3f}s (host clock after "
        f"synchronize); decode after prefill vs forward: {rel:.3e} of the "
        f"largest logit (tol {DECODE_REL_TOL})")
    del model, params, cache, enc, full
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: the reduced configs served on the card and on the CPU: one of each of
#: the vlm, moe, hybrid and encdec families, and kimi beside moonshot (its
#: 2 KV heads)
FAMILY_ARCHS = ("chameleon-34b", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b",
                "jamba-v0.1-52b", "seamless-m4t-large-v2")


def reduced_batches(torch, cfg):
    """forward's inputs at the reduced config: 2 x 24 tokens (with 2 x 10
    frames for enc-dec), and for vlm also 2 x 16 embeddings in place of
    tokens."""
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=gen, dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 10, cfg.d_model), generator=gen)
    batches = [batch]
    if cfg.family == "vlm":
        batches.append({"tokens": None, "embeds": torch.randn(
            (2, 16, cfg.d_model), generator=gen)})
    return batches


def family_card_vs_cpu_phase(torch, K) -> dict:
    """Each FAMILY_ARCHS config at ``.reduced()`` widths, one set of
    weights (drawn on the CPU and moved): forward logits on the card
    against the CPU path within phase 4's float32 tolerance (the vlm
    ``embeds`` and enc-dec frames included; every flash forward at a
    FAMILY_FLASH geometry), then 6 chat requests served by InferenceEngine
    under ``mixed`` (page 64, chunk 8, 4 slots) on both devices: the token
    streams must be equal, the card run's launches exactly
    serving_launches', and enc-dec's prefill must have run multi-slot
    dispatches with padded rows. Returns the launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.factory import build_model
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.request import chat_trace
    tol = CARD_VS_CPU_ATOL["float32"]
    launches: dict = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch).reduced()
        cpu, card = build_model(cfg, "cpu"), build_model(cfg, "cuda")
        cpu_params = cpu.init(torch.Generator().manual_seed(0))
        card_params = _tree(cpu_params, lambda t: t.cuda())
        errs = []
        for batch in reduced_batches(torch, cfg):
            want, _ = cpu.forward(cpu_params, batch, remat="none")
            with flash_geometry(torch, f"{arch} reduced forward"):
                got, _ = card.forward(card_params, {
                    k: None if v is None else v.cuda()
                    for k, v in batch.items()}, remat="none")
            errs.append((got.cpu() - want).abs().max().item())
            if not torch.isfinite(got).all() or errs[-1] > tol:
                fail(f"{arch} reduced: card vs CPU forward logits differ by "
                     f"{errs[-1]:.3e} > {tol} ({sorted(batch)})")
        streams = []
        for model, params in ((card, card_params), (cpu, cpu_params)):
            engine = InferenceEngine(model, max_slots=4, max_seq=64,
                                     policy="mixed", prefill_chunk=8,
                                     page_size=64)
            engine.load_params(params)
            for req in chat_trace(6, cfg.vocab_size, mean_prompt=14,
                                  max_new=8, seed=11):
                engine.submit(req)
            zero_counts(K)
            with PrefillPlans(InferenceEngine) as plans:
                done = engine.run()
            if model is card:
                torch.cuda.synchronize()
                add_counts(launches, check_launches(
                    K, f"{arch} reduced, served on the card",
                    serving_launches(engine, plans)))
                check_geometry(f"{arch} reduced", [engine])
                if cfg.family == "encdec" and plans.padded <= 0:
                    fail(f"{arch} reduced: no multi-slot prefill dispatch "
                         "padded a shorter row")
            streams.append(sorted((r.request_id, list(r.tokens_out))
                                  for r in done))
        if len(streams[0]) != 6 or streams[0] != streams[1]:
            fail(f"{arch} reduced: the card's token streams differ from "
                 "the CPU's")
        log(f"card vs CPU, {arch} reduced: forward logits within "
            f"{max(errs):.3e} (tol {tol}; {len(errs)} batches), token "
            f"streams equal ({sum(len(t) for _, t in streams[0])} tokens, "
            f"6 requests, mixed; prefill dispatches "
            f"{engine.stats.prefill_dispatches}: {plans.multi} multi-slot "
            f"({plans.padded} padded), {plans.per_slot} per-slot in place "
            "of multi-slot)")
    return launches



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


def step_inputs(torch, vocab, c=C):
    """A ``c``-token prefill chunk of 4 rows (row 2 tail-padded to c/2 + 1
    real tokens) from an empty cache, then a decode step with row 3
    idle."""
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, vocab, (B, c), generator=gen,
                           dtype=torch.int32)
    valid = torch.tensor([c, c, c // 2 + 1, c], dtype=torch.int32)
    nxt = torch.randint(0, vocab, (B, 1), generator=gen, dtype=torch.int32)
    act_dec = torch.tensor([True, True, True, False])
    return tokens, valid, nxt, act_dec


def real_logits(torch, pf, dec, valid, act_dec):
    """Real tokens only: prefill pads and the inactive decode row compute
    garbage that the engine discards."""
    keep = [pf[i, :valid[i]] for i in range(B)]
    keep += [dec[i:i + 1] for i in range(B) if act_dec[i]]
    return torch.cat(keep).float().cpu()


def paged_steps(torch, cfg, page, nb, c):
    """card_vs_cpu's run on the paged cache: a ``c``-token prefill chunk
    and a decode step of 4 rows, two pages of ``page`` a row in an
    ``nb``-entry table."""
    from repro_torch.models import transformer
    zeros = torch.zeros((B,), dtype=torch.int32)
    act_pf = torch.ones((B,), dtype=torch.bool)
    tokens, valid, nxt, act_dec = step_inputs(torch, cfg.vocab_size, c)
    bt = torch.zeros((B, nb), dtype=torch.int32)
    bt[:, :2] = torch.arange(1, 2 * B + 1, dtype=torch.int32).reshape(B, 2)

    def paged(params, dev, cache_dtype):
        cache = transformer.init_paged_cache(cfg, 2 * B + 1, page, dev,
                                             cache_dtype)
        on = (lambda t: t.to(dev))
        pf, _ = transformer.prefill_chunk_paged(
            params, cache, on(tokens), on(zeros), on(bt), cfg, on(act_pf),
            on(valid))
        dec, _ = transformer.decode_step_paged(
            params, cache, on(nxt), on(valid), on(bt), cfg, on(act_dec))
        return real_logits(torch, pf, dec, valid, act_dec)

    return paged


def card_vs_cpu_phase(torch, paged_engine, contiguous_engine, mamba_engine):
    from repro_torch.models import mamba_lm, transformer
    zeros = torch.zeros((B,), dtype=torch.int32)
    act_pf = torch.ones((B,), dtype=torch.bool)

    cfg = paged_engine.cfg
    tokens, valid, nxt, act_dec = step_inputs(torch, cfg.vocab_size)

    def contiguous(params, dev, cache_dtype):
        cache = transformer.init_cache(cfg, B, 4 * C, dev, cache_dtype)
        on = (lambda t: t.to(dev))
        pf, _ = transformer.prefill_chunk(params, cache, on(tokens),
                                          on(zeros), cfg, on(act_pf),
                                          on(valid))
        dec, _ = transformer.decode_step(params, cache, on(nxt), on(valid),
                                         cfg, on(act_dec))
        return real_logits(torch, pf, dec, valid, act_dec)

    card_vs_cpu(torch, "paged tinyllama-1.1b",
                paged_steps(torch, cfg, PAGE, NB, C), paged_engine.params)
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



# ------------------------------------------------------------ phase 5c
#: the reduced config the hints phase serves on the card and the CPU
#: (tinyllama-1.1b reduced, 4 layers: 4 heads of 16 over 2 KV heads;
#: chunk 8, max-seq 64): kernels #3 and #4 are checked at this contiguous
#: geometry there first, on float32 caches (what the int8 path hands them)
REDUCED_CONTIGUOUS = PagedShape("tinyllama reduced", 4, 2, 16, 8, 64, 1)
#: kernel #6 at one query head a KV head (attn_impl="repeat_kv" at full
#: width: 32 heads of 64 over 32 KV heads, causal): (rows, sequence,
#: dtype); the S 2048 cases are timed, the last is the geometry of the
#: phase's training steps
G1_CASES = [(B, 2048, "float32"), (B, 2048, "bfloat16"), (1, 256, "float32")]
#: the training steps under best_hints(cfg, "train"): full width cut to
#: HINT_TRAIN_LAYERS layers, HINT_TRAIN_STEPS AdamW steps of 1 x 256
HINT_TRAIN_LAYERS, HINT_TRAIN_STEPS = 2, 2


def int8_serving(torch, serve, K, contiguous) -> dict:
    """The int8 path at full width (served and counted by serve_phase),
    its cache's bytes and latencies against the bf16 contiguous engine
    ``contiguous`` of phase 4, and a decode step and a prefill chunk of
    each cache profiled for the device's busy share. Returns the
    launches."""
    from repro_torch.distributed import hints
    path = "int8 tinyllama-1.1b"
    engine, counts = serve_phase(torch, serve, K, path)
    cache = engine.cache
    if cache["k"].dtype != torch.int8 or "k_scale" not in cache \
            or cache["k_scale"].dtype != torch.bfloat16:
        fail(f"{path}: the engine's cache is not int8 with bf16 scales: "
             f"{ {k: str(t.dtype) for k, t in cache.items()} }")
    nbytes = [sum(t.numel() * t.element_size() for t in c.values())
              for c in (cache, contiguous.cache)]
    hd = cache["k"].shape[-1]
    want = (hd + 2) / (2 * hd)
    if abs(nbytes[0] / nbytes[1] - want) > 1e-9:
        fail(f"{path}: cache bytes {nbytes[0]} / bf16 {nbytes[1]} != {want}")
    (t8, p8), (t16, p16) = medians(engine), medians(contiguous)
    log(f"{path}: cache {nbytes[0] / 2**20:.2f} MiB int8 + scales against "
        f"{nbytes[1] / 2**20:.2f} MiB bf16 (ratio "
        f"{nbytes[0] / nbytes[1]:.4f} = (d + 2) / 2d); TTFT median "
        f"{t8:.4f}s (bf16 contiguous {t16:.4f}s), TPOT median {p8:.5f}s "
        f"({p16:.5f}s), same run")
    dev = torch.device("cuda")
    model, params = engine.model, engine.params
    with hints.hints(kv_cache_dtype="int8"):
        c8 = model.init_cache(B, S)
    c16 = model.init_cache(B, S)
    ln, act, tok1, tokc = dispatch_inputs(torch, engine.cfg.vocab_size, dev)
    profile_dispatches(torch, "contiguous tinyllama-1.1b", {
        f"{name} decode step": functools.partial(
            model.decode_step, params, c, tok1, ln, act)
        for name, c in (("int8", c8), ("bf16", c16))} | {
        f"{name} prefill chunk": functools.partial(
            model.prefill_chunk, params, c, tokc, ln, act, None)
        for name, c in (("int8", c8), ("bf16", c16))}, n=5)
    del engine, model, params, c8, c16
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def int8_card_vs_cpu(torch, K, ref) -> dict:
    """Kernels #3 and #4 at REDUCED_CONTIGUOUS on float32 caches, then the
    reduced config served under the int8 hint by InferenceEngine on both
    devices from one set of weights (drawn on the CPU and moved), 6 chat
    requests under ``mixed``: equal token streams, the card's launches
    exactly serving_launches'. Returns the launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import hints
    from repro_torch.models.factory import build_model
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.request import chat_trace
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    shape = REDUCED_CONTIGUOUS
    errs = (contiguous_decode_case(torch, K, ref, gen, dev, shape,
                                   [5, 23, shape.cap, 0], torch.float32)[0],
            contiguous_prefill_case(torch, K, ref, gen, dev, shape,
                                    [0, 3, 21, shape.cap - shape.c],
                                    torch.float32)[0])
    log(f"contiguous kernels at {shape.label} (H {shape.h}, KV {shape.kv}, "
        f"d {shape.d}, chunk {shape.c}, {shape.cap} positions, float32 "
        f"caches): max abs err decode {errs[0]:.3e}, prefill {errs[1]:.3e} "
        f"(tol {ATOL} + {RTOL}*|plain|), repeats bitwise equal")
    cfg = get_config("tinyllama-1.1b").reduced()
    cpu, card = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    cpu_params = cpu.init(torch.Generator().manual_seed(0))
    card_params = _tree(cpu_params, lambda t: t.cuda())
    launches, streams = {}, []
    for model, params in ((card, card_params), (cpu, cpu_params)):
        with hints.hints(kv_cache_dtype="int8"):
            engine = InferenceEngine(model, max_slots=B, max_seq=shape.cap,
                                     policy="mixed", prefill_chunk=shape.c)
        if engine.paged or engine.cache["k"].dtype != torch.int8:
            fail("int8 reduced: the engine did not take the int8 cache")
        engine.load_params(params)
        for req in chat_trace(6, cfg.vocab_size, mean_prompt=14, max_new=8,
                              seed=11):
            engine.submit(req)
        zero_counts(K)
        with PrefillPlans(InferenceEngine) as plans:
            done = engine.run()
        if model is card:
            torch.cuda.synchronize()
            launches = check_launches(K, "int8 reduced, served on the card",
                                      serving_launches(engine, plans))
            check_geometry("int8 reduced", [engine], [shape])
        streams.append(sorted((r.request_id, list(r.tokens_out))
                              for r in done))
    if len(streams[0]) != 6 or streams[0] != streams[1]:
        fail(f"int8 reduced: the card's token streams differ from the "
             f"CPU's: {streams[0]} vs {streams[1]}")
    log(f"card vs CPU, tinyllama-1.1b reduced under int8 KV: token streams "
        f"equal ({sum(len(t) for _, t in streams[0])} tokens, 6 requests, "
        f"mixed; {plans.multi} multi-slot prefill dispatches)")
    return launches


def flash_g1_checks(torch, F, K, ref) -> None:
    """Kernel #6 and its backward at G1_CASES against their plain versions
    (the forward called twice, bitwise equal); at S 2048 the forward timed
    beside the grouped call on the same queries (KV 4), the plain version
    and SDPA."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    fwd, bwd = K["flash_attention"], K["flash_attention_bwd"]
    for b, s, dname in G1_CASES:
        dtype = getattr(torch, dname)
        tol = ATOL if dname == "float32" else BF16_TOL
        q, k, v = flash_inputs(torch, gen, dev, s, s, dtype, b=b, kv=H)
        what = f"flash_attention[G=1: B={b} S={s} H=KV={H} d={D} {dname}]"
        o, lse = fwd(q, k, v, causal=True, return_lse=True)
        err = check_close(what, o, ref.flash_attention_ref(q, k, v,
                                                           causal=True), tol)
        lse_err = check_close(what + " lse", lse,
                              ref.flash_attention_lse_ref(q, k, causal=True))
        check_repeat(torch, what, lambda: fwd(q, k, v, causal=True), o)
        do = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
        got = bwd(q, k, v, o, lse, do, causal=True)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        berr = [check_close(f"{what} backward {n}", g, w, tol)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)]
        del got, want
        line = (f"{what}: max abs err {err:.3e}, lse {lse_err:.3e}, "
                f"backward dq/dk/dv {'/'.join(f'{e:.3e}' for e in berr)} "
                f"(tol {tol} + {tol}*|plain|), repeats bitwise equal")
        if s == 2048:
            pairs = b * H * flash_pairs(s, s, True)
            bound = flash_bound_entry(q.element_size() * 4 * b * H * s * D,
                                      4 * D * pairs, pairs,
                                      bf16=dname == "bfloat16")
            _, kg, vg = flash_inputs(torch, gen, dev, s, s, dtype, b=b)
            ms = timed_ms(torch, lambda: fwd(q, k, v, causal=True), 10)
            grouped = timed_ms(torch, lambda: fwd(q, kg, vg, causal=True), 10)
            plain_ms = timed_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, causal=True), 5)
            lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), 10)
            line += (f" | kernel {ms:.4f} ms | grouped (KV {KV}) "
                     f"{grouped:.4f} ms | plain {plain_ms:.4f} ms | sdpa "
                     f"{lib_ms:.4f} ms | bound {bound[0]:.4f} ms "
                     f"({bound[1]})")
            del kg, vg
        log(line)
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()


def hinted_training(torch, K) -> dict:
    """HINT_TRAIN_STEPS AdamW steps of tinyllama-1.1b at full width cut to
    HINT_TRAIN_LAYERS layers under best_hints(cfg, "train") (repeat_kv,
    bf16 flash logits, remat dots), on the card between a zero of the
    counts and their exact check, and on the CPU from the same weights:
    each step's loss within the card-vs-CPU loss tolerance (1e-4). Returns
    the launches."""
    from repro_torch.distributed import hints
    from repro_torch.distributed.autotune import best_hints
    from repro_torch.models.factory import build_model
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.optimizer import OptimizerConfig, adamw_init
    from repro_torch.training.train_step import make_train_step
    model, params = tinyllama(torch, layers=HINT_TRAIN_LAYERS)
    cfg = model.cfg
    hint, remat = best_hints(cfg, "train")
    if hint.get("attn_impl") != "repeat_kv" or remat != "dots":
        fail(f"best_hints(tinyllama-1.1b, train) = {hint}, {remat}")
    b, s, _ = G1_CASES[-1]
    data = SyntheticTokens(DataConfig(cfg.vocab_size, s, b, seed=0))
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=10)
    losses = []
    for m, p in ((model, params),
                 (build_model(cfg, "cpu"), _tree(params, lambda t: t.cpu()))):
        _, step = make_train_step(m, opt_cfg, remat=remat)
        state = (p, adamw_init(p))
        if m is model:
            zero_counts(K)
        with hints.hints(**hint):
            for i in range(HINT_TRAIN_STEPS):
                *state, metrics = step(*state, data.batch(i))
                losses.append(metrics["loss"].item())
        if m is model:
            torch.cuda.synchronize()
            n = HINT_TRAIN_LAYERS * HINT_TRAIN_STEPS
            counts = check_launches(K, "hinted training", {
                "flash_attention": 2 * n, "flash_attention_bwd": n})
    card, cpu = losses[:HINT_TRAIN_STEPS], losses[HINT_TRAIN_STEPS:]
    dl = max(abs(a - c) for a, c in zip(card, cpu))
    if not all(math.isfinite(x) for x in card) or dl > 1e-4:
        fail(f"hinted training: card losses {card} vs CPU {cpu}")
    log(f"training under {hint}, remat {remat} ({HINT_TRAIN_LAYERS} of 22 "
        f"layers, {HINT_TRAIN_STEPS} AdamW steps of {b} x {s}): card losses "
        f"{card}, CPU {cpu}: within {dl:.3e} (tol 1e-4); the flash kernels "
        f"at G = 1")
    del model, params, state
    torch.cuda.empty_cache()
    return counts


def hints_phase(torch, F, K, ref, serve, contiguous) -> dict:
    """(a) the int8-KV serving path at full width and reduced on both
    devices; (b) kernel #6 at one query head a KV head, and training steps
    under the per-cell hint table. Returns the launches of the counted
    runs."""
    launches: dict = {}
    seconds = []
    for part, args in ((int8_serving, (torch, serve, K, contiguous)),
                       (int8_card_vs_cpu, (torch, K, ref)),
                       (flash_g1_checks, (torch, F, K, ref)),
                       (hinted_training, (torch, K))):
        t0 = time.monotonic()
        add_counts(launches, part(*args) or {})
        seconds.append(f"{part.__name__} {time.monotonic() - t0:.1f}s")
    log(f"hints phase: {', '.join(seconds)}")
    return launches


# ------------------------------------------------------------ phase 5b
#: the paper's three-app concurrent workload (benchmarks/common.py,
#: standard_scenario at its smoke counts) under the five fig5 policies
FIG5_APPS = (("chatbot", 2), ("imagegen", 2), ("live_captions", 5))
FIG5_POLICIES = ("greedy", "static", "slo_aware", "weighted_fair",
                 "preemptive_priority")
FULL_WIDTH_POLICY = "slo_aware"
#: steps of the full-width run profiled for the device's idle share
PROFILE_FROM, PROFILE_STEPS = 20, 10


def fig5_scenario(policy: str):
    from repro_torch.bench import Scenario, ScenarioApp
    return Scenario(name="fig5_concurrent", mode="concurrent", policy=policy,
                    total_chips=256, chip="tpu-v5e", substrate="engine",
                    apps=[ScenarioApp(app_type=t, num_requests=n)
                          for t, n in FIG5_APPS])


class StepWindow:
    """Profiles engine steps [start, start + n) of a run, counted over
    every partition's engine: host wall on the host clock between two
    synchronisations, device busy the sum of the profiler's device kernel
    times in between."""

    def __init__(self, torch, start: int, n: int):
        self.torch, self.start, self.n = torch, start, n
        self.seen = 0
        self.prof = None
        self.wall_ms = self.busy_ms = None

    def before(self) -> None:
        if self.seen == self.start:
            from torch.profiler import ProfilerActivity, profile
            self.torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.monotonic()

    def after(self) -> None:
        self.seen += 1
        if self.prof is not None and self.seen == self.start + self.n:
            self.torch.cuda.synchronize()
            self.wall_ms = (time.monotonic() - self.t0) * 1e3
            self.prof.stop()
            self.busy_ms = sum(t for t, _, _ in device_rows(
                self.torch, self.prof, 1))
            self.prof = None


def recording_engines(runner, engines: list, window=None):
    """An InferenceEngine that appends itself to ``engines`` (so the phase
    can read each partition's geometry after a run) and steps through
    ``window`` when one is given; the runner's own class is restored by
    the caller."""
    base = runner.InferenceEngine

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

        def step(self):
            if window is not None:
                window.before()
            out = super().step()
            if window is not None:
                window.after()
            return out

    return Recorded


def scenario_run(torch, K, runner, policy, device, window=None):
    """One fig5 Scenario through run_scenario_on_engine on ``device``, the
    launch counts set to 0 just before it; returns the document, the
    partitions' EngineStats, the engines and the wall seconds."""
    base = runner.InferenceEngine
    engines: list = []
    runner.InferenceEngine = recording_engines(runner, engines, window)
    try:
        zero_counts(K)
        t0 = time.monotonic()
        res = runner.run_scenario_on_engine(fig5_scenario(policy),
                                            device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        runner.InferenceEngine = base
    return res.to_json(), res.engine_stats, engines, wall


def scenario_launches(K, what, stats, layers) -> dict:
    """The paged kernels' launches in the Scenario run just made: exactly
    layers x the decode dispatches (one a decode sync) and layers x the
    prefill dispatches summed over the partitions' EngineStats; no other
    kernel."""
    return check_launches(K, what, {
        "paged_decode_attention":
        layers * sum(s.decode_syncs for s in stats.values()),
        "paged_prefill_attention":
        layers * sum(s.prefill_dispatches for s in stats.values())})


def token_streams(engines) -> list:
    """Each engine's finished requests: app, id, generated token ids and
    their (virtual) times."""
    return [sorted((r.app, r.request_id, list(r.tokens_out), r.t_tokens)
                   for r in e.done) for e in engines]


def check_geometry(what, engines, contiguous=None) -> None:
    """Every engine ran its kernels at a geometry that phase 3 held
    against their plain versions: the attention kernels at the same heads,
    head dim, chunk and (paged) page with no more table entries than a
    PAGED_SHAPES shape (the contiguous kernels, over no more positions,
    at a ``contiguous`` shape: SERVING's or a FAMILY_SHAPES shape unless
    given), the SSD at SSD_WIDTHS."""
    for e in engines:
        cfg = e.cfg
        if cfg.family in ("ssm", "hybrid") and (
                cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state) \
                not in SSD_WIDTHS:
            fail(f"{what}: an engine ran the SSD at (H, P, N) "
                 f"{(cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state)}, "
                 "widths phase 3 did not check")
        if cfg.family == "ssm":
            continue
        key = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
               e.prefill_chunk)
        if e.paged:
            ok = any((s.h, s.kv, s.d, s.c, s.page) == key + (e.page_size,)
                     and e.allocator.max_blocks <= s.nb
                     for s in PAGED_SHAPES)
            where = (f"page {e.page_size} with {e.allocator.max_blocks} "
                     "table entries")
        else:
            ok = any((s.h, s.kv, s.d, s.c) == key and e.max_seq <= s.cap
                     for s in contiguous or [SERVING, *FAMILY_SHAPES])
            where = f"a contiguous cache of {e.max_seq} positions"
        if not ok:
            fail(f"{what}: an engine ran at (H, KV, d, chunk) {key}, "
                 f"{where}: a geometry phase 3 did not check")


def vehicle_card_vs_cpu(torch, runner) -> None:
    """The vehicle is one model on both devices: its weights on the card
    equal the CPU's bit for bit, and one prefill chunk (the runner's chunk)
    and one decode step at the tuner's page 256 give logits that agree
    within phase 4's tolerances (card_vs_cpu)."""
    _, card, cfg = runner.engine_model("cuda")
    _, cpu, _ = runner.engine_model("cpu")
    card_leaves, cpu_leaves = [], []
    _tree(card, card_leaves.append)
    _tree(cpu, cpu_leaves.append)
    if len(card_leaves) != len(cpu_leaves) or not all(
            a.is_cuda and torch.equal(a.cpu(), b)
            for a, b in zip(card_leaves, cpu_leaves)):
        fail("scenario vehicle: the card's weights differ from the CPU's")
    card_vs_cpu(torch, "scenario vehicle (page 256)",
                paged_steps(torch, cfg, 256, 5, runner.ENGINE_PREFILL_CHUNK),
                card)


def doc_diff(a, b, path="") -> list[str]:
    """Paths at which two JSON documents differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in sorted(set(a) | set(b))
                for d in doc_diff(a.get(k), b.get(k), f"{path}.{k}")]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in doc_diff(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def geometry(engines) -> str:
    return ", ".join(f"{e.paged and 'paged' or 'contiguous'} page "
                     f"{e.page_size} x {e.kv_pages} max-seq {e.max_seq}"
                     for e in engines)


def scenario_phase(torch, K):
    """(a) The five fig5 policies on the reference vehicle
    (engine_runner.engine_model: reduced tinyllama-1.1b, 2 layers) on the
    card and on the CPU in this process: the two documents must be equal
    (all timing is the runner's virtual clock), and the paged kernels must
    have run exactly as the card run's EngineStats dictate. (b) slo_aware
    with the vehicle replaced by full-width tinyllama-1.1b (22 layers,
    d_model 2048, 32 heads over 4 KV heads of 64; random float32 weights
    from seed 0), substituted for the runner's engine_model here: per-app
    latencies, SLO attainment and the makespan must equal (a)'s; any other
    field that differs is printed by name. A window of its steps is
    profiled for the device's idle share."""
    from repro_torch.bench import engine_runner as runner
    from repro_torch.kernels import build
    # the tuner's picks come from its roofline; its cache stays in the
    # checkout (the build directory), fresh for this run
    cache = build.BUILD_DIR / "autotune.json"
    cache.unlink(missing_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache)
    launches: dict = {}
    docs = {}
    for policy in FIG5_POLICIES:
        what = f"scenario {policy} (vehicle)"
        card, stats, engines, wall = scenario_run(torch, K, runner, policy,
                                                  "cuda")
        want = scenario_launches(K, what, stats, runner.ENGINE_LAYERS)
        add_counts(launches, want)
        check_geometry(what, engines)
        cpu, _, cpu_engines, cpu_wall = scenario_run(torch, K, runner,
                                                     policy, "cpu")
        diff = doc_diff(card, cpu)
        if diff:
            fail(f"{what}: card and CPU documents differ at {diff[:10]}")
        streams = token_streams(engines)
        if streams != token_streams(cpu_engines):
            fail(f"{what}: the card's token streams differ from the CPU's")
        docs[policy] = card
        log(f"{what}: card {wall:.2f}s, CPU {cpu_wall:.2f}s wall; "
            f"documents and token streams equal "
            f"({sum(len(t) for e in streams for _, _, t, _ in e)} tokens); "
            f"steps "
            f"{sum(s.steps for s in stats.values())}, decode dispatches "
            f"{sum(s.decode_syncs for s in stats.values())}, prefill "
            f"dispatches {sum(s.prefill_dispatches for s in stats.values())}"
            f"; engines: {geometry(engines)}")
        for label, sim in card["results"].items():
            apps = {a: (r["slo_attainment"], round(r["p50"], 4))
                    for a, r in sim["apps"].items()}
            log(f"  {label}: makespan {sim['makespan_s']:.4f} s "
                f"(virtual clock, the simulated tpu-v5e's model); "
                f"(SLO attainment, p50 normalised latency) {apps}")

    vehicle_card_vs_cpu(torch, runner)

    model, params = tinyllama(torch)
    vehicle = runner.engine_model
    runner.engine_model = lambda device="cuda": (model, params, model.cfg)
    window = StepWindow(torch, PROFILE_FROM, PROFILE_STEPS)
    try:
        what = f"scenario {FULL_WIDTH_POLICY} (full width)"
        full, stats, engines, wall = scenario_run(
            torch, K, runner, FULL_WIDTH_POLICY, "cuda", window)
    finally:
        runner.engine_model = vehicle
    cfg = model.cfg
    if (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim) != (22, 2048, 32, 4, 64):
        fail(f"{what}: {cfg.name} is not at full width")
    add_counts(launches, scenario_launches(K, what, stats, cfg.num_layers))
    check_geometry(what, engines)
    ref_doc = docs[FULL_WIDTH_POLICY]
    diff = doc_diff(ref_doc, full)
    pinned = [d for d in diff if ".apps." in d or d.endswith(".makespan_s")]
    if pinned:
        fail(f"{what}: latencies, SLO attainment or makespan differ from "
             f"the vehicle's at {pinned[:10]}")
    steps = sum(s.steps for s in stats.values())
    log(f"{what}: {wall:.2f}s wall, {steps} steps ({wall / steps * 1e3:.2f}"
        f" ms host wall a step), decode dispatches "
        f"{sum(s.decode_syncs for s in stats.values())}, prefill dispatches "
        f"{sum(s.prefill_dispatches for s in stats.values())}; engines: "
        f"{geometry(engines)}")
    log(f"{what}: per-app latencies, SLO attainment and makespan equal the "
        f"vehicle's; other fields that differ: {diff or 'none'}")
    if window.wall_ms is None:
        fail(f"{what}: the run took fewer than "
             f"{PROFILE_FROM + PROFILE_STEPS} steps to profile")
    log(f"{what}: profiled steps {PROFILE_FROM}-"
        f"{PROFILE_FROM + PROFILE_STEPS - 1}: host wall "
        f"{window.wall_ms / PROFILE_STEPS:.3f} ms a step, device busy "
        f"{window.busy_ms / PROFILE_STEPS:.3f} ms a step, device idle "
        f"{100 * (1 - window.busy_ms / window.wall_ms):.1f}%")
    del model, params
    torch.cuda.empty_cache()
    return launches

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
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        seconds[name] = round(time.monotonic() - t0, 1)
        return out

    resolve_device("cuda")            # TF32 off for every float32 matmul
    timed("build", build_phase, build)
    K = wrappers()
    measured = timed("kernels", kernel_phase, torch, F, K, ref)
    engines, launches = {}, {}
    for path in PATHS:
        engines[path], counts = timed(path, serve_phase, torch, serve, K,
                                      path)
        add_counts(launches, counts)
    timed("profile", profile_phase, torch, engines["paged tinyllama-1.1b"],
          engines["mamba2-1.3b"])
    timed("card vs CPU", card_vs_cpu_phase, torch, *engines.values())
    add_counts(launches, timed("hints", hints_phase, torch, F, K, ref, serve,
                               engines["contiguous tinyllama-1.1b"]))
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    for name, phase, args in (
            ("families", family_serve_phase, (torch, serve, K)),
            ("seamless prefill", seamless_prefill_phase, (torch, K)),
            ("families card vs CPU", family_card_vs_cpu_phase, (torch, K)),
            ("scenario", scenario_phase, (torch, K)),
            ("rmsnorm path", rmsnorm_path_phase, (torch, K)),
            ("prefill", prefill_phase, (torch, K)),
            ("training", train_phase, (torch, K))):
        add_counts(launches, timed(name, phase, *args))
    timed("training card vs CPU", training_card_vs_cpu_phase, torch)
    log(f"seconds a phase: {seconds}")
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
