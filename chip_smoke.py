#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

  python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits nonzero; nothing is caught and passed over):

1. device   — requires torch.cuda.is_available(); prints the card's name
              and power limit as nvidia-smi reports them.
2. build    — compiles every kernel under src/repro_torch/kernels/csrc with
              nvcc (one process per source, all started together) and
              prints the seconds and ptxas's register/shared-memory report.
3. kernels  — each kernel's wrapper at the serving path's shapes
              (tinyllama-1.1b, 4 slots, page 16, 256-token table, chunk 16)
              against its plain PyTorch version on the same card, with
              ragged lengths, garbage in the sentinel page and past every
              length, an idle slot and prefill horizons crossing pages; in
              q float32 / pools bfloat16 (the serving dtypes) and all
              float32. Tolerance: 2e-5 absolute + 2e-5 relative (both sides
              compute in float32 on identical inputs; they differ in
              summation order). Then times kernel, plain version and one
              scaled_dot_product_attention call on the gathered view (a
              yardstick only: the port never calls it).
4. serve    — repro_torch.launch.serve.main on tinyllama-1.1b at full width
              (22 layers, random float32 weights from seed 0, bfloat16 KV
              pool): 8 requests, 4 slots, max-seq 256, 16 new tokens,
              chunk 16, page 16 — once to warm up, then measured with
              every kernel's launch count set to 0 just before and read
              just after. Every request must finish and each kernel must
              have run 22 times per dispatch. A profiled decode step and
              prefill chunk show where a dispatch's time goes. Then one
              prefill chunk and one decode step at full width on the card
              and, with the same weights and pool, on the CPU path: logits
              must agree within 1e-3 absolute with a float32 pool and
              2e-2 with the bfloat16 serving pool (card_vs_cpu_phase says
              why).
5. report   — a JSON line of per-kernel numbers, the nvidia-smi line, and
              last a JSON line naming the device.
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
ATOL = RTOL = 2e-5

# serving-path shapes: tinyllama-1.1b, 4 slots, page 16, max-seq 256
B, H, KV, D, PAGE, NB, C, POOL = 4, 32, 4, 64, 16, 16, 16, 64
DECODE_LENGTHS = [37, 256, 1, 0]   # row 2: one token; row 3: idle slot
PREFILL_STARTS = [0, 7, 200, 240]
ROPE_THETA = 10_000.0


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
            if "registers" in line or "Compiling entry" in line:
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


def check_close(name, got, want):
    import torch
    err = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite kernel output")
    over = err - RTOL * want.float().abs()
    if over.max().item() > ATOL:
        fail(f"{name}: kernel vs plain max abs err {err.max().item():.3e} "
             f"exceeds {ATOL} + {RTOL}*|plain|")
    return err.max().item()


def decode_bound(lengths):
    n = sum(lengths)
    byts = (B * H * D * 4 + n * KV * D * 2 * 2 + B * NB * 4 + B * 4
            + B * H * D * 4)
    flops = 4 * D * H * n
    return byts, flops


def prefill_bound(starts):
    visible = sum(s + C for s in starts)
    byts = (B * H * C * D * 4 + visible * KV * D * 2 * 2 + B * NB * 4 + B * 4
            + B * H * C * D * 4)
    # row (b, h, c) attends s + c + 1 positions: 2 flops each for q.k and p.v
    flops = sum(4 * D * H * (C * (s + 1) + C * (C - 1) // 2) for s in starts)
    return byts, flops


def bound_entry(byts, flops):
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, F, pda, ppa, ref):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    out = {}

    # ---------------------------------------------------------- decode
    # the idle row 3 maps no page: its table is all sentinel
    need = [math.ceil(n / PAGE) for n in DECODE_LENGTHS]
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    active = [i for i, n in enumerate(DECODE_LENGTHS) if n > 0]
    for pool_dtype in (torch.bfloat16, torch.float32):
        k, v, bt = make_pool(torch, gen, dev, need, pool_dtype)
        got = pda.paged_decode_attention(q, k, v, bt, lengths,
                                         rope_theta=ROPE_THETA)
        want = ref.paged_decode_attention_ref(q, k, v, bt, lengths,
                                              rope_theta=ROPE_THETA)
        torch.cuda.synchronize()
        err = check_close(f"paged_decode_attention[{pool_dtype}]",
                          got[active], want[active])
        if not torch.all(got[3] == 0):
            fail("paged_decode_attention: a length-0 row must give 0")
        log(f"paged_decode_attention q=float32 pools={pool_dtype}: "
            f"max abs err {err:.3e} (tol {ATOL} + {RTOL}*|plain|)")
        if pool_dtype == torch.bfloat16:
            ms = timed_ms(torch, lambda: pda.paged_decode_attention(
                q, k, v, bt, lengths, rope_theta=ROPE_THETA))
            plain_ms = timed_ms(torch, lambda: ref.paged_decode_attention_ref(
                q, k, v, bt, lengths, rope_theta=ROPE_THETA))
            # yardstick: SDPA on the gathered, pre-rotated, head-expanded view
            kg = ref._gather_head_major(k, bt).repeat_interleave(H // KV, 1)
            vg = ref._gather_head_major(v, bt).repeat_interleave(H // KV, 1)
            qr = ref.rope_ref(q, (lengths - 1)[:, None], ROPE_THETA)
            mask = (torch.arange(NB * PAGE, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
                qr[:, :, None].to(kg.dtype), kg, vg, attn_mask=mask))
            bound_ms, bound_by = bound_entry(*decode_bound(DECODE_LENGTHS))
            out["paged_decode_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)

    # --------------------------------------------------------- prefill
    need = [math.ceil((s + C) / PAGE) for s in PREFILL_STARTS]
    start = torch.tensor(PREFILL_STARTS, dtype=torch.int32, device=dev)
    # model layout (B, C, H, d) seen head-major, as ops passes it
    qc = torch.randn((B, C, H, D), generator=gen, device=dev).transpose(1, 2)
    for pool_dtype in (torch.bfloat16, torch.float32):
        k, v, bt = make_pool(torch, gen, dev, need, pool_dtype)
        got = ppa.paged_prefill_attention(qc, k, v, bt, start,
                                          rope_theta=ROPE_THETA)
        want = ref.paged_prefill_attention_ref(qc, k, v, bt, start,
                                               rope_theta=ROPE_THETA)
        torch.cuda.synchronize()
        err = check_close(f"paged_prefill_attention[{pool_dtype}]", got, want)
        log(f"paged_prefill_attention q=float32 pools={pool_dtype}: "
            f"max abs err {err:.3e} (tol {ATOL} + {RTOL}*|plain|)")
        if pool_dtype == torch.bfloat16:
            ms = timed_ms(torch, lambda: ppa.paged_prefill_attention(
                qc, k, v, bt, start, rope_theta=ROPE_THETA))
            plain_ms = timed_ms(torch, lambda: ref.paged_prefill_attention_ref(
                qc, k, v, bt, start, rope_theta=ROPE_THETA))
            kg = ref._gather_head_major(k, bt).repeat_interleave(H // KV, 1)
            vg = ref._gather_head_major(v, bt).repeat_interleave(H // KV, 1)
            pos = start[:, None] + torch.arange(C, device=dev)
            qr = ref.rope_ref(qc, pos[:, None, :], ROPE_THETA)
            mask = (torch.arange(NB * PAGE, device=dev)[None, None, :]
                    <= pos[:, :, None])[:, None]
            lib_ms = timed_ms(torch, lambda: F.scaled_dot_product_attention(
                qr.to(kg.dtype), kg, vg, attn_mask=mask))
            bound_ms, bound_by = bound_entry(*prefill_bound(PREFILL_STARTS))
            out["paged_prefill_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)
    for name, row in out.items():
        log(f"{name}: kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f}"
            f" ms | sdpa yardstick {row['library_ms']:.4f} ms | bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return out


# ------------------------------------------------------------------ phase 4
SERVE_ARGV = ["--arch", "tinyllama-1.1b", "--requests", "8", "--slots", "4",
              "--max-seq", "256", "--max-new", "16", "--prefill-chunk", "16",
              "--page-size", "16", "--policy", "chunked", "--device", "cuda",
              "--seed", "0"]


def serve_phase(torch, serve, pda, ppa):
    """A warm-up run (cuBLAS heuristics, lazy module loading: paid once per
    process, not per request), then the measured run with every kernel's
    launch count set to 0 just before it and read just after."""
    t0 = time.monotonic()
    serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    log(f"warm-up serve run (same trace) took {time.monotonic() - t0:.2f}s")
    pda.paged_decode_attention.launches = 0
    ppa.paged_prefill_attention.launches = 0
    engine = serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": pda.paged_decode_attention.launches,
                "paged_prefill_attention":
                    ppa.paged_prefill_attention.launches}
    st = engine.stats
    layers = engine.cfg.num_layers
    if engine.cfg.d_model != 2048 or layers != 22:
        fail(f"served {engine.cfg.name} is not full-width tinyllama-1.1b")
    if len(engine.done) != 8 or any(len(r.tokens_out) != 16
                                    for r in engine.done):
        fail(f"{len(engine.done)}/8 requests finished with 16 tokens")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was launched {n} times on the serving path")
    if launches["paged_decode_attention"] != layers * st.decode_syncs:
        fail(f"decode kernel launches {launches['paged_decode_attention']} "
             f"!= {layers} x {st.decode_syncs} decode dispatches")
    if launches["paged_prefill_attention"] != layers * st.prefill_dispatches:
        fail(f"prefill kernel launches {launches['paged_prefill_attention']}"
             f" != {layers} x {st.prefill_dispatches} prefill dispatches")
    ttft = sorted(r.ttft for r in engine.done)
    tpot = sorted(r.tpot for r in engine.done)
    log(f"served 8/8 on {engine.cfg.name}: TTFT median "
        f"{ttft[len(ttft) // 2]:.4f}s max {ttft[-1]:.4f}s | TPOT median "
        f"{tpot[len(tpot) // 2]:.5f}s max {tpot[-1]:.5f}s | launches "
        f"{launches}")
    log(f"EngineStats {json.dumps(dataclasses.asdict(st))}")
    return engine, launches


def profile_phase(torch, engine):
    """Where one full-width dispatch spends its time: host wall time per
    decode step and per 16-token prefill chunk (4 rows, 40-63 cached
    tokens), the device time the profiler sees in the same calls, and the
    kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    model, params = engine.model, engine.params
    dev = torch.device("cuda")
    cache = model.init_paged_cache(1 + 4 * NB, PAGE, B, NB * PAGE)
    bt = torch.arange(1, 1 + B * NB, dtype=torch.int32,
                      device=dev).reshape(B, NB)
    gen = torch.Generator(device=dev).manual_seed(3)
    vocab = engine.cfg.vocab_size
    ln = torch.tensor([40, 50, 60, 63], dtype=torch.int32, device=dev)
    act = torch.ones((B,), dtype=torch.bool, device=dev)
    tok1 = torch.randint(0, vocab, (B, 1), generator=gen, device=dev,
                         dtype=torch.int32)
    tokc = torch.randint(0, vocab, (B, C), generator=gen, device=dev,
                         dtype=torch.int32)
    calls = {
        "decode step": lambda: model.decode_step_paged(
            params, cache, tok1, ln, bt, act),
        "prefill chunk": lambda: model.prefill_chunk_paged(
            params, cache, tokc, ln, bt, act, None),
    }
    for what, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        n = 10
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
        log(f"profile {what} (full width, B={B}): host wall {wall_ms:.3f} "
            f"ms/dispatch, device busy {dev_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f}% of wall)")
        for t, cnt, key in rows[:8]:
            log(f"  {t:.4f} ms  x{cnt}  {key[:90]}")


CARD_VS_CPU_ATOL = {"float32": 1e-3, "bfloat16": 2e-2}


def card_vs_cpu_phase(torch, engine, device: str = "cuda"):
    """One prefill chunk and one decode step at full width, on the card and
    on the CPU path, from the same weights, with the pool in float32 and in
    the serving dtype bfloat16. With a float32 pool both sides compute in
    float32 and differ only in summation order. A bfloat16 pool rounds
    each cached value once; a value within float32 noise of a rounding tie
    lands on the other side on one device, and 22 layers carry that
    1-ulp (0.4%) step to the logits — its size is printed beside the size
    of the whole bfloat16-vs-float32 storage effect on the CPU."""
    from repro_torch.models import transformer
    cfg = engine.cfg
    gen = torch.Generator().manual_seed(7)
    b, pages = 4, 8
    tokens = torch.randint(0, cfg.vocab_size, (b, C), generator=gen,
                           dtype=torch.int32)
    bt = torch.zeros((b, NB), dtype=torch.int32)
    bt[:, :2] = torch.arange(1, 2 * b + 1, dtype=torch.int32).reshape(b, 2)
    start = torch.zeros((b,), dtype=torch.int32)
    valid = torch.tensor([C, C, 9, C], dtype=torch.int32)
    act_pf = torch.ones((b,), dtype=torch.bool)
    lengths = valid.clone()
    act_dec = torch.tensor([True, True, True, False])
    nxt = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                        dtype=torch.int32)

    def run(params, dev, pool_dtype):
        cache = transformer.init_paged_cache(cfg, pages + 1, PAGE, dev,
                                             pool_dtype)
        on = (lambda t: t.to(dev))
        pf, _ = transformer.prefill_chunk_paged(
            params, cache, on(tokens), on(start), on(bt), cfg, on(act_pf),
            on(valid))
        dec, _ = transformer.decode_step_paged(
            params, cache, on(nxt), on(lengths), on(bt), cfg, on(act_dec))
        # compare real tokens only: prefill pads and the inactive decode
        # row compute garbage that the engine discards
        keep = [pf[i, :valid[i]] for i in range(b)]
        keep += [dec[i:i + 1] for i in range(b) if act_dec[i]]
        return torch.cat(keep).float().cpu()

    t0 = time.monotonic()
    cpu_params = _tree(engine.params, lambda t: t.cpu())
    cpu = {}
    for name in ("float32", "bfloat16"):
        pool_dtype = getattr(torch, name)
        card = run(engine.params, torch.device(device), pool_dtype)
        cpu[name] = run(cpu_params, torch.device("cpu"), pool_dtype)
        if not torch.isfinite(card).all():
            fail(f"card logits are not finite ({name} pool)")
        err = (card - cpu[name]).abs().max().item()
        if err > CARD_VS_CPU_ATOL[name]:
            fail(f"card vs CPU logits differ by {err:.3e} > "
                 f"{CARD_VS_CPU_ATOL[name]} ({name} pool)")
        log(f"card vs CPU, full width, prefill chunk + decode step, {name} "
            f"pool: max abs logit err {err:.3e} (tol "
            f"{CARD_VS_CPU_ATOL[name]}; |logits| <= "
            f"{cpu[name].abs().max().item():.3f})")
    effect = (cpu["bfloat16"] - cpu["float32"]).abs().max().item()
    log(f"bfloat16-vs-float32 pool on the CPU alone moves logits by up to "
        f"{effect:.3e}; checks took {time.monotonic() - t0:.1f}s")


def _tree(node, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in node.items()}


# --------------------------------------------------------------------- main
KERNELS = {
    "paged_decode_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention.py:91"),
    "paged_prefill_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        replaces="src/repro/kernels/paged_prefill_attention.py:80"),
}


def main() -> None:
    import torch
    smi_line = device_phase(torch)
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.launch import serve

    resolve_device("cuda")            # TF32 off for every float32 matmul
    build_phase(build)
    measured = kernel_phase(torch, F, pda, ppa, ref)
    engine, launches = serve_phase(torch, serve, pda, ppa)
    profile_phase(torch, engine)
    card_vs_cpu_phase(torch, engine)

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
