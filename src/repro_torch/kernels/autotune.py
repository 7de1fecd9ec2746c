# Copy of src/repro/kernels/autotune.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Roofline-guided block-size autotuner for the Pallas kernels.

The seed hard-coded one block size per kernel (``s_block=512`` for
flash-decode, ``head_block=8`` for the SSD scan, 128/128 for flash prefill).
This module turns those into tuned, per-shape choices:

1. **Candidate sweep** — enumerate block sizes per kernel (powers of two,
   restricted to divisors where the kernel has no pad path).
2. **Roofline pruning** — score every candidate with the analytic model from
   :mod:`repro_torch.roofline.hw` (compute vs. HBM time, a per-grid-step issue
   overhead, VMEM footprint) and discard candidates whose working set exceeds
   the VMEM budget or whose estimate is far off the best.
3. **Optional measurement** — on real hardware, pass ``measure`` (a callable
   ``blocks -> seconds``) to time the surviving top-k and pick the winner;
   without it (this CPU container) the roofline argmin is used directly.
4. **Persistence** — winners land in a versioned JSON cache keyed by
   ``(kernel, shape-bucket, device-kind)`` so later processes (and the
   kernels' public entry points, which consult :func:`best_config` when
   called without explicit blocks) skip the sweep.

The same machinery hosts the engine-level *batch-size* selection the
roadmap calls for (`roofline-verified batch-size selection per app`):
:func:`roofline_batch_size` finds the decode batch where a model crosses
from HBM-bound to compute-bound on the target chip, and
``distributed/autotune.py`` re-exports it next to the per-cell hint table.

Cache file format (``docs/performance.md`` documents regeneration):

.. code-block:: json

   {"version": 1,
    "configs": {
      "decode_attention|b=4,d=64,g=2,kv=4,s=2048|cpu|tpu-v5e": {
         "blocks": {"s_block": 512}, "est_us": 12.9, "source": "roofline"}}}
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Callable, Optional

from repro_torch.roofline.hw import ChipSpec, DEFAULT_CHIP

SCHEMA_VERSION = 1

# Working-set budget: half of a v5e core's ~16 MB VMEM, leaving room for
# double buffering of the streamed inputs.
VMEM_BUDGET_BYTES = 8 * 1024 * 1024
# Fixed cost to issue one grid step (DMA setup + scalar prologue). Coarse,
# but it is what makes tiny blocks lose to big ones on the roofline.
GRID_STEP_OVERHEAD_S = 2e-7

_LOCK = threading.Lock()
_MEM: dict[str, dict] = {}
_FILE_LOADED = [False]


# --------------------------------------------------------------- cache file

def cache_path() -> str:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def _load_file() -> None:
    if _FILE_LOADED[0]:
        return
    _FILE_LOADED[0] = True
    try:
        with open(cache_path()) as f:
            doc = json.load(f)
        if doc.get("version") == SCHEMA_VERSION:
            _MEM.update(doc.get("configs", {}))
    except (OSError, ValueError):
        pass


def _save_file() -> None:
    path = cache_path()
    try:
        # merge-before-write: another process may have persisted entries
        # (possibly expensive measured-on-TPU ones) since we loaded — keep
        # theirs for keys we did not tune ourselves this run
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc.get("version") == SCHEMA_VERSION:
                merged = dict(doc.get("configs", {}))
                merged.update(_MEM)
                _MEM.update(merged)
        except (OSError, ValueError):
            pass
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": SCHEMA_VERSION, "configs": _MEM}, f,
                      indent=1, sort_keys=True)
    except OSError:
        pass  # read-only FS: in-memory cache still works


def reset(clear_file: bool = False) -> None:
    """Drop the in-memory cache (tests; config regeneration)."""
    with _LOCK:
        _MEM.clear()
        _FILE_LOADED[0] = False
        if clear_file:
            try:
                os.remove(cache_path())
            except OSError:
                pass


# ------------------------------------------------------------------ helpers

def largest_divisor(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def pow2_bucket(n: int) -> int:
    """Round up to the next power of two (shape-bucketing for cache keys)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def device_kind() -> str:
    try:
        import torch
        if not torch.cuda.is_available():
            return "cpu"
        return torch.cuda.get_device_name(0).replace(" ", "-").lower()
    except Exception:  # noqa: BLE001 — no backend at all
        return "unknown"


def _key(kernel: str, bucket: dict, chip: ChipSpec) -> str:
    # device_kind = where we measure; chip.name = the roofline target the
    # analytic estimates were computed against. Both shape the winner.
    shape = ",".join(f"{k}={bucket[k]}" for k in sorted(bucket))
    return f"{kernel}|{shape}|{device_kind()}|{chip.name}"


# ----------------------------------------------- per-kernel analytic models
# Each entry: bucket(shape) -> canonical bucketed shape;
#             candidates(bucket) -> list of block dicts;
#             roofline(bucket, blocks, chip) -> estimated seconds;
#             vmem(bucket, blocks) -> working-set bytes.

_POW2_BLOCKS = (64, 128, 256, 512, 1024, 2048, 4096)


def _decode_bucket(shape: dict) -> dict:
    return {"b": pow2_bucket(shape["b"]), "kv": shape["kv"], "g": shape["g"],
            "s": pow2_bucket(shape["s"]), "d": shape["d"]}


def _decode_candidates(bk: dict) -> list[dict]:
    s = bk["s"]
    cands = [{"s_block": c} for c in _POW2_BLOCKS if c <= s]
    if not cands:
        cands = [{"s_block": s}]
    return cands


def _decode_vmem(bk: dict, blocks: dict) -> int:
    sb, d, g = blocks["s_block"], bk["d"], bk["g"]
    return 4 * (2 * sb * d + 3 * g * d + 2 * g)   # k,v tiles + q/acc + m,l


def _decode_roofline(bk: dict, blocks: dict, chip: ChipSpec) -> float:
    b, kv, g, s, d = bk["b"], bk["kv"], bk["g"], bk["s"], bk["d"]
    sb = blocks["s_block"]
    ns = math.ceil(s / sb)
    s_eff = ns * sb                      # pad path reads the padded cache
    flops = 4.0 * b * kv * g * s_eff * d
    byts = 2.0 * (2 * b * kv * s_eff * d) + 2.0 * 2 * b * kv * g * d
    t = max(flops / chip.peak_flops_bf16, byts / chip.hbm_bandwidth)
    return t + b * kv * ns * GRID_STEP_OVERHEAD_S


# Paged flash-decode: the sequence tile IS the page (pages are not
# contiguous in the pool, so a tile cannot span pages). The autotuner
# therefore tunes the PAGE SIZE the engine's BlockAllocator should use:
# per-grid-step issue overhead pushes pages up; internal fragmentation
# (on average half a page wasted per resident sequence) pushes them down.
_PAGE_SIZES = (8, 16, 32, 64, 128, 256)


def _paged_decode_bucket(shape: dict) -> dict:
    return _decode_bucket(shape)


def _paged_decode_candidates(bk: dict) -> list[dict]:
    s = bk["s"]
    cands = [{"page_size": p} for p in _PAGE_SIZES if p <= s]
    return cands or [{"page_size": s}]


def _paged_decode_vmem(bk: dict, blocks: dict) -> int:
    return _decode_vmem(bk, {"s_block": blocks["page_size"]})


def _paged_decode_roofline(bk: dict, blocks: dict, chip: ChipSpec) -> float:
    b, kv, g, s, d = bk["b"], bk["kv"], bk["g"], bk["s"], bk["d"]
    page = blocks["page_size"]
    # shape buckets round UP to a power of two, so model the mean resident
    # length as 0.75*s; the kernel streams every ALLOCATED page, and on
    # average the last page is half empty — internal fragmentation charges
    # page/2 extra tokens per row (pushes pages DOWN), while the per-page
    # grid-step issue overhead pushes pages UP.
    ell = 0.75 * s
    nb = ell / page + 0.5
    s_eff = nb * page
    flops = 4.0 * b * kv * g * s_eff * d
    byts = 2.0 * (2 * b * kv * s_eff * d) + 2.0 * 2 * b * kv * g * d
    # block-table scalar reads are SMEM-resident: no HBM term
    t = max(flops / chip.peak_flops_bf16, byts / chip.hbm_bandwidth)
    return t + b * kv * nb * GRID_STEP_OVERHEAD_S


# Prefill-chunk flash attention: C*G query rows per (batch row, KV head)
# against the full cache, streamed in s_block tiles (kernels/
# prefill_attention.py). Same shape family as flash-decode with the extra
# chunk axis multiplying compute and the q/acc VMEM footprint.

def _prefill_attn_bucket(shape: dict) -> dict:
    return {"b": pow2_bucket(shape["b"]), "kv": shape["kv"], "g": shape["g"],
            "c": pow2_bucket(shape["c"]), "s": pow2_bucket(shape["s"]),
            "d": shape["d"]}


def _prefill_attn_candidates(bk: dict) -> list[dict]:
    s = bk["s"]
    cands = [{"s_block": c} for c in _POW2_BLOCKS if c <= s]
    return cands or [{"s_block": s}]


def _prefill_attn_vmem(bk: dict, blocks: dict) -> int:
    sb, d = blocks["s_block"], bk["d"]
    r = bk["c"] * bk["g"]                         # query rows per grid cell
    return 4 * (2 * sb * d + 3 * r * d + 2 * r)   # k,v tiles + q/acc + m,l


def _prefill_attn_roofline(bk: dict, blocks: dict, chip: ChipSpec) -> float:
    b, kv, g, c, s, d = (bk["b"], bk["kv"], bk["g"], bk["c"], bk["s"],
                         bk["d"])
    sb = blocks["s_block"]
    ns = math.ceil(s / sb)
    s_eff = ns * sb                      # pad path reads the padded cache
    flops = 4.0 * b * kv * g * c * s_eff * d
    byts = 2.0 * (2 * b * kv * s_eff * d) + 2.0 * 2 * b * kv * g * c * d
    t = max(flops / chip.peak_flops_bf16, byts / chip.hbm_bandwidth)
    return t + b * kv * ns * GRID_STEP_OVERHEAD_S


# Engine-level prefill CHUNK size: how many prompt tokens one chunked-prefill
# dispatch should advance. Each dispatch re-reads the weights (W bytes)
# regardless of chunk size, while compute scales with the chunk — so small
# chunks waste bandwidth re-reading weights and large chunks only add
# decode-stall latency (a decode-ready row waits out the whole dispatch).
# The roofline winner is the BALANCE point t_comp ≈ t_mem: the smallest
# chunk that saturates compute, scored by imbalance with ties broken toward
# the smaller (lower-stall) candidate. Param counts are bucketed in
# megaparams so one cache entry covers a model family size class.

_ENGINE_CHUNKS = (8, 16, 32, 64, 128, 256, 512)


def _engine_chunk_bucket(shape: dict) -> dict:
    return {"mtotal": pow2_bucket(shape["mtotal"]),
            "mactive": pow2_bucket(shape["mactive"]),
            "seq": pow2_bucket(shape["seq"])}


def _engine_chunk_candidates(bk: dict) -> list[dict]:
    cands = [{"prefill_chunk": c} for c in _ENGINE_CHUNKS if c <= bk["seq"]]
    return cands or [{"prefill_chunk": max(1, bk["seq"])}]


def _engine_chunk_vmem(bk: dict, blocks: dict) -> int:
    return 0                             # activations, dwarfed by the pools


def _engine_chunk_roofline(bk: dict, blocks: dict, chip: ChipSpec) -> float:
    c = blocks["prefill_chunk"]
    w_bytes = 2.0e6 * bk["mtotal"]                 # bf16 weights, re-read
    flops_tok = 2.0e6 * bk["mactive"]
    t_comp = c * flops_tok / chip.peak_flops_bf16
    t_mem = w_bytes / chip.hbm_bandwidth
    imbalance = max(t_comp, t_mem) / max(min(t_comp, t_mem), 1e-12)
    return imbalance + 1e-6 * c          # tie-break toward lower stall


def engine_prefill_chunk(cfg, *, chip: ChipSpec = DEFAULT_CHIP,
                         max_seq: int = 4096) -> int:
    """Autotuned prefill-chunk size for serving ``cfg`` on ``chip``.

    Consulted by ``InferenceEngine`` when constructed with
    ``prefill_chunk=None`` — the per-app replacement for the static ctor
    default (the paper's "static server config" pitfall). Cached under the
    versioned autotune key like every kernel entry.
    """
    total, active = cfg.param_counts()
    shape = {"mtotal": max(1, int(total / 1e6)),
             "mactive": max(1, int(active / 1e6)),
             "seq": max(1, int(max_seq))}
    return best_config("engine_prefill_chunk", shape,
                       chip=chip)["prefill_chunk"]


def _flash_bucket(shape: dict) -> dict:
    return {"b": pow2_bucket(shape["b"]), "h": shape["h"], "kv": shape["kv"],
            "sq": pow2_bucket(shape["sq"]), "skv": pow2_bucket(shape["skv"]),
            "d": shape["d"], "causal": bool(shape.get("causal", True))}


def _flash_candidates(bk: dict) -> list[dict]:
    qs = sorted({largest_divisor(bk["sq"], c)
                 for c in _POW2_BLOCKS if c <= bk["sq"]} or {bk["sq"]})
    ks = sorted({largest_divisor(bk["skv"], c)
                 for c in _POW2_BLOCKS if c <= bk["skv"]} or {bk["skv"]})
    return [{"q_block": qb, "kv_block": kb} for qb in qs for kb in ks]


def _flash_vmem(bk: dict, blocks: dict) -> int:
    qb, kb, d = blocks["q_block"], blocks["kv_block"], bk["d"]
    return 4 * (2 * qb * d + 2 * kb * d + qb * kb + 2 * qb)


def _flash_roofline(bk: dict, blocks: dict, chip: ChipSpec) -> float:
    b, h, kv, sq, skv, d = (bk["b"], bk["h"], bk["kv"], bk["sq"], bk["skv"],
                            bk["d"])
    qb, kb = blocks["q_block"], blocks["kv_block"]
    causal = bk["causal"]
    frac = 0.5 if causal else 1.0
    flops = 4.0 * b * h * sq * skv * d * frac
    byts = 2.0 * (b * h * sq * d * 2 + 2 * b * kv * skv * d)
    steps = b * h * math.ceil(sq / qb) * math.ceil(skv / kb) * frac
    t = max(flops / chip.peak_flops_bf16, byts / chip.hbm_bandwidth)
    return t + steps * GRID_STEP_OVERHEAD_S


def _ssd_bucket(shape: dict) -> dict:
    return {"m": pow2_bucket(shape["m"]), "q": shape["q"], "h": shape["h"],
            "p": shape["p"], "n": shape["n"]}


def _ssd_candidates(bk: dict) -> list[dict]:
    h = bk["h"]
    cands = sorted({largest_divisor(h, c) for c in (1, 2, 4, 8, 16, 32)
                    if c <= h})
    return [{"head_block": hb} for hb in cands]


def _ssd_vmem(bk: dict, blocks: dict) -> int:
    q, p, n = bk["q"], bk["p"], bk["n"]
    hb = blocks["head_block"]
    return 4 * (q * q + 2 * q * hb * p + 2 * q * hb + 2 * q * n + hb * p * n)


def _ssd_roofline(bk: dict, blocks: dict, chip: ChipSpec) -> float:
    m, q, h, p, n = bk["m"], bk["q"], bk["h"], bk["p"], bk["n"]
    hb = blocks["head_block"]
    flops = 2.0 * m * (q * q * n + h * (q * q * (1 + p) + q * p * n))
    byts = 4.0 * (2 * m * q * h * p + 2 * m * q * h + 2 * m * q * n
                  + m * h * p * n)
    steps = m * math.ceil(h / hb)
    t = max(flops / chip.peak_flops_bf16, byts / chip.hbm_bandwidth)
    return t + steps * GRID_STEP_OVERHEAD_S


_KERNELS = {
    "decode_attention": (_decode_bucket, _decode_candidates, _decode_vmem,
                         _decode_roofline),
    "paged_decode_attention": (_paged_decode_bucket, _paged_decode_candidates,
                               _paged_decode_vmem, _paged_decode_roofline),
    "prefill_attention": (_prefill_attn_bucket, _prefill_attn_candidates,
                          _prefill_attn_vmem, _prefill_attn_roofline),
    "engine_prefill_chunk": (_engine_chunk_bucket, _engine_chunk_candidates,
                             _engine_chunk_vmem, _engine_chunk_roofline),
    "flash_attention": (_flash_bucket, _flash_candidates, _flash_vmem,
                        _flash_roofline),
    "ssd_chunk_scan": (_ssd_bucket, _ssd_candidates, _ssd_vmem,
                       _ssd_roofline),
}


# ---------------------------------------------------------------- frontend

def roofline_estimate(kernel: str, shape: dict, blocks: dict,
                      chip: ChipSpec = DEFAULT_CHIP) -> float:
    """Analytic seconds for one kernel invocation with these blocks."""
    bucket_fn, _, _, roof_fn = _KERNELS[kernel]
    return roof_fn(bucket_fn(shape), blocks, chip)


def candidates(kernel: str, shape: dict) -> list[dict]:
    bucket_fn, cand_fn, vmem_fn, _ = _KERNELS[kernel]
    bk = bucket_fn(shape)
    cands = [c for c in cand_fn(bk) if vmem_fn(bk, c) <= VMEM_BUDGET_BYTES]
    return cands or cand_fn(bk)[:1]   # degenerate shape: keep one candidate


def best_config(kernel: str, shape: dict, *, chip: ChipSpec = DEFAULT_CHIP,
                measure: Optional[Callable[[dict], float]] = None,
                top_k: int = 3) -> dict:
    """Best block config for ``kernel`` on ``shape``.

    Returns the block dict (e.g. ``{"s_block": 512}``). Consults the
    in-memory + JSON caches first; otherwise sweeps candidates, prunes with
    the roofline model, optionally times the survivors via ``measure``
    (``blocks -> seconds``), and persists the winner.
    """
    if kernel not in _KERNELS:
        raise KeyError(f"unknown kernel {kernel!r}; known: {sorted(_KERNELS)}")
    bucket_fn = _KERNELS[kernel][0]
    key = _key(kernel, bucket_fn(shape), chip)
    with _LOCK:
        _load_file()
        hit = _MEM.get(key)
        if hit is not None:
            return dict(hit["blocks"])

    cands = candidates(kernel, shape)
    scored = sorted(cands, key=lambda c: roofline_estimate(kernel, shape, c,
                                                           chip))
    source = "roofline"
    best = scored[0]
    best_t = roofline_estimate(kernel, shape, best, chip)
    if measure is not None:
        timed = [(measure(c), c) for c in scored[:top_k]]
        best_t, best = min(timed, key=lambda tc: tc[0])
        source = "measured"

    with _LOCK:
        _MEM[key] = {"blocks": dict(best), "est_us": best_t * 1e6,
                     "source": source}
        _save_file()
    return dict(best)


# ----------------------------------------- roofline batch-size selection
# (the "roofline-verified batch-size selection per app" roadmap item; the
# per-cell hint table in distributed/autotune.py re-exports this)

def _decode_row_bytes(cfg, ctx: int) -> float:
    """HBM bytes touched per batch row per decode step (cache traffic)."""
    if cfg.family in ("ssm", "hybrid"):
        h, p, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
        state = 4.0 * h * p * n + 2.0 * (cfg.ssm_conv_width - 1) * (
            cfg.ssm_d_inner + 2 * cfg.ssm_state)
        if cfg.family == "ssm":
            return cfg.num_layers * 2 * state      # read + write
        n_attn = cfg.num_layers // cfg.attn_every
        n_ssm = cfg.num_layers - n_attn
        kv = 2.0 * n_attn * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * ctx
        return n_ssm * 2 * state + kv
    layers = getattr(cfg, "num_decoder_layers", 0) or cfg.num_layers
    return 2.0 * layers * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * ctx


def roofline_batch_size(cfg, kind: str = "decode", *,
                        chip: ChipSpec = DEFAULT_CHIP,
                        ctx: int = 4096) -> int:
    """Decode batch size where the model crosses from HBM- to compute-bound.

    Per step the weights are read once (``W`` bytes) regardless of batch,
    while compute and KV/state traffic scale with B:
    ``t_mem(B) = (W + B·R)/bw`` and ``t_comp(B) = B·2·P_active/peak``.
    The crossover batch amortizes the weight reads without queueing extra
    latency; it is capped by HBM capacity (weights + B rows of cache).
    """
    total, active = cfg.param_counts()
    w_bytes = 2.0 * total
    row = _decode_row_bytes(cfg, ctx)
    flop_per_tok = 2.0 * active
    denom = flop_per_tok / chip.peak_flops_bf16 - row / chip.hbm_bandwidth
    if denom <= 0:       # cache traffic dominates: batching never saturates
        b_star = float("inf")
    else:
        b_star = (w_bytes / chip.hbm_bandwidth) / denom
    cache_row_cap = max(row / 2.0, 1.0)   # resident bytes per row (one copy)
    b_cap = max(1.0, (chip.hbm_bytes - w_bytes) / cache_row_cap)
    b = int(max(1.0, min(b_star, b_cap)))
    return max(1, 1 << (b.bit_length() - 1))   # floor to a power of two
