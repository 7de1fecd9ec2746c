# Copy of src/repro/distributed/autotune.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Per-(arch-family × step-kind) best-known configurations, measured by the
§Perf hillclimb (EXPERIMENTS.md). The launcher applies these instead of a
one-size-fits-all flag set — the measured sweep shows each knob helps some
cells and hurts others:

  - moe_impl=shardmap: 3–6× on MoE train/prefill (kills dispatch
    all-gathers) but LOSES on decode (8 tokens/shard can't amortize the
    shard_map region) → train/prefill only.
  - attn_impl=repeat_kv: only when H % 16 == 0 (else it just multiplies KV
    bytes — qwen3's 40 heads regressed 13%).
  - kv_cache_dtype=int8: decode only (1.5–2× across all KV archs).
  - remat=dots: dense/MoE/hybrid train (+10% … +100%); regressed enc-dec.
  - attn_logits_bf16: train/prefill with long sequences.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
# Batch-size selection is folded into the roofline-verified kernel autotuner
# (same analytic chip model, same cache machinery); re-exported here so the
# launcher keeps a single "what config should this cell run" import.
from repro_torch.kernels.autotune import roofline_batch_size as best_batch_size  # noqa: F401


def best_hints(cfg: ModelConfig, kind: str) -> tuple[dict, str]:
    """Returns (hints dict, remat policy) for a (config, step-kind) cell."""
    hints: dict = {}
    remat = "full"
    decode = kind in ("decode", "long_decode")
    heads_ok = cfg.num_heads and cfg.num_heads % 16 == 0

    if cfg.is_moe and not decode:
        hints["moe_impl"] = "shardmap"
    if decode and cfg.family in ("dense", "moe", "vlm"):
        hints["kv_cache_dtype"] = "int8"
    if not decode and cfg.family != "encdec":
        hints["attn_logits_bf16"] = True
        if heads_ok and cfg.num_kv_heads < cfg.num_heads:
            hints["attn_impl"] = "repeat_kv"
    if kind == "train" and cfg.family in ("dense", "moe", "vlm", "hybrid"):
        remat = "dots"
    return hints, remat
