# Copy of src/repro/distributed/hints.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Global sharding/layout hints — the hillclimb knobs (EXPERIMENTS.md §Perf).

Models read these at trace time; the dry-run CLI sets them per variant so
each hypothesis lowers as a one-flag change against the same code:

  moe_impl            scatter (baseline) | shardmap (local EP dispatch +
                      one psum per layer — kills the data->model scatter
                      all-gathers)
  attn_kv_replicated  False (baseline) | True: constrain k/v to be
                      model-replicated right after projection so GQA
                      reshapes/blocking stay local (one small all-gather per
                      layer instead of per-q-block gathers)
  kv_cache_dtype      bfloat16 (baseline) | int8: quantized KV cache with
                      per-(token, head) scales — halves decode cache traffic
  seq_parallel_residual  False | True: residual stream sharded over model
                      between blocks (all-reduce -> reduce-scatter+all-gather)
"""
from __future__ import annotations

import contextlib
from typing import Any

_DEFAULTS: dict[str, Any] = {
    "moe_impl": "scatter",
    "attn_kv_replicated": False,
    "attn_impl": "gqa_grouped",   # | repeat_kv: broadcast KV to H heads so
                                  # the head dim stays 16-shardable (kills the
                                  # per-layer q all-gather the GQA reshape
                                  # (H -> KV x G, both < 16) forces)
    "kv_cache_dtype": "bfloat16",
    "attn_logits_bf16": False,    # store flash logit/prob blocks in bf16
                                  # (f32 accumulators kept) — halves the
                                  # dominant attention-materialization bytes
    "seq_parallel_residual": False,  # reserved: Megatron-SP residual layout
    "residual_replicated": False,  # pin the bf16 residual stream to
                                   # model-replicated after every sublayer —
                                   # stops XLA all-gathering the f32 rmsnorm
                                   # upcast (measured 23.6 GB/layer on
                                   # chameleon train_4k)
}

_ACTIVE = dict(_DEFAULTS)


def get(name: str):
    return _ACTIVE[name]


def set_hint(name: str, value):
    if name not in _DEFAULTS:
        raise KeyError(f"unknown hint {name!r}; known: {sorted(_DEFAULTS)}")
    if isinstance(_DEFAULTS[name], bool) and isinstance(value, str):
        value = value.lower() in ("1", "true", "yes", "on")
    _ACTIVE[name] = value


def reset():
    _ACTIVE.update(_DEFAULTS)


@contextlib.contextmanager
def hints(**kw):
    prev = {k: _ACTIVE[k] for k in kw}
    try:
        for k, v in kw.items():
            set_hint(k, v)
        yield
    finally:
        _ACTIVE.update(prev)
