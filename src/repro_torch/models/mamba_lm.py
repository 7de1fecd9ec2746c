"""Mamba2 LM (family=ssm): an attention-free stack of SSD blocks.

Counterpart of :mod:`repro.models.mamba_lm`: ``init_params``,
``forward``, ``prefill``, ``init_cache``, ``decode_step`` and
``prefill_chunk``. Layer = x + SSD(rmsnorm(x)); no separate FFN. Decode
carries an O(1) state per layer, so a row's cost does not grow with its
context. ``forward`` runs the SSD kernel on the card, which has no
backward yet: there a forward that needs gradients raises
(``ops.ssd_intra_chunk``); on the CPU it trains through the plain path.

The cache is updated IN PLACE: each layer's new state is written into the
caller's cache tensors, which casts it to their dtypes (conv states in
the serving dtype, the SSM state in float32) — the cast the JAX
``ModelBundle`` applies to the rebuilt cache after every step.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, ssm
from repro_torch.models.transformer import (_remat, layer_view, lm_logits,
                                            unstack_layers)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> dict:
    """Random weights drawn from ``gen`` on ``gen.device``: the JAX
    initialiser's leaves, shapes and scales, stacked on a leading layer
    axis (not its numbers)."""
    n, d = cfg.num_layers, cfg.d_model
    dev = gen.device
    params = {
        "embedding": layers.dense_init(gen, (cfg.padded_vocab, d),
                                       dtype=dtype),
        "layers": {
            "ln": torch.ones((n, d), device=dev),
            "ssm": ssm.init_ssm(gen, cfg, lead=(n,), dtype=dtype),
        },
        "ln_f": torch.ones((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, (d, cfg.padded_vocab),
                                              dtype=dtype)
    return params


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            remat: str = "full", return_state: bool = False):
    """tokens: (B, S) -> (logits (B, S, V), aux 0) or, with
    ``return_state``, (logits, aux, states): every layer's final state
    stacked on a leading layer axis (:func:`init_cache`'s leaves). Any
    ``remat`` but ``none`` recomputes each layer in the backward pass, as
    the JAX body's ``jax.checkpoint``."""
    x = layers.embed(params["embedding"], tokens)

    def body(x, lp):
        h = layers.rmsnorm(x, lp["ln"], cfg.norm_eps)
        out, state = ssm.ssd_forward(lp["ssm"], h, cfg)
        return x + out, (state if return_state else None)

    body = _remat(body, "none" if remat == "none" else "full")
    states = []
    for lp in unstack_layers(params["layers"], cfg.num_layers):
        x, st = body(x, lp)
        states.append(st)
    logits = lm_logits(params, x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_state:
        return logits, aux, {k: torch.stack([st[k] for st in states])
                             for k in states[0]}
    return logits, aux


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_seq: int = 0):
    """Run the whole prompt: (logits, the per-layer states) — the JAX
    prefill's cache, in the dtypes the forward made them (float32 with
    float32 weights)."""
    logits, _, states = forward(params, tokens, cfg, remat="none",
                                return_state=True)
    return logits, states


def init_cache(cfg: ModelConfig, batch: int, device: torch.device,
               dtype=torch.bfloat16) -> dict:
    """Per-layer recurrent state, batch-major after the layer axis:
    ``ssm`` (L, B, H, P, N) float32, ``conv_*`` (L, B, W-1, C) in
    ``dtype``. Its size does not depend on the sequence length."""
    return ssm.init_ssm_state(cfg, batch, device, dtype,
                              lead=(cfg.num_layers,))


def _run_layers(params: dict, cache: dict, x: torch.Tensor,
                cfg: ModelConfig, block) -> torch.Tensor:
    """Every residual SSD block; ``block(p_ssm, h, state)`` returns the
    block's output and new state, which is written into ``cache``."""
    for i in range(cfg.num_layers):
        lp = layer_view(params["layers"], i)
        state = {k: v[i] for k, v in cache.items()}
        h = layers.rmsnorm(x, lp["ln"], cfg.norm_eps)
        out, new = block(lp["ssm"], h, state)
        x = x + out
        for k, v in new.items():
            cache[k][i].copy_(v)
    return lm_logits(params, x, cfg)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                lengths: torch.Tensor, cfg: ModelConfig,
                active: torch.Tensor | None = None):
    """tokens: (B,1); ``lengths`` unused (the state summarizes the whole
    prefix). Returns (logits (B, V), cache) with the new state written
    into ``cache`` in place; rows with ``active=False`` keep theirs."""
    del lengths
    x = layers.embed(params["embedding"], tokens)
    logits = _run_layers(params, cache, x, cfg, lambda p, h, st:
                         ssm.ssm_decode_step(p, h, st, cfg, active=active))
    return logits[:, 0], cache


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                  start_len: torch.Tensor, cfg: ModelConfig,
                  active: torch.Tensor | None = None,
                  valid: torch.Tensor | None = None):
    """Batched chunked prefill: one SSD pass over C tokens per layer,
    continuing from the cached state (``start_len`` is implicit in it).

    tokens: (B,C) -> (logits (B,C,V), cache) with the new state written
    into ``cache`` in place. Inactive rows keep their state; ``valid``:
    optional (B,) real-token count per row (pads at the tail get dt=0, so
    the state only ever sees real tokens; pad logits are garbage)."""
    del start_len

    def block(p, h, st):
        out, new = ssm.ssd_forward(p, h, cfg, init_state=st,
                                   token_valid=valid)
        if active is not None:
            new = ssm.mask_state(new, st, active)
        return out, new

    x = layers.embed(params["embedding"], tokens)
    return _run_layers(params, cache, x, cfg, block), cache
