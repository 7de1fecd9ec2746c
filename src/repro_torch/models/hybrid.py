"""Jamba-style hybrid: Mamba/attention interleave + alternating dense/MoE FFN.

Counterpart of :mod:`repro.models.hybrid`. The layer stack is periodic
with period ``attn_every`` (8 for jamba): within a period, sublayer i is
an SSD mixer except the last, which is attention; FFNs alternate
dense/MoE per ``moe_every``. Parameters keep the JAX leaves: ``blocks``
holds one period's sublayers ``sub0 .. sub{p-1}``, every leaf stacked on
a leading axis of the ``num_layers / attn_every`` periods; the JAX
``lax.scan`` over periods is a Python loop.

Caches: the attention sublayers' KV is the dense family's — contiguous
``(nb, B, max_seq + 1, KV, hd)`` with its drop position, or the page
pool ``(nb, pages + 1, page, KV, hd)`` with its drop page, one pool row
per period — and the SSD sublayers' recurrent state stays slot-resident,
``ssm`` leaves ``(nb, n_ssm, B, ...)``: the batch on axis 2. Steps write
both in place; inactive rows keep their KV (the drop slot takes their
writes) and their state (``ssm.mask_state``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, moe, ssm, transformer
from repro_torch.models.transformer import (_remat, _write_mask,
                                            cache_write_index, layer_view,
                                            paged_write_index, unstack_layers)


def _period(cfg: ModelConfig) -> int:
    return cfg.attn_every


def _is_attn(cfg: ModelConfig, i: int) -> bool:
    return i == _period(cfg) - 1


def _is_moe(cfg: ModelConfig, i: int) -> bool:
    return cfg.moe_every > 0 and (i % cfg.moe_every == cfg.moe_every - 1)


def num_blocks(cfg: ModelConfig) -> int:
    """Periods in the stack: one attention sublayer (and KV layer) each."""
    return cfg.num_layers // _period(cfg)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> dict:
    """Random weights drawn from ``gen`` on ``gen.device``: the JAX
    initialiser's leaves, shapes and scales (not its numbers)."""
    if cfg.num_layers % _period(cfg):
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple "
                         f"of attn_every {_period(cfg)}")
    nb, d = num_blocks(cfg), cfg.d_model
    dev = gen.device
    blocks = {}
    for i in range(_period(cfg)):
        sub = {"ln1": torch.ones((nb, d), device=dev),
               "ln2": torch.ones((nb, d), device=dev)}
        if _is_attn(cfg, i):
            sub["attn"] = transformer.init_attn(gen, cfg, (nb,), dtype)
        else:
            sub["ssm"] = ssm.init_ssm(gen, cfg, lead=(nb,), dtype=dtype)
        if _is_moe(cfg, i):
            sub["moe"] = moe.init_moe(gen, cfg, lead=(nb,), dtype=dtype)
        else:
            sub["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, lead=(nb,),
                                         dtype=dtype)
        blocks[f"sub{i}"] = sub
    return {
        "embedding": layers.dense_init(gen, (cfg.padded_vocab, d),
                                       dtype=dtype),
        "blocks": blocks,
        "ln_f": torch.ones((d,), device=dev),
        "lm_head": layers.dense_init(gen, (d, cfg.padded_vocab),
                                     dtype=dtype),
    }


def _sub_ffn(sub: dict, x: torch.Tensor, cfg: ModelConfig,
             token_mask: torch.Tensor | None = None):
    if "moe" in sub:
        return moe.moe_dispatch(sub["moe"], x, cfg, token_mask)
    return layers.mlp(sub["mlp"], x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            remat: str = "full", return_cache: bool = False):
    """tokens: (B, S) -> (logits, aux) or, with ``return_cache``,
    (logits, aux, {"k", "v": (nb, B, S, KV, hd), "ssm": states (nb, n_ssm,
    B, ...)}). Any ``remat`` but ``none`` recomputes each period in the
    backward pass, as the JAX body's ``jax.checkpoint``."""
    x = layers.embed(params["embedding"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x, bp):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kv, states = None, []
        for i in range(_period(cfg)):
            sub = bp[f"sub{i}"]
            h = layers.rmsnorm(x, sub["ln1"], cfg.norm_eps)
            if _is_attn(cfg, i):
                out, kv = transformer.attention_block(sub["attn"], h, cfg,
                                                      positions)
            else:
                out, st = ssm.ssd_forward(sub["ssm"], h, cfg)
                states.append(st)
            x = x + out
            h2 = layers.rmsnorm(x, sub["ln2"], cfg.norm_eps)
            f, a = _sub_ffn(sub, h2, cfg)
            x = x + f
            aux = aux + a
        if not return_cache:
            return x, aux, None
        return x, aux, (kv, {k: torch.stack([st[k] for st in states])
                             for k in states[0]})

    body = _remat(body, "none" if remat == "none" else "full")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for bp in unstack_layers(params["blocks"], num_blocks(cfg)):
        x, a, y = body(x, bp)
        aux = aux + a
        ys.append(y)
    logits = transformer.lm_logits(params, x, cfg, tied=False)
    if not return_cache:
        return logits, aux
    states = {k: torch.stack([st[k] for _, st in ys]) for k in ys[0][1]}
    return logits, aux, {"k": torch.stack([kv[0] for kv, _ in ys]),
                         "v": torch.stack([kv[1] for kv, _ in ys]),
                         "ssm": states}


def _ssm_states(cfg: ModelConfig, batch: int, device: torch.device,
                dtype) -> dict:
    return ssm.init_ssm_state(cfg, batch, device, dtype,
                              lead=(num_blocks(cfg), _period(cfg) - 1))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device, dtype=torch.bfloat16) -> dict:
    """The attention sublayers' contiguous KV (one layer a period, with
    the drop position) and the SSD sublayers' state, ``(nb, n_ssm, B,
    ...)`` (the SSM state float32, conv states in ``dtype``)."""
    cache = transformer.init_cache(cfg, batch, max_seq, device, dtype,
                                   num_layers=num_blocks(cfg))
    cache["ssm"] = _ssm_states(cfg, batch, device, dtype)
    return cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     batch: int, device: torch.device,
                     dtype=torch.bfloat16) -> dict:
    """Paged hybrid cache: the attention sublayers' KV in a shared page
    pool (one pool row per period, with the drop page); the SSD
    sublayers' O(1) state stays slot-resident — there is nothing to
    page."""
    cache = transformer.init_paged_cache(cfg, num_pages, page_size, device,
                                         dtype, num_layers=num_blocks(cfg))
    cache["ssm"] = _ssm_states(cfg, batch, device, dtype)
    return cache


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_seq: int):
    """Run the whole prompt: (logits, cache) with the KV in
    :func:`init_cache`'s layout (bfloat16, the prompt in the first S
    positions) and the SSD states as the forward made them."""
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq {max_seq}")
    logits, _, kv = forward(params, tokens, cfg, remat="none",
                            return_cache=True)
    cache = transformer.init_cache(cfg, b, max_seq, logits.device,
                                   num_layers=num_blocks(cfg))
    cache = transformer.fill_cache(cache, kv, s)
    cache["ssm"] = kv["ssm"]
    return logits, cache


def _run_blocks(params: dict, cache: dict, x: torch.Tensor, cfg: ModelConfig,
                attend, mix, active) -> torch.Tensor:
    """Every period's sublayers, then the logits. ``attend(blk, p, h)`` is
    period ``blk``'s attention (it writes the period's KV);
    ``mix(p, h, state)`` an SSD sublayer's (out, new state), which is
    written into ``cache["ssm"]`` in place; ``active`` reaches the MoE
    FFNs."""
    states = cache["ssm"]
    for blk in range(num_blocks(cfg)):
        bp = layer_view(params["blocks"], blk)
        si = 0
        for i in range(_period(cfg)):
            sub = bp[f"sub{i}"]
            h = layers.rmsnorm(x, sub["ln1"], cfg.norm_eps)
            if _is_attn(cfg, i):
                out = attend(blk, sub["attn"], h)
            else:
                st = {k: v[blk, si] for k, v in states.items()}
                out, new = mix(sub["ssm"], h, st)
                for k, v in new.items():
                    states[k][blk, si].copy_(v)
                si += 1
            x = x + out
            h2 = layers.rmsnorm(x, sub["ln2"], cfg.norm_eps)
            x = x + _sub_ffn(sub, h2, cfg, token_mask=active)[0]
    return transformer.lm_logits(params, x, cfg, tied=False)


def _decode_mix(cfg, active):
    return lambda p, h, st: ssm.ssm_decode_step(p, h, st, cfg, active=active)


def _chunk_mix(cfg, active, valid):
    def mix(p, h, st):
        out, new = ssm.ssd_forward(p, h, cfg, init_state=st,
                                   token_valid=valid)
        if active is not None:
            new = ssm.mask_state(new, st, active)
        return out, new
    return mix


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                lengths: torch.Tensor, cfg: ModelConfig,
                active: torch.Tensor | None = None):
    """One decode step on the contiguous cache: (logits (B, V), cache).
    Inactive rows keep both their KV rows and their SSM state."""
    x = layers.embed(params["embedding"], tokens)
    index = cache_write_index(lengths[:, None],
                              _write_mask(tokens.shape[0], 1, x.device,
                                          active, None),
                              cache["k"].shape[2] - 1)
    logits = _run_blocks(params, cache, x, cfg, lambda blk, p, h:
                         transformer.attention_decode_block(
                             p, h, cfg, cache["k"][blk], cache["v"][blk],
                             lengths, index),
                         _decode_mix(cfg, active), active)
    return logits[:, 0], cache


def decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      lengths: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig, active: torch.Tensor | None = None):
    """Paged decode across the SSD/attention interleave: attention KV
    through the page pool and block tables, SSM state slot-resident."""
    x = layers.embed(params["embedding"], tokens)
    _, pages, page = cache["k_pages"].shape[:3]
    index = paged_write_index(lengths[:, None], block_tables, page,
                              _write_mask(tokens.shape[0], 1, x.device,
                                          active, None), pages - 1)
    logits = _run_blocks(params, cache, x, cfg, lambda blk, p, h:
                         transformer.attention_decode_block_paged(
                             p, h, cfg, cache["k_pages"][blk],
                             cache["v_pages"][blk], block_tables, lengths,
                             index),
                         _decode_mix(cfg, active), active)
    return logits[:, 0], cache


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                  start_len: torch.Tensor, cfg: ModelConfig,
                  active: torch.Tensor | None = None,
                  valid: torch.Tensor | None = None):
    """Batched chunked prefill across the interleave on the contiguous
    cache: attention sublayers write the chunk's K/V at per-row offsets
    and attend over the cache; SSD sublayers run one chunked-SSD pass from
    the cached state. ``valid``: per-row real-token count (pads at the
    tail write no KV and get dt = 0). Returns (logits (B, C, V), cache)."""
    x = layers.embed(params["embedding"], tokens)
    b, c = tokens.shape
    positions = start_len[:, None] + torch.arange(c, device=x.device)[None, :]
    index = cache_write_index(positions,
                              _write_mask(b, c, x.device, active, valid),
                              cache["k"].shape[2] - 1)
    logits = _run_blocks(params, cache, x, cfg, lambda blk, p, h:
                         transformer.attention_prefill_chunk_block(
                             p, h, cfg, cache["k"][blk], cache["v"][blk],
                             start_len, index),
                         _chunk_mix(cfg, active, valid), active)
    return logits, cache


def prefill_chunk_paged(params: dict, cache: dict, tokens: torch.Tensor,
                        start_len: torch.Tensor, block_tables: torch.Tensor,
                        cfg: ModelConfig, active: torch.Tensor | None = None,
                        valid: torch.Tensor | None = None):
    """Paged batched chunked prefill; see :func:`prefill_chunk`."""
    x = layers.embed(params["embedding"], tokens)
    b, c = tokens.shape
    _, pages, page = cache["k_pages"].shape[:3]
    positions = start_len[:, None] + torch.arange(c, device=x.device)[None, :]
    index = paged_write_index(positions, block_tables, page,
                              _write_mask(b, c, x.device, active, valid),
                              pages - 1)
    logits = _run_blocks(params, cache, x, cfg, lambda blk, p, h:
                         transformer.attention_prefill_chunk_block_paged(
                             p, h, cfg, cache["k_pages"][blk],
                             cache["v_pages"][blk], block_tables, start_len,
                             index),
                         _chunk_mix(cfg, active, valid), active)
    return logits, cache
