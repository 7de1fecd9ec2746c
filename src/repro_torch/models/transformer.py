"""Decoder-only transformer LM, dense family: the paged serving subset.

Counterpart of :mod:`repro.models.transformer`. Parameters are a nested
dict with the same leaf names and shapes as the JAX package — the einsum
layouts ``wq (d, h, hd)``, ``wk``/``wv (d, kv, hd)``, ``wo (h, hd, d)`` —
with every per-layer leaf stacked on a leading layer axis, so one set of
weights drives both packages (:mod:`repro_torch.models.convert`). The
JAX ``lax.scan`` over layers is a Python loop over per-layer views.

The page pools are updated IN PLACE: where the JAX functions return a
rebuilt cache, these write the new keys/values into the caller's pool
tensors and return the same dict.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

# ----------------------------------------------------------------- params


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> dict:
    """Random weights drawn from ``gen`` on ``gen.device`` (normal, 0.02),
    norms at 1 — the JAX initialiser's shapes and scales, not its numbers
    (a ``torch.Generator`` and a JAX key give different streams)."""
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, n = cfg.resolved_head_dim, cfg.num_layers
    dev = gen.device
    emb = layers.dense_init(gen, (cfg.padded_vocab, d), dtype=dtype)
    attn = {
        "wq": layers.dense_init(gen, (n, d, h, hd), dtype=dtype),
        "wk": layers.dense_init(gen, (n, d, kv, hd), dtype=dtype),
        "wv": layers.dense_init(gen, (n, d, kv, hd), dtype=dtype),
        "wo": layers.dense_init(gen, (n, h, hd, d), dtype=dtype),
    }
    if cfg.use_qk_norm:
        attn["q_norm"] = torch.ones((n, hd), device=dev)
        attn["k_norm"] = torch.ones((n, hd), device=dev)
    params = {
        "embedding": emb,
        "layers": {
            "ln1": torch.ones((n, d), device=dev),
            "ln2": torch.ones((n, d), device=dev),
            "attn": attn,
            "ffn": layers.init_mlp(gen, d, cfg.d_ff, lead=(n,), dtype=dtype),
        },
        "ln_f": torch.ones((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, (d, cfg.padded_vocab),
                                              dtype=dtype)
    return params


def layer_view(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {k: layer_view(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device: torch.device, dtype=torch.bfloat16) -> dict:
    """Page-pool KV cache: ``num_pages`` shared pages of ``page_size``
    tokens per layer, ``(L, num_pages + 1, page, KV, hd)``; rows address
    them through engine-side block tables. The extra last page is the drop
    page (:func:`paged_write_index`): no block table names it."""
    shape = (cfg.num_layers, num_pages + 1, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


# ----------------------------------------------------------------- pieces

def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, rope_q: bool = True):
    """``rope_q=False``: leave q un-rotated — the paged attention applies
    the rotation itself (k is always rotated before caching)."""
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dke->bske", x, p["wk"])
    v = torch.einsum("bsd,dke->bske", x, p["wv"])
    if cfg.use_qk_norm:
        q = layers.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope_q:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def paged_write_index(positions: torch.Tensor, block_tables: torch.Tensor,
                      page: int, keep: torch.Tensor, drop_page: int):
    """Where the new tokens' K/V land in the pool.

    positions: (B, C) absolute positions; keep: (B, C) bool — which writes
    count. Returns ``(page_ids, offsets)``, each (B*C,), one per token.
    The JAX package drops inactive rows and pad tokens by pointing their
    page id past the pool end under ``mode="drop"``; an out-of-range
    ``index_put_`` would fault, and filtering them out (``nonzero``) would
    make the host wait for the card on every dispatch. So the port sends
    them to ``drop_page``, the spare last page of the pool
    (:func:`init_paged_cache`) — the id JAX points them at, made real.
    No block table names it, so what lands there is never read. Every
    dispatch then writes all B*C tokens, at fixed shapes and with no host
    sync. The block index is clamped to ``nb - 1`` as in JAX.
    """
    nb = block_tables.shape[1]
    block = torch.clamp(positions // page, max=nb - 1)
    pidx = torch.gather(block_tables.long(), 1, block.long())
    pidx = torch.where(keep, pidx, torch.full_like(pidx, drop_page))
    return pidx.reshape(-1), (positions % page).reshape(-1).long()


def _write_pages(pages: torch.Tensor, new: torch.Tensor, index) -> None:
    pidx, off = index
    pages[pidx, off] = new.reshape(-1, *new.shape[2:]).to(pages.dtype)


def attention_decode_block_paged(p: dict, x: torch.Tensor, cfg: ModelConfig,
                                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor, write_index):
    """One-token attention against a PAGED cache.

    x: (B,1,D); pools: (P, page, KV, hd) — written in place; block_tables:
    (B, nb) int32 page ids. The new k/v lands in the page covering position
    ``lengths`` (the engine maps that page before dispatch); attention reads
    K/V through the block table (``ops.attention_decode_paged``).

    ``write_index``: this dispatch's :func:`paged_write_index`, the same
    for every layer. It holds the JAX ``active`` mask: inactive rows write
    only into the drop page, and their outputs are garbage the caller
    ignores.
    """
    positions = lengths[:, None]
    q, k, v = _project_qkv(p, x, cfg, positions, rope_q=False)
    _write_pages(k_pages, k, write_index)
    _write_pages(v_pages, v, write_index)
    o = ops.attention_decode_paged(q, k_pages, v_pages, block_tables,
                                   lengths + 1, rope_theta=cfg.rope_theta)
    return torch.einsum("bshe,hed->bsd", o, p["wo"])


def attention_prefill_chunk_block_paged(p: dict, x: torch.Tensor,
                                        cfg: ModelConfig,
                                        k_pages: torch.Tensor,
                                        v_pages: torch.Tensor,
                                        block_tables: torch.Tensor,
                                        start_len: torch.Tensor, write_index):
    """Chunked-prefill attention against a PAGED cache: C new tokens are
    written into their rows' pages (positions ``start_len ..
    start_len+C-1`` resolved through the block table) and attended
    causally. ``write_index`` (this dispatch's :func:`paged_write_index`)
    holds the JAX ``active`` and ``valid`` masks: inactive rows and tail
    pads write only into the drop page, and their outputs are
    garbage."""
    c = x.shape[1]
    positions = start_len[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, rope_q=False)
    _write_pages(k_pages, k, write_index)
    _write_pages(v_pages, v, write_index)
    o = ops.attention_prefill_chunk_paged(q, k_pages, v_pages, block_tables,
                                          start_len,
                                          rope_theta=cfg.rope_theta)
    return torch.einsum("bshe,hed->bsd", o.to(x.dtype), p["wo"])


def _write_mask(b: int, c: int, device, active, valid) -> torch.Tensor:
    """(B, C) bool: which of the dispatch's new tokens reach their own
    page (the others go to the drop page)."""
    keep = torch.ones((b, c), dtype=torch.bool, device=device)
    if active is not None:
        keep = keep & active[:, None]
    if valid is not None:
        keep = keep & (torch.arange(c, device=device)[None, :]
                       < valid[:, None])
    return keep


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = layers.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return layers.unembed(x, params["embedding"], transpose=True)
    return layers.unembed(x, params["lm_head"], transpose=False)


# ---------------------------------------------------------------- forward

def decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      lengths: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig, active: torch.Tensor | None = None):
    """One decode step against the paged cache. tokens: (B,1); lengths:
    (B,) int32; block_tables: (B, nb) int32. Returns (logits (B, V),
    cache) with the new K/V written into ``cache`` (from
    :func:`init_paged_cache`: its last page is the drop page) in place;
    inactive rows leave every page but the drop page untouched."""
    x = layers.embed(params["embedding"], tokens)
    _, pages, page = cache["k_pages"].shape[:3]
    index = paged_write_index(lengths[:, None], block_tables, page,
                              _write_mask(tokens.shape[0], 1, x.device,
                                          active, None), pages - 1)
    for i in range(cfg.num_layers):
        lp = layer_view(params["layers"], i)
        h = layers.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        attn_out = attention_decode_block_paged(
            lp["attn"], h, cfg, cache["k_pages"][i], cache["v_pages"][i],
            block_tables, lengths, index)
        x = x + attn_out
        h2 = layers.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + layers.mlp(lp["ffn"], h2)
    return _logits(params, x, cfg)[:, 0], cache


def prefill_chunk_paged(params: dict, cache: dict, tokens: torch.Tensor,
                        start_len: torch.Tensor, block_tables: torch.Tensor,
                        cfg: ModelConfig, active: torch.Tensor | None = None,
                        valid: torch.Tensor | None = None):
    """Batched chunked prefill against the paged cache: advance every row
    by C tokens in one pass. tokens: (B, C); start_len: (B,) int32 tokens
    already cached per row. Returns (logits (B, C, V), cache) with the
    chunk's K/V written into ``cache`` (from :func:`init_paged_cache`) in
    place. Rows with ``active=False`` and tail pads beyond ``valid`` write
    only into the drop page, the pool's last."""
    x = layers.embed(params["embedding"], tokens)
    b, c = tokens.shape
    _, pages, page = cache["k_pages"].shape[:3]
    positions = start_len[:, None] + torch.arange(c, device=x.device)[None, :]
    index = paged_write_index(positions, block_tables, page,
                              _write_mask(b, c, x.device, active, valid),
                              pages - 1)
    for i in range(cfg.num_layers):
        lp = layer_view(params["layers"], i)
        h = layers.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        attn_out = attention_prefill_chunk_block_paged(
            lp["attn"], h, cfg, cache["k_pages"][i], cache["v_pages"][i],
            block_tables, start_len, index)
        x = x + attn_out
        h2 = layers.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + layers.mlp(lp["ffn"], h2)
    return _logits(params, x, cfg), cache
