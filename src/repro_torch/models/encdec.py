"""Encoder-decoder backbone (seamless-m4t class).

Counterpart of :mod:`repro.models.encdec`. The audio frontend is a stub:
callers supply precomputed fbank-frame embeddings (B, Tf, d_model), and a
learned linear projection stands in for the feature extractor. The
encoder is bidirectional — its attention is the flash kernel with
``causal=False`` on the card; the decoder is causal with self- and
cross-attention, and serves with a growing self-KV cache (the dense
family's contiguous cache or page pool, with their drop slots) plus a
static, slot-resident cross-KV cache ``(Ld, B, Tf, KV, hd)``.

Cross-attention is the JAX package's plain attention on both devices, as
the reference computes it outside any Pallas kernel: ``naive_attention``
(block-wise ``flash_attention_jnp`` from 2048 queries and frames) in
``forward``, ``decode_attention`` over the whole static cross-KV in the
decode steps. The chunked prefills are token-stepped — one decode step
per chunk token, a Python loop where JAX scans — with JAX's ``valid``
contract: step j deactivates the rows with ``j >= valid``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, layers, transformer
from repro_torch.models.transformer import (_remat, _write_mask,
                                            cache_write_index, layer_view,
                                            paged_write_index, unstack_layers)

FRAME_RATIO = 4  # target tokens per encoder frame (fbank subsampling stub)


def frames_len(seq_len: int) -> int:
    return max(8, seq_len // FRAME_RATIO)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> dict:
    """Random weights drawn from ``gen`` on ``gen.device``: the JAX
    initialiser's leaves, shapes and scales (not its numbers)."""
    d, ne, nd = cfg.d_model, cfg.num_encoder_layers, cfg.num_decoder_layers
    dev = gen.device

    def ones(n):
        return torch.ones((n, d), device=dev)

    return {
        "frontend": layers.dense_init(gen, (d, d), dtype=dtype),
        "embedding": layers.dense_init(gen, (cfg.padded_vocab, d),
                                       dtype=dtype),
        "encoder": {
            "ln1": ones(ne), "ln2": ones(ne),
            "attn": transformer.init_attn(gen, cfg, (ne,), dtype),
            "ffn": layers.init_mlp(gen, d, cfg.d_ff, lead=(ne,),
                                   dtype=dtype),
        },
        "decoder": {
            "ln1": ones(nd), "lnx": ones(nd), "ln2": ones(nd),
            "self_attn": transformer.init_attn(gen, cfg, (nd,), dtype),
            "cross_attn": transformer.init_attn(gen, cfg, (nd,), dtype),
            "ffn": layers.init_mlp(gen, d, cfg.d_ff, lead=(nd,),
                                   dtype=dtype),
        },
        "ln_enc": torch.ones((d,), device=dev),
        "ln_f": torch.ones((d,), device=dev),
        "lm_head": layers.dense_init(gen, (d, cfg.padded_vocab),
                                     dtype=dtype),
    }


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           remat: str = "full") -> torch.Tensor:
    """frames: (B, Tf, D) precomputed embeddings (frontend stub) -> the
    normed encoder output (B, Tf, D)."""
    x = torch.einsum("btd,de->bte", frames, params["frontend"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x, lp):
        h = layers.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        out, _ = transformer.attention_block(lp["attn"], h, cfg, positions,
                                             causal=False)
        x = x + out
        h2 = layers.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + layers.mlp(lp["ffn"], h2)

    body = _remat(body, "none" if remat == "none" else "full")
    for lp in unstack_layers(params["encoder"], cfg.num_encoder_layers):
        x = body(x, lp)
    return layers.rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _cross_kv(p: dict, enc_out: torch.Tensor):
    k = torch.einsum("btd,dke->btke", enc_out, p["wk"])
    v = torch.einsum("btd,dke->btke", enc_out, p["wv"])
    return k, v


def _cross_q(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    if cfg.use_qk_norm:
        q = layers.rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return q


def _cross_attend(p: dict, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    q = _cross_q(p, x, cfg)
    if x.shape[1] >= ops.FLASH_MIN_SEQ and k.shape[1] >= 2048:
        o = attention.flash_attention_jnp(q, k, v, causal=False)
    else:
        o = attention.naive_attention(q, k, v, causal=False)
    return torch.einsum("bshe,hed->bsd", o, p["wo"])


def forward(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig, *, remat: str = "full",
            return_cache: bool = False):
    """Teacher-forced decode over ``tokens`` (B, S) attending to the
    encoded ``frames`` (B, Tf, D). Returns (logits, aux 0) or, with
    ``return_cache``, (logits, aux, {"k", "v": (Ld, B, S, KV, hd),
    "cross_k", "cross_v": (Ld, B, Tf, KV, hd)})."""
    enc_out = encode(params, frames, cfg, remat)
    x = layers.embed(params["embedding"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x, lp):
        h = layers.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        out, kv = transformer.attention_block(lp["self_attn"], h, cfg,
                                              positions)
        x = x + out
        hx = layers.rmsnorm(x, lp["lnx"], cfg.norm_eps)
        ck, cv = _cross_kv(lp["cross_attn"], enc_out)
        x = x + _cross_attend(lp["cross_attn"], hx, ck, cv, cfg)
        h2 = layers.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + layers.mlp(lp["ffn"], h2)
        return x, ((*kv, ck, cv) if return_cache else None)

    body = _remat(body, "none" if remat == "none" else "full")
    ys = []
    for lp in unstack_layers(params["decoder"], cfg.num_decoder_layers):
        x, y = body(x, lp)
        ys.append(y)
    logits = transformer.lm_logits(params, x, cfg, tied=False)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not return_cache:
        return logits, aux
    names = ("k", "v", "cross_k", "cross_v")
    return logits, aux, {n: torch.stack([y[i] for y in ys])
                         for i, n in enumerate(names)}


def _cross_cache(cfg: ModelConfig, batch: int, max_seq: int,
                 device: torch.device, dtype) -> dict:
    shape = (cfg.num_decoder_layers, batch, frames_len(max_seq),
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device, dtype=torch.bfloat16) -> dict:
    """The decoder's contiguous self-KV (with its drop position) and the
    static cross-KV of ``frames_len(max_seq)`` frames."""
    cache = transformer.init_kv_cache(cfg, batch, max_seq, device, dtype,
                                      num_layers=cfg.num_decoder_layers)
    cache.update(_cross_cache(cfg, batch, max_seq, device, dtype))
    return cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     batch: int, max_seq: int, device: torch.device,
                     dtype=torch.bfloat16) -> dict:
    """Paged enc-dec cache: the growing decoder self-KV in the page pool
    (with its drop page); the cross-KV is written once at encode time and
    never grows, so it stays slot-resident."""
    cache = transformer.init_paged_cache(cfg, num_pages, page_size, device,
                                         dtype,
                                         num_layers=cfg.num_decoder_layers)
    cache.update(_cross_cache(cfg, batch, max_seq, device, dtype))
    return cache


def prefill(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig, max_seq: int):
    """Encode the frames and run the whole prompt: (logits, cache) with
    the self-KV in :func:`init_cache`'s layout and the cross-KV of the
    given frames, all bfloat16."""
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq {max_seq}")
    logits, _, kv = forward(params, frames, tokens, cfg, remat="none",
                            return_cache=True)
    cache = transformer.init_kv_cache(cfg, b, max_seq, logits.device,
                                      num_layers=cfg.num_decoder_layers)
    cache = transformer.fill_cache(cache, kv, s)
    cache["cross_k"] = kv["cross_k"].to(torch.bfloat16)
    cache["cross_v"] = kv["cross_v"].to(torch.bfloat16)
    return logits, cache


def _run_decoder(params: dict, cache: dict, x: torch.Tensor,
                 cfg: ModelConfig, attend) -> torch.Tensor:
    """Every decoder layer on one token a row, then the logits.
    ``attend(i, p, h)`` is layer i's self-attention (it writes the
    layer's KV); the cross-attention reads all of the static cross-KV."""
    b = x.shape[0]
    for i in range(cfg.num_decoder_layers):
        lp = layer_view(params["decoder"], i)
        h = layers.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + attend(i, lp["self_attn"], h)
        hx = layers.rmsnorm(x, lp["lnx"], cfg.norm_eps)
        ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        q = _cross_q(lp["cross_attn"], hx, cfg)
        tf = torch.full((b,), ck.shape[1], dtype=torch.int32,
                        device=x.device)
        o = attention.decode_attention(q, ck, cv, tf)
        x = x + torch.einsum("bshe,hed->bsd", o, lp["cross_attn"]["wo"])
        h2 = layers.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + layers.mlp(lp["ffn"], h2)
    return transformer.lm_logits(params, x, cfg, tied=False)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                lengths: torch.Tensor, cfg: ModelConfig,
                active: torch.Tensor | None = None):
    """One decode step on the contiguous self-KV: (logits (B, V), cache);
    inactive rows write only their drop position."""
    x = layers.embed(params["embedding"], tokens)
    index = cache_write_index(lengths[:, None],
                              _write_mask(tokens.shape[0], 1, x.device,
                                          active, None),
                              cache["k"].shape[2] - 1)
    logits = _run_decoder(params, cache, x, cfg, lambda i, p, h:
                          transformer.attention_decode_block(
                              p, h, cfg, cache["k"][i], cache["v"][i],
                              lengths, index))
    return logits[:, 0], cache


def decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      lengths: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig, active: torch.Tensor | None = None):
    """Paged decode step: self-attention KV through the page pool and
    block tables; cross-attention reads the slot-resident static cache."""
    x = layers.embed(params["embedding"], tokens)
    _, pages, page = cache["k_pages"].shape[:3]
    index = paged_write_index(lengths[:, None], block_tables, page,
                              _write_mask(tokens.shape[0], 1, x.device,
                                          active, None), pages - 1)
    logits = _run_decoder(params, cache, x, cfg, lambda i, p, h:
                          transformer.attention_decode_block_paged(
                              p, h, cfg, cache["k_pages"][i],
                              cache["v_pages"][i], block_tables, lengths,
                              index))
    return logits[:, 0], cache


def _token_stepped(step, tokens: torch.Tensor, start_len: torch.Tensor,
                   active: torch.Tensor | None, valid: torch.Tensor | None):
    """The chunk as one decode ``step(tok, lengths, act)`` per token:
    step j runs the rows that are active and, under ``valid``, have a
    j-th real token; a row's length advances only where it ran."""
    ln = start_len
    out = []
    for j in range(tokens.shape[1]):
        act = active
        if valid is not None:
            act = j < valid if active is None else active & (j < valid)
        out.append(step(tokens[:, j:j + 1], ln, act))
        ln = ln + (1 if act is None else act.to(ln.dtype))
    return torch.stack(out, dim=1)


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                  start_len: torch.Tensor, cfg: ModelConfig,
                  active: torch.Tensor | None = None,
                  valid: torch.Tensor | None = None):
    """Chunked prefill for the decoder on the contiguous cache: one
    :func:`decode_step` per chunk token (exact token-stepped semantics).
    Returns (logits (B, C, V), cache)."""
    logits = _token_stepped(
        lambda tok, ln, act: decode_step(params, cache, tok, ln, cfg,
                                         act)[0],
        tokens, start_len, active, valid)
    return logits, cache


def prefill_chunk_paged(params: dict, cache: dict, tokens: torch.Tensor,
                        start_len: torch.Tensor, block_tables: torch.Tensor,
                        cfg: ModelConfig, active: torch.Tensor | None = None,
                        valid: torch.Tensor | None = None):
    """Paged chunked prefill: one :func:`decode_step_paged` per chunk
    token, with the contiguous :func:`prefill_chunk`'s ``valid``
    contract."""
    logits = _token_stepped(
        lambda tok, ln, act: decode_step_paged(params, cache, tok, ln,
                                               block_tables, cfg, act)[0],
        tokens, start_len, active, valid)
    return logits, cache
