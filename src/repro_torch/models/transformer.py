"""Decoder-only transformer LM (dense / moe / vlm families).

Counterpart of :mod:`repro.models.transformer`: the full-sequence
``forward`` (training and eval, with the ``none``/``full``/``dots`` remat
policies; the vlm ``embeds`` in place of the token embedding) and
whole-prompt ``prefill``; the contiguous-cache (``init_cache``,
``decode_step``, ``prefill_chunk``) and paged-pool (``init_paged_cache``,
``decode_step_paged``, ``prefill_chunk_paged``) serving steps, whose MoE
FFNs (:mod:`repro_torch.models.moe`) take the step's ``active`` as their
token mask. The hints of :mod:`repro_torch.distributed.hints`, read at
call time as JAX reads them at trace time: ``kv_cache_dtype="int8"``
(:func:`init_cache` makes the contiguous cache int8 with per-(token,
head) bf16 scales, and the steps quantize what they write and
dequantize what attention reads), ``attn_impl="repeat_kv"``
(:func:`attention_block`), and the two sharding constraints
``attn_kv_replicated`` and ``residual_replicated``, which redistribute
DTensor activations on a device mesh and, as in JAX, change nothing off
one. On a mesh the einsums are ``mesh_ops.einsum`` (XLA's dot rule on
the shards) and a few layouts are anchored (``mesh_ops.anchor``) where
DTensor's op-by-op choice would wander from where XLA settles.
Parameters are a nested dict with the same leaf names and shapes as the
JAX package — the einsum layouts ``wq (d, h, hd)``, ``wk``/``wv (d, kv,
hd)``, ``wo (h, hd, d)`` — with every per-layer leaf stacked on a leading
layer axis, so one set of weights drives both packages
(:mod:`repro_torch.models.convert`). The JAX ``lax.scan`` over layers is a
Python loop over per-layer views.

Caches are updated IN PLACE: where the JAX functions return a rebuilt
cache, these write the new keys/values into the caller's tensors and
return the same dict. JAX drops the writes of inactive rows and pad
tokens by pointing them past the cache end under ``mode="drop"``; an
out-of-range ``index_put_`` would fault, and filtering them out
(``nonzero``) would make the host wait for the card on every dispatch. So
both caches carry one spare slot at the index JAX points them at — a drop
page past the pool's end, a drop position past each row's ``max_seq`` —
and the dropped writes land there, at fixed shapes and with no host sync.
Attention never reads it.

The serving steps open the profiler ranges of
:func:`repro_torch.telemetry.recorder.scope` while a profiler collects
(nothing otherwise): ``model.embed``, ``model.attn.qkv`` (the input norm,
projections, qk-norm, rope), ``model.attn.kv_write`` (the write index and
the cache writes), ``model.attn.kernel``, ``model.attn.out``,
``model.ffn`` (its norm and the FFN) and ``model.head``; the attention's
four inside the paged blocks only.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import hints, mesh_ops
from repro_torch.kernels import ops
from repro_torch.models import layers, moe
from repro_torch.telemetry.recorder import scope

# ----------------------------------------------------------------- params


def init_attn(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (),
              dtype=torch.float32) -> dict:
    """Random attention weights from ``gen`` in the einsum layouts;
    ``lead`` prepends stacking axes (the layers)."""
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    attn = {
        "wq": layers.dense_init(gen, (*lead, d, h, hd), dtype=dtype),
        "wk": layers.dense_init(gen, (*lead, d, kv, hd), dtype=dtype),
        "wv": layers.dense_init(gen, (*lead, d, kv, hd), dtype=dtype),
        "wo": layers.dense_init(gen, (*lead, h, hd, d), dtype=dtype),
    }
    if cfg.use_qk_norm:
        attn["q_norm"] = torch.ones((*lead, hd), device=gen.device)
        attn["k_norm"] = torch.ones((*lead, hd), device=gen.device)
    return attn


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> dict:
    """Random weights drawn from ``gen`` on ``gen.device`` (normal, 0.02),
    norms at 1 — the JAX initialiser's shapes and scales, not its numbers
    (a ``torch.Generator`` and a JAX key give different streams). The moe
    family's FFN is :func:`moe.init_moe`'s, the others' a SwiGLU MLP."""
    d, n = cfg.d_model, cfg.num_layers
    dev = gen.device
    params = {
        "embedding": layers.dense_init(gen, (cfg.padded_vocab, d),
                                       dtype=dtype),
        "layers": {
            "ln1": torch.ones((n, d), device=dev),
            "ln2": torch.ones((n, d), device=dev),
            "attn": init_attn(gen, cfg, (n,), dtype),
            "ffn": (moe.init_moe(gen, cfg, lead=(n,), dtype=dtype)
                    if cfg.is_moe else
                    layers.init_mlp(gen, d, cfg.d_ff, lead=(n,), dtype=dtype)),
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


def unstack_layers(stacked: dict, n: int) -> list[dict]:
    """All ``n`` layers' parameters, each leaf split once with ``unbind``:
    under autograd its backward is one ``stack`` per leaf, where a select
    per layer (:func:`layer_view`) would write a zero tensor the size of
    the whole stacked leaf for every layer."""
    parts = {k: unstack_layers(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in stacked.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  device: torch.device, dtype=torch.bfloat16,
                  num_layers: int | None = None) -> dict:
    """Contiguous KV cache, ``(L, B, max_seq + 1, KV, hd)``: each row's
    slot of ``max_seq`` positions plus one, the drop position
    (:func:`cache_write_index`), which attention never reads. ``L`` is
    ``num_layers`` where given (the attention layers of a hybrid or the
    decoder of an enc-dec model, whose caches stay in ``dtype`` under the
    int8 hint, as in JAX), else ``cfg.num_layers``."""
    shape = (num_layers or cfg.num_layers, batch, max_seq + 1,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device, dtype=torch.bfloat16) -> dict:
    """The transformer family's contiguous cache: :func:`init_kv_cache`,
    or under the ``kv_cache_dtype="int8"`` hint int8 keys and values with
    ``k_scale``/``v_scale`` of ``(L, B, max_seq + 1, KV)`` bfloat16 — one
    scale per token and head, the drop position included (JAX's leaves,
    plus that position)."""
    int8 = hints.get("kv_cache_dtype") == "int8"
    cache = init_kv_cache(cfg, batch, max_seq, device,
                          torch.int8 if int8 else dtype)
    if int8:
        shape = cache["k"].shape[:-1]
        cache["k_scale"] = torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device)
    return cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device: torch.device, dtype=torch.bfloat16,
                     num_layers: int | None = None) -> dict:
    """Page-pool KV cache: ``num_pages`` shared pages of ``page_size``
    tokens per layer, ``(L, num_pages + 1, page, KV, hd)``; rows address
    them through engine-side block tables. The extra last page is the drop
    page (:func:`paged_write_index`): no block table names it. ``L`` as in
    :func:`init_cache`."""
    shape = (num_layers or cfg.num_layers, num_pages + 1, page_size,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


# ----------------------------------------------------------------- pieces

def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, rope_q: bool = True):
    """``rope_q=False``: leave q un-rotated — the paged attention applies
    the rotation itself (k is always rotated before caching)."""
    q = mesh_ops.einsum("bsd,dhe->bshe", x, p["wq"])
    k = mesh_ops.einsum("bsd,dke->bske", x, p["wk"])
    v = mesh_ops.einsum("bsd,dke->bske", x, p["wv"])
    if cfg.use_qk_norm:
        q = layers.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope_q:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, causal: bool = True):
    """Full-sequence attention (``ops.attention_prefill``: the flash kernel
    on CUDA). Returns (out, (k, v)) for cache capture.

    Under ``attn_impl="repeat_kv"`` (GQA configs only) K and V are
    repeated to the H query heads first, and the un-repeated (k, v) are
    returned: the flash kernel runs at one query head a KV head on CUDA;
    the CPU takes the JAX hint's path (``naive_attention`` below
    ``ops.FLASH_MIN_SEQ`` positions, ``flash_attention_jnp`` from there).
    Otherwise, under ``attn_kv_replicated`` on a device mesh (DTensor
    activations), k/v are redistributed to batch-on-dp and replicated
    over ``model`` and q to its heads on ``model`` where they are a
    multiple of 16 — JAX's constraints, gradients included; off a mesh,
    as in JAX, the hint changes nothing."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    if (hints.get("attn_impl") == "repeat_kv"
            and cfg.num_kv_heads < cfg.num_heads):
        g = cfg.num_heads // cfg.num_kv_heads
        o = ops.attention_prefill(q, k.repeat_interleave(g, dim=2),
                                  v.repeat_interleave(g, dim=2),
                                  causal=causal)
    else:
        if hints.get("attn_kv_replicated"):
            h_ax = "model" if cfg.num_heads % 16 == 0 else None
            k = mesh_ops.anchor(k, "batch", None, None, None)
            v = mesh_ops.anchor(v, "batch", None, None, None)
            q = mesh_ops.anchor(q, "batch", None, h_ax, None)
        o = ops.attention_prefill(q, k, v, causal=causal)
    o = mesh_ops.anchor(o, "batch", None, "model", None)
    out = mesh_ops.einsum("bshe,hed->bsd", o, p["wo"])
    return out, (k, v)


def cache_write_index(positions: torch.Tensor, keep: torch.Tensor,
                      max_seq: int):
    """Where the new tokens' K/V land in the contiguous cache.

    positions: (B, C) absolute positions; keep: (B, C) bool — which writes
    count. Returns ``(rows, positions)``, each (B*C,), one per token.
    Dropped writes — and positions at or past ``max_seq``, which JAX's
    ``mode="drop"`` discards too — go to position ``max_seq``, the row's
    drop position (:func:`init_cache`)."""
    pos = torch.where(keep & (positions < max_seq), positions,
                      torch.full_like(positions, max_seq))
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return rows.expand_as(pos).reshape(-1), pos.reshape(-1).long()


def paged_write_index(positions: torch.Tensor, block_tables: torch.Tensor,
                      page: int, keep: torch.Tensor, drop_page: int):
    """Where the new tokens' K/V land in the pool.

    positions: (B, C) absolute positions; keep: (B, C) bool — which writes
    count. Returns ``(page_ids, offsets)``, each (B*C,), one per token.
    Dropped writes go to ``drop_page``, the spare last page of the pool
    (:func:`init_paged_cache`) — the id JAX points them at, made real. No
    block table names it, so what lands there is never read. The block
    index is clamped to ``nb - 1`` as in JAX.
    """
    nb = block_tables.shape[1]
    block = torch.clamp(positions // page, max=nb - 1)
    pidx = torch.gather(block_tables.long(), 1, block.long())
    pidx = torch.where(keep, pidx, torch.full_like(pidx, drop_page))
    return pidx.reshape(-1), (positions % page).reshape(-1).long()


def _write(cache: torch.Tensor, new: torch.Tensor, index) -> None:
    """Scatter the (B, C, KV, hd) new keys or values — or their (B, C, KV)
    int8 scales — to ``index`` (from :func:`cache_write_index` or
    :func:`paged_write_index`)."""
    mesh_ops.index_put(cache, index,
                       new.reshape(-1, *new.shape[2:]).to(cache.dtype))


def _quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t: (..., hd) -> (int8 values, bf16 scale of each (...) vector): the
    scale is max |t| / 127 in float32, at least 1e-8; the values
    round(t / scale) (half to even, as ``jnp.round``) clipped to ±127."""
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _cache_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
              k: torch.Tensor, v: torch.Tensor, write_index,
              k_scale: torch.Tensor | None,
              v_scale: torch.Tensor | None):
    """Write the new (B, C, KV, hd) keys and values into one layer's
    contiguous cache and return the (B, max_seq, KV, hd) tensors attention
    reads. With scales (an int8 cache, (B, max_seq + 1, KV) each) they are
    stored quantized, scales beside them, and read dequantized in float32:
    the int8 value times its bf16 scale, a product float32 holds exactly.
    JAX writes ``int8 -> bf16 * bf16 scale``, but XLA keeps that product
    unrounded where attention reads it back in float32 (its default
    ``xla_allow_excess_precision``), so the exact product is what the
    JAX package computes on its jnp path; rounding it to bf16 here would
    move ~0.2% of the next layer's int8 entries by one unit."""
    s = k_cache.shape[1] - 1
    if k_scale is None:
        _write(k_cache, k, write_index)
        _write(v_cache, v, write_index)
        return (mesh_ops.prefix(k_cache, 1, s),
                mesh_ops.prefix(v_cache, 1, s))
    full = []
    for cache, scales, t in ((k_cache, k_scale, k), (v_cache, v_scale, v)):
        q, scale = _quantize_kv(t)
        _write(cache, q, write_index)
        _write(scales, scale, write_index)
        full.append(mesh_ops.prefix(cache, 1, s).float()
                    * mesh_ops.prefix(scales, 1, s)[..., None].float())
    return full[0], full[1]


def attention_decode_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           lengths: torch.Tensor, write_index,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None):
    """One-token attention against the contiguous cache.

    x: (B,1,D); caches: (B, max_seq + 1, KV, hd) — written in place; int8
    with (B, max_seq + 1, KV) ``k_scale``/``v_scale`` under the int8
    hint (:func:`init_cache`). The new k/v lands at
    position ``lengths``; attention reads the first ``max_seq`` positions
    over ``lengths + 1`` (``ops.attention_decode``, q rotated there),
    dequantized from an int8 cache (:func:`_cache_kv`). ``write_index``:
    this dispatch's :func:`cache_write_index`, the same for every layer;
    it holds the JAX ``active`` mask (inactive rows write only their drop
    position, and their outputs are garbage the caller ignores)."""
    q, k, v = _project_qkv(p, x, cfg, lengths[:, None], rope_q=False)
    k_full, v_full = _cache_kv(k_cache, v_cache, k, v, write_index, k_scale,
                               v_scale)
    o = ops.attention_decode(q, k_full, v_full, lengths + 1,
                             rope_theta=cfg.rope_theta)
    return mesh_ops.einsum("bshe,hed->bsd", o, p["wo"])


def _chunk_attend(p: dict, q: torch.Tensor, k_full: torch.Tensor,
                  v_full: torch.Tensor, start_len: torch.Tensor,
                  cfg: ModelConfig, x_dtype) -> torch.Tensor:
    """Chunk-vs-cache causal attention: q (B,C,H,hd) UN-rotated (RoPE is
    fused into the attention), k_full/v_full (B,S,KV,hd); chunk token j
    sits at ``start_len + j``."""
    o = ops.attention_prefill_chunk(q, k_full, v_full, start_len,
                                    rope_theta=cfg.rope_theta)
    return mesh_ops.einsum("bshe,hed->bsd", o.to(x_dtype), p["wo"])


def attention_prefill_chunk_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                                  k_cache: torch.Tensor,
                                  v_cache: torch.Tensor,
                                  start_len: torch.Tensor, write_index,
                                  k_scale: torch.Tensor | None = None,
                                  v_scale: torch.Tensor | None = None):
    """Chunked-prefill attention against the contiguous cache: the C new
    tokens' k/v are written at ``start_len .. start_len+C-1`` (quantized,
    with ``k_scale``/``v_scale``, in an int8 cache) and attended causally
    over the first ``max_seq`` positions. ``write_index`` (this dispatch's
    :func:`cache_write_index`) holds the JAX ``active`` and ``valid``
    masks: inactive rows and tail pads write only their drop position, and
    their outputs are garbage."""
    c = x.shape[1]
    positions = start_len[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, rope_q=False)
    k_full, v_full = _cache_kv(k_cache, v_cache, k, v, write_index, k_scale,
                               v_scale)
    return _chunk_attend(p, q, k_full, v_full, start_len, cfg, x.dtype)


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
    with scope("model.attn.qkv"):
        q, k, v = _project_qkv(p, x, cfg, positions, rope_q=False)
    with scope("model.attn.kv_write"):
        _write(k_pages, k, write_index)
        _write(v_pages, v, write_index)
    with scope("model.attn.kernel"):
        o = ops.attention_decode_paged(q, k_pages, v_pages, block_tables,
                                       lengths + 1, rope_theta=cfg.rope_theta)
    with scope("model.attn.out"):
        return mesh_ops.einsum("bshe,hed->bsd", o, p["wo"])


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
    with scope("model.attn.qkv"):
        positions = (start_len[:, None]
                     + torch.arange(c, device=x.device)[None, :])
        q, k, v = _project_qkv(p, x, cfg, positions, rope_q=False)
    with scope("model.attn.kv_write"):
        _write(k_pages, k, write_index)
        _write(v_pages, v, write_index)
    with scope("model.attn.kernel"):
        o = ops.attention_prefill_chunk_paged(q, k_pages, v_pages,
                                              block_tables, start_len,
                                              rope_theta=cfg.rope_theta)
    with scope("model.attn.out"):
        return mesh_ops.einsum("bshe,hed->bsd", o.to(x.dtype), p["wo"])


def _ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
         token_mask: torch.Tensor | None = None):
    """The layer's feed-forward: (out, aux). The MoE family routes through
    ``moe.moe_dispatch`` (``token_mask``: the serving rows that count);
    the dense MLP's aux is 0."""
    if cfg.is_moe:
        return moe.moe_dispatch(p, x, cfg, token_mask)
    return layers.mlp(p, x), torch.zeros((), dtype=torch.float32,
                                         device=x.device)


def _write_mask(b: int, c: int, device, active, valid) -> torch.Tensor:
    """(B, C) bool: which of the dispatch's new tokens reach the cache
    (the others go to the drop page or drop position)."""
    keep = torch.ones((b, c), dtype=torch.bool, device=device)
    if active is not None:
        keep = keep & active[:, None]
    if valid is not None:
        keep = keep & (torch.arange(c, device=device)[None, :]
                       < valid[:, None])
    return keep


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig,
              tied: bool | None = None) -> torch.Tensor:
    """Final norm, then the LM head: the embedding's transpose where
    ``tied`` (default: the config's ``tie_embeddings``), else ``lm_head``."""
    x = layers.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings if tied is None else tied:
        return layers.unembed(x, params["embedding"], transpose=True)
    return layers.unembed(x, params["lm_head"], transpose=False)


def _run_layers(params: dict, x: torch.Tensor, cfg: ModelConfig,
                attend, token_mask: torch.Tensor | None) -> torch.Tensor:
    """Every pre-norm block, then the logits. ``attend(i, p_attn, h)`` is
    layer i's attention on its normed input ``h`` (it writes the layer's
    cache); ``token_mask`` (the step's ``active``) reaches the MoE FFN."""
    for i in range(cfg.num_layers):
        lp = layer_view(params["layers"], i)
        with scope("model.attn.qkv"):
            h = layers.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + attend(i, lp["attn"], h)
        with scope("model.ffn"):
            h2 = layers.rmsnorm(x, lp["ln2"], cfg.norm_eps)
            x = x + _ffn(lp["ffn"], h2, cfg, token_mask)[0]
    with scope("model.head"):
        return lm_logits(params, x, cfg)


# ---------------------------------------------------------------- forward

#: remat "dots" saves these ops' outputs (the projection and MLP products:
#: matmuls without batch dims, JAX's ``checkpoint_dots_with_no_batch_dims``)
#: and recomputes everything else, attention included
_SAVED_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_MATMULS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``none``: keep every activation; ``full``: keep only each layer's
    input and recompute the layer in the backward pass; ``dots``: keep the
    matmul outputs too (selective checkpointing)."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *a: _ckpt.checkpoint(fn, *a, use_reentrant=False)
    if policy == "dots":
        return lambda *a: _ckpt.checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: _ckpt.create_selective_checkpoint_contexts(
                _save_matmuls))
    raise ValueError(f"remat policy {policy!r}: none, full or dots")


def _residual_constraint(x: torch.Tensor) -> torch.Tensor:
    """Under ``residual_replicated``: the residual stream pinned to
    batch-on-dp and replicated over ``model`` after every sublayer (on a
    mesh; a plain tensor as it is, as JAX drops the constraint off one)."""
    if not hints.get("residual_replicated"):
        return x
    return mesh_ops.anchor(x, "batch", None, None)


def forward(params: dict, tokens: torch.Tensor | None, cfg: ModelConfig, *,
            remat: str = "full", embeds: torch.Tensor | None = None,
            causal: bool = True, return_cache: bool = False):
    """tokens: (B, S) int, or ``embeds``: (B, S, D) in place of the token
    embedding (the vlm frontend stub; ``tokens`` may then be None).
    Returns (logits (B, S, V), aux_loss) or (logits, aux_loss, cache) with
    cache = {"k": (L, B, S, KV, hd), "v": ...} (the rotated keys and the
    values, in the activations' dtype) when ``return_cache``. ``aux_loss``
    sums the MoE layers' balance terms (0 without experts)."""
    x = (embeds if embeds is not None
         else layers.embed(params["embedding"], tokens))
    x = mesh_ops.anchor(x, "batch", None, None)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x, lp):
        h = layers.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        attn_out, kv = attention_block(lp["attn"], h, cfg, positions, causal)
        x = _residual_constraint(x + attn_out)
        h2 = layers.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        ffn_out, a = _ffn(lp["ffn"], h2, cfg)
        return (_residual_constraint(x + ffn_out), a,
                (kv if return_cache else None))

    body = _remat(body, remat)
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params["layers"], cfg.num_layers):
        x, a, kv = body(x, lp)
        aux = aux + a
        if return_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    logits = lm_logits(params, x, cfg)
    if return_cache:
        return logits, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits, aux


def fill_cache(cache: dict, kv: dict, s: int) -> dict:
    """Write a whole prompt's (L, B, S, KV, hd) keys/values into the first
    ``s`` positions of a contiguous cache from :func:`init_kv_cache`. On
    a mesh (DTensor keys/values) the cache's two leaves are rebuilt as the
    keys and values followed by zeros, in their layout (an in-place write
    of a sharded tensor into a plain one has no DTensor rule)."""
    if isinstance(kv["k"], DTensor):
        for n in ("k", "v"):
            t = kv[n].to(cache[n].dtype)
            tail = list(t.shape)
            tail[2] = cache[n].shape[2] - s
            cache[n] = torch.cat([t, mesh_ops.zeros(tail, like=t)], dim=2)
        return cache
    cache["k"][:, :, :s] = kv["k"]
    cache["v"][:, :, :s] = kv["v"]
    return cache


def prefill(params: dict, tokens: torch.Tensor | None, cfg: ModelConfig,
            max_seq: int, embeds: torch.Tensor | None = None):
    """Run the whole prompt (``tokens`` (B, S), or ``embeds`` (B, S, D)
    for the vlm stub); return (logits (B, S, V), cache) with the cache in
    :func:`init_kv_cache`'s layout — (L, B, max_seq + 1, KV, hd) bfloat16
    under every hint, as JAX's,
    the prompt's keys/values in the first S positions, zeros after them
    and in the drop position — ready for :func:`decode_step`. JAX pads its
    cache to ``max_seq``; a prompt longer than ``max_seq`` is refused here
    (the port's cache has a fixed slot)."""
    b, s = (tokens if tokens is not None else embeds).shape[:2]
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq {max_seq}")
    logits, _, kv = forward(params, tokens, cfg, remat="none",
                            embeds=embeds, return_cache=True)
    cache = init_kv_cache(cfg, b, max_seq, logits.device)
    return logits, fill_cache(cache, kv, s)


def _scales(cache: dict, i: int) -> tuple:
    """Layer ``i``'s (k_scale, v_scale) of an int8 cache, else (None,
    None): the cache's leaves, not the hint, decide, as in JAX."""
    if "k_scale" not in cache:
        return None, None
    return cache["k_scale"][i], cache["v_scale"][i]


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                lengths: torch.Tensor, cfg: ModelConfig,
                active: torch.Tensor | None = None):
    """One decode step against the contiguous cache. tokens: (B,1);
    lengths: (B,) int32. Returns (logits (B, V), cache) with the new K/V
    written into ``cache`` (from :func:`init_cache`) in place; inactive
    rows leave every position but their drop position untouched."""
    x = layers.embed(params["embedding"], tokens)
    index = cache_write_index(lengths[:, None],
                              _write_mask(tokens.shape[0], 1, x.device,
                                          active, None),
                              cache["k"].shape[2] - 1)
    logits = _run_layers(params, x, cfg, lambda i, p, h:
                         attention_decode_block(p, h, cfg, cache["k"][i],
                                                cache["v"][i], lengths,
                                                index, *_scales(cache, i)),
                         active)
    return logits[:, 0], cache


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                  start_len: torch.Tensor, cfg: ModelConfig,
                  active: torch.Tensor | None = None,
                  valid: torch.Tensor | None = None):
    """Batched chunked prefill against the contiguous cache: advance every
    row by C tokens in one pass. tokens: (B, C); start_len: (B,) int32
    tokens already cached per row. Returns (logits (B, C, V), cache) with
    the chunk's K/V written into ``cache`` (from :func:`init_cache`) in
    place. Rows with ``active=False`` and tail pads beyond ``valid`` write
    only their drop position."""
    x = layers.embed(params["embedding"], tokens)
    b, c = tokens.shape
    positions = start_len[:, None] + torch.arange(c, device=x.device)[None, :]
    index = cache_write_index(positions,
                              _write_mask(b, c, x.device, active, valid),
                              cache["k"].shape[2] - 1)
    logits = _run_layers(params, x, cfg, lambda i, p, h:
                         attention_prefill_chunk_block(
                             p, h, cfg, cache["k"][i], cache["v"][i],
                             start_len, index, *_scales(cache, i)), active)
    return logits, cache


def decode_step_paged(params: dict, cache: dict, tokens: torch.Tensor,
                      lengths: torch.Tensor, block_tables: torch.Tensor,
                      cfg: ModelConfig, active: torch.Tensor | None = None):
    """One decode step against the paged cache. tokens: (B,1); lengths:
    (B,) int32; block_tables: (B, nb) int32. Returns (logits (B, V),
    cache) with the new K/V written into ``cache`` (from
    :func:`init_paged_cache`: its last page is the drop page) in place;
    inactive rows leave every page but the drop page untouched."""
    with scope("model.embed"):
        x = layers.embed(params["embedding"], tokens)
    _, pages, page = cache["k_pages"].shape[:3]
    with scope("model.attn.kv_write"):
        index = paged_write_index(lengths[:, None], block_tables, page,
                                  _write_mask(tokens.shape[0], 1, x.device,
                                              active, None), pages - 1)
    logits = _run_layers(params, x, cfg, lambda i, p, h:
                         attention_decode_block_paged(
                             p, h, cfg, cache["k_pages"][i],
                             cache["v_pages"][i], block_tables, lengths,
                             index), active)
    return logits[:, 0], cache


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
    with scope("model.embed"):
        x = layers.embed(params["embedding"], tokens)
    b, c = tokens.shape
    _, pages, page = cache["k_pages"].shape[:3]
    with scope("model.attn.kv_write"):
        positions = (start_len[:, None]
                     + torch.arange(c, device=x.device)[None, :])
        index = paged_write_index(positions, block_tables, page,
                                  _write_mask(b, c, x.device, active, valid),
                                  pages - 1)
    logits = _run_layers(params, x, cfg, lambda i, p, h:
                         attention_prefill_chunk_block_paged(
                             p, h, cfg, cache["k_pages"][i],
                             cache["v_pages"][i], block_tables, start_len,
                             index), active)
    return logits, cache
