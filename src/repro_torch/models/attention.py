"""Attention in plain PyTorch: the port's CPU path.

Counterparts of the jnp lowerings in :mod:`repro.models.attention`
(``naive_attention``, ``flash_attention_jnp``, ``decode_attention_jnp``,
``paged_decode_attention_jnp``, ``prefill_chunk_attention_jnp``). They
gather the paged pool into a padded view and materialise the logits (the
block-causal ``flash_attention_jnp`` per KV block) — exact and cheap at
CPU test shapes. On a CUDA tensor :mod:`repro_torch.kernels.ops` sends the
calls to the hand-written kernels instead.

All functions take q: (B, Sq, H, d) and k/v: (B, Skv, KV, d) with GQA
(H = G * KV) and return (B, Sq, H, d).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import hints, mesh_ops
from repro_torch.models import layers

NEG_INF = -1e30


def _split_gqa(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    b, s, h, d = q.shape
    q = mesh_ops.fit_split(q, 2, num_kv)
    return q.reshape(b, s, num_kv, h // num_kv, d)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Materialised attention, the semantic oracle. ``q_offset``: absolute
    position of q[:, 0] (key positions count from 0). Returns q's dtype."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = _split_gqa(q, kv).float()
    scale = 1.0 / math.sqrt(d)
    logits = mesh_ops.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        logits = torch.where(mask[None, None, None], logits,
                             torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = mesh_ops.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _flash_one_qblock(qg: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor,
                      *, diag_mask: bool, q_block: int,
                      kv_block: int) -> torch.Tensor:
    """qg: (B, qb, KV, G, d); kb/vb: (nj, B, kvb, KV, d) stacked KV blocks.

    Online softmax over the nj KV blocks in order (JAX's ``lax.scan``);
    only the last (diagonal) block gets the triangular mask when
    ``diag_mask``. Under the ``attn_logits_bf16`` hint each block's logits
    and probabilities are rounded to bfloat16, the running max, sum and
    accumulator kept in float32, as in JAX. Returns (B, qb, KV, G, d) in
    qg's dtype."""
    b, qb, kv, g, d = qg.shape
    nj = kb.shape[0]
    scale = 1.0 / math.sqrt(d)
    qg32 = qg.float() * scale
    tri = torch.ones((q_block, kv_block), dtype=torch.bool,
                     device=qg.device).tril()
    neg = torch.tensor(NEG_INF, device=qg.device)
    m = torch.full((b, kv, g, qb), NEG_INF, device=qg.device)
    l = torch.zeros((b, kv, g, qb), device=qg.device)
    acc = torch.zeros((b, kv, g, qb, d), device=qg.device)
    logits_bf16 = hints.get("attn_logits_bf16")
    for j in range(nj):
        s = mesh_ops.einsum("bqkgd,bskd->bkgqs", qg32, kb[j].float())
        if diag_mask and j == nj - 1:
            s = torch.where(tri, s, neg)
        if logits_bf16:
            s = s.to(torch.bfloat16)
        m_new = torch.maximum(m, torch.amax(s, dim=-1).float())
        p = torch.exp(s.float() - m_new[..., None])
        if logits_bf16:
            p = p.to(torch.bfloat16)
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p.float(), dim=-1)
        # p rounds to v's dtype, the product sums in float32 (JAX's
        # preferred_element_type)
        acc = acc * alpha[..., None] + mesh_ops.einsum(
            "bkgqs,bskd->bkgqd", p.to(vb.dtype).float(), vb[j].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(qg.dtype)


def flash_attention_jnp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_block: int = 0,
                        kv_block: int = 0) -> torch.Tensor:
    """Block-causal flash attention: the JAX package's jnp lowering, block
    for block — a Python loop over query blocks, each attending only the
    KV blocks up to its diagonal (causal). Falls back to
    :func:`naive_attention` where the blocks do not divide the lengths."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kv = k.shape[2]
    q_block = q_block or max(1024, sq // 8)
    kv_block = kv_block or (q_block if causal else max(1024, skv // 8))
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    if sq % q_block or skv % kv_block or (causal and q_block != kv_block):
        return naive_attention(q, k, v, causal=causal)
    nq = sq // q_block
    qg = _split_gqa(q, kv)
    outs = []
    for i in range(nq):
        qi = qg[:, i * q_block:(i + 1) * q_block]
        hi = (i + 1) * kv_block if causal else skv
        nj = hi // kv_block
        kb = k[:, :hi].reshape(b, nj, kv_block, kv, d).transpose(0, 1)
        vb = v[:, :hi].reshape(b, nj, kv_block, kv, d).transpose(0, 1)
        outs.append(_flash_one_qblock(qi, kb, vb, diag_mask=causal,
                                      q_block=q_block, kv_block=kv_block))
    out = torch.cat(outs, dim=1)                       # (B, S, KV, G, d)
    return out.reshape(b, sq, h, d)


def gather_pages(pages: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """(P, page, KV, d) pool -> (B, nb*page, KV, d) padded per-row view."""
    g = pages[block_tables.long()]                  # (B, nb, page, KV, d)
    b, nb, page = g.shape[:3]
    return g.reshape(b, nb * page, *pages.shape[2:])


def prefill_chunk_attention(q: torch.Tensor, k_full: torch.Tensor,
                            v_full: torch.Tensor, positions: torch.Tensor,
                            rope_theta: float | None = None) -> torch.Tensor:
    """Chunk-vs-cache causal attention: C chunk tokens against the full
    cache (history + the chunk itself, already written).

    q: (B, C, H, d) UN-rotated; k_full/v_full: (B, S, KV, d); positions:
    (B, C) absolute position per chunk token. ``rope_theta``: rotate chunk
    query j at ``positions[:, j]`` here (cached keys are rotated at write
    time). Returns float32 (B, C, H, d) — callers cast.
    """
    b, c, h, d = q.shape
    s = k_full.shape[1]
    kvh = k_full.shape[2]
    g = h // kvh
    if rope_theta is not None:
        q = layers.apply_rope(q, positions, rope_theta)
    qg = q.reshape(b, c, kvh, g, d).float()
    scale = 1.0 / math.sqrt(d)
    logits = mesh_ops.einsum("bckgd,bskd->bkgcs", qg, k_full.float()) * scale
    kpos = torch.arange(s, device=q.device)
    valid = kpos[None, None, :] <= positions[:, :, None]            # (B,C,S)
    logits = torch.where(valid[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    pr = torch.softmax(logits, dim=-1)
    o = mesh_ops.einsum("bkgcs,bskd->bckgd", pr, v_full.float())
    return o.reshape(b, c, h, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor,
                     rope_theta: float | None = None) -> torch.Tensor:
    """Single-token decode attention against a cache.

    q: (B, 1, H, d); caches: (B, S, KV, d); length: (B,) valid prefix.
    ``rope_theta``: rotate q at position ``length - 1`` here (cached keys
    are rotated at write time)."""
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    s = k_cache.shape[1]
    length = length.reshape(-1)
    if rope_theta is not None:
        q = layers.apply_rope(q, length[:, None] - 1, rope_theta)
    qg = _split_gqa(q, kv)[:, 0].float()                 # (B, KV, G, d)
    scale = 1.0 / math.sqrt(d)
    logits = mesh_ops.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < length[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(NEG_INF, device=q.device))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    norm = torch.sum(p, dim=-1, keepdim=True)
    out = mesh_ops.einsum("bkgs,bskd->bkgd", p / norm, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           length: torch.Tensor,
                           rope_theta: float | None = None) -> torch.Tensor:
    """Single-token decode attention against a PAGED cache.

    q: (B, 1, H, d); pools: (P, page, KV, d) model layout; block_tables:
    (B, nb) int32 page ids; length: (B,) valid prefix per row. Gathers
    ``pool[block_tables]`` and defers to :func:`decode_attention`.
    Sentinel (unallocated) table entries point at a real page whose
    contents lie beyond ``length`` — masked like cache padding.
    """
    return decode_attention(q, gather_pages(k_pages, block_tables),
                            gather_pages(v_pages, block_tables), length,
                            rope_theta=rope_theta)
