"""Attention in plain PyTorch: the port's CPU path.

Counterparts of the jnp lowerings in :mod:`repro.models.attention`
(``decode_attention_jnp``, ``paged_decode_attention_jnp``,
``prefill_chunk_attention_jnp``). They gather the paged pool into a padded
view and materialise the logits — exact and cheap at CPU test shapes. On a
CUDA tensor :mod:`repro_torch.kernels.ops` sends the paged calls to the
hand-written kernels instead, which read the pool in place.

All functions take q: (B, Sq, H, d) and k/v: (B, Skv, KV, d) with GQA
(H = G * KV) and return (B, Sq, H, d).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers

NEG_INF = -1e30


def _split_gqa(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, d)


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
    logits = torch.einsum("bckgd,bskd->bkgcs", qg, k_full.float()) * scale
    kpos = torch.arange(s, device=q.device)
    valid = kpos[None, None, :] <= positions[:, :, None]            # (B,C,S)
    logits = torch.where(valid[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    pr = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgcs,bskd->bckgd", pr, v_full.float())
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
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < length[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(NEG_INF, device=q.device))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    norm = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / norm, v_cache.float())
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
