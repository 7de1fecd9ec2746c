"""Dispatch from the model's layout to the paged attention kernels.

Counterpart of :mod:`repro.kernels.ops` for the paged serving path.
Dispatch is by the device of ``q`` alone — there is no backend switch:

  cuda — the hand-written Hopper kernels, which read the pool in place
         (``paged_decode_attention`` / ``paged_prefill_attention``);
  cpu  — the plain path that mirrors the JAX package's jnp lowering: gather
         the pages through the block table, then the functions of
         :mod:`repro_torch.models.attention`.

Model-facing layouts are (B, S, H, d); the kernels are head-major — the
wrappers here transpose at the boundary (views, not copies).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill_attention import \
    paged_prefill_attention
from repro_torch.models import attention


def attention_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, d); pools: (P, page, KV, d); block_tables: (B, nb)
    int32; lengths (B,) int32 -> (B, 1, H, d).

    K/V are read through the per-row block table; RoPE of q at position
    ``lengths - 1`` is fused into the attention."""
    if q.device.type == "cpu":
        return attention.paged_decode_attention(q, k_pages, v_pages,
                                                block_tables, lengths,
                                                rope_theta=rope_theta)
    o = paged_decode_attention(q[:, 0], k_pages, v_pages, block_tables,
                               lengths, rope_theta=rope_theta)
    return o[:, None]


def attention_prefill_chunk_paged(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  start_len: torch.Tensor,
                                  rope_theta: float | None = None
                                  ) -> torch.Tensor:
    """q: (B, C, H, d) UN-rotated; pools: (P, page, KV, d) with the
    chunk's keys/values already written; block_tables: (B, nb) int32;
    start_len: (B,) int32 -> (B, C, H, d).

    Chunk token j attends positions ``<= start_len + j`` and is rotated
    there (fused RoPE). The CPU path returns float32, like the JAX jnp
    lowering; the kernel returns q's dtype."""
    if q.device.type == "cpu":
        k = attention.gather_pages(k_pages, block_tables)
        v = attention.gather_pages(v_pages, block_tables)
        positions = start_len[:, None] + torch.arange(q.shape[1],
                                                      device=q.device)
        return attention.prefill_chunk_attention(q, k, v, positions,
                                                 rope_theta=rope_theta)
    o = paged_prefill_attention(q.transpose(1, 2), k_pages, v_pages,
                                block_tables, start_len,
                                rope_theta=rope_theta)
    return o.transpose(1, 2)
