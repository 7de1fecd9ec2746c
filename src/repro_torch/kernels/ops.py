"""Dispatch from the model's layout to the kernels.

Counterpart of :mod:`repro.kernels.ops`. Dispatch is by the device of the
first operand alone — there is no backend switch:

  cuda — the hand-written Hopper kernels, which read the paged pool and
         the contiguous cache in place (``paged_decode_attention``,
         ``paged_prefill_attention``, ``decode_attention``,
         ``prefill_attention``), compute the SSD chunk
         (``ssd_chunk_scan``), full-sequence attention with its gradient
         (``flash_attention``, ``flash_attention_bwd``) and RMSNorm
         (``rmsnorm``);
  cpu  — the plain path that mirrors the JAX package's jnp lowering: the
         functions of :mod:`repro_torch.models.attention` (after a gather
         through the block table, for the paged pool), the SSD oracle and
         the RMSNorm oracle.

Model-facing layouts are (B, S, H, d); the kernels are head-major — the
wrappers here transpose at the boundary (views, not copies).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention)
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill_attention import \
    paged_prefill_attention
from repro_torch.kernels.prefill_attention import prefill_attention
from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_chunk_scan
from repro_torch.models import attention

#: from this sequence length on, the CPU path takes the block-causal
#: ``flash_attention_jnp`` instead of ``naive_attention``, as the JAX
#: package's jnp backend does (``repro.models.transformer.FLASH_MIN_SEQ``)
FLASH_MIN_SEQ = 2048


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. q: (B, S, H, d) (already rotated); k/v:
    (B, Skv, KV, d) -> (B, S, H, d) in q's dtype.

    On CUDA the flash kernel reads head-major views of the three tensors
    in place; where autograd records (grad enabled and an input needs a
    gradient) it goes through :class:`FlashAttention`, whose backward is
    the backward kernel. On the CPU: ``naive_attention`` below
    ``FLASH_MIN_SEQ`` positions and ``flash_attention_jnp`` at or above."""
    if q.device.type == "cpu":
        if q.shape[1] >= FLASH_MIN_SEQ:
            return attention.flash_attention_jnp(q, k, v, causal=causal)
        return attention.naive_attention(q, k, v, causal=causal)
    qt = q.transpose(1, 2)
    kt = k.contiguous().transpose(1, 2)
    vt = v.contiguous().transpose(1, 2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = FlashAttention.apply(qt, kt, vt, causal)
    else:
        o = flash_attention(qt, kt, vt, causal=causal)
    return o.transpose(1, 2)


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,) float32 -> x's shape and dtype. The kernel on
    CUDA over the flattened rows; ``ref.rmsnorm_ref`` on the CPU."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    shape = x.shape
    o = rmsnorm(x.reshape(-1, shape[-1]).contiguous(), w.contiguous(),
                eps=eps)
    return o.reshape(shape)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, d); caches: (B, S, KV, d); lengths (B,) int32 ->
    (B, 1, H, d).

    Row b attends its first ``lengths[b]`` positions; RoPE of q at position
    ``lengths - 1`` is fused into the attention. The kernel reads the
    cache through a head-major view of it, in place."""
    if q.device.type == "cpu":
        return attention.decode_attention(q, k_cache, v_cache, lengths,
                                          rope_theta=rope_theta)
    o = decode_attention(q[:, 0], k_cache.transpose(1, 2),
                         v_cache.transpose(1, 2), lengths,
                         rope_theta=rope_theta)
    return o[:, None]


def attention_prefill_chunk(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, start_len: torch.Tensor,
                            rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, C, H, d) UN-rotated; caches: (B, S, KV, d) with the chunk's
    keys/values already written at ``start_len .. start_len+C-1``;
    start_len: (B,) int32 -> (B, C, H, d).

    Chunk token j attends positions ``<= start_len + j`` and is rotated
    there (fused RoPE). The CPU path returns float32, like the JAX jnp
    lowering; the kernel returns q's dtype."""
    if q.device.type == "cpu":
        positions = start_len[:, None] + torch.arange(q.shape[1],
                                                      device=q.device)
        return attention.prefill_chunk_attention(q, k_cache, v_cache,
                                                 positions,
                                                 rope_theta=rope_theta)
    o = prefill_attention(q.transpose(1, 2), k_cache.transpose(1, 2),
                          v_cache.transpose(1, 2), start_len,
                          rope_theta=rope_theta)
    return o.transpose(1, 2)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    b_: torch.Tensor, c_: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (M, Q, H, P); dt/cum: (M, Q, H); b_/c_: (M, Q, N) -> (y (M, Q,
    H, P), state (M, H, P, N)). The kernel on CUDA; the oracle
    ``ref.ssd_chunk_ref`` on the CPU (the JAX jnp backend's choice).

    The kernel has no backward yet, so off the CPU a call that autograd would
    record raises rather than return outputs without gradients: training
    the ssm and hybrid families on the card waits for the SSD backward
    kernel (ROADMAP.md §1 item 4)."""
    if (x.device.type != "cpu" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, dt, cum, b_, c_))):
        raise NotImplementedError(
            "ssd_chunk_scan has no backward kernel yet: gradients through "
            "the SSD on the card wait for the SSD backward (ROADMAP.md §1 "
            "item 4); train the ssm and hybrid families on the CPU")
    return ssd_chunk_scan(x, dt, cum, b_, c_)


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
