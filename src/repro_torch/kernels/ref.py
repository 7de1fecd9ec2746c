"""Plain PyTorch versions of the kernels (the correctness ground truth).

Counterparts of :mod:`repro.kernels.ref`, in the same KERNEL-facing
head-major layouts (not the model's (B, S, H, d) — ops.py adapts). Each
kernel wrapper computes these on a CPU tensor; ``chip_smoke.py`` holds the
CUDA kernels against them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import rope_freqs

NEG_INF = -1e30


def _flash_logits(q: torch.Tensor, k: torch.Tensor,
                  causal: bool) -> torch.Tensor:
    """(B, KV, G, Sq, Skv) float32 scaled logits, masked to -1e30."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, d).float()
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if causal:      # key position <= query position, both from 0
        valid = torch.ones((sq, skv), dtype=torch.bool,
                           device=q.device).tril()
        logits = torch.where(valid, logits,
                             torch.tensor(NEG_INF, device=q.device))
    return logits


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, d); k/v: (B, KV, Skv, d). GQA H = G*KV. -> (B, H, Sq,
    d) in q's dtype. Causal: key position <= query position, both counted
    from 0 (also when Sq != Skv)."""
    b, h, sq, d = q.shape
    p = torch.softmax(_flash_logits(q, k, causal), dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True) -> torch.Tensor:
    """(B, H, Sq) float32 log-sum-exp of each query row's scaled logits —
    what the forward kernel writes for the backward."""
    b, h, sq, _ = q.shape
    return torch.logsumexp(_flash_logits(q, k, causal), dim=-1).reshape(
        b, h, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Gradients of :func:`flash_attention_ref` from the forward's output
    ``o`` and log-sum-exp ``lse`` (B, H, Sq): P = exp(logits - lse),
    dV = Pᵀ dO, dS = P (dO Vᵀ - rowsum(dO o)), dQ = dS K / sqrt(d),
    dK = dSᵀ Q / sqrt(d), summed over each KV head's G query heads.
    -> (dq in q's dtype, dk and dv in k's dtype)."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    g = h // kv
    split = (lambda t: t.reshape(b, kv, g, sq, -1).float())
    p = torch.exp(_flash_logits(q, k, causal) - split(lse))
    dog = split(do)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, v.float())
    delta = (dog * split(o)).sum(-1, keepdim=True)
    ds = p * (dp - delta) * (1.0 / math.sqrt(d))
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float())
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, split(q))
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small), both float32 holding TF32 values: big is x rounded to
    TF32 (10 mantissa bits) to nearest, ties away from zero — half of the
    13 dropped bits added to the magnitude, then cleared; small is the
    remainder x - big (exact in float32) as the tensor cores read it, its
    13 low bits dropped. The 3xTF32 route of the flash kernels forms a
    product a·b as big·big + big·small + small·big (csrc/flash_mma.cuh)."""
    x = x.float().contiguous()
    big = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    rest = (x - big).contiguous()
    return big, (rest.view(torch.int32) & ~0x1FFF).view(torch.float32)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,). Float32 mean square, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_ref(x: torch.Tensor, positions: torch.Tensor,
             theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., d); positions broadcastable to
    x.shape[:-1]. Split-halves layout, float32 result."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions.float()[..., None] * inv
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _masked_softmax(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    logits = torch.where(valid, logits,
                         torch.tensor(NEG_INF, device=logits.device))
    return torch.softmax(logits, dim=-1)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor,
                         rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, H, d); k/v: (B, KV, S, d); lengths: (B,). -> (B, H, d).

    ``rope_theta``: rotate q at position ``lengths - 1`` before attending
    (the fused-RoPE decode contract — cached k is already rotated)."""
    b, h, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    if rope_theta is not None:
        q = rope_ref(q, (lengths - 1)[:, None], rope_theta).to(q.dtype)
    qg = q.reshape(b, kv, g, d).float()
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    p = _masked_softmax(logits, valid[:, None, None, :])
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.reshape(b, h, d).to(q.dtype)


def _gather_head_major(pages: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """(P, page, KV, d) pool -> (B, KV, nb*page, d) gathered view."""
    g = pages[block_tables.long()]                  # (B, nb, page, KV, d)
    b, nb, page, kv, d = g.shape
    return g.reshape(b, nb * page, kv, d).transpose(1, 2)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor,
                               rope_theta: float | None = None
                               ) -> torch.Tensor:
    """Paged flash-decode: gather pages, defer to the dense version.

    q: (B, H, d); k/v pools: (P, page, KV, d) — the kernel's model layout;
    block_tables: (B, nb) int32 page ids; lengths: (B,). -> (B, H, d).
    Unallocated table entries hold a valid sentinel page; its contents sit
    past ``lengths`` and are masked, so the gather-then-attend is exact.
    """
    return decode_attention_ref(q, _gather_head_major(k_pages, block_tables),
                                _gather_head_major(v_pages, block_tables),
                                lengths, rope_theta=rope_theta)


def prefill_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          start_len: torch.Tensor,
                          rope_theta: float | None = None) -> torch.Tensor:
    """A C-token chunk against the full cache. q: (B, H, C, d); k/v:
    (B, KV, S, d) — the cache ALREADY holds the chunk's keys/values at
    ``start_len .. start_len + C - 1``; start_len: (B,). Chunk token j
    attends every cache position ``<= start_len + j``. -> (B, H, C, d).

    ``rope_theta``: rotate chunk query j at absolute position
    ``start_len + j`` before attending."""
    b, h, c, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    g = h // kv
    positions = start_len[:, None] + torch.arange(c, device=q.device)  # (B,C)
    if rope_theta is not None:
        q = rope_ref(q, positions[:, None, :], rope_theta).to(q.dtype)
    qg = q.reshape(b, kv, g, c, d).float()
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bkgcd,bksd->bkgcs", qg, k.float()) * scale
    valid = (torch.arange(s, device=q.device)[None, None, :]
             <= positions[:, :, None])                               # (B,C,S)
    p = _masked_softmax(logits, valid[:, None, None])
    o = torch.einsum("bkgcs,bksd->bkgcd", p, v.float())
    return o.reshape(b, h, c, d).to(q.dtype)


def paged_prefill_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                start_len: torch.Tensor,
                                rope_theta: float | None = None
                                ) -> torch.Tensor:
    """Paged prefill chunk: gather pages, defer to the dense version.

    q: (B, H, C, d); k/v pools: (P, page, KV, d); block_tables: (B, nb)
    int32 page ids; start_len: (B,). -> (B, H, C, d)."""
    return prefill_attention_ref(q, _gather_head_major(k_pages, block_tables),
                                 _gather_head_major(v_pages, block_tables),
                                 start_len, rope_theta=rope_theta)


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                  b_: torch.Tensor, c_: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD + end-of-chunk state, for one chunk or a batch of
    them (any leading dims, ``...`` below; the kernel's M).

    x: (..., Q, H, P); dt: (..., Q, H); cum: (..., Q, H) cumulative dt*A
    within the chunk; b_/c_: (..., Q, N) (ngroups=1). Returns
    (y_intra (..., Q, H, P) in x's dtype, state (..., H, P, N) float32).
    exp(cum_i - cum_j) may overflow above the diagonal; ``where`` (not a
    product) masks it, as in the JAX oracle.
    """
    q = x.shape[-3]
    xf = x.float()
    seg = cum[..., :, None, :] - cum[..., None, :, :]          # (..., Q, Q, H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[:, :, None], torch.exp(seg),
                        torch.zeros((), device=x.device))
    cb = torch.einsum("...qn,...kn->...qk", c_.float(), b_.float())
    scores = cb[..., None] * decay * dt[..., None, :, :]       # (..., Q, Q, H)
    y = torch.einsum("...qkh,...khp->...qhp", scores, xf)
    wgt = torch.exp(cum[..., -1:, :] - cum) * dt               # (..., Q, H)
    state = torch.einsum("...qn,...qh,...qhp->...hpn", b_.float(), wgt, xf)
    return y.to(x.dtype), state
