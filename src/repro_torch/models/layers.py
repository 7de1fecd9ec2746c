"""Shared neural-net building blocks (plain functions on tensors).

Counterpart of :mod:`repro.models.layers`; the same math in the same
dtypes, so both packages agree on the same weights.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import mesh_ops

# --------------------------------------------------------------------- init


def dense_init(gen: torch.Generator, shape, scale: float = 0.02,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, scale) weights drawn from ``gen`` on ``gen.device``."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


# -------------------------------------------------------------------- norms

def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dtype)


# --------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float,
               device: "torch.device | str" = "cpu") -> torch.Tensor:
    """``theta ** (-2i / head_dim)`` for i < head_dim/2, in float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, d); positions: broadcastable to (..., S).

    Split-halves layout: the first d/2 features rotate against the second
    d/2, as in the JAX package."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                       # (d/2,)
    ang = positions.float()[..., None] * inv                   # (..., S, d/2)
    sin = torch.sin(ang)[..., None, :]                         # (..., S, 1, d/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- mlp

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             lead: tuple = (), dtype=torch.float32) -> dict:
    """SwiGLU weights; ``lead`` prepends stacking axes (e.g. layers)."""
    return {
        "w_gate": dense_init(gen, (*lead, d_model, d_ff), dtype=dtype),
        "w_up": dense_init(gen, (*lead, d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (*lead, d_ff, d_model), dtype=dtype),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward: gate and up in one projection, then down
    (``ops.project``; on the CPU the three matmuls as they always ran)."""
    from repro_torch.kernels import ops     # ops imports this module
    h = ops.project(None, x, params["w_gate"], params["w_up"], gated=True)
    return ops.project(None, h, params["w_down"])


# ---------------------------------------------------------------- embedding

def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return mesh_ops.take_rows(table, tokens.long())


def unembed(x: torch.Tensor, table_or_head: torch.Tensor,
            transpose: bool) -> torch.Tensor:
    """Logits (``ops.project``). ``transpose``: table is (V, D)
    tied-embedding form."""
    from repro_torch.kernels import ops     # ops imports this module
    return ops.project(None, x, table_or_head.T if transpose
                       else table_or_head)


# ----------------------------------------------------------- cross entropy

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token-level cross entropy in float32, numerically stable: the
    max is subtracted as a constant (JAX's ``stop_gradient``). ``mask``:
    (…) weights of the tokens that count; the mean is over their sum."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    label_logit = mesh_ops.gather_last(shifted,
                                       labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
