"""GShard-style top-k MoE with capacity-bounded scatter dispatch.

Counterpart of :mod:`repro.models.moe`: ``init_moe``, ``capacity``, the
scatter ``moe_ffn`` (with the serving engine's ``token_mask`` and the
load-balance + router z-loss aux) and ``moe_dispatch``. The JAX
``moe_dispatch`` takes ``moe_ffn_shardmap`` only under the
``moe_impl="shardmap"`` hint on a device mesh; the port has neither hint
nor mesh, so it always takes the scatter path (the hint's default). The
expert products are ``torch.einsum``, as the JAX package computes them
outside any Pallas kernel.

Three places where PyTorch would pick other tokens than JAX unless told:

* *top-k ties*: ``jax.lax.top_k`` takes the lower expert id among equal
  probabilities; ``torch.topk`` promises no order, so the experts come
  from a stable descending sort, which keeps the lower id first;
* *the capacity cumsum* runs over the flattened ``B·S`` tokens in
  row-major order with masked rows taken out, as in JAX — another order
  would change which tokens are dropped;
* *the dispatch scatter* clips dropped tokens to slot ``c - 1`` with a
  zero contribution; an overwriting ``index_put_`` could let such a zero
  replace the kept token there, so the write accumulates (``x + 0`` is
  ``x``: at most one nonzero contribution reaches a slot, so the sum is
  exact in any order, on the card too).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (),
             dtype=torch.float32) -> dict:
    """Random MoE weights from ``gen`` (the JAX initialiser's leaves,
    shapes and scales; the router always float32); ``lead`` prepends
    stacking axes (the layers)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    params = {
        "router": layers.dense_init(gen, (*lead, d, e)),
        "w_gate": layers.dense_init(gen, (*lead, e, d, f), dtype=dtype),
        "w_up": layers.dense_init(gen, (*lead, e, d, f), dtype=dtype),
        "w_down": layers.dense_init(gen, (*lead, e, f, d), dtype=dtype),
    }
    if cfg.num_shared_experts:
        params["shared"] = layers.init_mlp(
            gen, d, f * cfg.num_shared_experts, lead=lead, dtype=dtype)
    return params


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = math.ceil(cfg.num_experts_per_token * num_tokens *
                  cfg.capacity_factor / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)  # pad to 8 for clean tiling


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
            token_mask: torch.Tensor | None = None):
    """x: (B, S, D) -> (y, aux_loss). Aux = load-balance + router z-loss.

    ``token_mask``: optional (B,) bool row mask (the serving engine's
    active-slot mask). Masked-out rows neither occupy expert capacity nor
    receive output."""
    b, s, d = x.shape
    t = b * s
    k = cfg.num_experts_per_token
    e = cfg.num_experts
    c = capacity(cfg, t)

    xf = x.reshape(t, d)
    router_logits = xf.float() @ params["router"]                 # (T, E)
    probs = torch.softmax(router_logits, dim=-1)
    gates, eids = top_k(probs, k)                                 # (T, k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)

    # position of each token inside its expert's capacity buffer
    onehot = F.one_hot(eids, e).sum(dim=1)                        # (T, E)
    if token_mask is not None:
        tok_live = token_mask.repeat_interleave(s)                # (T,)
        onehot = onehot * tok_live[:, None].to(onehot.dtype)
    pos_all = torch.cumsum(onehot, dim=0) * onehot - 1            # (T, E)
    pos = torch.gather(pos_all, 1, eids)                          # (T, k)
    keep = (pos >= 0) & (pos < c)
    if token_mask is not None:
        keep = keep & tok_live[:, None]
    pos_c = torch.clamp(pos, 0, c - 1)

    # ---- dispatch: k scatters token -> expert buffer
    xe = torch.zeros((e, c, d), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for j in range(k):
        contrib = torch.where(keep[:, j, None], xf, zero)
        xe.index_put_((eids[:, j], pos_c[:, j]), contrib, accumulate=True)

    # ---- expert FFN, batched over experts
    g = torch.einsum("ecd,edf->ecf", xe, params["w_gate"])
    u = torch.einsum("ecd,edf->ecf", xe, params["w_up"])
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * u, params["w_down"])

    # ---- combine: k gathers expert buffer -> token
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        yj = ye[eids[:, j], pos_c[:, j]]
        w = (gates[:, j] * keep[:, j]).to(x.dtype)
        y = y + yj * w[:, None]

    if "shared" in params:
        y = y + layers.mlp(params["shared"], xf)

    # load-balance aux (Switch): E * sum_e f_e * p_e; + router z-loss
    f_e = torch.mean(F.one_hot(eids, e).sum(dim=1).float(), dim=0)
    p_e = torch.mean(probs, dim=0)
    lb = e * torch.sum(f_e * p_e)
    z = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)
    return y.reshape(b, s, d), lb + 1e-3 * z


def moe_dispatch(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 token_mask: torch.Tensor | None = None):
    """The JAX entry point's scatter path (``hints.moe_impl`` at its
    default, ``"scatter"``); the shard_map variant is distributed work
    that the port does not have."""
    return moe_ffn(params, x, cfg, token_mask)
