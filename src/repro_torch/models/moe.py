"""GShard-style top-k MoE with capacity-bounded scatter dispatch.

Counterpart of :mod:`repro.models.moe`: ``init_moe``, ``capacity``, the
scatter ``moe_ffn`` (with the serving engine's ``token_mask`` and the
load-balance + router z-loss aux), the expert-parallel
``moe_ffn_shardmap`` and ``moe_dispatch``, which takes the latter under
the ``moe_impl="shardmap"`` hint when the activations lie on a device
mesh (DTensors) and the scatter path off one, as JAX does. The expert
products are einsums (``mesh_ops.einsum``: ``torch.einsum`` off a mesh),
as the JAX package computes them outside any Pallas kernel.

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
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import hints, mesh_ops, sharding
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


def _route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """Each token's router logits and probabilities (T, E) and its top-``k``
    experts: gates renormalised over them and expert ids (T, k)."""
    logits = mesh_ops.matmul(xf.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gates, eids = top_k(probs, k)
    return logits, probs, gates / torch.sum(gates, dim=-1, keepdim=True), eids


def _experts(xf: torch.Tensor, gates: torch.Tensor, eids: torch.Tensor,
             w: tuple, c: int, *, first: int | None = None,
             live: torch.Tensor | None = None) -> torch.Tensor:
    """Tokens xf (T, D) through the experts that ``w`` = (w_gate, w_up,
    w_down) holds, at ``c`` slots an expert -> (T, D). A token's slot is
    its rank among the tokens routed to that expert (a cumsum in token
    order), tokens past ``c`` are dropped, k scatters fill the expert
    buffers, the expert products run batched and k gathers weight the
    outputs by the gates. ``first``: the id of ``w``'s first expert where
    ``w`` holds one shard's range (the expert-parallel body: tokens routed
    elsewhere are left out); ``live``: (T,) bool, the tokens that may take
    a slot at all."""
    wg, wu, wd = w
    e_l, (t, d), k = wg.shape[0], xf.shape, eids.shape[1]
    e_c, valid = eids, None
    if first is not None:
        e_rel = eids - first
        valid = (e_rel >= 0) & (e_rel < e_l)
        e_c = torch.clamp(e_rel, 0, e_l - 1)
    if live is not None:
        valid = live[:, None] if valid is None else valid & live[:, None]

    # position of each token inside its expert's capacity buffer
    onehot = F.one_hot(e_c, e_l)                                  # (T, k, E)
    if valid is not None:
        onehot = onehot * valid[..., None].to(onehot.dtype)
    onehot = onehot.sum(dim=1)                                    # (T, E)
    pos_all = mesh_ops.along(lambda t: torch.cumsum(t, dim=0), onehot,
                             0) * onehot - 1                      # (T, E)
    pos = torch.gather(pos_all, 1, e_c)                           # (T, k)
    keep = (pos >= 0) & (pos < c)
    if valid is not None:
        keep = keep & valid
    pos_c = torch.clamp(pos, 0, c - 1)

    # ---- dispatch: k scatters token -> expert buffer
    xe = mesh_ops.zeros((e_l, c, d), like=xf)
    zero = torch.zeros((), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        contrib = torch.where(keep[:, j, None], xf, zero)
        xe = mesh_ops.index_add(xe, (e_c[:, j], pos_c[:, j]), contrib)

    # ---- expert FFN, batched over experts
    g = mesh_ops.einsum("ecd,edf->ecf", xe, wg)
    u = mesh_ops.einsum("ecd,edf->ecf", xe, wu)
    ye = mesh_ops.einsum("ecf,efd->ecd", F.silu(g) * u, wd)

    # ---- combine: k gathers expert buffer -> token
    y = torch.zeros((t, d), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        yj = ye[e_c[:, j], pos_c[:, j]]
        w_j = (gates[:, j] * keep[:, j]).to(xf.dtype)
        y = y + yj * w_j[:, None]
    return y


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
            token_mask: torch.Tensor | None = None):
    """x: (B, S, D) -> (y, aux_loss). Aux = load-balance + router z-loss.

    ``token_mask``: optional (B,) bool row mask (the serving engine's
    active-slot mask). Masked-out rows neither occupy expert capacity nor
    receive output."""
    b, s, d = x.shape
    t = b * s
    e = cfg.num_experts
    xf = mesh_ops.anchor(x.reshape(t, d), "batch", None)
    router_logits, probs, gates, eids = _route(xf, params["router"],
                                               cfg.num_experts_per_token)
    y = _experts(xf, gates, eids, (params["w_gate"], params["w_up"],
                                   params["w_down"]), capacity(cfg, t),
                 live=(None if token_mask is None
                       else token_mask.repeat_interleave(s)))
    if "shared" in params:
        y = y + layers.mlp(params["shared"], xf)

    # load-balance aux (Switch): E * sum_e f_e * p_e; + router z-loss
    f_e = torch.mean(F.one_hot(eids, e).sum(dim=1).float(), dim=0)
    p_e = torch.mean(probs, dim=0)
    lb = e * torch.sum(f_e * p_e)
    z = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)
    y = mesh_ops.anchor(y, "batch", None)
    return (mesh_ops.anchor(y.reshape(b, s, d), "batch", None, None),
            lb + 1e-3 * z)


# --------------------------------------------------------------------------
# expert-parallel dispatch on a mesh (the moe_impl="shardmap" hint)
# --------------------------------------------------------------------------
# Routing is computed redundantly on every model shard (tokens are
# model-replicated at the FFN input); each model shard gathers ONLY the
# tokens routed to ITS local experts — zero dispatch communication — and a
# single all-reduce over "model" combines expert outputs.

def _model_mesh(x: torch.Tensor):
    """The mesh of ``x`` where it is a DTensor on a mesh with a ``model``
    axis, else None."""
    if isinstance(x, DTensor) and "model" in (x.device_mesh.mesh_dim_names
                                              or ()):
        return x.device_mesh
    return None


def moe_ffn_shardmap(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Drop-in for :func:`moe_ffn` on a ('data','model') (+'pod') mesh:
    JAX's shard_map body over ``local_map``. Each model shard routes its
    data shard's tokens (replicated over ``model``), keeps those routed to
    its ``E / mp`` experts in a per-shard capacity buffer — JAX's
    ``capacity(T_l * mp) // mp``, rounded up to 8 — and returns its partial
    output; one all-reduce over ``model`` sums them. The aux loss is each
    data shard's, averaged over the dp axes (JAX's pmean; over ``model``
    it is already the same). Per-shard capacity drops other tokens than
    the global scatter does, by design. Off such a mesh, or where the
    experts do not divide the model axis, it is :func:`moe_ffn`."""
    mesh = _model_mesh(x)
    if mesh is None:
        return moe_ffn(params, x, cfg)
    names = list(mesh.mesh_dim_names)
    mp_size = mesh.size(names.index("model"))
    if cfg.num_experts % mp_size:
        return moe_ffn(params, x, cfg)
    dp = sharding.dp_axes(mesh)
    b, s, d = x.shape
    k = cfg.num_experts_per_token
    e = cfg.num_experts
    e_l = e // mp_size
    dpn = sharding.dp_size(mesh) if dp else 1
    bspec = sharding.dp_entry(mesh) if dp and b % dpn == 0 else None
    t_l = (b // dpn if bspec else b) * s
    c_l = capacity(cfg, t_l * mp_size) // mp_size  # same global capacity
    c_l = max(8, ((c_l + 7) // 8) * 8)
    m_idx = mesh.get_local_rank("model")
    P = sharding.P
    rep = sharding.placements(P(), mesh)
    x_pl = sharding.placements(P(bspec, None, None), mesh)
    w_pl = sharding.placements(P("model", None, None), mesh)
    y_pl = [mesh_ops.partial_sum() if n == "model" else p
            for n, p in zip(names, x_pl)]
    aux_pl = [mesh_ops.partial_sum() if bspec and n in dp else Replicate()
              for n in names]

    def body(router, wg, wu, wd, x_l):
        xf = x_l.reshape(-1, d)
        logits, probs, gates, eids = _route(xf, router, k)
        y = _experts(xf, gates, eids, (wg, wu, wd), c_l, first=m_idx * e_l)

        # aux: the same on every model shard (routing replicated); a
        # scatter-add of the counts, as JAX's
        counts = torch.zeros((e,), dtype=torch.float32,
                             device=x_l.device).index_add(
            0, eids.reshape(-1), torch.ones(eids.numel(),
                                            device=x_l.device))
        f_e = counts / eids.shape[0]
        p_e = torch.mean(probs, dim=0)
        aux = e * torch.sum(f_e * p_e) + 1e-3 * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2)
        if bspec:
            aux = aux / dpn                    # the dp mean, as a sum
        return y.reshape(x_l.shape), aux

    y, aux = local_map(
        body, out_placements=(y_pl, aux_pl),
        in_placements=(rep, w_pl, w_pl, w_pl, x_pl),
        redistribute_inputs=True, device_mesh=mesh)(
        params["router"], params["w_gate"], params["w_up"],
        params["w_down"], x)
    y = y.redistribute(mesh, x_pl)             # the all-reduce over model
    aux = aux.redistribute(mesh, rep)
    if "shared" in params:
        y = y + layers.mlp(params["shared"], x)
    return y, aux


def moe_dispatch(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 token_mask: torch.Tensor | None = None):
    """Entry point honouring the ``moe_impl`` hint: the expert-parallel
    :func:`moe_ffn_shardmap` under ``shardmap`` when no ``token_mask`` is
    given and ``x`` lies on a mesh with a ``model`` axis; the scatter
    :func:`moe_ffn` otherwise (``token_mask``, the serving engine's
    active-slot mask, always takes it, as in JAX)."""
    if (token_mask is None and hints.get("moe_impl") == "shardmap"
            and _model_mesh(x) is not None):
        return moe_ffn_shardmap(params, x, cfg)
    return moe_ffn(params, x, cfg, token_mask)
