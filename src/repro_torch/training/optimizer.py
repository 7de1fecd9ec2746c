"""Optimizers: AdamW with a float32 master copy of the weights, and
Adafactor (factored second moment) for the parameter-count outliers.

Counterpart of :mod:`repro.training.optimizer`, update for update. The
step scalars — the learning-rate schedule, the bias corrections
``1 - b**step`` and Adafactor's ``beta2`` — are float32 tensors, as JAX
computes them, not Python floats. The optimizer runs on the STACKED leaves
(one tensor per leaf for all layers), so Adafactor's factored moments and
its update-clipping RMS span all layers of a leaf, as in JAX.

Updates are functional: new tensors for the parameters and the state, the
inputs left as they were (the JAX semantics the fault-tolerance replay
relies on). A float32 parameter returned by AdamW may share storage with
the new master copy; nothing updates either in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.training.tree import tree_leaves, tree_map

Params = Any


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, float32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to global norm <= max_norm in float32, the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), norm


# ------------------------------------------------------------------ AdamW

def adamw_init(params: Params) -> dict:
    first = tree_leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        # a copy: the master must never alias the params
        "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                   copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, device=p.device), params),
    }


def adamw_update(cfg: OptimizerConfig, grads, opt_state: dict,
                 params: Params):
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())

    def upd(g, m, v, master):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / c1
        vh = v / c2
        new_master = master - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                    + cfg.weight_decay * master)
        return m, v, new_master

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"],
                   opt_state["master"])
    pick = (lambda i: tree_map(lambda _, t: t[i], grads, out))
    m, v, master = pick(0), pick(1), pick(2)
    new_params = tree_map(lambda mp, p: mp.to(p.dtype), master, params)
    new_state = {"step": step, "master": master, "m": m, "v": v}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


# -------------------------------------------------------------- Adafactor

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def adafactor_init(params: Params) -> dict:
    def vrow(p):
        shape = p.shape[:-1] if _factored(p.shape) else p.shape
        return torch.zeros(shape, device=p.device)

    def vcol(p):
        shape = (p.shape[:-2] + p.shape[-1:] if _factored(p.shape)
                 else (1,))
        return torch.zeros(shape, device=p.device)

    first = tree_leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "v_row": tree_map(vrow, params),
        "v_col": tree_map(vcol, params),
    }


def adafactor_update(cfg: OptimizerConfig, grads, opt_state: dict,
                     params: Params):
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    beta2 = 1.0 - (step.float() + 1.0) ** -0.8
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)

    def upd(g, vr, vc, p):
        g2 = g * g + 1e-30
        if _factored(g.shape):
            vr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=1e-30)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :])
        else:
            vr = beta2 * vr + (1 - beta2) * g2
            u = g / torch.sqrt(vr)
        # update clipping (RMS <= 1), over the whole stacked leaf
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        pf = p.float()
        newp = pf - lr * u - lr * cfg.weight_decay * pf
        return newp, vr, vc

    out = tree_map(upd, grads, opt_state["v_row"], opt_state["v_col"],
                   params)
    pick = (lambda i: tree_map(lambda _, t: t[i], grads, out))
    newp, vr, vc = pick(0), pick(1), pick(2)
    new_params = tree_map(lambda np_, p: np_.to(p.dtype), newp, params)
    return new_params, {"step": step, "v_row": vr, "v_col": vc}, \
        {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------------------------- dispatcher

def make_optimizer(cfg: OptimizerConfig):
    """(init(params) -> state, update(grads, state, params) -> (params,
    state, metrics))."""
    if cfg.name == "adamw":
        return adamw_init, lambda g, s, p: adamw_update(cfg, g, s, p)
    if cfg.name == "adafactor":
        return adafactor_init, lambda g, s, p: adafactor_update(cfg, g, s, p)
    raise ValueError(cfg.name)
