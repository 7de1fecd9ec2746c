"""The training, prefill and serving steps every launcher runs.

Counterpart of :mod:`repro.training.train_step`. PyTorch runs them eagerly:
``torch.autograd.grad`` of the loss takes the place of
``jax.value_and_grad``, and nothing is jitted. On CUDA the attention of
the loss goes through the flash kernel and its gradient through the
backward kernel (``ops.attention_prefill``).
"""
from __future__ import annotations

import torch

from repro_torch.models.factory import ModelBundle
from repro_torch.training.optimizer import OptimizerConfig, make_optimizer
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten


def to_device(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays (``SyntheticTokens``) or tensors on
    ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(model: ModelBundle, params, batch: dict, *,
                   remat: str = "full"):
    """(loss, gradient tree shaped like ``params``) of ``model.loss_fn``
    — ``jax.value_and_grad`` for the port. ``params`` are left as they
    were: the gradients are taken with respect to detached aliases."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss_fn(leaves, to_device(batch, model.device), remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(model: ModelBundle, opt_cfg: OptimizerConfig,
                    *, remat: str = "full"):
    """Returns (init_state, train_step).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    functional: the inputs are left as they were. Gradients average over
    the batch (the loss is a mean)."""
    opt_init, opt_update = make_optimizer(opt_cfg)

    def init_state(gen: torch.Generator, dtype=torch.bfloat16):
        params = model.init(gen, dtype)
        return params, opt_init(params)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, remat=remat)
        new_params, new_opt, om = opt_update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, **om}

    return init_state, train_step


def make_prefill_step(model: ModelBundle, max_seq: int):
    """prefill_step(params, batch) -> (logits (B, S, V), cache): the whole
    prompt through the full-sequence forward, no autograd."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, to_device(batch, model.device),
                                 max_seq)
    return prefill_step


def make_serve_step(model: ModelBundle):
    """One decode token for every row against the KV/SSM cache (written in
    place), no autograd."""
    def serve_step(params, cache, tokens, lengths):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, lengths)
    return serve_step
