"""Int8 gradient compression with error feedback.

Counterpart of :mod:`repro.training.grad_compression`: per-leaf symmetric
int8 quantization of the gradients before the data-parallel reduction,
with an error-feedback accumulator so that the quantization error is added
back the next step (EF-SGD) — a quarter of the float32 bytes on the wire.
Trees are the port's nested dicts of tensors.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.training.tree import tree_leaves, tree_map

Pytree = Any


def quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 values, float32 scale). Symmetric, per tensor; rounds
    half to even, as ``jnp.round`` does."""
    g32 = g.float()
    scale = torch.clamp(torch.amax(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress(grads: Pytree, error: Pytree | None = None
             ) -> tuple[tuple[Pytree, Pytree], Pytree]:
    """Returns ((q_tree, scale_tree), new error-feedback tree)."""
    if error is None:
        error = tree_map(lambda g: torch.zeros(g.shape, device=g.device),
                         grads)
    corrected = tree_map(lambda g, e: g.float() + e, grads, error)
    pairs = tree_map(quantize_leaf, corrected)
    q_tree = tree_map(lambda _, p: p[0], grads, pairs)
    s_tree = tree_map(lambda _, p: p[1], grads, pairs)
    deq = tree_map(dequantize_leaf, q_tree, s_tree)
    new_error = tree_map(lambda c, d: c - d, corrected, deq)
    return (q_tree, s_tree), new_error


def decompress(comp: tuple[Pytree, Pytree]) -> Pytree:
    q_tree, s_tree = comp
    return tree_map(dequantize_leaf, q_tree, s_tree)


def compression_ratio(grads: Pytree) -> float:
    """Bytes(f32 grads) / bytes(int8 + per-tensor scale)."""
    leaves = tree_leaves(grads)
    n = sum(x.numel() for x in leaves)
    return (4.0 * n) / (1.0 * n + 4.0 * len(leaves))
