"""Carry trees of arrays between the JAX package and the port.

The JAX checkpoint format (``repro.training.checkpoint._flatten``) is a
flat ``{path: ndarray}`` mapping with ``/``-joined paths ("embedding",
"layers/attn/wq", ...); a tuple's items are named ``__T0``, ``__T1``, a
list's ``__L0``, ... The port keeps the same leaf names and shapes, so one
mapping serves both packages, for parameters and optimizer states alike
(the AdamW ``step`` is a 0-d int32 leaf). This module never imports JAX;
callers hand it numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def flat_from_tree(tree, prefix: str = "") -> "dict[str, np.ndarray]":
    """``{path: ndarray}`` of a nested dict / tuple / list of tensors (or
    numpy arrays and Python numbers), in ``checkpoint._flatten``'s layout;
    tensors are copied to the host. A dtype numpy lacks (bfloat16) is
    refused rather than widened: restoring must give back the same
    dtypes."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_from_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (tuple, list)):
        tag = "T" if isinstance(tree, tuple) else "L"
        for i, v in enumerate(tree):
            key = f"__{tag}{i}"
            out.update(flat_from_tree(v, f"{prefix}/{key}" if prefix else key))
    elif isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            raise TypeError(f"{prefix!r}: bfloat16 has no numpy dtype; "
                            "cast the tree to float32 first")
        out[prefix] = tree.detach().cpu().numpy().copy()
    else:
        out[prefix] = np.asarray(tree)
    return out


def tree_from_flat(flat: "dict[str, np.ndarray]",
                   device: "str | torch.device" = "cuda"):
    """The nested tree of a flat ``{path: ndarray}`` mapping, every leaf a
    tensor on ``device`` (a 0-d array gives a 0-d tensor); ``__T``/``__L``
    children rebuild tuples/lists, as ``checkpoint._unflatten`` does."""
    dev = resolve_device(device)
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(arr, copy=True)).to(dev)

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.startswith(("__T", "__L")) for k in keys):
            seq = [rebuild(node[k])
                   for k in sorted(keys, key=lambda s: int(s[3:]))]
            return tuple(seq) if keys[0].startswith("__T") else seq
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def params_from_jax(flat: "dict[str, np.ndarray]",
                    device: "str | torch.device" = "cuda") -> dict:
    """The port's nested parameter dict from a flat ``{path: ndarray}``
    mapping of the JAX package's parameters, on ``device``: every
    family's tree, whose leaves keep the JAX names and shapes (hybrid's
    ``blocks/sub{i}``, enc-dec's ``encoder``/``decoder``, the MoE expert
    stacks ``w_gate``/``w_up``/``w_down (E, ...)`` and ``router``)."""
    if any(p.startswith(("__T", "__L")) for path in flat
           for p in path.split("/")):
        raise ValueError("sequence leaves are not part of any family's "
                         "parameters")
    return tree_from_flat(flat, device)
