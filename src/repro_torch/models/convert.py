"""Carry the JAX package's weights over to the port.

The JAX checkpoint format (``repro.training.checkpoint._flatten``) is a
flat ``{path: ndarray}`` mapping with ``/``-joined paths ("embedding",
"layers/attn/wq", ...). The port keeps the same leaf names and shapes, so
the bridge only rebuilds the nesting and moves each array to the device.
This module never imports JAX; callers hand it numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(flat: "dict[str, np.ndarray]",
                    device: "str | torch.device" = "cuda") -> dict:
    """The port's nested parameter dict from a flat ``{path: ndarray}``
    mapping of the JAX package's parameters, on ``device``."""
    dev = resolve_device(device)
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        if any(p.startswith(("__T", "__L")) for p in parts):
            raise ValueError(f"{path!r}: sequence leaves are not part of the "
                             "dense transformer's parameters")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(arr, copy=True)).to(dev)
    return root
