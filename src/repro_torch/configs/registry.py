"""Registry of the architectures the port serves.

The JAX registry (``repro.configs.registry``) holds all ten assigned
architectures; the port registers those of the families its serving path
runs so far — the dense transformers and mamba2 (ssm). The other families
are ROADMAP work.
"""
from __future__ import annotations

from repro_torch.configs import (mamba2_1_3b, qwen3_14b, stablelm_3b,
                                 stablelm_12b, tinyllama_1_1b)
from repro_torch.configs.base import ModelConfig

_MODULES = (
    mamba2_1_3b,
    tinyllama_1_1b,
    stablelm_12b,
    qwen3_14b,
    stablelm_3b,
)

CONFIGS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    if name in CONFIGS:
        return CONFIGS[name]
    # allow module-style ids (underscores)
    alt = name.replace("_", "-").replace("-1-3b", "-1.3b").replace("-1-1b", "-1.1b")
    if alt in CONFIGS:
        return CONFIGS[alt]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")


def list_archs() -> list[str]:
    return sorted(CONFIGS)
