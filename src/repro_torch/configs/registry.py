# Copy of src/repro/configs/registry.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Registry of the ten assigned architectures."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import (
    mamba2_1_3b,
    tinyllama_1_1b,
    stablelm_12b,
    qwen3_14b,
    stablelm_3b,
    jamba_v0_1_52b,
    chameleon_34b,
    seamless_m4t_large_v2,
    moonshot_v1_16b_a3b,
    kimi_k2_1t_a32b,
)

_MODULES = (
    mamba2_1_3b,
    tinyllama_1_1b,
    stablelm_12b,
    qwen3_14b,
    stablelm_3b,
    jamba_v0_1_52b,
    chameleon_34b,
    seamless_m4t_large_v2,
    moonshot_v1_16b_a3b,
    kimi_k2_1t_a32b,
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
