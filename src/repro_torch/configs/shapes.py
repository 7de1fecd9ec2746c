# Copy of src/repro/configs/shapes.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""The four assigned input-shape suites (shared by all ten LM-family archs)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="long_decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, per DESIGN.md §Arch-applicability.

    ``long_500k`` needs sub-quadratic attention: only SSM/hybrid run it.
    All assigned archs have decoders, so decode shapes always run.
    """
    if shape.kind == "long_decode" and not cfg.supports_long_context:
        return False, "full-attention arch: 500k decode is quadratic; skipped per spec"
    return True, ""


def all_cells(configs: dict[str, ModelConfig]) -> list[tuple[str, str, bool, str]]:
    """Every (arch, shape, applicable, reason) cell — 40 total."""
    out = []
    for arch, cfg in configs.items():
        for shape in SHAPES.values():
            ok, why = cell_is_applicable(cfg, shape)
            out.append((arch, shape.name, ok, why))
    return out
