# Copy of src/repro/configs/qwen3_14b.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""qwen3-14b — qk_norm, GQA. [hf:Qwen/Qwen3-8B (family); hf]

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
Qwen3 uses explicit head_dim=128 (40*128=5120) and per-head RMS qk-norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17_408,
    vocab_size=151_936,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-14B",
    notes="40 heads not divisible by model axis 16 -> hidden-dim TP for attn",
)
