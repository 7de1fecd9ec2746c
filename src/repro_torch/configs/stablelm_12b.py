# Copy of src/repro/configs/stablelm_12b.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""stablelm-12b. [hf:stabilityai/stablelm-2-1_6b (family); hf]

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,           # d_model // num_heads
    d_ff=13_824,
    vocab_size=100_352,
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-12b",
)
