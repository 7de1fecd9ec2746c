# Copy of src/repro/configs/stablelm_3b.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""stablelm-3b. [hf:stabilityai/stablelm-2-1_6b (family); unverified]

32L d_model=2560 32H (GQA kv=32, i.e. MHA) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50_304,
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-3b-4e1t",
)
