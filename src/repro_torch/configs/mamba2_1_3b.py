# Copy of src/repro/configs/mamba2_1_3b.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""mamba2-1.3b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] 48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128.
Mamba2-1.3B card: d_inner = 2*d_model = 4096, headdim=64 -> 64 SSD heads,
ngroups=1, conv width 4, chunk 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv_width=4,
    tie_embeddings=True,
    source="arXiv:2405.21060",
    notes="attention-free; decode is O(1) state update; long_500k applicable",
)
