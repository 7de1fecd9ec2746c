# Copy of src/repro/configs/jamba_v0_1_52b.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE. [arXiv:2403.19887; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Jamba: one attention layer per 8 (layer indices 7,15,23,31); MoE every other
layer. The SSM sublayers here use the Mamba2 SSD form (paper uses Mamba-1) so
they share this repo's ssd kernel — noted in DESIGN.md config-fidelity.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    num_experts=16,
    num_experts_per_token=2,
    moe_d_ff=14_336,
    attn_every=8,
    moe_every=2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    source="arXiv:2403.19887",
    notes="hybrid -> long_500k applicable (only 4/32 layers attend)",
)
