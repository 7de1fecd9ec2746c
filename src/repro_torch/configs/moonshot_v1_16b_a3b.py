# Copy of src/repro/configs/moonshot_v1_16b_a3b.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""moonshot-v1-16b-a3b — kimi/moonlight MoE. [hf:moonshotai/Moonlight-16B-A3B; hf]

48L d_model=2048 16H (GQA kv=16) d_ff=1408 (expert) vocab=163840, MoE 64e top-6.
Moonlight (DeepSeek-V3-style small): 64 routed experts top-6 + 2 shared
experts, expert intermediate 1408.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    num_experts=64,
    num_experts_per_token=6,
    moe_d_ff=1408,
    num_shared_experts=2,
    source="hf:moonshotai/Moonlight-16B-A3B",
    notes="EP: 4 experts per model shard on the 16-way axis",
)
