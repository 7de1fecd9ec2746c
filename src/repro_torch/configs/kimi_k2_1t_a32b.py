# Copy of src/repro/configs/kimi_k2_1t_a32b.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""kimi-k2-1t-a32b — trillion-param MoE (paper-table). [arXiv:2501.kimi2; unverified]

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (expert) vocab=163840, MoE 384e top-8.
+1 shared expert per the K2 card. head_dim pinned to 128 (decoupled from
d_model/num_heads = 112) for MXU alignment; the K2 card itself decouples head
dims (MLA) — recorded in DESIGN.md config-fidelity.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163_840,
    num_experts=384,
    num_experts_per_token=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    source="arXiv:2501 (Kimi K2 card)",
    notes="EP: 24 experts per model shard; largest dry-run cell",
)
