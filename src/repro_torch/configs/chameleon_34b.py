# Copy of src/repro/configs/chameleon_34b.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""chameleon-34b — early-fusion VLM, VQ image tokens. [arXiv:2405.09818; unverified]

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion: VQ-VAE image codes are ordinary vocabulary tokens, so the
backbone is a plain decoder LM; the VQ tokenizer frontend is a stub
(input_specs supplies token ids / patch embeddings). Also reused as the
DiT-style ImageGen backbone in core/apps.py.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=65_536,
    use_qk_norm=True,       # chameleon stabilizes with qk-norm
    frontend="vq_patches",
    source="arXiv:2405.09818",
)
