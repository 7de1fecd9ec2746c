# Copy of src/repro/configs/seamless_m4t_large_v2.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""seamless-m4t-large-v2 — enc-dec, multimodal audio. [arXiv:2308.11596; hf]

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
Built as 24 encoder + 24 decoder layers of the given width (Seamless large:
w2v-BERT speech encoder + NLLB text decoder, both 24L). Audio frontend is a
stub: input_specs() provides precomputed (batch, frames, d_model) fbank-frame
embeddings. LiveCaptions backend in the ConsumerBench app mapping.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    num_encoder_layers=24,
    num_decoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    frontend="audio_frames",
    source="arXiv:2308.11596",
)
