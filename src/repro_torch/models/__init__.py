"""Model code: layers, attention, the transformer (dense, moe, vlm),
MoE, Mamba2, the hybrid and the encoder-decoder families, weight
bridge."""
