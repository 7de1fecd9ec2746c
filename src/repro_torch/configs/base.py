# Copy of src/repro/configs/base.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Architecture configuration dataclasses.

Every assigned architecture is described by a single frozen ``ModelConfig``.
The model zoo (``repro.models``) consumes these; nothing in here touches jax
device state so configs import instantly everywhere (including the dry-run
process before XLA_FLAGS is applied).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int               # raw vocabulary from the model card
    head_dim: int = 0             # 0 -> d_model // num_heads
    # --- normalization / position ---
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # --- hybrid (jamba-style interleave) ---
    attn_every: int = 0           # attention layer index stride (jamba: 8)
    moe_every: int = 0            # MoE layer index stride     (jamba: 2)
    # --- encoder-decoder ---
    num_encoder_layers: int = 0
    num_decoder_layers: int = 0
    # --- modality frontend stubs ---
    frontend: str = "none"        # none | audio_frames | vq_patches
    # --- bookkeeping ---
    vocab_pad_multiple: int = 256
    source: str = ""
    notes: str = ""

    # ---------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM and hybrid archs only."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def attn_layer_ids(self) -> list[int]:
        """Which layer indices carry full attention (hybrid support)."""
        if self.family == "ssm":
            return []
        if self.family == "hybrid" and self.attn_every:
            return [i for i in range(self.num_layers) if i % self.attn_every == self.attn_every - 1]
        return list(range(self.num_layers))

    def moe_layer_ids(self) -> list[int]:
        if not self.is_moe:
            return []
        if self.moe_every:
            return [i for i in range(self.num_layers) if i % self.moe_every == self.moe_every - 1]
        return list(range(self.num_layers))

    # ------------------------------------------------------------ param math
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        qk_norm = 2 * hd if self.use_qk_norm else 0
        return q + kv + o + qk_norm

    def _mlp_params(self, d_ff: int) -> int:
        # SwiGLU: gate + up + down
        return 3 * self.d_model * d_ff

    def _moe_params(self) -> tuple[int, int]:
        """(total, active) params of one MoE layer's expert stack + router."""
        per_expert = self._mlp_params(self.moe_d_ff)
        router = self.d_model * self.num_experts
        shared = self.num_shared_experts * per_expert
        total = self.num_experts * per_expert + router + shared
        active = self.num_experts_per_token * per_expert + router + shared
        return total, active

    def _ssm_params(self) -> int:
        d_in = self.ssm_d_inner
        n = self.ssm_state
        h = self.ssm_num_heads
        # in_proj produces [z, x, B, C, dt]: 2*d_in + 2*n + h
        in_proj = self.d_model * (2 * d_in + 2 * n + h)
        conv = self.ssm_conv_width * (d_in + 2 * n)
        out_proj = d_in * self.d_model
        extras = 2 * h + d_in  # A_log, dt_bias, norm weight
        return in_proj + conv + out_proj + extras

    def _layer_params(self, layer_id: int) -> tuple[int, int]:
        """(total, active) params in one layer (norms ignored, negligible)."""
        total = active = 2 * self.d_model  # 2 rmsnorm scales
        is_attn = layer_id in self.attn_layer_ids() if self.family == "hybrid" else None
        if self.family == "ssm":
            p = self._ssm_params()
            return total + p, active + p
        if self.family == "hybrid":
            mix = self._attn_params() if is_attn else self._ssm_params()
            total += mix
            active += mix
            if layer_id in self.moe_layer_ids():
                t, a = self._moe_params()
                return total + t, active + a
            p = self._mlp_params(self.d_ff)
            return total + p, active + p
        # dense / moe / vlm / encdec decoder layers
        a_p = self._attn_params()
        total += a_p
        active += a_p
        if self.is_moe and layer_id in self.moe_layer_ids():
            t, a = self._moe_params()
            return total + t, active + a
        p = self._mlp_params(self.d_ff)
        return total + p, active + p

    def param_counts(self) -> tuple[int, int]:
        """(total, active) parameter counts, embeddings included once."""
        total = active = 0
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder: self+cross attn + mlp
            enc = self.num_encoder_layers * (self._attn_params() + self._mlp_params(self.d_ff) + 2 * self.d_model)
            dec = self.num_decoder_layers * (2 * self._attn_params() + self._mlp_params(self.d_ff) + 3 * self.d_model)
            total = active = enc + dec
        else:
            for i in range(self.num_layers):
                t, a = self._layer_params(i)
                total += t
                active += a
        emb = self.padded_vocab * self.d_model
        head = 0 if self.tie_embeddings else self.padded_vocab * self.d_model
        total += emb + head
        active += emb + head
        return total, active

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            vocab_pad_multiple=16,
        )
        if self.is_moe:
            kw.update(num_experts=4, num_experts_per_token=2, moe_d_ff=64,
                      num_shared_experts=min(self.num_shared_experts, 1))
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.family == "hybrid":
            kw.update(num_layers=4, attn_every=2, moe_every=2)
        if self.family == "encdec":
            kw.update(num_encoder_layers=2, num_decoder_layers=2, num_layers=2)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name + "-reduced", min(self.seq_len, 64),
                           min(self.global_batch, 2), self.kind)
