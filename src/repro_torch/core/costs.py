# Copy of src/repro/core/costs.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Analytic work-item cost model for the pod simulator.

Each work item carries global (flops, hbm_bytes, collective_bytes); the
simulator turns them into seconds for an allocation of n chips via the same
three-term roofline the dry-run reports:

    t(n) = max(flops / (n·peak·eff), bytes / (n·hbm_bw), coll / (n·link_bw))
           + launch_overhead

Costs derive from the architecture configs (2·N_active per token forward,
6·N_active training, KV traffic for decode, quadratic attention for prefill),
and can be calibrated against the dry-run roofline table
(``calibrate_from_dryrun``) which replaces the analytic per-token constants
with measured ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.roofline.hw import ChipSpec, HOST_CPU, TPU_V5E

LAUNCH_OVERHEAD_S = 20e-6
MXU_EFF = 0.55          # achievable fraction of peak on dense matmuls


@dataclass
class WorkItem:
    app: str
    request_id: int
    kind: str                      # prefill | decode | denoise | encode | train
    flops: float
    hbm_bytes: float
    coll_bytes: float = 0.0
    host_flops: float = 0.0        # serial host-side work (KV-cache-on-CPU)
    host_bytes: float = 0.0
    chunkable: bool = False
    min_chips: int = 1
    tokens: int = 1                # tokens this item computes (decode: per
                                   # sequence; prefill: prompt length) —
                                   # drives tpot/recompute/DRR accounting
    slo_hint_s: float = 1.0        # per-item slack for SLO-aware priority
    meta: dict = field(default_factory=dict)

    def duration_s(self, chips: int, chip: ChipSpec = TPU_V5E) -> float:
        t_c = self.flops / max(chips * chip.peak_flops_bf16 * MXU_EFF, 1.0)
        t_m = self.hbm_bytes / max(chips * chip.hbm_bandwidth, 1.0)
        t_l = (self.coll_bytes / max(chips * chip.ici_link_bandwidth, 1.0)
               if chip.ici_link_bandwidth else 0.0)
        t = max(t_c, t_m, t_l) + LAUNCH_OVERHEAD_S
        if self.host_flops or self.host_bytes:
            t += (self.host_flops / (HOST_CPU.peak_flops_bf16 * MXU_EFF)
                  + self.host_bytes / HOST_CPU.hbm_bandwidth)
        return t


def _attn_layers(cfg: ModelConfig) -> int:
    return len(cfg.attn_layer_ids())


def _kv_dim(cfg: ModelConfig) -> int:
    return 2 * cfg.num_kv_heads * cfg.resolved_head_dim  # K and V per token


def params_bytes(cfg: ModelConfig, active: bool = True) -> float:
    total, act = cfg.param_counts()
    return 2.0 * (act if active else total)


def decode_cost(cfg: ModelConfig, batch: int, ctx: int, *,
                kv_cache_on_host: bool = False) -> tuple[float, float, float, float, float]:
    """(flops, hbm, coll, host_flops, host_bytes) for one decode step."""
    _, n_active = cfg.param_counts()
    la = _attn_layers(cfg)
    kvd = _kv_dim(cfg)
    flops = 2.0 * n_active * batch
    attn_flops = 2.0 * batch * ctx * la * kvd
    kv_bytes = float(batch * ctx * la * kvd)  # bf16 read of K+V once
    if cfg.family == "ssm":
        kv_bytes = 2.0 * batch * cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        attn_flops = 2.0 * batch * cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state
    hbm = params_bytes(cfg) + batch * cfg.d_model * 4 * max(cfg.num_layers, 1)
    coll = 4.0 * batch * cfg.d_model * 2 * max(cfg.num_layers, 1)
    if kv_cache_on_host:
        # attention runs host-side against host-resident KV (paper §4.2.1)
        return flops, hbm, coll, attn_flops, kv_bytes
    return flops + attn_flops, hbm + kv_bytes, coll, 0.0, 0.0


def prefill_cost(cfg: ModelConfig, batch: int, seq: int) -> tuple[float, float, float]:
    _, n_active = cfg.param_counts()
    la = _attn_layers(cfg)
    kvd = _kv_dim(cfg)
    flops = 2.0 * n_active * batch * seq + batch * seq * seq * la * kvd  # causal ~1/2
    act_bytes = 4.0 * batch * seq * cfg.d_model * max(cfg.num_layers, 1)
    hbm = params_bytes(cfg) + act_bytes
    coll = 4.0 * batch * seq * cfg.d_model * 2 * max(cfg.num_layers, 1) / 16
    return flops, hbm, coll


def train_cost(cfg: ModelConfig, tokens: int) -> tuple[float, float, float]:
    total, n_active = cfg.param_counts()
    flops = 6.0 * n_active * tokens
    hbm = 14.0 * total + 6.0 * tokens * cfg.d_model * max(cfg.num_layers, 1)
    coll = 4.0 * total  # grad reduce-scatter + param all-gather (bf16, ring)
    return flops, hbm, coll


def forward_cost(cfg: ModelConfig, tokens: int) -> tuple[float, float, float]:
    """Plain forward pass (diffusion denoise step / encoder)."""
    _, n_active = cfg.param_counts()
    flops = 2.0 * n_active * tokens
    hbm = params_bytes(cfg) + 4.0 * tokens * cfg.d_model * max(cfg.num_layers, 1)
    coll = 4.0 * tokens * cfg.d_model * 2 * max(cfg.num_layers, 1) / 16
    return flops, hbm, coll


def calibrate_from_dryrun(results: list[dict]) -> dict[tuple[str, str], dict]:
    """arch×shape -> measured roofline terms (step seconds at 256 chips)."""
    table = {}
    for d in results:
        if d.get("status") == "ok" and "single" in d.get("mesh", ""):
            table[(d["arch"], d["shape"])] = {
                "compute_s": d["compute_s"], "memory_s": d["memory_s"],
                "collective_s": d["collective_s"], "chips": d["chips"],
            }
    return table
