# Copy of src/repro/roofline/hw.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Target-hardware constants (TPU v5e) for the analytic roofline.

The container runs on CPU; these constants describe the TARGET the dry-run
artifacts are analysed against, per the assignment:
  197 TFLOP/s bf16 per chip; 819 GB/s HBM; ~50 GB/s/link ICI.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s
    hbm_bandwidth: float        # B/s
    hbm_bytes: float            # capacity
    ici_link_bandwidth: float   # B/s per link (injection per chip for roofline)
    idle_power_w: float         # analytic power model
    peak_power_w: float
    #: unified memory (host and accelerator share one pool, as on the
    #: paper's consumer devices): co-tenant processes claim a large slice,
    #: so far less of the nominal capacity is available for KV pages
    uma: bool = False

    def kv_budget_bytes(self, model_bytes: float = 0.0) -> float:
        """Bytes available for the KV page pool after the weights: the
        per-platform capacity budget that sizes the pool. HBM platforms
        reserve ~10% for activations/runtime; UMA platforms reserve half —
        the OS and co-resident apps own the rest (ConsumerBench's
        constrained-shared-memory setting, Section 4.3)."""
        reserve = 0.5 if self.uma else 0.1
        return max(0.0, (self.hbm_bytes - model_bytes) * (1.0 - reserve))


TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    hbm_bytes=16 * 1024**3,
    ici_link_bandwidth=50e9,
    idle_power_w=60.0,
    peak_power_w=220.0,
)

# TPU v5p — the "other platform" for the paper's §4.4 cross-hardware
# comparison (their Apple Silicon appendix): faster chip, different
# compute/bandwidth balance.
TPU_V5P = ChipSpec(
    name="tpu-v5p",
    peak_flops_bf16=459e12,
    hbm_bandwidth=2765e9,
    hbm_bytes=95 * 1024**3,
    ici_link_bandwidth=100e9,
    idle_power_w=120.0,
    peak_power_w=470.0,
)

# Host (CPU fallback) — used by the ConsumerBench "run on CPU" lower bound,
# mirroring the paper's GPU-vs-CPU experiment. Order-of-magnitude numbers for
# a server-class host (as in the paper's Xeon Gold 6126 setup).
HOST_CPU = ChipSpec(
    name="host-cpu",
    peak_flops_bf16=3e12,       # AMX/AVX-class aggregate
    hbm_bandwidth=120e9,        # DDR
    hbm_bytes=256 * 1024**3,
    ici_link_bandwidth=0.0,
    idle_power_w=80.0,
    peak_power_w=165.0,
    uma=True,                   # host DRAM is shared with everything else
)

DEFAULT_CHIP = TPU_V5E

CHIPS = {c.name: c for c in (TPU_V5E, TPU_V5P, HOST_CPU)}


def kv_bytes_per_token(cfg, dtype_bytes: int = 2) -> int:
    """Device bytes ONE cached token costs across all pageable layers of a
    model config (jax-free: usable by the simulator substrate). 0 for pure
    SSM — its O(1) state has no per-token growth."""
    fam = getattr(cfg, "family", "dense")
    if fam == "ssm":
        return 0
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if fam == "hybrid":
        n_layers = cfg.num_layers // cfg.attn_every
    elif fam == "encdec":
        n_layers = cfg.num_decoder_layers
    else:
        n_layers = cfg.num_layers
    return 2 * n_layers * kv * hd * dtype_bytes


def kv_pool_pages(chip: ChipSpec, bytes_per_token: float, page_size: int, *,
                  memory_mb: float | None = None,
                  model_bytes: float = 0.0) -> int:
    """Pages the KV pool holds under a memory budget.

    ``memory_mb`` caps the pool explicitly (the Scenario knob); otherwise
    the chip's :meth:`ChipSpec.kv_budget_bytes` capacity budget applies.
    ``bytes_per_token`` is the all-layer KV cost of one token
    (:meth:`repro_torch.models.factory.ModelBundle.kv_bytes_per_token`)."""
    if bytes_per_token <= 0:
        return 0
    budget = (memory_mb * 1024**2 if memory_mb is not None
              else chip.kv_budget_bytes(model_bytes))
    return max(1, int(budget // (bytes_per_token * page_size)))


def get_chip(name: str) -> ChipSpec:
    """Look up a ChipSpec by name (scenario YAML uses names, not objects)."""
    try:
        return CHIPS[name]
    except KeyError:
        raise ValueError(f"unknown chip {name!r}; available: "
                         f"{', '.join(sorted(CHIPS))}") from None
