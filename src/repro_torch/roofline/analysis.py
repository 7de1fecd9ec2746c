# Copy of src/repro/roofline/analysis.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
"""Roofline-term extraction from compiled XLA artifacts.

Three terms per (arch × shape × mesh) cell, in seconds:

    compute    = HLO_FLOPs       / (chips × peak_FLOP/s)
    memory     = HLO_bytes       / (chips × HBM_bw)
    collective = collective_bytes / (chips × link_bw)

``cost_analysis()`` supplies HLO_FLOPs / HLO_bytes. Collective bytes are NOT
in cost_analysis: we parse the post-SPMD optimized HLO text and sum operand
sizes of all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute ops.
"""
from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field

from repro_torch.roofline.hw import ChipSpec, DEFAULT_CHIP

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute")

# e.g.  %ar = bf16[128,2048]{1,0} all-reduce(...)
#       ROOT %t = (f32[4], bf16[8,16]) all-to-all(...)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_LINE_RE = re.compile(
    r"=\s*(\(?[a-z0-9]+\[[^=]*?)\s+(" + "|".join(_COLLECTIVE_OPS) + r")\(")


def _shape_bytes(text: str) -> int:
    """Sum byte sizes of every dtype[shape] in a (possibly tuple) shape str."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_stats(hlo_text: str) -> dict:
    """Per-op-kind counts and byte totals from optimized HLO text.

    Bytes are the *output* shape bytes of each collective op — the data that
    actually crosses links (all-reduce operand==output; all-gather output is
    the gathered tensor; reduce-scatter output is the scattered shard, so we
    conservatively use output bytes as on-wire proxy in every case).
    """
    stats = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVE_OPS}
    for m in _LINE_RE.finditer(hlo_text):
        shape_text, op = m.group(1), m.group(2)
        stats[op]["count"] += 1
        stats[op]["bytes"] += _shape_bytes(shape_text)
    stats["total_bytes"] = sum(v["bytes"] for k, v in stats.items()
                               if isinstance(v, dict))
    stats["total_count"] = sum(v["count"] for k, v in stats.items()
                               if isinstance(v, dict))
    return stats


@dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    per_device_memory_bytes: float = 0.0
    collective_detail: dict = field(default_factory=dict)
    notes: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time (no overlap assumed across terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU at the roofline step time."""
        if self.step_time_s <= 0:
            return 0.0
        chips_peak = self.chips * DEFAULT_CHIP.peak_flops_bf16
        return self.model_flops / (self.step_time_s * chips_peak)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, step_time_s=self.step_time_s,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def achieved_fraction(flops: float, hbm_bytes: float, duration_s: float,
                      chips: int, chip: ChipSpec = DEFAULT_CHIP, *,
                      ici_bytes: float = 0.0) -> float:
    """Roofline achievement of an executed event: the fraction of the
    BINDING roofline resource actually moved in ``duration_s`` on
    ``chips`` — max of the compute fraction (FLOPs against peak MXU),
    the memory fraction (bytes against HBM bandwidth) and, when the
    event moved interconnect traffic, the ICI fraction (bytes against
    per-chip link bandwidth) — clamped to 1.

    This is the per-event SMOCC term the telemetry timelines integrate
    (compute-bound work lands near the MXU efficiency; memory-bound
    decode saturates the bandwidth roof; a sharded or disaggregated
    span whose KV/activation transfer dominates saturates the ICI roof
    instead), and is jax-free on purpose: both substrates call it with
    analytic FLOPs/bytes."""
    if duration_s <= 0.0 or chips <= 0:
        return 0.0
    comp = flops / (duration_s * chips * chip.peak_flops_bf16)
    memb = (hbm_bytes / (duration_s * chips * chip.hbm_bandwidth)
            if chip.hbm_bandwidth else 0.0)
    ici = (ici_bytes / (duration_s * chips * chip.ici_link_bandwidth)
           if ici_bytes and chip.ici_link_bandwidth else 0.0)
    return min(max(comp, memb, ici), 1.0)


def cost_analysis_terms(compiled) -> tuple[float, float]:
    """(flops, bytes accessed) from a compiled executable, robustly."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    flops = float(ca.get("flops", 0.0))
    byts = float(ca.get("bytes accessed", 0.0))
    if byts == 0.0:
        byts = sum(float(v) for k, v in ca.items()
                   if k.startswith("bytes accessed"))
    return flops, byts


def memory_analysis_bytes(compiled) -> float:
    try:
        ma = compiled.memory_analysis()
    except Exception:
        return 0.0
    if ma is None:
        return 0.0
    for attrs in (("temp_size_in_bytes", "argument_size_in_bytes",
                   "output_size_in_bytes"),):
        try:
            return float(sum(getattr(ma, a) for a in attrs))
        except Exception:
            pass
    return 0.0


def analyze(compiled, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, chip: ChipSpec = DEFAULT_CHIP,
            hlo_text: str | None = None, notes: str = "") -> RooflineResult:
    """Build the three-term roofline from a compiled executable.

    cost_analysis flops/bytes on the SPMD-partitioned module are PER-DEVICE
    (the module describes one shard's program), so the per-chip terms divide
    by nothing further; we record them as measured.
    """
    flops, byts = cost_analysis_terms(compiled)
    text = hlo_text if hlo_text is not None else compiled.as_text()
    coll = collective_stats(text)
    collective_bytes = coll["total_bytes"]
    return RooflineResult(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops * chips,   # scale per-device numbers to whole mesh
        hlo_bytes=byts * chips,
        collective_bytes=collective_bytes * chips,
        model_flops=model_flops,
        compute_s=flops / chip.peak_flops_bf16,
        memory_s=byts / chip.hbm_bandwidth,
        collective_s=collective_bytes / chip.ici_link_bandwidth,
        per_device_memory_bytes=memory_analysis_bytes(compiled),
        collective_detail=coll,
        notes=notes,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D (train, dense) or 6·N_active·D (MoE); forward-only
    kinds use 2·N·D. Decode kinds count one token per row plus KV readback
    is a memory (not FLOP) term, so FLOPs = 2·N_active·B tokens.

    enc-dec: the encoder sees seq/FRAME_RATIO frames, the decoder seq tokens
    — weight the two stacks accordingly (a single 2·N·D would overcount)."""
    total, active = cfg.param_counts()
    n = active
    mult = {"train": 6.0, "prefill": 2.0}.get(shape.kind, 2.0)
    if cfg.family == "encdec" and shape.kind in ("train", "prefill"):
        from repro_torch.models.encdec import frames_len
        enc_frac = cfg.num_encoder_layers / (cfg.num_encoder_layers +
                                             cfg.num_decoder_layers)
        n_enc = active * enc_frac
        n_dec = active - n_enc
        return (mult * n_enc * shape.global_batch * frames_len(shape.seq_len)
                + mult * n_dec * shape.global_batch * shape.seq_len)
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
        return mult * n * tokens
    # decode kinds: one new token per batch row
    return 2.0 * n * shape.global_batch


def save_results(results: list[RooflineResult], path: str) -> None:
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in results], f, indent=1)


def load_results(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)
