"""Uniform model API for the serving engine: the dense family.

Counterpart of :mod:`repro.models.factory` for the paged serving path.
Other families (moe, vlm, ssm, hybrid, encdec) raise
``NotImplementedError``: they are ROADMAP queue 1, slice 3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer

Params = Any
Cache = dict


@dataclass
class ModelBundle:
    cfg: ModelConfig
    device: torch.device

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator, dtype=torch.float32) -> Params:
        """Random weights from ``gen`` (a generator on ``self.device``)."""
        if torch.device(gen.device).type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return transformer.init_params(gen, self.cfg, dtype)

    # ------------------------------------------------------ paged serving
    #: cache leaves that live in the shared page pool (no batch axis);
    #: slot-slicing helpers pass them through untouched
    PAGE_KEYS = ("k_pages", "v_pages")

    def cache_pages(self) -> bool:
        """The dense family's growing KV always pages."""
        return True

    def prefix_shareable(self) -> bool:
        """Finished requests' prompt KV can be reused across requests: the
        dense transformer's entire prefill state lives in the page pool."""
        return self.cfg.family == "dense" and not self.cfg.is_moe

    def copy_page(self, cache: Cache, src: int, dst: int) -> Cache:
        """Copy one pool row across every layer, in place — the CoW fork
        behind :meth:`BlockAllocator.fork_table`."""
        for key in self.PAGE_KEYS:
            leaf = cache[key]
            leaf[:, dst] = leaf[:, src]
        return cache

    def init_paged_cache(self, num_pages: int, page_size: int, batch: int,
                         max_seq: int, dtype=torch.bfloat16) -> Cache:
        """Page-pool cache: ``num_pages`` pages of ``page_size`` tokens per
        layer, shared by all rows (block tables are engine-side). ``batch``
        and ``max_seq`` size slot-resident leaves, which the dense family
        does not have."""
        return transformer.init_paged_cache(self.cfg, num_pages, page_size,
                                            self.device, dtype)

    def decode_step_paged(self, params: Params, cache: Cache,
                          tokens: torch.Tensor, lengths: torch.Tensor,
                          block_tables: torch.Tensor,
                          active: torch.Tensor | None = None):
        """One decode step for all B rows against the page pool; the new
        K/V is written into ``cache`` in place. Returns (logits (B, V),
        cache)."""
        return transformer.decode_step_paged(params, cache, tokens, lengths,
                                             block_tables, self.cfg, active)

    def prefill_chunk_paged(self, params: Params, cache: Cache,
                            tokens: torch.Tensor, start_len: torch.Tensor,
                            block_tables: torch.Tensor,
                            active: torch.Tensor | None = None,
                            valid: torch.Tensor | None = None):
        """Advance every row's prefill by C tokens in one dispatch; the
        chunk's K/V is written into ``cache`` in place. ``valid``: per-row
        count of real tokens (multi-slot batched prefill). Returns
        (logits (B, C, V), cache)."""
        return transformer.prefill_chunk_paged(params, cache, tokens,
                                               start_len, block_tables,
                                               self.cfg, active, valid)

    def multi_slot_batchable(self) -> bool:
        """Can ``prefill_chunk_paged(valid=...)`` batch several mid-prefill
        slots into one dispatch without changing any row's tokens? True:
        a dense row's compute is independent of the other rows."""
        return not self.cfg.is_moe

    # ------------------------------------------------- cache slot slicing
    def slice_cache(self, cache: Cache, slot: int) -> Cache:
        """Per-slot view. Page-pool leaves have no batch axis and pass
        through whole; slot-resident leaves are (L, B, ...)."""
        return {k: v if k in self.PAGE_KEYS else v[:, slot:slot + 1]
                for k, v in cache.items()}

    def set_cache_slice(self, cache: Cache, slot: int, piece: Cache) -> Cache:
        """Write a per-slot piece back in place; page-pool leaves are left
        untouched (slot admission remaps block tables instead)."""
        for k, v in cache.items():
            if k not in self.PAGE_KEYS:
                v[:, slot:slot + 1] = piece[k].to(v.dtype)
        return cache


def build_model(cfg: ModelConfig,
                device: "str | torch.device" = "cuda") -> ModelBundle:
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1, "
            "slice 3: the other families on the serving path)")
    return ModelBundle(cfg, resolve_device(device))
