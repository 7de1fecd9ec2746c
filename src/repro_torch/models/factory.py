"""Uniform model API: training, eval and serving for the dense and ssm
families.

Counterpart of :mod:`repro.models.factory`: the dense transformer's
full-sequence ``forward``, ``loss_fn`` and whole-prompt ``prefill``, and
its serving steps on the paged pool or the contiguous cache; the Mamba2 LM
(family ``ssm``), whose recurrent state never pages, serves only (its
``forward``/``prefill`` need an SSD backward: ROADMAP queue 1, slice 4).
Other families (moe, vlm, hybrid, encdec) raise ``NotImplementedError``:
they are ROADMAP queue 1, slice 3.

Every step writes its new cache into the caller's tensors in place and
returns the same dict; the write casts to the cache's own dtypes, the cast
the JAX bundle applies to the rebuilt cache after every step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, mamba_lm, transformer

Params = Any
Cache = dict

#: the families whose serving path is ported
PORTED_FAMILIES = ("dense", "ssm")


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
        if self.cfg.family == "ssm":
            return mamba_lm.init_params(gen, self.cfg, dtype)
        return transformer.init_params(gen, self.cfg, dtype)

    # ------------------------------------------------------------ forward
    def _dense_only(self, what: str) -> None:
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"{what} of family {self.cfg.family!r} is not ported yet "
                "(ROADMAP.md queue 1, slice 4: mamba_lm.forward/prefill and "
                "the SSD backward)")

    def forward(self, params: Params, batch: dict, *, remat: str = "full"):
        """batch -> (logits, aux). Train/eval full-sequence pass."""
        self._dense_only("forward")
        return transformer.forward(params, batch["tokens"], self.cfg,
                                   remat=remat)

    def loss_fn(self, params: Params, batch: dict, *,
                remat: str = "full") -> torch.Tensor:
        """Next-token cross entropy (+0.01·aux, 0 for the dense family)."""
        logits, aux = self.forward(params, batch, remat=remat)
        tokens = batch["tokens"]
        loss = layers.cross_entropy(logits[:, :-1], tokens[:, 1:],
                                    batch.get("mask"))
        return loss + 0.01 * aux

    def prefill(self, params: Params, batch: dict, max_seq: int):
        """Whole-prompt prefill: (logits (B, S, V), the contiguous cache of
        :meth:`init_cache` holding the prompt)."""
        self._dense_only("prefill")
        return transformer.prefill(params, batch["tokens"], self.cfg,
                                   max_seq)

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_seq: int,
                   dtype=torch.bfloat16) -> Cache:
        """Slot-resident cache for ``batch`` rows: the dense family's
        (L, B, max_seq + 1, KV, hd) keys and values (the last position is
        the drop position), or the ssm family's recurrent state (conv
        states in ``dtype``, the SSM state in float32)."""
        if self.cfg.family == "ssm":
            return mamba_lm.init_cache(self.cfg, batch, self.device, dtype)
        return transformer.init_cache(self.cfg, batch, max_seq, self.device,
                                      dtype)

    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor,
                    lengths: torch.Tensor,
                    active: torch.Tensor | None = None):
        """One decode step for all B rows against the slot-resident cache;
        rows where ``active`` is False keep their cache. Returns (logits
        (B, V), cache)."""
        if self.cfg.family == "ssm":
            return mamba_lm.decode_step(params, cache, tokens, lengths,
                                        self.cfg, active)
        return transformer.decode_step(params, cache, tokens, lengths,
                                       self.cfg, active)

    def prefill_chunk(self, params: Params, cache: Cache,
                      tokens: torch.Tensor, start_len: torch.Tensor,
                      active: torch.Tensor | None = None,
                      valid: torch.Tensor | None = None):
        """Advance every row's prefill by C tokens in one dispatch against
        the slot-resident cache. ``valid``: per-row count of real tokens
        (multi-slot batched prefill). Returns (logits (B, C, V), cache)."""
        if self.cfg.family == "ssm":
            return mamba_lm.prefill_chunk(params, cache, tokens, start_len,
                                          self.cfg, active, valid)
        return transformer.prefill_chunk(params, cache, tokens, start_len,
                                         self.cfg, active, valid)

    # ------------------------------------------------------ paged serving
    #: cache leaves that live in the shared page pool (no batch axis);
    #: slot-slicing helpers pass them through untouched
    PAGE_KEYS = ("k_pages", "v_pages")
    #: contiguous KV leaves (L, B, max_seq + 1, KV, hd): the position past
    #: ``max_seq`` is the drop position, which slices leave out
    DROP_POSITION_KEYS = ("k", "v")

    def cache_pages(self) -> bool:
        """Does this family page its cache? The dense family's growing KV
        does; the ssm family's O(1) recurrent state is slot-resident by
        nature — there is nothing to page."""
        return self.cfg.family != "ssm"

    def prefix_shareable(self) -> bool:
        """Finished requests' prompt KV can be reused across requests: the
        dense transformer's entire prefill state lives in the page pool."""
        return (self.cache_pages() and self.cfg.family == "dense"
                and not self.cfg.is_moe)

    def copy_page(self, cache: Cache, src: int, dst: int) -> Cache:
        """Copy one pool row across every layer, in place — the CoW fork
        behind :meth:`BlockAllocator.fork_table`."""
        for key in self.PAGE_KEYS:
            leaf = cache[key]
            leaf[:, dst] = leaf[:, src]
        return cache

    def _no_pages(self) -> None:
        if not self.cache_pages():
            raise ValueError(f"family {self.cfg.family!r} has no KV to page; "
                             "check cache_pages() first")

    def init_paged_cache(self, num_pages: int, page_size: int, batch: int,
                         max_seq: int, dtype=torch.bfloat16) -> Cache:
        """Page-pool cache: ``num_pages`` pages of ``page_size`` tokens per
        layer, shared by all rows (block tables are engine-side). ``batch``
        and ``max_seq`` size slot-resident leaves, which the dense family
        does not have."""
        self._no_pages()
        return transformer.init_paged_cache(self.cfg, num_pages, page_size,
                                            self.device, dtype)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Device bytes ONE cached token costs across all paged layers —
        what sizes the page pool against a memory budget."""
        from repro_torch.roofline.hw import kv_bytes_per_token
        return kv_bytes_per_token(self.cfg, dtype_bytes)

    def decode_step_paged(self, params: Params, cache: Cache,
                          tokens: torch.Tensor, lengths: torch.Tensor,
                          block_tables: torch.Tensor,
                          active: torch.Tensor | None = None):
        """One decode step for all B rows against the page pool; the new
        K/V is written into ``cache`` in place. Returns (logits (B, V),
        cache)."""
        self._no_pages()
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
        self._no_pages()
        return transformer.prefill_chunk_paged(params, cache, tokens,
                                               start_len, block_tables,
                                               self.cfg, active, valid)

    def multi_slot_batchable(self) -> bool:
        """Can ``prefill_chunk(valid=...)`` batch several mid-prefill slots
        into one dispatch without changing any row's tokens? True for both
        ported families: a row's compute is independent of the other
        rows (MoE capacity, which couples them, is not ported)."""
        return not self.cfg.is_moe

    # ------------------------------------------------- cache slot slicing
    def slice_cache(self, cache: Cache, slot: int) -> Cache:
        """Per-slot view. Page-pool leaves have no batch axis and pass
        through whole; slot-resident leaves are (L, B, ...) and give their
        slot, without the contiguous KV's drop position — the JAX bundle's
        slice."""
        out = {}
        for k, v in cache.items():
            if k in self.PAGE_KEYS:
                out[k] = v
            elif k in self.DROP_POSITION_KEYS:
                out[k] = v[:, slot:slot + 1, :v.shape[2] - 1]
            else:
                out[k] = v[:, slot:slot + 1]
        return out

    def set_cache_slice(self, cache: Cache, slot: int, piece: Cache) -> Cache:
        """Write a per-slot piece back in place; page-pool leaves are left
        untouched (slot admission remaps block tables instead)."""
        for k, v in cache.items():
            if k in self.PAGE_KEYS:
                continue
            dst = v[:, slot:slot + 1]
            if k in self.DROP_POSITION_KEYS:
                dst = dst[:, :, :piece[k].shape[2]]
            dst.copy_(piece[k])
        return cache


def build_model(cfg: ModelConfig,
                device: "str | torch.device" = "cuda") -> ModelBundle:
    if cfg.family not in PORTED_FAMILIES or cfg.is_moe:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1, "
            "slice 3: the other families on the serving path)")
    return ModelBundle(cfg, resolve_device(device))
