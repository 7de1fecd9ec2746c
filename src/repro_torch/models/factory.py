"""Uniform model API over every family: training, eval and serving.

Counterpart of :mod:`repro.models.factory`: one :class:`ModelBundle` for
each config in the registry — dense, moe and vlm
(:mod:`~repro_torch.models.transformer`, with
:mod:`~repro_torch.models.moe`), ssm (:mod:`~repro_torch.models.mamba_lm`),
hybrid (:mod:`~repro_torch.models.hybrid`) and encdec
(:mod:`~repro_torch.models.encdec`): ``init``, ``forward``, ``loss_fn``,
whole-prompt ``prefill``, and the serving steps on the paged pool or the
contiguous cache, with the JAX bundle's dispatch. On the card the SSD
kernel has no backward, as the JAX package's Pallas SSD has none, so the
ssm and hybrid families train on the CPU only (ROADMAP.md, "Beyond the
reference").

Every step writes its new cache into the caller's tensors in place and
returns the same dict; the write casts to the cache's own dtypes, the cast
the JAX bundle applies to the rebuilt cache after every step.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import hints
from repro_torch.models import (encdec, hybrid, layers, mamba_lm,
                                transformer)
from repro_torch.training.tree import tree_map

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
        f = self.cfg.family
        if f in ("dense", "moe", "vlm"):
            return transformer.init_params(gen, self.cfg, dtype)
        if f == "ssm":
            return mamba_lm.init_params(gen, self.cfg, dtype)
        if f == "hybrid":
            return hybrid.init_params(gen, self.cfg, dtype)
        if f == "encdec":
            return encdec.init_params(gen, self.cfg, dtype)
        raise ValueError(f"unknown family {f}")

    def abstract_params(self, dtype=torch.bfloat16) -> Params:
        """Meta tensors of every parameter's shape and dtype — JAX's
        ``eval_shape`` of ``init``: nothing is allocated (the initialiser
        runs under a ``FakeTensorMode``)."""
        cpu = ModelBundle(self.cfg, torch.device("cpu"))
        return _abstract(lambda: cpu.init(torch.Generator(), dtype))

    # ------------------------------------------------------------ forward
    def forward(self, params: Params, batch: dict, *, remat: str = "full"):
        """batch -> (logits, aux). Train/eval full-sequence pass: encdec
        takes ``frames`` beside ``tokens``; the transformer families take
        ``embeds`` in place of the token embedding."""
        f = self.cfg.family
        if f == "encdec":
            return encdec.forward(params, batch["frames"], batch["tokens"],
                                  self.cfg, remat=remat)
        if f == "ssm":
            return mamba_lm.forward(params, batch["tokens"], self.cfg,
                                    remat=remat)
        if f == "hybrid":
            return hybrid.forward(params, batch["tokens"], self.cfg,
                                  remat=remat)
        return transformer.forward(params, batch["tokens"], self.cfg,
                                   remat=remat, embeds=batch.get("embeds"))

    def loss_fn(self, params: Params, batch: dict, *,
                remat: str = "full") -> torch.Tensor:
        """Next-token cross entropy (+0.01·aux for MoE balance)."""
        logits, aux = self.forward(params, batch, remat=remat)
        tokens = batch["tokens"]
        loss = layers.cross_entropy(logits[:, :-1], tokens[:, 1:],
                                    batch.get("mask"))
        return loss + 0.01 * aux

    def prefill(self, params: Params, batch: dict, max_seq: int):
        """Whole-prompt prefill: (logits (B, S, V), the cache of
        :meth:`init_cache`'s layout holding the prompt — for ssm, the
        per-layer states)."""
        f = self.cfg.family
        if f == "encdec":
            return encdec.prefill(params, batch["frames"], batch["tokens"],
                                  self.cfg, max_seq)
        if f == "ssm":
            return mamba_lm.prefill(params, batch["tokens"], self.cfg,
                                    max_seq)
        if f == "hybrid":
            return hybrid.prefill(params, batch["tokens"], self.cfg, max_seq)
        return transformer.prefill(params, batch["tokens"], self.cfg,
                                   max_seq, embeds=batch.get("embeds"))

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_seq: int,
                   dtype=torch.bfloat16) -> Cache:
        """Slot-resident cache for ``batch`` rows: the attention layers'
        (L, B, max_seq + 1, KV, hd) keys and values (the last position is
        the drop position; int8 with their scales for the dense, moe and
        vlm families under the ``kv_cache_dtype="int8"`` hint), the ssm
        family's recurrent state (conv states in ``dtype``, the SSM state
        in float32), hybrid's both, enc-dec's decoder KV and static
        cross-KV."""
        f = self.cfg.family
        if f == "ssm":
            return mamba_lm.init_cache(self.cfg, batch, self.device, dtype)
        if f == "hybrid":
            return hybrid.init_cache(self.cfg, batch, max_seq, self.device,
                                     dtype)
        if f == "encdec":
            return encdec.init_cache(self.cfg, batch, max_seq, self.device,
                                     dtype)
        return transformer.init_cache(self.cfg, batch, max_seq, self.device,
                                      dtype)

    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor,
                    lengths: torch.Tensor,
                    active: torch.Tensor | None = None):
        """One decode step for all B rows against the slot-resident cache;
        rows where ``active`` is False keep their cache. Returns (logits
        (B, V), cache)."""
        f = self.cfg.family
        if f == "ssm":
            return mamba_lm.decode_step(params, cache, tokens, lengths,
                                        self.cfg, active)
        if f == "hybrid":
            return hybrid.decode_step(params, cache, tokens, lengths,
                                      self.cfg, active)
        if f == "encdec":
            return encdec.decode_step(params, cache, tokens, lengths,
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
        f = self.cfg.family
        if f == "ssm":
            return mamba_lm.prefill_chunk(params, cache, tokens, start_len,
                                          self.cfg, active, valid)
        if f == "hybrid":
            return hybrid.prefill_chunk(params, cache, tokens, start_len,
                                        self.cfg, active, valid)
        if f == "encdec":
            return encdec.prefill_chunk(params, cache, tokens, start_len,
                                        self.cfg, active, valid)
        return transformer.prefill_chunk(params, cache, tokens, start_len,
                                         self.cfg, active, valid)

    # ------------------------------------------------------ paged serving
    #: cache leaves that live in the shared page pool (no batch axis);
    #: slot-slicing helpers pass them through untouched
    PAGE_KEYS = ("k_pages", "v_pages")
    #: contiguous KV leaves (L, B, max_seq + 1, KV, hd) and the int8
    #: cache's scales (L, B, max_seq + 1, KV): the position past
    #: ``max_seq`` is the drop position, which slices leave out
    DROP_POSITION_KEYS = ("k", "v", "k_scale", "v_scale")

    def cache_pages(self) -> bool:
        """Does this family page its cache? True for every family with
        growing attention KV (dense/moe/vlm transformers, hybrid attention
        sublayers, enc-dec decoder self-KV); the ssm family's O(1)
        recurrent state is slot-resident by nature — there is nothing to
        page. Under the ``kv_cache_dtype="int8"`` hint no family pages:
        int8 KV lives on the contiguous cache, as in JAX."""
        if hints.get("kv_cache_dtype") == "int8":
            return False
        return self.cfg.family != "ssm"

    def prefix_shareable(self) -> bool:
        """Can finished requests' prompt KV be reused across requests?
        Only where the ENTIRE prefill state lives in the page pool: pure
        dense transformers (vlm text stacks included). Hybrid keeps
        slot-resident SSM state and enc-dec slot-resident cross-KV; MoE
        routing is batch-coupled (capacity drops), so a donor's KV is not
        what a fresh prefill would compute."""
        return (self.cache_pages()
                and self.cfg.family in ("dense", "vlm")
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
        layer, shared by all rows (block tables are engine-side); leaves
        that cannot page (hybrid SSM state, enc-dec cross-KV) stay
        slot-resident, sized by ``batch`` and ``max_seq``."""
        self._no_pages()
        f = self.cfg.family
        if f == "hybrid":
            return hybrid.init_paged_cache(self.cfg, num_pages, page_size,
                                           batch, self.device, dtype)
        if f == "encdec":
            return encdec.init_paged_cache(self.cfg, num_pages, page_size,
                                           batch, max_seq, self.device,
                                           dtype)
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
        f = self.cfg.family
        if f == "hybrid":
            return hybrid.decode_step_paged(params, cache, tokens, lengths,
                                            block_tables, self.cfg, active)
        if f == "encdec":
            return encdec.decode_step_paged(params, cache, tokens, lengths,
                                            block_tables, self.cfg, active)
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
        (logits (B, C, V), cache). Where :meth:`packs_prefill_rows`, only
        the rows ``active`` marks are computed: the inputs are left as
        they are, and the inactive rows' logits are unspecified."""
        self._no_pages()
        f = self.cfg.family
        if f == "hybrid":
            return hybrid.prefill_chunk_paged(params, cache, tokens,
                                              start_len, block_tables,
                                              self.cfg, active, valid)
        if f == "encdec":
            return encdec.prefill_chunk_paged(params, cache, tokens,
                                              start_len, block_tables,
                                              self.cfg, active, valid)
        if active is not None and self.packs_prefill_rows():
            return self._packed_prefill(params, cache, tokens, start_len,
                                        block_tables, active, valid)
        return transformer.prefill_chunk_paged(params, cache, tokens,
                                               start_len, block_tables,
                                               self.cfg, active, valid)

    def _packed_prefill(self, params, cache, tokens, start_len,
                        block_tables, active, valid):
        """:func:`transformer.prefill_chunk_paged` on the active rows
        alone, gathered into a batch of their own (the host reads
        ``active`` once, a small device-to-host copy); their logits are
        scattered back into a (B, C, V) tensor."""
        rows = active.nonzero().flatten()
        if rows.numel() in (0, tokens.shape[0]):
            return transformer.prefill_chunk_paged(
                params, cache, tokens, start_len, block_tables, self.cfg,
                active, valid)

        def pick(t):
            return None if t is None else t.index_select(0, rows)

        logits, cache = transformer.prefill_chunk_paged(
            params, cache, pick(tokens), pick(start_len), pick(block_tables),
            self.cfg, None, pick(valid))
        out = logits.new_empty((tokens.shape[0], *logits.shape[1:]))
        return out.index_copy_(0, rows, logits), cache

    def multi_slot_batchable(self) -> bool:
        """Can ``prefill_chunk(valid=...)`` batch several mid-prefill slots
        into one dispatch without changing any row's tokens? True for every
        family whose per-token compute is row-independent. False when MoE
        routing is present (dense MoE, or hybrid with ``moe_every > 0``):
        expert capacity is assigned by a cumulative sum over ALL tokens in
        the flattened batch, so co-batched rows change which of a row's
        tokens get dropped — the engine falls back to per-slot
        dispatches."""
        if self.cfg.is_moe:
            return False
        return not (self.cfg.family == "hybrid" and self.cfg.moe_every > 0)

    def packs_prefill_rows(self) -> bool:
        """Does :meth:`prefill_chunk_paged` compute only the rows
        ``active`` marks? True where rows are independent
        (:meth:`multi_slot_batchable`) and the whole prefill state lives
        in the page pool: the dense and vlm transformers. Hybrid's SSM
        state and enc-dec's cross-KV are slot-resident, indexed by batch
        row; MoE capacity couples the rows of a batch."""
        return (self.multi_slot_batchable()
                and self.cfg.family not in ("hybrid", "encdec", "ssm"))

    # ---------------------------------------------------------- dry-run IO
    def input_specs(self, shape: ShapeConfig) -> dict:
        """Meta stand-ins for every model input of a cell: the (B, S)
        int32 tokens (enc-dec: and ``frames_len(S)`` bf16 frames) of a
        train or prefill cell; a decode cell's one new token a row and its
        (B,) int32 lengths."""
        b, s = shape.global_batch, shape.seq_len
        meta = functools.partial(torch.empty, device="meta")
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": meta((b, s), dtype=torch.int32)}
            if self.cfg.family == "encdec":
                specs["frames"] = meta(
                    (b, encdec.frames_len(s), self.cfg.d_model),
                    dtype=torch.bfloat16)
            return specs
        return {"tokens": meta((b, 1), dtype=torch.int32),
                "lengths": meta((b,), dtype=torch.int32)}

    def abstract_cache(self, shape: ShapeConfig,
                       dtype=torch.bfloat16) -> Cache:
        """Meta tensors of :meth:`init_cache` for the cell's batch and
        sequence length (the int8 hint in force decides k/v's dtype and
        the scales), with JAX's shapes: the contiguous KV leaves hold
        ``seq_len`` positions, the last of which a step on this cache
        takes for its drop position (so it serves ``seq_len - 1``)."""
        cpu = ModelBundle(self.cfg, torch.device("cpu"))
        cache = _abstract(lambda: cpu.init_cache(shape.global_batch,
                                                 shape.seq_len, dtype))
        for k in self.DROP_POSITION_KEYS:
            if k in cache:
                t = cache[k]
                cache[k] = torch.empty((*t.shape[:2], t.shape[2] - 1,
                                        *t.shape[3:]), dtype=t.dtype,
                                       device="meta")
        return cache

    # ------------------------------------------------- cache slot slicing
    def _batch_axis(self, key: str) -> int:
        """The batch axis of a top-level slot-resident leaf: hybrid's SSM
        states are (nb, n_ssm, B, ...), every other leaf (L, B, ...)."""
        return 2 if self.cfg.family == "hybrid" and key == "ssm" else 1

    def slice_cache(self, cache: Cache, slot: int) -> Cache:
        """Per-slot view. Page-pool leaves have no batch axis and pass
        through whole; slot-resident leaves give their slot, the
        contiguous KV without its drop position — the JAX bundle's
        slice."""
        out = {}
        for k, v in cache.items():
            if k in self.PAGE_KEYS:
                out[k] = v
                continue
            ax = self._batch_axis(k)
            if isinstance(v, dict):
                out[k] = {n: t.narrow(ax, slot, 1) for n, t in v.items()}
            elif k in self.DROP_POSITION_KEYS:
                out[k] = v[:, slot:slot + 1, :v.shape[2] - 1]
            else:
                out[k] = v.narrow(ax, slot, 1)
        return out

    def set_cache_slice(self, cache: Cache, slot: int, piece: Cache) -> Cache:
        """Write a per-slot piece back in place; page-pool leaves are left
        untouched (slot admission remaps block tables instead)."""
        for k, v in cache.items():
            if k in self.PAGE_KEYS:
                continue
            ax = self._batch_axis(k)
            if isinstance(v, dict):
                for n, t in v.items():
                    t.narrow(ax, slot, 1).copy_(piece[k][n])
                continue
            dst = v.narrow(ax, slot, 1)
            if k in self.DROP_POSITION_KEYS:
                dst = dst[:, :, :piece[k].shape[2]]
            dst.copy_(piece[k])
        return cache


def _abstract(make) -> Any:
    """The tree ``make()`` returns, as meta tensors: ``make`` runs under a
    ``FakeTensorMode``, so no leaf is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = make()
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def build_model(cfg: ModelConfig,
                device: "str | torch.device" = "cuda") -> ModelBundle:
    return ModelBundle(cfg, resolve_device(device))
