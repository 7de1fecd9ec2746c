"""Dispatch from the model's layout to the kernels.

Counterpart of :mod:`repro.kernels.ops`. Dispatch is by the device of the
first operand alone — there is no backend switch:

  cuda — the hand-written Hopper kernels, which read the paged pool and
         the contiguous cache in place (``paged_decode_attention``,
         ``paged_prefill_attention``, ``decode_attention``,
         ``prefill_attention``), compute the SSD chunk
         (``ssd_chunk_scan``), full-sequence attention with its gradient
         (``flash_attention``, ``flash_attention_bwd``) and RMSNorm
         (``rmsnorm``) and the model step's projections of at most 16
         rows (``skinny_gemm``, through :func:`project`);
  cpu  — the plain path that mirrors the JAX package's jnp lowering: the
         functions of :mod:`repro_torch.models.attention` (after a gather
         through the block table, for the paged pool), the SSD oracle and
         the RMSNorm oracle.

Model-facing layouts are (B, S, H, d); the kernels are head-major — the
wrappers here transpose at the boundary (views, not copies).

On a device mesh the operands are DTensors. Attention is local to a row
and a head, the SSD chunk to a chunk and a head, RMSNorm to a row, so each
entry unwraps the shards (batch and heads sharded as the specs left them;
a query whose heads the KV heads cannot follow is gathered over them
first), runs itself on them — the kernel on CUDA shards, with no fallback
to the plain version — and wraps the result with the placements it came
with. A cache sharded along its sequence (flash-decode sequence
parallelism) cannot be read a shard at a time: on the CPU the plain path
then runs on the DTensors as they are; on CUDA it raises.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import mesh_ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention)
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill_attention import \
    paged_prefill_attention
from repro_torch.kernels.prefill_attention import prefill_attention
from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels import skinny_gemm
from repro_torch.kernels.ssd_scan import ssd_chunk_scan
from repro_torch.models import attention

#: from this sequence length on, the CPU path takes the block-causal
#: ``flash_attention_jnp`` instead of ``naive_attention``, as the JAX
#: package's jnp backend does (``repro.models.transformer.FLASH_MIN_SEQ``)
FLASH_MIN_SEQ = 2048


def _local_heads(fn, *operands, **kw):
    """``fn(*shards, **kw)`` on each rank's shards of DTensor operands
    laid out as the model's, given in ``fn``'s order as (tensor, kind):
    ``"q"`` (B, S, H, d) and ``"kv"`` (B, S, KV, d) sharded on batch (dim
    0) and heads (dim 2), ``"rows"`` (B, ...) on batch, ``"pool"`` (P,
    page, KV, d) on heads only. Returns the output as a DTensor in q's
    layout, or None where a cache is sharded along its sequence."""
    q = operands[0][0]
    mesh = q.device_mesh
    pools = [t for t, kind in operands if kind == "pool"]
    heads_of = [t for t, kind in operands if kind in ("kv", "pool")]
    pl = {"q": [], "kv": [], "rows": [], "pool": []}
    for i, p in enumerate(q.placements):
        if any(kind == "kv" and isinstance(t, DTensor)
               and isinstance(t.placements[i], Shard)
               and t.placements[i].dim == 1 for t, kind in operands):
            return None
        batch = isinstance(p, Shard) and p.dim == 0 and not pools
        heads = (isinstance(p, Shard) and p.dim == 2
                 and all(t.shape[2] % mesh.size(i) == 0 for t in heads_of))
        pl["q"].append(Shard(0) if batch else Shard(2) if heads
                       else Replicate())
        pl["kv"].append(pl["q"][-1])
        pl["rows"].append(Shard(0) if batch else Replicate())
        pl["pool"].append(Shard(2) if heads else Replicate())

    def local(t, kind):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, pl[kind]).to_local()

    out = fn(*(local(t, kind) for t, kind in operands), **kw)
    return DTensor.from_local(out, mesh, pl["q"], run_check=False,
                              shape=q.shape,
                              stride=mesh_ops.stride_like(out, q.shape))


def _no_local(name: str):
    raise NotImplementedError(
        f"ops.{name}: a CUDA cache sharded along its sequence has no "
        "kernel (the kernels read whole rows)")


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True) -> torch.Tensor:
    """Full-sequence attention. q: (B, S, H, d) (already rotated); k/v:
    (B, Skv, KV, d) -> (B, S, H, d) in q's dtype.

    On CUDA the flash kernel reads head-major views of the three tensors
    in place; where autograd records (grad enabled and an input needs a
    gradient) it goes through :class:`FlashAttention`, whose backward is
    the backward kernel. On the CPU: ``naive_attention`` below
    ``FLASH_MIN_SEQ`` positions and ``flash_attention_jnp`` at or above."""
    if isinstance(q, DTensor):
        o = _local_heads(attention_prefill, (q, "q"), (k, "kv"), (v, "kv"),
                         causal=causal)
        if o is not None:
            return o
        if q.device.type != "cpu":
            _no_local("attention_prefill")
    if q.device.type == "cpu":
        if q.shape[1] >= FLASH_MIN_SEQ:
            return attention.flash_attention_jnp(q, k, v, causal=causal)
        return attention.naive_attention(q, k, v, causal=causal)
    qt = q.transpose(1, 2)
    kt = k.contiguous().transpose(1, 2)
    vt = v.contiguous().transpose(1, 2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = FlashAttention.apply(qt, kt, vt, causal)
    else:
        o = flash_attention(qt, kt, vt, causal=causal)
    return o.transpose(1, 2)


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,) float32 -> x's shape and dtype. The kernel on
    CUDA over the flattened rows; ``ref.rmsnorm_ref`` on the CPU."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = [p if isinstance(p, Shard) and p.dim < x.ndim - 1
              else Replicate() for p in x.placements]
        rep = [Replicate()] * mesh.ndim
        w_l = (w.redistribute(mesh, rep).to_local()
               if isinstance(w, DTensor) else w)
        o = fused_rmsnorm(x.redistribute(mesh, pl).to_local(), w_l, eps)
        return DTensor.from_local(o, mesh, pl, run_check=False,
                                  shape=x.shape,
                                  stride=mesh_ops.stride_like(o, x.shape))
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    shape = x.shape
    o = rmsnorm(x.reshape(-1, shape[-1]).contiguous(), w.contiguous(),
                eps=eps)
    return o.reshape(shape)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, d); caches: (B, S, KV, d); lengths (B,) int32 ->
    (B, 1, H, d).

    Row b attends its first ``lengths[b]`` positions; RoPE of q at position
    ``lengths - 1`` is fused into the attention. The kernel reads the
    cache through a head-major view of it, in place."""
    if isinstance(q, DTensor):
        o = _local_heads(attention_decode, (q, "q"), (k_cache, "kv"),
                         (v_cache, "kv"), (lengths, "rows"),
                         rope_theta=rope_theta)
        if o is not None:
            return o
        if q.device.type != "cpu":
            _no_local("attention_decode")
    if q.device.type == "cpu":
        return attention.decode_attention(q, k_cache, v_cache, lengths,
                                          rope_theta=rope_theta)
    o = decode_attention(q[:, 0], k_cache.transpose(1, 2),
                         v_cache.transpose(1, 2), lengths,
                         rope_theta=rope_theta)
    return o[:, None]


def attention_prefill_chunk(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, start_len: torch.Tensor,
                            rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, C, H, d) UN-rotated; caches: (B, S, KV, d) with the chunk's
    keys/values already written at ``start_len .. start_len+C-1``;
    start_len: (B,) int32 -> (B, C, H, d).

    Chunk token j attends positions ``<= start_len + j`` and is rotated
    there (fused RoPE). The CPU path returns float32, like the JAX jnp
    lowering; the kernel returns q's dtype."""
    if isinstance(q, DTensor):
        o = _local_heads(attention_prefill_chunk, (q, "q"), (k_cache, "kv"),
                         (v_cache, "kv"), (start_len, "rows"),
                         rope_theta=rope_theta)
        if o is not None:
            return o
        if q.device.type != "cpu":
            _no_local("attention_prefill_chunk")
    if q.device.type == "cpu":
        positions = start_len[:, None] + torch.arange(q.shape[1],
                                                      device=q.device)
        return attention.prefill_chunk_attention(q, k_cache, v_cache,
                                                 positions,
                                                 rope_theta=rope_theta)
    o = prefill_attention(q.transpose(1, 2), k_cache.transpose(1, 2),
                          v_cache.transpose(1, 2), start_len,
                          rope_theta=rope_theta)
    return o.transpose(1, 2)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                    b_: torch.Tensor, c_: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (M, Q, H, P); dt/cum: (M, Q, H); b_/c_: (M, Q, N) -> (y (M, Q,
    H, P), state (M, H, P, N)). The kernel on CUDA; the oracle
    ``ref.ssd_chunk_ref`` on the CPU (the JAX jnp backend's choice).

    The kernel has no backward, so off the CPU a call that autograd would
    record raises rather than return outputs without gradients, as the JAX
    package cannot differentiate its Pallas SSD kernel either and trains
    the ssm and hybrid families on its jnp lowering (ROADMAP.md, "Beyond
    the reference": the SSD backward kernel)."""
    if (x.device.type != "cpu" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, dt, cum, b_, c_))):
        raise NotImplementedError(
            "ssd_chunk_scan has no backward kernel: the JAX package cannot "
            "differentiate its Pallas SSD either (ROADMAP.md, \"Beyond the "
            "reference\": the SSD backward kernel); train the ssm and hybrid "
            "families on the CPU")
    if isinstance(x, DTensor):
        # local to a chunk (M, dim 0) and a head (dim 2 of x, dt, cum)
        mesh = x.device_mesh
        pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
              for p in x.placements]
        bc_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in pl]
        loc = [t.redistribute(mesh, pl).to_local() for t in (x, dt, cum)]
        loc += [t.redistribute(mesh, bc_pl).to_local() for t in (b_, c_)]
        y, state = ssd_intra_chunk(*loc)
        st_pl = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
                 for p in pl]
        m, _, h, p_ = x.shape
        st_shape = (m, h, p_, b_.shape[-1])
        return (DTensor.from_local(
                    y, mesh, pl, run_check=False, shape=x.shape,
                    stride=mesh_ops.stride_like(y, x.shape)),
                DTensor.from_local(
                    state, mesh, st_pl, run_check=False, shape=st_shape,
                    stride=mesh_ops.stride_like(state, st_shape)))
    return ssd_chunk_scan(x, dt, cum, b_, c_)


def attention_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           rope_theta: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, d); pools: (P, page, KV, d); block_tables: (B, nb)
    int32; lengths (B,) int32 -> (B, 1, H, d).

    K/V are read through the per-row block table; RoPE of q at position
    ``lengths - 1`` is fused into the attention."""
    if isinstance(q, DTensor):
        return _local_heads(attention_decode_paged, (q, "q"),
                            (k_pages, "pool"), (v_pages, "pool"),
                            (block_tables, "rows"), (lengths, "rows"),
                            rope_theta=rope_theta)
    if q.device.type == "cpu":
        return attention.paged_decode_attention(q, k_pages, v_pages,
                                                block_tables, lengths,
                                                rope_theta=rope_theta)
    o = paged_decode_attention(q[:, 0], k_pages, v_pages, block_tables,
                               lengths, rope_theta=rope_theta)
    return o[:, None]


def attention_prefill_chunk_paged(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  start_len: torch.Tensor,
                                  rope_theta: float | None = None
                                  ) -> torch.Tensor:
    """q: (B, C, H, d) UN-rotated; pools: (P, page, KV, d) with the
    chunk's keys/values already written; block_tables: (B, nb) int32;
    start_len: (B,) int32 -> (B, C, H, d).

    Chunk token j attends positions ``<= start_len + j`` and is rotated
    there (fused RoPE). The CPU path returns float32, like the JAX jnp
    lowering; the kernel returns q's dtype."""
    if isinstance(q, DTensor):
        return _local_heads(attention_prefill_chunk_paged, (q, "q"),
                            (k_pages, "pool"), (v_pages, "pool"),
                            (block_tables, "rows"), (start_len, "rows"),
                            rope_theta=rope_theta)
    if q.device.type == "cpu":
        k = attention.gather_pages(k_pages, block_tables)
        v = attention.gather_pages(v_pages, block_tables)
        positions = start_len[:, None] + torch.arange(q.shape[1],
                                                      device=q.device)
        return attention.prefill_chunk_attention(q, k, v, positions,
                                                 rope_theta=rope_theta)
    o = paged_prefill_attention(q.transpose(1, 2), k_pages, v_pages,
                                block_tables, start_len,
                                rope_theta=rope_theta)
    return o.transpose(1, 2)


@functools.lru_cache(maxsize=16)
def _contracted(eq: str | None) -> int:
    """How many trailing dims of x ``eq`` contracts with the leading dims
    of the weight (``x @ w``: one)."""
    if eq is None:
        return 1
    (xs, ws), out = (t.split(",") for t in eq.replace(" ", "").split("->"))
    return sum(c in ws and c not in out for c in xs)


def project_plain(eq: str | None, x: torch.Tensor, *ws: torch.Tensor,
                  gated: bool = False):
    """:func:`project`'s products as the step always wrote them: the
    einsums and matmuls of ``mesh_ops``, on any device (the CPU and
    DTensor route)."""
    if gated:
        return F.silu(mesh_ops.matmul(x, ws[0])) * mesh_ops.matmul(x, ws[1])
    outs = tuple(mesh_ops.einsum(eq, x, w) if eq is not None
                 else mesh_ops.matmul(x, w) for w in ws)
    return outs[0] if len(outs) == 1 else outs


def project(eq: str | None, x: torch.Tensor, *ws: torch.Tensor,
            gated: bool = False):
    """The model step's projections: ``x`` against each weight of ``ws``
    (1-3, read against the same x) as ``eq`` writes the product
    (``torch.einsum``'s equation, x first; None: ``x @ w``), one output a
    weight (a tuple for several); ``gated``: two weights, gate and up, and
    the one output ``silu(x · gate) · (x · up)``. The weights keep their
    stored layout: the contracted dims lead (``wq (d, h, e)``, ``wo (h, e,
    d)``, ``w_gate (d, F)``), the rest are the output's.

    The route, decided from what the operands show, in this order:

      plain  — a tensor off CUDA (the CPU) or a DTensor:
               :func:`project_plain`, the einsums and matmuls the step
               always ran, bit for bit;
      kernel — a CUDA float32 product of at most 16 rows of x (the decode
               step's batch) whose layout the kernel takes
               (``skinny_gemm.takes``), where autograd records nothing
               (the kernel has no backward): ``skinny_gemm``, each weight
               read once where it lies, qkv or gate and up in one launch;
      matmul — any other CUDA product, training's included:
               ``torch.matmul`` on the flattened views (a view of a
               stacked leaf, never a copy of it).

    ``project.routes`` counts the calls by route."""
    if (isinstance(x, DTensor) or not x.is_cuda
            or any(isinstance(w, DTensor) for w in ws)):
        project.routes["plain"] += 1
        return project_plain(eq, x, *ws, gated=gated)
    nk = _contracted(eq)
    lead = x.shape[:x.dim() - nk]
    k = x.numel() // max(1, lead.numel())
    x2 = x.reshape(-1, k)
    w2 = [w.reshape(k, -1) for w in ws]
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in ws))
    if not grad and skinny_gemm.takes(x2, w2, gated):
        project.routes["kernel"] += 1
        outs = skinny_gemm.launch(x2, w2, gated)
    else:
        project.routes["matmul"] += 1
        outs = ((F.silu(x2 @ w2[0]) * (x2 @ w2[1]),) if gated
                else tuple(x2 @ w for w in w2))
    if gated:
        return (outs if isinstance(outs, torch.Tensor) else outs[0]).reshape(
            *lead, ws[0].shape[nk:].numel())
    outs = tuple(o.reshape(*lead, *w.shape[nk:]) for o, w in zip(outs, ws))
    return outs[0] if len(outs) == 1 else outs


#: calls of :func:`project` by route since the counts were last set to 0
project.routes = {"plain": 0, "kernel": 0, "matmul": 0}
