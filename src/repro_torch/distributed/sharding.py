"""Partition-spec rules for every architecture family, and their DTensor
placements.

Counterpart of :mod:`repro.distributed.sharding`, rule for rule:
  - mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi.
  - TP on "model": attention heads where divisible, else hidden dim; MLP d_ff;
    expert axis for MoE; padded vocab for embedding/lm-head.
  - DP on ("pod","data"): batch dims of activations.
  - ZeRO-1: optimizer state / master params get the largest remaining dim
    sharded over the dp axes.
  - FSDP (kimi-k2 class): parameters themselves additionally sharded over dp.

All per-layer parameters carry a leading stacked-layer axis which is never
sharded. Rules are name+shape driven so the same engine covers every family.

A spec is a :class:`P`, JAX's ``PartitionSpec`` for the port: one entry per
leading tensor dim, each ``None``, a mesh axis name or a tuple of them; the
spec functions return nested dicts of them shaped like their input trees.
:func:`placements` turns a spec into DTensor placements on a
:class:`~torch.distributed.device_mesh.DeviceMesh`: mesh dim ``i`` gets
``Shard(d)`` where tensor dim ``d``'s entry names it, else ``Replicate()``.
A tuple entry such as ``("pod", "data")`` shards one dim over two mesh
dims; DTensor splits it over the earlier mesh dim first, which is
``NamedSharding``'s major-to-minor order only when the tuple lists its axes
in mesh order — every rule here does, and :func:`placements` refuses any
other order. :func:`place` puts a tree's leaves on the mesh and
:func:`constrain` is ``with_sharding_constraint``: a redistribution of a
DTensor, nothing for a plain tensor. The ops a step runs on the shards
live in :mod:`repro_torch.distributed.mesh_ops`.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro_torch.configs.base import ModelConfig, ShapeConfig

# archs whose parameters must be fully sharded (params don't fit TP-only)
FSDP_ARCHS = {"kimi-k2-1t-a32b"}
# archs that train with Adafactor instead of AdamW (optimizer-state budget)
ADAFACTOR_ARCHS = {"kimi-k2-1t-a32b"}


class P(tuple):
    """``PartitionSpec(*entries)``: a tuple of per-dim entries; dims past
    its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def mesh_axes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    ax = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in ax)


def dp_size(mesh) -> int:
    ax = mesh_axes(mesh)
    return math.prod(ax[a] for a in dp_axes(mesh))


def dp_entry(mesh):
    """The batch dim's entry: the dp axes (a tuple of two on a multi-pod
    mesh), or None without one."""
    dp = dp_axes(mesh)
    return (dp if len(dp) > 1 else dp[0]) if dp else None


def _maybe(dim: int, axis: str | tuple, axes: dict[str, int]):
    """Return axis if dim is divisible by its mesh extent, else None."""
    if isinstance(axis, tuple):
        size = math.prod(axes[a] for a in axis)
    else:
        size = axes.get(axis, 1)
    return axis if size > 1 and dim % size == 0 else None


def _spec_for_leaf(path: str, shape: tuple[int, ...], cfg: ModelConfig,
                   axes: dict[str, int], fsdp: bool, dp: tuple[str, ...]):
    """Primary TP spec for one parameter leaf (layer-stack dims excluded)."""
    name = path.split("/")[-1]
    nd = len(shape)
    mp = "model"
    spec = P

    if name == "embedding":
        return spec(_maybe(shape[0], mp, axes), None)
    if name == "lm_head":
        return spec(None, _maybe(shape[1], mp, axes))
    if name == "frontend":
        return spec(None, _maybe(shape[1], mp, axes))
    if name in ("wq", "wk", "wv"):           # (D, H|KV, hd)
        h_ax = _maybe(shape[1], mp, axes)
        if h_ax is not None:
            return spec(None, h_ax, None)
        return spec(_maybe(shape[0], mp, axes), None, None)
    if name == "wo":                          # (H, hd, D)
        h_ax = _maybe(shape[0], mp, axes)
        if h_ax is not None:
            return spec(h_ax, None, None)
        return spec(None, None, _maybe(shape[2], mp, axes))
    if name in ("w_gate", "w_up"):
        if nd == 3 and shape[0] == cfg.num_experts:   # (E, D, F)
            return spec(_maybe(shape[0], mp, axes), None, None)
        return spec(None, _maybe(shape[-1], mp, axes))  # (D, F)
    if name == "w_down":
        if nd == 3 and shape[0] == cfg.num_experts:   # (E, F, D)
            return spec(_maybe(shape[0], mp, axes), None, None)
        return spec(_maybe(shape[0], mp, axes), None)   # (F, D)
    if name == "router":                      # (D, E)
        return spec(None, _maybe(shape[1], mp, axes))
    if name in ("w_z", "w_x", "w_dt"):        # (D, d_in|H)
        return spec(None, _maybe(shape[1], mp, axes))
    if name in ("w_B", "w_C"):                # (D, N) — replicated (ngroups=1)
        return spec(None, None)
    if name == "conv_x":                      # (W, d_in)
        return spec(None, _maybe(shape[1], mp, axes))
    if name in ("conv_B", "conv_C"):
        return spec(None, None)
    if name == "w_out":                       # (d_in, D)
        return spec(_maybe(shape[0], mp, axes), None)
    if name in ("A_log", "dt_bias", "D_skip"):
        return spec(_maybe(shape[0], mp, axes))
    if name == "gate_norm":
        return spec(_maybe(shape[0], mp, axes))
    # norms / scalars: replicate
    return P(*([None] * nd))


def _add_dp_shard(spec: P, shape: tuple[int, ...], dp: tuple[str, ...],
                  axes: dict[str, int]):
    """Shard the largest still-unsharded dim over the dp axes (ZeRO/FSDP)."""
    if not dp:
        return spec
    dpsize = math.prod(axes[a] for a in dp)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = None, 0
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and d % dpsize == 0 and d > best_dim:
            best, best_dim = i, d
    if best is None:
        # try just "data"
        dsize = axes.get("data", 1)
        for i, (e, d) in enumerate(zip(entries, shape)):
            if e is None and d % dsize == 0 and d > best_dim:
                best, best_dim = i, d
        if best is None:
            return P(*entries)
        entries[best] = "data"
        return P(*entries)
    entries[best] = dp if len(dp) > 1 else dp[0]
    return P(*entries)


def _walk(tree, prefix=""):
    """(path, leaf) pairs with dict-key paths."""
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(_walk(v, f"{prefix}/{k}" if prefix else k))
    else:
        out.append((prefix, tree))
    return out


def _map_with_path(fn, tree, prefix=""):
    """``fn(path, leaf)`` over a nested dict, keeping its shape."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


_STACK_KEYS = ("layers", "blocks", "encoder", "decoder")


def _stack_depth(path: str, cfg: ModelConfig) -> int:
    """Leading stacked dims to skip: 1 inside layer stacks, +1 for hybrid
    intra-block ssm-state stacks (handled in cache specs, not params)."""
    head = path.split("/")[0]
    return 1 if head in _STACK_KEYS else 0


def param_pspecs(cfg: ModelConfig, mesh, abstract_params,
                 *, fsdp: bool | None = None):
    """Spec tree matching the parameter tree."""
    axes = mesh_axes(mesh)
    dp = dp_axes(mesh)
    if fsdp is None:
        fsdp = cfg.name in FSDP_ARCHS

    def one(path, leaf):
        skip = _stack_depth(path, cfg)
        shape = tuple(leaf.shape)[skip:]
        spec = _spec_for_leaf(path, shape, cfg, axes, fsdp, dp)
        if fsdp:
            spec = _add_dp_shard(spec, shape, dp, axes)
        return P(*([None] * skip + list(spec)))

    return _map_with_path(one, abstract_params)


def optstate_extra_pspecs(cfg: ModelConfig, mesh, abstract_params):
    """ZeRO-1 specs: param spec + largest free dim over dp (for m/v/master)."""
    axes = mesh_axes(mesh)
    dp = dp_axes(mesh)
    base = param_pspecs(cfg, mesh, abstract_params)

    def one(spec, leaf):
        return _add_dp_shard(spec, tuple(leaf.shape), dp, axes)

    return _map(one, base, abstract_params)


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    dp = dp_axes(mesh)
    axes = mesh_axes(mesh)
    dpn = math.prod(axes[a] for a in dp) if dp else 1
    bspec = (dp if len(dp) > 1 else dp[0]) if dp and shape.global_batch % dpn == 0 else None
    specs = {"tokens": P(bspec, None)}
    if cfg.family == "encdec" and shape.kind in ("train", "prefill"):
        specs["frames"] = P(bspec, None, None)
    if shape.is_decode:
        specs = {"tokens": P(bspec, None), "lengths": P(bspec)}
    return specs


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 abstract_cache):
    """KV/SSM cache specs. Batch on dp; long-context (B==1): sequence over
    (data, model) — flash-decode sequence parallelism."""
    axes = mesh_axes(mesh)
    dp = dp_axes(mesh)
    dpn = math.prod(axes[a] for a in dp) if dp else 1
    b = shape.global_batch
    batch_ok = dp and b % dpn == 0
    bspec = (dp if len(dp) > 1 else dp[0]) if batch_ok else None
    long_ctx = not batch_ok  # B=1 long_500k: shard sequence instead

    def one(path, leaf):
        name = path.split("/")[-1]
        nd = len(leaf.shape)
        if name in ("k", "v", "cross_k", "cross_v"):
            # (L, B, S, KV, hd)
            if long_ctx:
                seq_ax = ("data", "model")
                if leaf.shape[2] % (axes.get("data", 1) * axes.get("model", 1)):
                    seq_ax = "model" if leaf.shape[2] % axes.get("model", 1) == 0 else None
                return P(None, None, seq_ax, None, None)
            kv_ax = _maybe(leaf.shape[3], "model", axes)
            if kv_ax is None:
                # KV heads don't divide the model axis: flash-decode style
                # sequence sharding over "model" instead.
                seq_ax = _maybe(leaf.shape[2], "model", axes)
                return P(None, bspec, seq_ax, None, None)
            return P(None, bspec, None, kv_ax, None)
        if name in ("k_scale", "v_scale"):
            # (L, B, S, KV) — mirror the k/v rules without the head dim
            if long_ctx:
                seq_ax = ("data", "model")
                if leaf.shape[2] % (axes.get("data", 1) * axes.get("model", 1)):
                    seq_ax = "model" if leaf.shape[2] % axes.get("model", 1) == 0 else None
                return P(None, None, seq_ax, None)
            kv_ax = _maybe(leaf.shape[3], "model", axes)
            if kv_ax is None:
                seq_ax = _maybe(leaf.shape[2], "model", axes)
                return P(None, bspec, seq_ax, None)
            return P(None, bspec, None, kv_ax)
        if name == "ssm":
            # (L[, sub], B, H, P, N)
            lead = nd - 4
            h_ax = _maybe(leaf.shape[lead + 1], "model", axes)
            return P(*([None] * lead), bspec, h_ax, None, None)
        if name in ("conv_x",):
            lead = nd - 3
            c_ax = _maybe(leaf.shape[lead + 2], "model", axes)
            return P(*([None] * lead), bspec, None, c_ax)
        if name in ("conv_B", "conv_C"):
            lead = nd - 3
            return P(*([None] * lead), bspec, None, None)
        return P(*([None] * nd))

    return _map_with_path(one, abstract_cache)


def logits_pspec(cfg: ModelConfig, mesh, decode: bool,
                 global_batch: int | None = None):
    axes = mesh_axes(mesh)
    dp = dp_axes(mesh)
    v_ax = _maybe(cfg.padded_vocab, "model", axes)
    dpn = math.prod(axes[a] for a in dp) if dp else 1
    batch_ok = dp and (global_batch is None or global_batch % dpn == 0)
    bspec = (dp if len(dp) > 1 else dp[0]) if batch_ok else None
    if decode:
        return P(bspec, v_ax)
    return P(bspec, None, v_ax)


# ------------------------------------------------------- DTensor placements

def placements(spec: P, mesh) -> list[Placement]:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dim. An axis
    of extent 1 holds the whole dim either way and is left replicated
    (DTensor refuses to flatten a dim sharded one way)."""
    names = list(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        entry = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in entry]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of {entry} are not in "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    return out


def local_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """This rank's shard shape of a ``shape`` tensor under ``spec``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():      # it computes with real tensors
        return tuple(_compute_local_shape_and_global_offset(
            tuple(shape), mesh.shape, mesh.get_coordinate(),
            placements(spec, mesh))[0])


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def place_leaf(t: torch.Tensor, spec: P, mesh) -> DTensor:
    """One tensor as a DTensor under ``spec``. A tensor with values is cut
    into this rank's shard (every rank holds the same full tensor, so no
    data moves); a fake or meta tensor becomes an empty shard of the shape
    the rank would hold: a CPU tensor of the ``FakeTensorMode`` in force
    (the dry run's), else a meta tensor."""
    pl = placements(spec, mesh)
    if t.device.type == "meta" or _fake_mode() is not None:
        fake = _fake_mode() is not None
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device="cpu" if fake else "meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=tuple(t.shape),
                                  stride=_contiguous_stride(t.shape))
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def _fake_mode():
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


def place(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` placed under the spec at its path."""
    return _map(lambda t, s: place_leaf(t, s, mesh), tree, specs)


def constrain(x: torch.Tensor, spec: P) -> torch.Tensor:
    """``with_sharding_constraint``: a DTensor redistributed to ``spec`` on
    its own mesh (axes the mesh lacks are left out of ``spec`` by the
    caller); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = placements(spec, x.device_mesh)
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)
