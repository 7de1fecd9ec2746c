"""GPipe-style pipeline parallelism over the ``stage`` axis of a device mesh.

Counterpart of :mod:`repro.distributed.pipeline`. Layers are split into S
contiguous stages; a microbatched forward pushes activations from stage to
stage. The bubble fraction is (S-1)/(S-1+M) for M microbatches — reported
by ``bubble_fraction``.

JAX runs the schedule under ``shard_map`` with a ``ppermute``; here every
rank of the mesh runs it on its own stage's layers, and the activations
move by ``all_to_all_single`` over the stage axis's process group, with
the whole tensor sent to the next stage and nothing to the others. One
collective call on every rank cannot deadlock on the ring, as blocking
send/recv pairs that all send first would, and it serves S = 1 (the
activation goes to the rank itself) on gloo and on NCCL alike.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.training.tree import tree_leaves, tree_map


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    s, m = num_stages, num_microbatches
    return (s - 1) / (s - 1 + m)


def _to_next_stage(h: torch.Tensor, stage: int, num_stages: int,
                   group) -> torch.Tensor:
    """``h`` of stage ``stage`` sent to stage ``(stage + 1) % S``; returns
    what stage ``(stage - 1) % S`` sent (JAX's ``ppermute`` on the ring)."""
    flat = h.contiguous().reshape(-1)
    n = flat.numel()
    send = [n if j == (stage + 1) % num_stages else 0
            for j in range(num_stages)]
    recv = [n if j == (stage - 1) % num_stages else 0
            for j in range(num_stages)]
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out.reshape(h.shape)


@torch.no_grad()
def pipelined_forward(layer_fn: Callable, params_stacked, x: torch.Tensor,
                      mesh: DeviceMesh, *, num_microbatches: int,
                      stage_axis: str = "stage") -> torch.Tensor:
    """Run ``layer_fn`` stacks split over the ``stage`` mesh axis.

    layer_fn(layer_params, h) -> h, applied L/S times per stage.
    params_stacked: nested dict of tensors with leading layer axis L
    (L % S == 0), the same on every rank.
    x: (B, ...) global batch, the same on every rank; B % num_microbatches
    == 0.

    Returns y with the same shape as x, equal on every rank of the stage
    axis. GPipe schedule: each stage processes microbatch m at step t =
    stage + m; all M + S - 1 steps run every layer of every stage, bubble
    steps on zeros as in JAX, so each rank calls ``layer_fn`` L/S · (M + S
    - 1) times. A forward only: the collectives carry no gradient, so it
    runs without autograd."""
    if stage_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no {stage_axis!r} axis: "
                         f"{mesh.mesh_dim_names}")
    num_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    stage = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    l = tree_leaves(params_stacked)[0].shape[0]
    b = x.shape[0]
    if l % num_stages or b % num_microbatches:
        raise ValueError(f"{l} layers over {num_stages} stages, batch {b} "
                         f"in {num_microbatches} microbatches: each must "
                         "divide")
    mb = b // num_microbatches
    per = l // num_stages

    # this stage's slice of the layer axis, by its stage coordinate
    stage_layers = [tree_map(lambda p, i=i: p[stage * per + i],
                             params_stacked) for i in range(per)]
    micro = x.reshape((num_microbatches, mb) + x.shape[1:])

    def stage_apply(h):
        for lp in stage_layers:
            h = layer_fn(lp, h)
        return h

    num_steps = num_microbatches + num_stages - 1
    buf = torch.zeros_like(micro[0])
    outs = torch.zeros_like(micro)
    last = num_stages - 1
    for t in range(num_steps):
        # stage 0 ingests microbatch t (if in range)
        incoming = micro[t] if t < num_microbatches else torch.zeros_like(buf)
        h_out = stage_apply(incoming if stage == 0 else buf)
        # push to next stage
        buf = _to_next_stage(h_out, stage, num_stages, group)
        # last stage emits microbatch t - (S-1)
        emit_idx = t - last
        if emit_idx >= 0 and stage == last:
            outs[emit_idx] = h_out
    # only the last stage holds real outputs; broadcast via a masked sum
    # (the other stages add exact zeros, so every rank gets the same bits)
    outs = outs * float(stage == last)
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs.reshape(x.shape)
