"""Device meshes: the production ``(16, 16)`` and ``(2, 16, 16)`` meshes,
any smaller one, and the one-device mesh.

Counterpart of :mod:`repro.launch.mesh`, with the same shapes and axis
names, built as :class:`torch.distributed.device_mesh.DeviceMesh`. A mesh
covers ranks ``0 .. prod(shape) - 1`` of the default process group in
row-major order (``jax.make_mesh``'s order on host devices), so a group
larger than the mesh also serves it (the elastic re-mesh of a shrunken
data axis). Building a mesh never initialises a process group: the caller
does (NCCL on the card; gloo, or the ``fake`` backend of the dry run, on
the CPU), and a mesh asked for without one raises.

The device type follows the default group's backend: ``cuda`` for NCCL,
``cpu`` for gloo and for the fake group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` (e.g. ``(4, 4)`` on 16
    ranks) over the first ``prod(shape)`` ranks of the default group."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no default process group; initialise one first "
            "(torch.distributed.init_process_group)")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(_device_type(),
                      torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh() -> DeviceMesh:
    """Every rank of the default group on ``data`` (``(n, 1)``), or
    ``(1, 1)`` on one rank."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n, 1), ("data", "model"))


def mesh_name(mesh: DeviceMesh) -> str:
    return "x".join(str(s) for s in mesh.shape) + \
        "(" + ",".join(mesh.mesh_dim_names) + ")"
