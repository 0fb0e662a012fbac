"""Production mesh + per-arch parallelism policy: the port of the JAX
package's ``launch/mesh.py``.

``make_production_mesh`` is a function (never a module-level constant), so
importing this module touches no process group.  One pod is a 16 x 16
``(data, model)`` mesh of 256 ranks; two pods add a leading ``pod`` axis
that data parallelism spans (DP = pod x data).  A mesh here is a torch
``DeviceMesh`` over ranks of the ``torch.distributed`` world; the rules
(:func:`dp_axes`, :func:`dp_size` and :mod:`repro_torch.models.sharding`)
read any object with ``axis_names`` and a ``shape`` mapping each name to
its size, as the reference's ``jax.sharding.Mesh`` has, and
:func:`mesh_view` gives a ``DeviceMesh`` that face.

``make_lane_mesh`` is the 1-D counterpart the sweep engine's split uses
(:mod:`repro_torch.sweep.shard`): lanes never talk to each other, so the
port's split is one process with a thread a card, and its lane mesh is a
``MeshView`` with one ``lanes`` axis over those devices and no process
group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshView:
    """The face of a mesh the sharding rules read: axis names in order and
    each axis' size by name (and, for a lane mesh, its devices in
    order)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: Tuple[torch.device, ...] = ()


def make_lane_mesh(devices: Optional[Sequence] = None) -> MeshView:
    """1-D mesh over ``devices`` (default: every visible card) with axis
    ``lanes``: the reference's ``jax.sharding.Mesh(devices, ("lanes",))``.
    A lane batch's leading axis splits over it in equal contiguous pieces
    (:func:`repro_torch.sweep.shard.shard_lanes`)."""
    if devices is None:
        from repro_torch import resolve_device
        resolve_device(None)   # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("lane mesh needs at least one device")
    return MeshView(("lanes",), {"lanes": len(devs)}, devs)


def mesh_view(mesh):
    """``mesh`` itself when it has ``axis_names`` (a ``MeshView``, a test's
    fake mesh), else a ``MeshView`` of a ``DeviceMesh``: its
    ``mesh_dim_names`` as ``axis_names``."""
    if hasattr(mesh, "axis_names"):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    return MeshView(names, dict(zip(names, mesh.mesh.shape)))


def world_size() -> int:
    """The ``torch.distributed`` world's size (1 when no group is open)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def world_device_type() -> str:
    """The device type the open world's collectives take: ``cuda`` on an
    NCCL world, else ``cpu`` (gloo, or no world).  Every mesh and every
    broadcast of the port takes its device type from here, whatever the
    machine holds: a CPU job on a card's host runs on gloo and on ``cpu``."""
    import torch.distributed as dist
    return ("cuda" if dist.is_initialized() and dist.get_backend() == "nccl"
            else "cpu")


def make_production_mesh(*, multi_pod: bool = False):
    """A ``DeviceMesh`` over the world's first 256 ranks, ``(data, model)``
    16 x 16, or with ``multi_pod`` its first 512, ``(pod, data, model)``
    2 x 16 x 16.  Raises ``RuntimeError`` on a smaller world."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, the torch.distributed world "
            f"has {have}; open a process group of {n} ranks (one a card) "
            "before building the production mesh")
    return DeviceMesh(world_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_view(mesh).axis_names)


def dp_size(mesh) -> int:
    view = mesh_view(mesh)
    out = 1
    for a in dp_axes(view):
        out *= view.shape[a]
    return out


@dataclasses.dataclass(frozen=True)
class ParallelPolicy:
    """Per-arch distribution knobs."""

    fsdp: bool = False        # ZeRO-3 weight sharding over dp axes
    zero1: bool = True        # optimizer moments sharded over dp (ZeRO-1)
    remat: str = "dots"       # none | dots | full
    accum_steps: int = 1      # gradient accumulation microbatches
    param_dtype: str = "float32"  # bf16 + f32 master for the big archs


# Archs whose f32 params + moments exceed a 256-rank pod without weight
# sharding; they default to FSDP + bf16 params.
_BIG = {"qwen2-72b", "deepseek-v2-236b"}
# Small archs have memory headroom at train_4k: skip activation
# checkpointing.
_SMALL = {"olmoe-1b-7b", "stablelm-1.6b", "mamba2-1.3b", "internvl2-2b",
          "zamba2-2.7b"}


def default_policy(arch: str) -> ParallelPolicy:
    if arch in _BIG:
        return ParallelPolicy(fsdp=True, param_dtype="bfloat16")
    if arch in _SMALL:
        return ParallelPolicy(remat="none")
    return ParallelPolicy()
