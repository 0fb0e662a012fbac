"""Resharding a train state onto a new mesh (the malleable-ML bridge): the
port of the JAX package's ``elastic/resharding.py``.

When the cluster scheduler expands or shrinks a training job, its
data-parallel width changes: the job rebuilds its mesh and every tensor
must land in its placement under the new one.  Every rank of the
``torch.distributed`` world runs the same code; a mesh is always the
world's first ranks, so the old group's first rank is rank 0, and
``reshard_tree`` first broadcasts each tensor from rank 0 to every rank of
the new mesh (after a resize from width 1 to 2, only rank 0 holds the
state), then places it by its spec: a replicated tensor stays a plain
tensor (the kernels take plain tensors; a spec naming only axes of size
1 is replicated), a sharded one becomes a
``DTensor`` holding the spec's slice (on a mesh whose ``model`` axis is
above 1 the layers then run tensor-parallel on those slices,
:mod:`repro_torch.models.tp`).  Ranks outside the new mesh keep what
they hold.  ``resize_plan`` computes the cost model that the
scheduler's speedup model reads: bytes moved and the estimated
reconfiguration time.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.launch.mesh import world_device_type, world_size
from repro_torch.models import tp
from repro_torch.models.sharding import (is_replicated, placements,
                                         port_leaves, tensor_specs)

Params = Any


# the job meshes built under the open world, by shape: a resize back to a
# width reuses its mesh and process groups instead of opening new ones
_MESHES: dict = {}


def make_job_mesh(n_hosts: int, model_parallel: int = 1,
                  device_type: str = None):
    """``DeviceMesh`` for one elastic job: ``(data = n_hosts, model =
    model_parallel)`` over the world's first ``n_hosts * model_parallel``
    ranks, on ``device_type``: the job's tensors' (a sharded tensor lives
    on its mesh's device type), by default the world's.  Every rank of the
    world must call it (the first call at a shape opens the mesh's process
    groups; later ones under the same world return the same mesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    need = n_hosts * model_parallel
    have = world_size()
    if need > have:
        raise ValueError(f"job needs {need} devices, have {have}")
    world = dist.group.WORLD if dist.is_initialized() else None
    if _MESHES.get("world") is not world:
        _MESHES.clear()
        _MESHES["world"] = world
    key = (n_hosts, model_parallel, device_type or world_device_type())
    if key not in _MESHES:
        _MESHES[key] = DeviceMesh(
            key[2], torch.arange(need).reshape(n_hosts, model_parallel),
            mesh_dim_names=("data", "model"))
    return _MESHES[key]


def in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _from_rank0(t: torch.Tensor, mesh) -> None:
    """Broadcast ``t`` in place from rank 0 (the mesh's first) to every
    rank of ``mesh``: down the first mesh column, then along each row (a
    tensor off the mesh's device type crosses through a copy on it)."""
    import torch.distributed as dist
    buf = t if t.device.type == mesh.device_type else t.to(mesh.device_type)
    coord = mesh.get_coordinate()
    rows, cols = mesh.mesh.shape
    if rows > 1 and coord[1] == 0:
        dist.broadcast(buf, src=0, group=mesh.get_group("data"))
    if cols > 1:
        dist.broadcast(buf, src=int(mesh.mesh[coord[0], 0]),
                       group=mesh.get_group("model"))
    if buf is not t:
        t.copy_(buf)


def _local_slice(full: torch.Tensor, place, mesh) -> torch.Tensor:
    from torch.distributed.tensor import Shard
    out = full
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            out = torch.chunk(out, mesh.mesh.shape[i], dim=p.dim)[coord[i]]
    return out.contiguous()


def _set_leaf(tree, keys, value) -> None:
    """Put ``value`` at ``keys`` of ``tree`` (a module's parameter as a new
    ``nn.Parameter``, the module's model group read anew)."""
    node = tree
    for k in keys[:-1]:
        node = node[k]
    if isinstance(node, nn.Module):
        tp.placements_changed(node)
        owner, _, name = keys[-1].rpartition(".")
        mod = node.get_submodule(owner)
        old = getattr(mod, name)
        setattr(mod, name, nn.Parameter(value,
                                        requires_grad=old.requires_grad))
    else:
        node[keys[-1]] = value


def gather_tree(tree: Params) -> Params:
    """Replace each ``DTensor`` of ``tree`` on a mesh that holds this rank by
    its whole tensor, in place (a collective: every rank of the world calls
    it); returns ``tree``."""
    from torch.distributed.tensor import DTensor
    for keys, leaf in list(port_leaves(tree)):
        if isinstance(leaf, DTensor) and in_mesh(leaf.device_mesh):
            _set_leaf(tree, keys, leaf.full_tensor())
    return tree


def reshard_tree(tree: Params, new_mesh, *, fsdp: bool = False) -> Params:
    """Move every tensor of ``tree`` (a train state: the LM's parameters
    and the optimizer's trees) to its placement under ``new_mesh``, in
    place; returns ``tree``."""
    from torch.distributed.tensor import DTensor
    specs = tensor_specs(tree, new_mesh, fsdp=fsdp)
    gather_tree(tree)
    if not in_mesh(new_mesh):
        return tree
    size = new_mesh.mesh.numel()
    for keys, leaf in list(port_leaves(tree)):
        if size > 1:
            with torch.no_grad():
                _from_rank0(leaf.data if isinstance(leaf, nn.Parameter)
                            else leaf, new_mesh)
        spec = specs["/".join(keys)]
        if not is_replicated(spec, new_mesh):
            place = placements(spec, new_mesh)
            full = leaf.detach()
            _set_leaf(tree, keys, DTensor.from_local(
                _local_slice(full, place, new_mesh), new_mesh, place,
                run_check=False, shape=full.shape, stride=full.stride()))
    return tree


def tree_bytes(tree) -> int:
    """Bytes of every tensor of ``tree`` (a DTensor's global shape)."""
    return sum(leaf.numel() * leaf.element_size()
               for _keys, leaf in port_leaves(tree))


@dataclasses.dataclass(frozen=True)
class ResizePlan:
    old_dp: int
    new_dp: int
    param_bytes: int
    bytes_moved: int          # upper bound: full regather on width change
    est_seconds: float        # at the link bandwidth assumed below

    # NVLink on one H100 SXM5: 900 GB/s over its 18 NVLink-4 links, both
    # directions together (NVIDIA H100 Tensor Core GPU datasheet); a
    # broadcast's bytes leave a card in one direction: 450 GB/s
    LINK_GBPS: float = 450.0


def resize_plan(tree: Params, old_dp: int, new_dp: int) -> ResizePlan:
    """Cost model for a dp-width change (checkpoint-free resharding): the
    full-regather bound, every byte of the state (the parameters, the
    optimizer's moments and its step, as the reference counts them) over
    one card's NVLink."""
    nbytes = tree_bytes(tree)
    est = nbytes / (ResizePlan.LINK_GBPS * 1e9)
    return ResizePlan(old_dp=old_dp, new_dp=new_dp, param_bytes=int(nbytes),
                      bytes_moved=int(nbytes), est_seconds=float(est))
