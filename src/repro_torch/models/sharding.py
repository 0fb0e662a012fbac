"""Partition rules: parameter names -> partition specs, and their placement
on a torch ``DeviceMesh``.  The port of the JAX package's
``models/sharding.py``.

A spec is a tuple with one entry a dimension: a mesh-axis name, a tuple of
names (the dimension split over those axes, the first outermost), or
``None`` (replicated): the reference's ``PartitionSpec``.  Rules are keyed
on the JAX leaf *name* (the last key of its path).  Conventions:

  * ``model`` axis: attention heads / FFN hidden / experts / vocab (TP).
  * ``data`` (+ ``pod``): batch; with ``fsdp=True`` a remaining parameter
    dim is also sharded (ZeRO-3-style).
  * Dims are indexed from the end, so the layer axis of a stacked leaf is
    transparent to the model rules.
  * Anything not divisible by the mesh axis stays replicated: the rules
    read the mesh's axis sizes, so the same rules serve the 16 x 16 and
    2 x 16 x 16 meshes.

The reference stacks a segment's layers on a leading axis; the port keeps
one tensor a layer (``segments.<i>.<layer>.<rest>`` is row ``<layer>`` of
the JAX leaf ``segments/<i>/<rest>``, :func:`repro_torch.convert.jax_key`).
So :func:`param_specs` reads the *stacked* leaves (the layer count from the
tree) and gives the reference's specs for them, and :func:`tensor_specs`
gives each port tensor its row's spec: the stacked spec without its layer
axis.  Two stacked specs shard the layer axis itself: with ``fsdp`` a
stacked 1-D leaf (a norm's ``(L, d)`` ``scale``: a few KB a layer) may
have it sharded over ``data``, and a MoE block's shared-expert stack
``(L, d, ff)``, which the expert rule reads as ``(E, d_in, d_out)``, over
``model`` where L divides.  A layer's tensor has no such axis: its row is
replicated.  Under a ``(data, 1)`` mesh without ``fsdp`` every spec is
replicated.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
from torch import nn

from repro_torch.convert import jax_key
from repro_torch.launch.mesh import mesh_view

Spec = Tuple[Any, ...]

# leaf name -> (dims to try sharding over "model", in preference order);
# dims are indexed from the END (negative), so stacked leading axes are
# transparent.
_MODEL_RULES: Dict[str, Tuple[int, ...]] = {
    # embeddings
    "table": (-2,),          # (V, d): shard vocab
    "unembed": (-1,),        # (d, V): shard vocab
    # attention
    "wq": (-1,), "wk": (-1,), "wv": (-1,), "wo": (-2,),
    "bq": (-1,), "bk": (-1,), "bv": (-1,),
    # MLA
    "wq_a": (-1,), "wq_b": (-1,), "wkv_a": (-1,),
    "wk_b": (-1,), "wv_b": (-1,),
    # MLP
    "w1": (-1,), "w3": (-1,), "w2": (-2,),
    # MoE (experts dim is dim -3 for w1/w3/w2 — handled specially below)
    "router": (),
    # Mamba
    "in_z": (-1,), "in_x": (-1,), "in_dt": (-1,),
    "in_b": (), "in_c": (),
    "conv_x": (-1,), "conv_bias_x": (-1,),
    "conv_bc": (), "conv_bias_bc": (),
    "a_log": (-1,), "dt_bias": (-1,), "d_skip": (-1,),
    "out_proj": (-2,),
    # norms
    "scale": (), "bias": (),
}

_MOE_EXPERT_LEAVES = {"w1", "w2", "w3"}  # when ndim>=3 with experts leading


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _parts(path) -> Tuple[str, ...]:
    """A leaf path, ``"a/b/c"`` or a sequence of keys, as its keys."""
    return tuple(path.split("/")) if isinstance(path, str) else tuple(
        str(p) for p in path)


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _dp_entry(dp_axes):
    return dp_axes if len(dp_axes) > 1 else dp_axes[0]


def spec_for_param(path, leaf, mesh, *, fsdp: bool = False,
                   dp_axes: Tuple[str, ...] = ("data",)) -> Spec:
    """The spec of the JAX leaf at ``path`` (``"segments/1/moe/w1"``) of
    shape ``leaf`` (a shape, or anything with ``.shape``: the *stacked*
    leaf for a segment's layers)."""
    mesh = mesh_view(mesh)
    parts = _parts(path)
    name = parts[-1] if parts else ""
    shape = _shape_of(leaf)
    ndim = len(shape)
    spec = [None] * ndim
    model = _axis_size(mesh, "model")
    dp = 1
    for a in dp_axes:
        dp *= _axis_size(mesh, a)

    if "moe" in parts and name in _MOE_EXPERT_LEAVES and ndim >= 3:
        # (..., E, d_in, d_out): shard experts over model
        e_dim = ndim - 3
        if shape[e_dim] % model == 0:
            spec[e_dim] = "model"
        if fsdp:
            # ZeRO-3 second dim: always the FF dim (w1/w3: -1, w2: -2)
            ff_dim = ndim - 1 if name in ("w1", "w3") else ndim - 2
            if spec[ff_dim] is None and shape[ff_dim] % dp == 0:
                spec[ff_dim] = _dp_entry(dp_axes)
        return tuple(spec)
    for d in _MODEL_RULES.get(name, ()):
        dim = ndim + d
        if 0 <= dim < ndim and shape[dim] % model == 0:
            spec[dim] = "model"
            break

    if fsdp and ndim >= 2:
        # ZeRO-3-style: shard one remaining dim over the dp axes (the last
        # two dims, the stacked layer axis of a 1-D leaf among them)
        for dim in range(ndim - 2, ndim):
            if spec[dim] is None and shape[dim] % dp == 0:
                spec[dim] = _dp_entry(dp_axes)
                break
    return tuple(spec)


# ------------------------------------------------------------- the trees
def port_leaves(tree, prefix: Tuple[str, ...] = ()):
    """``(keys, leaf)`` of every leaf of ``tree``: nested mappings (their
    keys), an ``nn.Module`` (its parameters by name, one key each), and
    leaves that are tensors, arrays or anything with ``.shape``."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + (name,), p
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from port_leaves(v, prefix + (str(k),))
    elif hasattr(tree, "shape"):
        yield prefix, tree
    else:
        raise TypeError(f"{'/'.join(prefix)}: not a tree or a leaf: "
                        f"{type(tree).__name__}")


def _jax_path(keys: Tuple[str, ...]):
    """(the JAX leaf path, the layer row or None) of a port leaf's keys: the
    last key, a port parameter name or a JAX path, through ``jax_key``."""
    if not keys:
        return "", None
    key, layer = jax_key(keys[-1])
    return "/".join(keys[:-1] + (key,)), layer


def stacked_shapes(tree) -> Dict[str, Tuple[int, ...]]:
    """``{JAX leaf path: shape}`` of ``tree``'s leaves with a segment's
    layers stacked on a leading axis (its length the layer count in the
    tree), as the reference's pytree holds them."""
    rows: Dict[str, Dict[int, Tuple[int, ...]]] = {}
    out: Dict[str, Tuple[int, ...]] = {}
    for keys, leaf in port_leaves(tree):
        path, layer = _jax_path(keys)
        if layer is None:
            out[path] = _shape_of(leaf)
        else:
            rows.setdefault(path, {})[layer] = _shape_of(leaf)
    for path, by_layer in rows.items():
        shapes = set(by_layer.values())
        if len(shapes) != 1 or sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{path}: layers {sorted(by_layer)} of shapes "
                             f"{sorted(shapes)} do not stack")
        out[path] = (len(by_layer),) + shapes.pop()
    return out


def param_specs(params, mesh, *, fsdp: bool = False,
                dp_axes: Tuple[str, ...] = ("data",)) -> Dict[str, Spec]:
    """``{JAX leaf path: spec}`` over ``params``' stacked leaves (an LM, a
    train state, or a mapping of JAX paths or port names to arrays)."""
    return {path: spec_for_param(path, shape, mesh, fsdp=fsdp,
                                 dp_axes=dp_axes)
            for path, shape in stacked_shapes(params).items()}


def tensor_specs(tree, mesh, *, fsdp: bool = False,
                 dp_axes: Tuple[str, ...] = ("data",)) -> Dict[str, Spec]:
    """``{port path: spec}``: each of ``tree``'s own tensors (keys joined by
    ``/``) with its row's spec, the stacked leaf's spec without its layer
    axis (a row of a stack sharded on that axis is replicated)."""
    specs = param_specs(tree, mesh, fsdp=fsdp, dp_axes=dp_axes)
    out = {}
    for keys, _leaf in port_leaves(tree):
        path, layer = _jax_path(keys)
        spec = specs[path]
        out["/".join(keys)] = spec if layer is None else spec[1:]
    return out


def placements(spec: Spec, mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``, one
    a mesh dimension: ``Shard(d)`` on an axis that names dimension d,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_view(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[names.index(axis)] = Shard(d)
    return tuple(out)


def param_shardings(params, mesh, **kw) -> Dict[str, tuple]:
    """``{port path: placements}`` of each tensor of ``params`` on the
    ``DeviceMesh`` ``mesh``."""
    return {path: placements(spec, mesh)
            for path, spec in tensor_specs(params, mesh, **kw).items()}


def batch_spec(mesh) -> Spec:
    """Sharding for (B, ...) batch arrays: batch over all dp axes."""
    names = mesh_view(mesh).axis_names
    axes = tuple(a for a in ("pod", "data") if a in names)
    return (_dp_entry(axes),)


def cache_specs(cache, mesh):
    """Decode-cache shardings: batch over dp axes, heads/features over
    model; the same structure as ``cache`` (``{"segments": [...]}``, a
    Mamba-2 segment's ``MambaCache``) with a spec for each leaf.

    Cache layouts (see models/decode.py):
      (L, B, S, Hkv, Dh) — batch dim 1; shard Hkv (or Dh) over model.
      (B, S, Hkv, Dh)    — shared blocks; batch dim 0.
      MLA (L, B, S, lora) — batch dim 1, latent replicated over model.
      Mamba conv/state   — batch dim 1, heads/d_inner over model.
    A leaf's name is its nearest mapping key, as the reference reads it
    (a ``MambaCache`` field's is its segment list's, ``segments``).
    """
    view = mesh_view(mesh)
    dp = tuple(a for a in ("pod", "data") if a in view.axis_names)
    dp_entry = _dp_entry(dp)
    model = _axis_size(view, "model")
    batch_total = 1
    for a in dp:
        batch_total *= _axis_size(view, a)

    def leaf_spec(name, x):
        shape = _shape_of(x)
        ndim = len(shape)
        bdim = 1 if ndim >= 4 or name in ("state", "conv_x", "conv_bc") else 0
        if ndim == 4 and name in ("k", "v", "ck", "cv"):
            bdim = 0  # shared-block cache (B, S, H, Dh)
        spec = [None] * ndim
        if shape[bdim] % batch_total == 0 and shape[bdim] > 1:
            spec[bdim] = dp_entry
        if name in ("ckv", "krope"):
            # MLA latent cache: shard the latent dim over model
            if shape[-1] % model == 0 and shape[-1] >= model:
                spec[-1] = "model"
            return tuple(spec)
        for dim in range(ndim - 2, ndim):
            if dim > bdim and spec[dim] is None and shape[dim] % model == 0:
                spec[dim] = "model"
                break
        return tuple(spec)

    def walk(node, name):
        if hasattr(node, "shape"):
            return leaf_spec(name, node)
        if isinstance(node, Mapping):
            return {k: walk(v, str(k)) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(walk(v, name) for v in node))
        return type(node)(walk(v, name) for v in node)

    return walk(cache, "")


def is_replicated(spec: Spec, mesh) -> bool:
    """Whether ``spec`` keeps the whole tensor on every rank of ``mesh``:
    it names no axis, or only axes of size 1."""
    view = mesh_view(mesh)
    return all(_axis_size(view, axis) == 1 for entry in spec
               for axis in (entry if isinstance(entry, tuple) else (entry,))
               if axis is not None)

