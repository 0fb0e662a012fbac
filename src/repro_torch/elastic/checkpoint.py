"""Sharded npz checkpointing with a JSON manifest (fault tolerance): the
port of the JAX package's ``elastic/checkpoint.py``, on the same files.

Layout:  <dir>/step_<N:08d>/manifest.json + shard_<k:04d>.npz
The manifest records each leaf's name (its tree path joined by ``/``:
``params/segments/0/mixer/in_z``, ``opt/mu/...``, ``opt/step``), shape,
dtype and shard; a shard holds leaves until it passes 512 MiB, and an
npz key is the name with ``/`` as ``__``.  Leaves are taken in the order
``jax.tree_util`` flattens the same tree (a mapping's keys sorted, a
list's items in order), so either package writes the files the other
reads; the port's train state enters and leaves as the JAX train state's
layout through ``repro_torch.convert.train_state_to_numpy`` /
``train_state_into``.  Writes are atomic (tmp dir + rename) and old
checkpoints are garbage-collected with ``keep``.

A bfloat16 leaf is refused, naming it: numpy has no bfloat16 without
``ml_dtypes``, which the port does not need.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

Params = Any
_SHARD_BYTES = 512 * 1024 * 1024


def _sort_key(name: str):
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in name.split("/"))


def _walk(tree, prefix: Tuple[str, ...]):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _flatten_with_names(tree) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` of every leaf, in the reference's order; a flat
    mapping keyed by ``/``-joined paths names its leaves as the nested
    tree would."""
    return sorted(_walk(tree, ()), key=lambda item: _sort_key(item[0]))


def _host_array(name: str, leaf) -> np.ndarray:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        raise ValueError(f"checkpoint leaf {name} is bfloat16, which numpy "
                         "cannot hold without ml_dtypes")
    return arr


def save_checkpoint(directory: str, step: int, tree: Params,
                    keep: int = 3) -> str:
    """Write tree to <directory>/step_<step>; returns the path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        named = _flatten_with_names(tree)
        manifest: Dict[str, Any] = {"step": step, "leaves": [], "shards": []}
        shard: Dict[str, np.ndarray] = {}
        shard_bytes = 0
        shard_id = 0

        def flush():
            nonlocal shard, shard_bytes, shard_id
            if shard:
                fname = f"shard_{shard_id:04d}.npz"
                np.savez(os.path.join(tmp, fname), **shard)
                manifest["shards"].append(fname)
                shard_id += 1
                shard = {}
                shard_bytes = 0

        for name, leaf in named:
            arr = _host_array(name, leaf)
            manifest["leaves"].append({
                "name": name, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "shard": shard_id})
            shard[name.replace("/", "__")] = arr
            shard_bytes += arr.nbytes
            if shard_bytes >= _SHARD_BYTES:
                flush()
        flush()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    return steps[-1] if steps else None


def _unflatten(tree_like, leaves: Dict[str, np.ndarray], prefix=()):
    if isinstance(tree_like, Mapping):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, leaves, prefix + (str(i),))
                               for i, v in enumerate(tree_like))
    return leaves["/".join(prefix)]


def restore_checkpoint(directory: str, tree_like: Params,
                       step: Optional[int] = None) -> Tuple[Params, int]:
    """Restore into the structure of ``tree_like`` (shapes must match);
    the leaves come back as numpy arrays."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays: Dict[str, np.ndarray] = {}
    for fname in manifest["shards"]:
        with np.load(os.path.join(path, fname)) as z:
            for k in z.files:
                arrays[k.replace("__", "/")] = z[k]
    leaves = {}
    for name, like in _flatten_with_names(tree_like):
        if name not in arrays:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = arrays[name]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"shape mismatch for {name}: {arr.shape} vs "
                f"{tuple(like.shape)}")
        leaves[name] = arr
    return _unflatten(tree_like, leaves), step
