"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's ``BatchedLanes`` / ``PassParams`` / slot arrays, handed
over as numpy arrays keyed by field name, become the port's tensors on a
given device (dtypes kept: bool, int32, float32), and a result dict comes
back as numpy.  The LLM layer's parameters and decode caches cross the
same way, keyed by their JAX pytree paths.  The parity tests use this so
both packages compute on identical inputs; nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.passes import PassParams
from repro_torch.sweep.batch import BatchedLanes


def to_tensors(arrays: Mapping[str, object], device=None
               ) -> Dict[str, torch.Tensor]:
    """numpy arrays (or array-likes) keyed by name -> tensors on ``device``.

    ``None`` values stay ``None``.
    """
    dev = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        out[name] = None if a is None else torch.from_numpy(
            np.array(a, copy=True, order="C")).to(dev)
    return out


def batch_from_numpy(arrays: Mapping[str, object], device=None
                     ) -> BatchedLanes:
    """A :class:`BatchedLanes` from the JAX batch's fields by name."""
    t = to_tensors({f: arrays[f] for f in BatchedLanes._fields}, device)
    return BatchedLanes(**t)


def params_from_numpy(arrays: Mapping[str, object], device=None
                      ) -> PassParams:
    """A :class:`PassParams` from the JAX pass parameters by name."""
    t = to_tensors({f: arrays.get(f) for f in PassParams._fields}, device)
    return PassParams(**t)


def result_to_numpy(result) -> Dict[str, object]:
    """A result dict or tuple of tensors -> numpy (other values kept)."""
    def conv(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) else v
    if isinstance(result, Mapping):
        return {k: conv(v) for k, v in result.items()}
    return type(result)(conv(v) for v in result)


# ---------------------------------------------------------------- LLM layer
def _fill(module: torch.nn.Module, flat: Mapping[str, object], leaf):
    """Copy into each parameter of ``module`` the array ``leaf(name)``
    picks from ``flat`` (``(key, array)``); every parameter must be filled
    and every key of ``flat`` used."""
    used = set()
    with torch.no_grad():
        for name, prm in module.named_parameters():
            key, arr = leaf(name)
            if arr.shape != tuple(prm.shape):
                raise ValueError(f"{key}: {arr.shape} for a parameter of "
                                 f"{tuple(prm.shape)}")
            prm.copy_(torch.from_numpy(np.array(arr, copy=True)))
            used.add(key)
    if used != set(flat):
        raise ValueError(f"leaves not used: {sorted(set(flat) - used)}")
    return module


def module_from_numpy(module: torch.nn.Module, flat: Mapping[str, object]):
    """Fill ``module`` (a layer's parameter holder: ``MoE``, ``MLA``,
    ``GQA``, ...) from the JAX parameter dict of the same layer, keyed by
    leaf paths joined by ``/`` (``"shared/w1"``, ``"q_norm/scale"``)."""
    def leaf(name):
        key = name.replace(".", "/")
        return key, np.asarray(flat[key])
    return _fill(module, flat, leaf)


def lm_params_from_numpy(flat: Mapping[str, object], cfg, device=None):
    """The port's :class:`~repro_torch.models.transformer.LM` holding the
    JAX ``init_params`` pytree's values.

    ``flat`` maps each JAX leaf's path, joined by ``/``
    (``"segments/3/mixer/in_z"``, ``"segments/1/moe/shared/w1"``,
    ``"segments/0/cross/wq"``, ``"enc_segments/0/attn/wq"``,
    ``"shared_block/attn/wq"``, ``"enc_norm/scale"``, ``"embed/table"``), to
    its numpy array; a segment's stacked leaves (layers on axis 0, then a
    MoE leaf's experts) are split into the port's per-layer modules.  Every
    parameter must be filled and every leaf used.
    """
    from repro_torch.models.transformer import LM

    def leaf(name):
        parts = name.split(".")
        if parts[0] in ("segments", "enc_segments"):
            key = "/".join(parts[:2] + parts[3:])
            return key, np.asarray(flat[key])[int(parts[2])]
        key = "/".join(parts)
        return key, np.asarray(flat[key])

    return _fill(LM(cfg, resolve_device(device)), flat, leaf)


def cache_to_numpy(cache) -> Dict[str, np.ndarray]:
    """A decode cache as numpy arrays keyed ``segments/<i>/<leaf>`` (the
    JAX cache's leaf paths)."""
    out = {}
    for i, seg in enumerate(cache["segments"]):
        items = seg._asdict().items() if hasattr(seg, "_asdict") else \
            seg.items()
        for name, t in items:
            out[f"segments/{i}/{name}"] = t.detach().cpu().numpy()
    return out


def cache_from_numpy(flat: Mapping[str, object], cfg, device=None):
    """The inverse of :func:`cache_to_numpy` for ``cfg``'s decoder plan."""
    from repro_torch.models.ssm import MambaCache
    from repro_torch.models.transformer import decoder_plan, uses_mla
    dev = resolve_device(device)

    def t(key):
        return torch.from_numpy(np.array(flat[key], copy=True)).to(dev)

    segs = []
    for i, seg in enumerate(decoder_plan(cfg)):
        if seg.kind == "mamba":
            segs.append(MambaCache(*(t(f"segments/{i}/{f}")
                                     for f in MambaCache._fields)))
        else:
            names = (("ckv", "krope") if uses_mla(cfg, seg.kind)
                     else ("k", "v", "ck", "cv") if seg.kind == "dec"
                     else ("k", "v"))
            segs.append({n: t(f"segments/{i}/{n}") for n in names})
    return {"segments": segs}
