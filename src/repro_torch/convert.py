"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's ``BatchedLanes`` / ``PassParams`` / slot arrays, handed
over as numpy arrays keyed by field name, become the port's tensors on a
given device (dtypes kept: bool, int32, float32), and a result dict comes
back as numpy.  The parity tests use this so both packages compute on
identical inputs; nothing here imports JAX.
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
