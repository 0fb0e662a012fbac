"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's ``BatchedLanes`` / ``PassParams`` / slot arrays, handed
over as numpy arrays keyed by field name, become the port's tensors on a
given device (dtypes kept: bool, int32, float32), and a result dict comes
back as numpy.  The LLM layer's parameters (and their gradients), decode
caches and train states cross the same way, keyed by their JAX pytree
paths.  The parity tests use this so
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

    return _fill(LM(cfg, resolve_device(device)), flat,
                 lambda name: _jax_leaf(name, flat))


def jax_key(name: str):
    """``(JAX leaf path, layer index or None)`` of a parameter name of the
    port's LM: a segment's layer ``segments.<i>.<layer>.<rest>`` is row
    ``<layer>`` of the stack ``segments/<i>/<rest>``."""
    parts = name.split(".")
    if parts[0] in ("segments", "enc_segments"):
        return "/".join(parts[:2] + parts[3:]), int(parts[2])
    return "/".join(parts), None


def _jax_leaf(name: str, flat: Mapping[str, object]):
    key, layer = jax_key(name)
    arr = np.asarray(flat[key])
    return key, arr if layer is None else arr[layer]


def named_to_numpy(named: Mapping[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
    """Tensors keyed by the port's parameter names -> numpy arrays keyed by
    the JAX leaf paths, a segment's layers stacked on axis 0 in order: the
    inverse of the mapping :func:`lm_params_from_numpy` reads."""
    stacks: Dict[str, dict] = {}
    out = {}
    for name, t in named.items():
        key, layer = jax_key(name)
        arr = t.detach().cpu().numpy()
        if layer is None:
            out[key] = arr
        else:
            stacks.setdefault(key, {})[layer] = arr
    for key, rows in stacks.items():
        out[key] = np.stack([rows[i] for i in range(len(rows))])
    return out


def named_from_numpy(flat: Mapping[str, object], model: torch.nn.Module,
                     device=None) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`named_to_numpy` for ``model``'s parameter
    names: a tree of the JAX layout (an optimizer moment, a residual) as
    tensors keyed by parameter name, on ``device``."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(_jax_leaf(name, flat)[1],
                                            copy=True)).to(dev)
            for name, _ in model.named_parameters()}


def lm_params_to_numpy(model: torch.nn.Module, cfg, *, grad: bool = False
                       ) -> Dict[str, np.ndarray]:
    """The LM's parameters (or, with ``grad``, their ``.grad``) as numpy
    arrays keyed by the JAX ``init_params`` leaf paths: the inverse of
    :func:`lm_params_from_numpy`.  Raises for a model of another config's
    plan."""
    from repro_torch.models.transformer import decoder_plan
    if tuple(model.plan) != decoder_plan(cfg):
        raise ValueError(f"the model's plan {model.plan} is not {cfg.name}'s")
    return named_to_numpy({n: p.grad if grad else p
                           for n, p in model.named_parameters()})


def train_state_to_numpy(state) -> Dict[str, object]:
    """A train state (``repro_torch.train.train_step``) in the JAX train
    state's layout: ``{"params", "opt": {"mu", "nu", "step"[, "master"]}[,
    "ef"]}``, each tree keyed by JAX leaf paths, ``step`` an int32."""
    opt = state["opt"]
    out = {"params": named_to_numpy(dict(state["params"].named_parameters())),
           "opt": {k: named_to_numpy(opt[k]) for k in ("mu", "nu", "master")
                   if k in opt}}
    out["opt"]["step"] = np.int32(int(opt["step"]))
    if "ef" in state:
        out["ef"] = named_to_numpy(state["ef"])
    return out


def train_state_from_numpy(tree: Mapping[str, object], cfg, device=None):
    """The inverse of :func:`train_state_to_numpy`: a JAX train state's
    arrays (``tree["params"]`` and the ``opt`` / ``ef`` trees keyed by leaf
    path) as the port's train state on ``device``, its parameters needing
    gradients.  Refuses what ``train_step.check_trainable`` refuses."""
    from repro_torch.train.train_step import check_trainable
    dev = resolve_device(device)
    check_trainable(cfg, dev)
    model = lm_params_from_numpy(tree["params"], cfg, dev)
    model.requires_grad_(True)
    opt = {k: named_from_numpy(v, model, dev)
           for k, v in tree["opt"].items() if k != "step"}
    opt["step"] = torch.tensor(int(tree["opt"]["step"]), dtype=torch.int32)
    state = {"params": model, "opt": opt}
    if "ef" in tree:
        state["ef"] = named_from_numpy(tree["ef"], model, dev)
    return state


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
