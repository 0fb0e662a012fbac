"""Train-step factory: loss / gradients -> (compressed) gradients -> AdamW.
The port of the JAX package's ``train/train_step.py``.

* microbatch gradient accumulation (``accum_steps``): a Python loop over
  the microbatches, each ``backward()`` in turn, the gradients summed in
  f32 (the reference's ``lax.scan``);
* the activation-checkpoint policy (none / dots / full), threaded to the
  model (:func:`repro_torch.models.transformer.remat_call`);
* optional int8 error-feedback gradient compression
  (:mod:`repro_torch.elastic.compression`);
* bf16-param / f32-master mixed precision through the optimizer config.

The state is ``{"params": the LM (its parameters need gradients), "opt":
the AdamW state keyed by parameter name, "ef": the residuals (with
compress_grads)}``; a step updates it in place and returns it.  On a CUDA
device the gradients of RMSNorm, attention and the Mamba-2 SSD scan come
from their backward kernels; :func:`check_trainable` refuses, before any
step, a config whose Mamba-2 blocks are wider than the SSD backward kernel
takes (no registered one is).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.elastic.compression import (compress_decompress,
                                             init_residuals)
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import transformer as T

from .optimizer import AdamWConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: str = "dots"           # none | dots | full
    accum_steps: int = 1
    compress_grads: bool = False  # int8 error-feedback DP compression
    opt: AdamWConfig = AdamWConfig()


def check_trainable(cfg: ModelConfig, device) -> None:
    """Raise ``ValueError`` for a config with Mamba-2 blocks (the ``mamba``
    kind, zamba2's hybrid stack) of a head dim or a state wider than the
    SSD backward kernel takes, on a CUDA device."""
    if torch.device(device).type == "cuda" and any(
            seg.kind == "mamba" for seg in T.decoder_plan(cfg)):
        dims = T._ssm_dims(cfg)
        if (dims.headdim > SSD.MAX_HEADDIM
                or dims.dstate > SSD.BWD_MAX_DSTATE):
            raise ValueError(
                f"{cfg.name}: Mamba-2 head dim {dims.headdim} and state "
                f"{dims.dstate}; the SSD backward kernel takes up to "
                f"{SSD.MAX_HEADDIM} and {SSD.BWD_MAX_DSTATE}")


def loss_fn(model: T.LM, cfg: ModelConfig, batch, tc: TrainConfig):
    return T.forward_train(model, cfg, batch, dtype=tc.compute_dtype,
                           remat=tc.remat)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    b = next(iter(batch.values())).shape[0]
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def _backward(model: T.LM, cfg: ModelConfig, batch, tc: TrainConfig):
    """(loss, metrics) of one forward, its gradients left in ``.grad``."""
    model.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, cfg, batch, tc)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def _grads(model: T.LM) -> Dict[str, torch.Tensor]:
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def grads_of(model: T.LM, cfg: ModelConfig, batch, tc: TrainConfig):
    """``(loss, metrics, grads)``: mean gradients over ``tc.accum_steps``
    microbatches, keyed by parameter name."""
    if tc.accum_steps <= 1:
        loss, metrics = _backward(model, cfg, batch, tc)
        return loss, metrics, _grads(model)
    acc = {n: torch.zeros_like(p, dtype=torch.float32)
           for n, p in model.named_parameters()}
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=next(model.parameters()).device)
    for mb in _split_microbatches(batch, tc.accum_steps):
        loss, _ = _backward(model, cfg, mb, tc)
        g = _grads(model)
        torch._foreach_add_(list(acc.values()),
                            [g[n].float() for n in acc])
        loss_sum = loss_sum + loss
    inv = 1.0 / tc.accum_steps
    torch._foreach_mul_(list(acc.values()), inv)
    loss = loss_sum * inv
    return loss, {"ce_loss": loss, "aux_loss": torch.zeros_like(loss)}, acc


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, stats)``; ``batch``
    holds tensors on the model's device."""

    def train_step(state, batch):
        model = state["params"]
        check_trainable(cfg, next(model.parameters()).device)
        loss, metrics, grads = grads_of(model, cfg, batch, tc)
        if tc.compress_grads:
            grads, state["ef"] = compress_decompress(grads, state["ef"])
        params = dict(model.named_parameters())
        _, state["opt"], stats = adamw_update(params, grads, state["opt"],
                                              tc.opt)
        model.zero_grad(set_to_none=True)
        return state, {**stats, "loss": loss, **metrics}

    return train_step


def init_train_state(cfg: ModelConfig, tc: TrainConfig,
                     generator: torch.Generator, device=None):
    """A model from :func:`repro_torch.models.transformer.init_params` (in
    ``tc.param_dtype``, gradients on), its AdamW state and, with
    ``compress_grads``, zero residuals.  Refuses what
    :func:`check_trainable` refuses."""
    dev = resolve_device(device)
    check_trainable(cfg, dev)
    model = T.init_params(cfg, generator, dev, dtype=tc.param_dtype)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"params": model, "opt": init_opt_state(params, tc.opt)}
    if tc.compress_grads:
        state["ef"] = init_residuals(params)
    return state
