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

With a data-parallel ``group`` (the elastic trainer's step at a width
above 1, :mod:`repro_torch.elastic.manager`) each rank takes its block of
the global batch, and the step computes the global batch's function: MoE
layers route as the global batch (:func:`repro_torch.models.moe.
data_parallel`), and the gradients, the loss and its parts are averaged
over the group before clipping, compression and AdamW, so every rank
applies the same update.

A model placed on a ``(data, model)`` mesh with ``model`` > 1 trains
tensor-parallel (:mod:`repro_torch.models.tp`): the forward and backward
run on the local shards, the gradients stay local (a replicated
parameter's is whole on every rank of the model group), ``group`` is the
mesh's ``data`` group alone, the clip norm sums the split gradients'
squares over the model group and counts each replicated one once, and
AdamW updates each rank's shards.

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
from repro_torch.models import moe as M
from repro_torch.models import tp as TP
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
    """Each parameter's gradient (zeros where it has none), local shards
    under tensor parallelism."""
    return {n: TP.local(p.grad) if p.grad is not None
            else torch.zeros_like(TP.local(p.detach()))
            for n, p in model.named_parameters()}


def grads_of(model: T.LM, cfg: ModelConfig, batch, tc: TrainConfig):
    """``(loss, metrics, grads)``: mean gradients over ``tc.accum_steps``
    microbatches, keyed by parameter name."""
    if tc.accum_steps <= 1:
        loss, metrics = _backward(model, cfg, batch, tc)
        return loss, metrics, _grads(model)
    acc = {n: torch.zeros_like(TP.local(p.detach()), dtype=torch.float32)
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


def all_reduce_mean(tensors, group) -> None:
    """Average ``tensors`` over ``group``'s ranks in place: one flat buffer
    (summed over the ranks, then divided by their count) a dtype."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    n = dist.get_world_size(group)
    by_dtype: Dict[Any, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = _flatten_dense_tensors(same)
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for t, r in zip(same, _unflatten_dense_tensors(flat, same)):
            t.copy_(r)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, group=None):
    """Returns ``train_step(state, batch) -> (state, stats)``; ``batch``
    holds tensors on the model's device (with ``group``, this rank's block
    of the global batch, of the same size on every rank)."""
    if group is not None:
        import torch.distributed as dist
        if dist.get_world_size(group) == 1:
            group = None

    def train_step(state, batch):
        model = state["params"]
        check_trainable(cfg, next(model.parameters()).device)
        with M.data_parallel(group):
            loss, metrics, grads = grads_of(model, cfg, batch, tc)
        if group is not None:
            all_reduce_mean(list(grads.values()), group)
            parts = torch.stack([loss, metrics["ce_loss"],
                                 metrics["aux_loss"]]).float()
            all_reduce_mean([parts], group)
            loss, metrics = parts[0], {"ce_loss": parts[1],
                                       "aux_loss": parts[2]}
        # under tensor parallelism: the split parameters and the model
        # group their gradients' squares and scales are taken over (read
        # once a placement)
        tp_grp = TP.model_group_of(model)
        split = TP.split_names(model)
        over = tp_grp.group if tp_grp else None
        if tc.compress_grads:
            ef = state["ef"]
            grads, new_ef = compress_decompress(
                grads, {n: TP.local(t) for n, t in ef.items()}, split, over)
            with torch.no_grad():
                for n, t in new_ef.items():
                    if TP.shard_dim(ef[n]) is None:
                        ef[n] = t
                    else:
                        TP.local(ef[n]).copy_(t)
        with torch.no_grad():
            params = {n: TP.local(p) for n, p in model.named_parameters()}
            opt = {k: ({n: TP.local(t) for n, t in v.items()}
                       if isinstance(v, dict) else v)
                   for k, v in state["opt"].items()}
        _, new_opt, stats = adamw_update(params, grads, opt, tc.opt, split,
                                         over)
        state["opt"]["step"] = new_opt["step"]
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
