"""AdamW + LR schedules in plain PyTorch: the port of the JAX package's
``train/optimizer.py``.

The state is the reference's ``{"mu", "nu", "step"[, "master"]}``, its
trees keyed by parameter name (``model.named_parameters()``): moments f32;
``step`` an int32 scalar, kept on the host; with ``master_in_opt`` f32
master weights, so the model's parameters may live in bf16.  The update
runs in f32, parameter by parameter as the reference does, as
``torch._foreach_*`` ops over all the parameters at once, and writes the
parameters, moments and master weights in place (the reference returns new
trees).  The JAX package has no kernel here, so plain PyTorch is the port.
The schedules compute in f32 on the host, as the reference's do on its
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


# -------------------------------------------------------------- schedules
def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32, device="cpu")


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def linear_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        return torch.where(step < warmup, warm, base_lr * (1 - 0.9 * t))
    return lr


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable = cosine_schedule(3e-4, 100, 10_000)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_in_opt: bool = False   # keep f32 master copies (bf16 params)


def init_opt_state(params: Params, cfg: AdamWConfig) -> Dict[str, object]:
    """Zero moments beside each parameter, step 0 (and the f32 master
    copies with ``master_in_opt``)."""
    state = {"mu": {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()},
             "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()},
             "step": torch.zeros((), dtype=torch.int32)}
    if cfg.master_in_opt:
        state["master"] = {n: p.detach().float().clone()
                           for n, p in params.items()}
    return state


def _f32_list(tensors):
    return [t if t.dtype == torch.float32 else t.float() for t in tensors]


def global_norm(tree: Params, sharded=(), group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32.  Under tensor
    parallelism ``tree`` holds this rank's shards: the squares of the
    tensors named in ``sharded`` are summed over ``group`` (the model
    group) and every other tensor, whole on each rank, counts once."""
    if group is None or not sharded:
        norms = torch._foreach_norm(_f32_list(tree.values()), 2)
        return torch.linalg.vector_norm(torch.stack(norms))
    import torch.distributed as dist
    from repro_torch.launch.mesh import world_device_type
    sq = []
    for names in ([n for n in tree if n in sharded],
                  [n for n in tree if n not in sharded]):
        norms = torch._foreach_norm(_f32_list(tree[n] for n in names), 2)
        sq.append(torch.linalg.vector_norm(torch.stack(norms)) ** 2
                  if norms else torch.zeros(
                      (), device=next(iter(tree.values())).device))
    part = sq[0].to(world_device_type())
    dist.all_reduce(part, group=group)
    return torch.sqrt(part.to(sq[1].device) + sq[1])


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: Dict[str, object],
                 cfg: AdamWConfig, sharded=(), group=None):
    """One AdamW step, in place.  Returns ``(params, state, stats)``:
    ``params`` and the state's trees are the ones given, updated; stats
    ``{"lr", "grad_norm"}``.  f32 ``grads`` are scaled by the clip factor
    in place (the step consumes them).  Under tensor parallelism the trees
    hold this rank's local shards, ``sharded`` names the split ones and
    ``group`` is the model group (:func:`global_norm`); the update is
    elementwise, so it runs on the shards as they are."""
    names = list(params)
    step = state["step"] + 1
    lr = cfg.lr(step)

    gnorm = global_norm(grads, sharded, group)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    g = _f32_list(grads[n] for n in names)
    torch._foreach_mul_(g, clip)
    mu = [state["mu"][n] for n in names]
    nu = [state["nu"][n] for n in names]
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, g, alpha=1 - cfg.b1)
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_addcmul_(nu, g, g, value=1 - cfg.b2)
    del g

    stepf = _f32(step)
    bc1 = float(1 - cfg.b1 ** stepf)
    bc2 = float(1 - cfg.b2 ** stepf)
    master = state.get("master")
    ref = [master[n] if master is not None else params[n] for n in names]
    p32 = _f32_list(ref)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, denom)
    del denom
    torch._foreach_add_(upd, p32, alpha=cfg.weight_decay)
    torch._foreach_add_(p32, upd, alpha=-float(lr))
    del upd
    for n, new in zip(names, p32):
        for dst in (master[n] if master is not None else None, params[n]):
            if dst is not None and dst is not new:
                dst.copy_(new)
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    if master is not None:
        new_state["master"] = master
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
