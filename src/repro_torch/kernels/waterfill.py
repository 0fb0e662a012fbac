"""Prefix waterfill: the CUDA kernel ``csrc/waterfill.cu`` and its callers.

Replaces the JAX package's Pallas ``repro/kernels/waterfill.py::waterfill``.
:func:`waterfill` launches the kernel for CUDA tensors and uses the plain
version (:func:`repro_torch.kernels.ref.waterfill_ref`) only for tensors on
the CPU; :func:`greedy_give_waterfill` is the greedy Step-3 give of the
scheduling pass through it (``expand_backend="waterfill"``).
"""
from __future__ import annotations

import torch

from .build import launch
from .ref import waterfill_ref

I32 = torch.int32


def waterfill(cap: torch.Tensor, target) -> torch.Tensor:
    """Per-row take, in order, with sum == min(target, sum(row)).

    ``cap``: ``(N,)`` or ``(B, W)`` int32 >= 0, already in priority order;
    ``target``: a scalar or ``(B,)`` per-row targets.
    """
    if cap.device.type == "cpu":
        return waterfill_ref(cap, target)
    if cap.device.type != "cuda":
        raise ValueError(f"waterfill runs on cuda or cpu, not {cap.device}")
    if cap.dtype != I32 or cap.ndim not in (1, 2):
        raise ValueError("waterfill takes (N,) or (B, W) int32 capacities")
    rows = cap.reshape(-1, cap.shape[-1]).contiguous()
    tgt = torch.as_tensor(target, dtype=I32, device=cap.device)
    tgt = tgt.expand(rows.shape[0]).contiguous()
    out = torch.empty_like(rows)
    if rows.numel():
        launch("waterfill", cap, "repro_waterfill", rows.data_ptr(),
               tgt.data_ptr(), out.data_ptr(), rows.shape[0], rows.shape[1])
    return out.reshape(cap.shape)


def greedy_give_waterfill(prio, room, idle):
    """Greedy ascending-priority give of ``idle`` nodes over ``room``.

    Slots are sorted by ``(prio, slot)`` -- a stable argsort keeps the
    FCFS tie-break of the bisection give -- waterfilled per lane and
    scattered back.  Mirrors ``repro.core.passes._pallas_give``.
    """
    order = torch.argsort(prio, dim=-1, stable=True)
    give_sorted = waterfill(torch.gather(room, -1, order), idle)
    return torch.zeros_like(room).scatter_(-1, order, give_sorted)
