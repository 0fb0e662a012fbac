"""Plain PyTorch versions of the port's CUDA kernels.

Each kernel wrapper falls back to its plain version only for tensors that
lie on the CPU; the CPU tests use these, and ``chip_smoke.py`` holds every
kernel against its plain version on the card.  Nothing on the main path
calls them when a card is present.
"""
from __future__ import annotations

import torch

from repro_torch.core.passes import SHADOW_ITERS, plain_tick

I32 = torch.int32


def schedule_tick_ref(p, state, alloc, remaining, start_t, act, capacity,
                      t_now, *, fill_rounds: int, prio_lo: int, prio_hi: int,
                      shadow_iters: int = SHADOW_ITERS,
                      backfill_depth=None):
    """The greedy, class-free Steps-1..3 pass (what ``schedule_tick.cu``
    computes), as plain PyTorch ops.  Returns ``(state, alloc, start_t)``."""
    return plain_tick(
        p, state, alloc, remaining, start_t, act, capacity, t_now,
        balanced=False, fill_rounds=fill_rounds, prio_lo=prio_lo,
        prio_hi=prio_hi, span_max=0, shadow_iters=shadow_iters,
        backfill_depth=backfill_depth)


def waterfill_ref(cap, target):
    """Per-row prefix waterfill: ``clip(min(target, total) - excl_cumsum(cap),
    0, cap)``.

    ``cap``: ``(N,)`` or ``(B, W)`` int32 >= 0 in priority order;
    ``target``: a scalar, or one int per row.  Each row's take sums to
    ``min(target, row total)``.
    """
    cap = torch.as_tensor(cap, dtype=I32)
    target = torch.as_tensor(target, dtype=I32, device=cap.device)
    cum = torch.cumsum(cap, dim=-1, dtype=I32)
    if cap.shape[-1]:
        total = cum[..., -1]
    else:
        total = torch.zeros(cap.shape[:-1], dtype=I32, device=cap.device)
    tgt = torch.minimum(target, total)[..., None]
    return torch.minimum(torch.clamp(tgt - (cum - cap), min=0), cap)
