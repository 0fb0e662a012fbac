"""Fused greedy scheduling pass: the CUDA kernel ``csrc/schedule_tick.cu``.

Replaces the JAX package's Pallas ``repro/kernels/schedule_tick.py::
fused_schedule_tick``.  :func:`fused_schedule_tick` launches one CTA per
lane over the ``(B, W)`` slot rows (any W: the kernel tiles the row) and
uses the plain version (:func:`repro_torch.kernels.ref.schedule_tick_ref`)
only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.passes import PassParams, bisect_rounds

from .build import launch
from .ref import schedule_tick_ref

I32, F32, U8 = torch.int32, torch.float32, torch.uint8


def fused_schedule_tick(p: PassParams, state, alloc, remaining, start_t, act,
                        capacity, t_now, *, fill_rounds: int, prio_lo: int,
                        prio_hi: int, shadow_iters: int,
                        backfill_depth=None):
    """One greedy, class-free Steps-1..3 pass over every lane.

    Same layout as :func:`repro_torch.core.passes.schedule_tick`: slot
    tensors ``(..., W)``, ``act`` broadcastable to them, per-lane
    ``capacity``, ``t_now`` and optional ``backfill_depth``.  Returns
    ``(state, alloc, start_t)``.
    """
    if state.device.type == "cpu":
        return schedule_tick_ref(
            p, state, alloc, remaining, start_t, act, capacity, t_now,
            fill_rounds=fill_rounds, prio_lo=prio_lo, prio_hi=prio_hi,
            shadow_iters=shadow_iters, backfill_depth=backfill_depth)
    if state.device.type != "cuda":
        raise ValueError(f"schedule_tick runs on cuda or cpu, "
                         f"not {state.device}")
    shape = state.shape
    W = shape[-1]
    lanes = shape[:-1]

    def row(a, dtype):
        a = torch.as_tensor(a, device=state.device)
        return a.expand(shape).to(dtype).reshape(-1, W).contiguous()

    def scal(a, dtype):
        a = torch.as_tensor(a, device=state.device)
        return a.expand(lanes).to(dtype).reshape(-1).contiguous()

    ins = [row(state, I32), row(alloc, I32), row(remaining, F32),
           row(start_t, F32), row(act, U8), row(p.malleable, U8),
           row(p.want, I32), row(p.floor, I32), row(p.shrink_floor, I32),
           row(p.prio_ref, I32), row(p.max_nodes, I32), row(p.pfrac, F32),
           row(p.wall_work, F32), scal(capacity, I32), scal(t_now, F32)]
    depth = None if backfill_depth is None else scal(backfill_depth, I32)
    B = ins[0].shape[0]
    out_state = torch.empty_like(ins[0])
    out_alloc = torch.empty_like(ins[1])
    out_start = torch.empty_like(ins[3])
    # bounds and rounds of the Step-2 take and the Step-3 give, exactly as
    # take_desc_prefix / give_asc_prefix derive them
    take_lo, take_hi = prio_lo - 1, prio_hi
    give_lo, give_hi = -prio_hi - 1, -(prio_lo - 1) + 1
    if B and W:
        launch("schedule_tick", state, "repro_schedule_tick",
               *(t.data_ptr() for t in ins),
               None if depth is None else depth.data_ptr(),
               out_state.data_ptr(), out_alloc.data_ptr(),
               out_start.data_ptr(),
               B, W, fill_rounds, prio_lo, prio_hi, shadow_iters,
               take_lo, take_hi, bisect_rounds(take_lo, take_hi),
               give_lo, give_hi, bisect_rounds(give_lo, give_hi))
    return (out_state.reshape(shape), out_alloc.reshape(shape),
            out_start.reshape(shape))
