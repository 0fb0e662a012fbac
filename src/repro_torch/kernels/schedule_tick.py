"""Fused greedy scheduling pass: the CUDA kernel ``csrc/schedule_tick.cu``.

Replaces the JAX package's Pallas ``repro/kernels/schedule_tick.py::
fused_schedule_tick``.  :func:`fused_schedule_tick` launches the kernel
over the ``(B, W)`` slot rows in the tier :func:`plan` picks for the row
length, and uses the plain version
(:func:`repro_torch.kernels.ref.schedule_tick_ref`) only for tensors on the
CPU.  :func:`kernel_args` is what the launch takes: the caller's tensors
as they are, with no copy (it raises where a dtype or layout is not the
kernel's).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.passes import PassParams, bisect_rounds

from .build import launch
from .ref import schedule_tick_ref

I32, F32 = torch.int32, torch.float32

# The tiers of csrc/schedule_tick.cu (TickTier in csrc/kernels.h) and their
# limits: rows of up to 256 slots run one warp (a CTA) a lane; longer rows
# one CTA (8 slots a thread) with the row in shared memory, up to 4,096
# slots; a longer row takes the fewest CTAs of a cluster that hold it, and
# more while the lanes leave SMs free and each CTA keeps 2,048 slots; rows
# longer than 8 CTAs hold keep the same arrays in a device-memory scratch.
# Chosen by device time on the H100 (PERF.md): a cluster barrier costs more
# than a CTA barrier, so a row that fits one CTA is not split, and one warp
# a CTA beat four at W = 256.
TIERS = ("warp", "cta", "cluster", "global")
WARP_MAX_SLOTS = 256
CTA_SLOTS = 4096
SLOTS_PER_THREAD = 8
MAX_CLUSTER = 8
MIN_SPLIT_SLOTS = 2048
GLOBAL_THREADS = 512
MAX_THREADS = 512
H100_SMS = 132             # the plan's default: an H100 SXM
SLOT_BYTES = 37            # a slot's arrays: nine of 4 bytes and a flag byte
PART_BYTES = 2 * 32 * 16   # two buffers of 32 int4 partials (CTA teams)
MAX_SMEM_BYTES = 232_448   # a CTA's shared memory on Hopper


class TickPlan(NamedTuple):
    """How the kernel runs ``B`` lanes of ``W`` slots: ``tier`` (one of
    :data:`TIERS`), ``threads`` a CTA (one warp in the warp tier),
    ``k`` consecutive slots a thread, ``cluster`` CTAs a lane sharing its
    row (``ceil(W / cluster)`` slots each), ``smem`` bytes of dynamic
    shared memory a CTA (the launch computes the same bytes in
    ``schedule_tick_smem``), the global tier's ``scratch`` bytes of device
    memory, and ``code``, the plan packed into the one int the C entry
    point takes."""
    tier: str
    threads: int
    k: int
    cluster: int
    smem: int
    scratch: int
    code: int


def pack(tier: str, threads: int, k: int, cluster: int) -> int:
    """``TickPlan.code``: bits 0-1 the tier, 2-5 the cluster, 6-11 the
    warps a CTA, 12-27 the slots a thread (decoded in ``bindings.cpp``)."""
    return TIERS.index(tier) | cluster << 2 | (threads // 32) << 6 | k << 12


def make_plan(B: int, tier: str, threads: int, k: int,
              cluster: int) -> TickPlan:
    """The plan of ``B`` lanes run as given, with its shared and scratch
    bytes (:func:`plan` picks the arguments; tests make small ones)."""
    rows = threads * k * SLOT_BYTES
    smem = {"warp": rows, "global": PART_BYTES}.get(tier, PART_BYTES + rows)
    scratch = B * cluster * rows if tier == "global" else 0
    return TickPlan(tier, threads, k, cluster, smem, scratch,
                    pack(tier, threads, k, cluster))


@functools.lru_cache(maxsize=1024)
def plan(B: int, W: int, sms: int = H100_SMS) -> TickPlan:
    """The kernel's launch plan for ``B`` lanes of ``W`` slots (any W) on a
    card of ``sms`` multiprocessors."""
    if W <= WARP_MAX_SLOTS:
        return make_plan(B, "warp", 32, 4 if W <= 128 else 8, 1)
    c = 1
    while c < MAX_CLUSTER and -(-W // c) > CTA_SLOTS:
        c *= 2
    if -(-W // c) <= CTA_SLOTS:
        while (1 < c < MAX_CLUSTER and B * 2 * c <= sms
               and -(-W // (2 * c)) >= MIN_SPLIT_SLOTS):
            c *= 2
        threads = -(-W // (c * 32 * SLOTS_PER_THREAD)) * 32
        return make_plan(B, "cta" if c == 1 else "cluster", threads,
                         SLOTS_PER_THREAD, c)
    c = MAX_CLUSTER
    while c > 1 and B * c > sms:
        c //= 2
    k = -(-W // (c * GLOBAL_THREADS))
    return make_plan(B, "global", GLOBAL_THREADS, k, c)


@functools.lru_cache(maxsize=16)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _row(t, shape, dtype, name):
    if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
        raise ValueError(f"schedule_tick takes {name} as a contiguous "
                         f"{dtype} tensor of shape {tuple(shape)}, not "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"(strides {t.stride()})")
    return t


def _bytes(t, shape, name):
    """A bool row read as its bytes, in place."""
    return _row(t, shape, torch.bool, name).view(torch.uint8)


def kernel_args(p: PassParams, state, alloc, remaining, start_t, act,
                capacity, t_now, backfill_depth=None):
    """The launch's inputs, as the caller's tensors: ``(rows, act_lane,
    lanes)`` with ``rows`` the 13 slot rows then ``capacity``, ``t_now``
    and ``depth`` (or None), reshaped (views) but never copied or
    converted.  ``act`` of the lanes' shape with a trailing 1 (it
    broadcasts along the slots) is taken as one flag a lane (``act_lane``
    is then 1), else it must be a full row.  Raises for any other dtype,
    shape or layout."""
    shape = state.shape
    W = shape[-1]
    lanes = shape[:-1]
    if act.shape == shape:
        act_lane = 0
        act_t = _bytes(act, shape, "act")
    else:
        if act.shape != lanes + (1,):
            raise ValueError(f"schedule_tick takes act of shape "
                             f"{tuple(shape)} or {tuple(lanes + (1,))}, "
                             f"not {tuple(act.shape)}")
        act_lane = 1
        act_t = _bytes(act.reshape(lanes), lanes, "act")
    rows = [_row(state, shape, I32, "state"),
            _row(alloc, shape, I32, "alloc"),
            _row(remaining, shape, F32, "remaining"),
            _row(start_t, shape, F32, "start_t"), act_t,
            _bytes(p.malleable, shape, "malleable"),
            _row(p.want, shape, I32, "want"),
            _row(p.floor, shape, I32, "floor"),
            _row(p.shrink_floor, shape, I32, "shrink_floor"),
            _row(p.prio_ref, shape, I32, "prio_ref"),
            _row(p.max_nodes, shape, I32, "max_nodes"),
            _row(p.pfrac, shape, F32, "pfrac"),
            _row(p.wall_work, shape, F32, "wall_work"),
            _row(capacity, lanes, I32, "capacity"),
            _row(t_now, lanes, F32, "t_now"),
            None if backfill_depth is None
            else _row(backfill_depth, lanes, I32, "backfill_depth")]
    return rows, act_lane, math.prod(lanes)


def fused_schedule_tick(p: PassParams, state, alloc, remaining, start_t, act,
                        capacity, t_now, *, fill_rounds: int, prio_lo: int,
                        prio_hi: int, shadow_iters: int,
                        backfill_depth=None):
    """One greedy, class-free Steps-1..3 pass over every lane.

    Same layout as :func:`repro_torch.core.passes.schedule_tick`: slot
    tensors ``(..., W)``, ``act`` broadcastable to them, per-lane
    ``capacity``, ``t_now`` and optional ``backfill_depth``.  On the card
    every tensor must already have the kernel's dtype (int32 counts,
    float32 times, bool flags) and be contiguous; ``act`` may be one flag
    a lane.  Returns ``(state, alloc, start_t)``.
    """
    if state.device.type == "cpu":
        return schedule_tick_ref(
            p, state, alloc, remaining, start_t, act, capacity, t_now,
            fill_rounds=fill_rounds, prio_lo=prio_lo, prio_hi=prio_hi,
            shadow_iters=shadow_iters, backfill_depth=backfill_depth)
    if state.device.type != "cuda":
        raise ValueError(f"schedule_tick runs on cuda or cpu, "
                         f"not {state.device}")
    rows, act_lane, B = kernel_args(p, state, alloc, remaining, start_t, act,
                                    capacity, t_now, backfill_depth)
    dev = state.get_device()
    for t in rows:
        if t is not None and t.get_device() != dev:
            raise ValueError(f"schedule_tick takes every tensor on "
                             f"{state.device}, not {t.device}")
    W = state.shape[-1]
    out_state = torch.empty_like(state)
    out_alloc = torch.empty_like(alloc)
    out_start = torch.empty_like(start_t)
    if B and W:
        pl = plan(B, W, _sm_count(dev))
        scratch = (torch.empty(pl.scratch, dtype=torch.uint8,
                               device=state.device) if pl.scratch else None)
        launch("schedule_tick", state, "repro_schedule_tick",
               *(None if t is None else t.data_ptr() for t in rows),
               out_state.data_ptr(), out_alloc.data_ptr(),
               out_start.data_ptr(),
               None if scratch is None else scratch.data_ptr(),
               B, W, act_lane, pl.code, fill_rounds, prio_lo, prio_hi,
               shadow_iters, *bisect_bounds(prio_lo, prio_hi))
    return out_state, out_alloc, out_start


@functools.lru_cache(maxsize=64)
def bisect_bounds(prio_lo: int, prio_hi: int) -> tuple:
    """Bounds ``(lo, hi]`` and rounds of the Step-2 take and the Step-3
    give, exactly as ``take_desc_prefix`` / ``give_asc_prefix`` derive
    them in the plain pass."""
    take_lo, take_hi = prio_lo - 1, prio_hi
    give_lo, give_hi = -prio_hi - 1, -(prio_lo - 1) + 1
    return (take_lo, take_hi, bisect_rounds(take_lo, take_hi),
            give_lo, give_hi, bisect_rounds(give_lo, give_hi))
