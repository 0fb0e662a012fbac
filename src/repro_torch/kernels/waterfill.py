"""Prefix waterfill: the CUDA kernel ``csrc/waterfill.cu`` and its callers.

Replaces the JAX package's Pallas ``repro/kernels/waterfill.py::waterfill``.
:func:`waterfill` launches the kernel for CUDA tensors in the tier
:func:`plan` picks from the shape, and uses the plain version
(:func:`repro_torch.kernels.ref.waterfill_ref`) only for tensors on the
CPU; on either device it takes only what the kernel takes, and raises on
anything else.  :func:`greedy_give_waterfill` is the greedy Step-3 give of
the scheduling pass through it (``expand_backend="waterfill"``): one
argsort and one launch.  :func:`greedy_shrink_waterfill` /
:func:`greedy_expand_waterfill` are the numpy DES's ``greedy_shrink`` /
``greedy_expand`` over it, one launch each.  The JAX package names these
wrappers ``greedy_shrink_pallas`` / ``greedy_expand_pallas`` and the
backend ``"pallas"``; the port says ``waterfill`` for both.
"""
from __future__ import annotations

import functools
import operator
import sys
from typing import NamedTuple

import torch

from . import KernelModule
from .build import launch, sm_count
from .ref import waterfill_ref

I32, I64 = torch.int32, torch.int64

# The tiers of csrc/waterfill.cu (WaterfillTier in csrc/kernels.h) and their
# limits, set by device times of hand-made plans on the H100 (PERF.md):
# rows of up to 256 slots run one warp a row (8 slots a lane at most), one
# row a CTA until the rows outnumber the SMs, then up to WARP_ROWS; rows of
# up to 4,096 slots run one CTA a row, 4 slots a thread, whatever the row
# count (the look-back's counter, memset and descriptor round trips cost
# more than a CTA's scan of such a row even when few CTAs run); longer rows
# are cut into tiles of 256 threads x 4 slots joined by a decoupled
# look-back (more slots a thread gained nothing, and lost on rows that
# take scalar accesses).
TIERS = ("warp", "cta", "lookback")
WARP_MAX_SLOTS = 256
WARP_ROWS = 4
SLOTS_PER_THREAD = 4     # the CTA and look-back tiers'
CTA_MAX_SLOTS = 1024 * SLOTS_PER_THREAD
LOOKBACK_THREADS = 256
VEC_BIT, SHARED_TARGET_BIT = 1 << 14, 1 << 15
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


class WaterfillPlan(NamedTuple):
    """How the kernel runs ``B`` rows of ``N`` slots: ``tier`` (one of
    :data:`TIERS`), ``threads`` a CTA, ``k`` consecutive slots a thread,
    ``grid`` CTAs, ``tiles`` a row (1 outside the look-back tier),
    ``scratch`` int64 words of device scratch (the look-back's tile counter
    and one descriptor a tile; 0 in the other tiers) and ``code``, the plan
    packed into the int the C entry point takes (the wrapper adds the
    per-call bits :data:`VEC_BIT` and :data:`SHARED_TARGET_BIT`)."""
    tier: str
    threads: int
    k: int
    grid: int
    tiles: int
    scratch: int
    code: int


def pack(tier: str, threads: int, k: int) -> int:
    """``WaterfillPlan.code``: bits 0-1 the tier, 2-7 the slots a thread,
    8-13 the warps a CTA (decoded in ``bindings.cpp``)."""
    return TIERS.index(tier) | k << 2 | (threads // 32) << 8


def make_plan(B: int, N: int, tier: str, threads: int,
              k: int) -> WaterfillPlan:
    """The plan of ``B`` rows of ``N`` slots run as given (:func:`plan`
    picks the arguments; tests make small ones)."""
    tiles, scratch = 1, 0
    if tier == "warp":
        grid = -(-B // (threads // 32))
    elif tier == "cta":
        grid = B
    else:
        tiles = -(-N // (threads * k))
        grid = B * tiles
        scratch = 1 + grid
    return WaterfillPlan(tier, threads, k, grid, tiles, scratch,
                         pack(tier, threads, k))


@functools.lru_cache(maxsize=1024)
def plan(B: int, N: int, sms: int) -> WaterfillPlan:
    """The kernel's launch plan for ``B`` rows of ``N >= 1`` slots on a card
    of ``sms`` multiprocessors."""
    if N <= WARP_MAX_SLOTS:
        k = 1
        while 32 * k < N:
            k *= 2
        rows = min(WARP_ROWS, max(1, B // sms))
        return make_plan(B, N, "warp", 32 * rows, k)
    k = SLOTS_PER_THREAD
    if N <= CTA_MAX_SLOTS:
        return make_plan(B, N, "cta", -(-N // (32 * k)) * 32, k)
    return make_plan(B, N, "lookback", LOOKBACK_THREADS, k)


def _refuse(what: str, t) -> ValueError:
    return ValueError(f"waterfill takes {what}, not {t.dtype} of shape "
                      f"{tuple(t.shape)} (strides {t.stride()}) on "
                      f"{t.device}")


def check_args(cap: torch.Tensor, target, order=None) -> tuple:
    """Validates a call as the kernel takes it: ``cap`` ``(N,)`` or
    ``(B, W)`` contiguous int32 on cpu or cuda; ``target`` a Python int in
    int32 range, or an int32 tensor on cap's device of shape ``()`` or
    ``cap.shape[:-1]``; ``order`` None or a contiguous int64 tensor of
    cap's shape on its device.  Returns ``(B, N, shared)``, ``shared``
    when a 0-d target tensor serves every row of a 2-D ``cap``.  (Written
    for the launch's host time: tensor attributes that build Python objects,
    such as ``device.type`` and shape slices, are read only on failure.)"""
    if not (cap.is_cuda or cap.is_cpu):
        raise ValueError(f"waterfill runs on cuda or cpu, not {cap.device}")
    nd = cap.ndim
    if cap.dtype != I32 or nd not in (1, 2) or not cap.is_contiguous():
        raise _refuse("(N,) or (B, W) contiguous int32 capacities", cap)
    N = cap.shape[-1]
    B = cap.shape[0] if nd == 2 else 1
    shared = False
    if torch.is_tensor(target):
        tnd = target.ndim
        if (target.dtype != I32 or target.device != cap.device
                or not (tnd == 0 or (nd == 2 and tnd == 1
                                     and target.shape[0] == B))):
            raise _refuse(f"an int32 target of shape () or "
                          f"{tuple(cap.shape[:-1])} on {cap.device}", target)
        shared = nd == 2 and tnd == 0
    else:
        value = operator.index(target)
        if not INT32_MIN <= value <= INT32_MAX:
            raise ValueError(f"waterfill target {value} is outside int32")
    if order is not None and (order.dtype != I64 or order.shape != cap.shape
                              or order.device != cap.device
                              or not order.is_contiguous()):
        raise _refuse(f"an order of int64 row positions of shape "
                      f"{tuple(cap.shape)} on {cap.device}", order)
    return (B if N else 0), N, shared


def kernel_args(cap, target, order, out, scratch, pl: WaterfillPlan,
                shared: bool) -> tuple:
    """The C entry point's arguments but the stream: pointers (a Python int
    target crosses by value, with a null pointer), sizes and the plan's
    code with this call's bits (16-byte accesses where the plan, ``order``
    and the pointers allow them; one target for every row)."""
    N = cap.shape[-1]
    B = cap.shape[0] if cap.ndim == 2 else 1
    cp, op = cap.data_ptr(), out.data_ptr()
    code = pl.code | (SHARED_TARGET_BIT if shared else 0)
    if (order is None and pl.k % 4 == 0 and (B == 1 or N % 4 == 0)
            and (cp | op) % 16 == 0):
        code |= VEC_BIT
    if torch.is_tensor(target):
        tptr, value = target.data_ptr(), 0
    else:
        tptr, value = None, operator.index(target)
    return (cp, tptr, None if order is None else order.data_ptr(), op,
            None if scratch is None else scratch.data_ptr(), B, N, value,
            code)


def waterfill(cap: torch.Tensor, target, order=None) -> torch.Tensor:
    """Per-row take, in order, with sum == min(target, sum(row)).

    ``cap``: ``(N,)`` or ``(B, W)`` contiguous int32 >= 0; ``target``: a
    Python int, or an int32 tensor of shape ``()`` or one per row;
    ``order``: None (``cap`` is already in priority order) or an int64
    permutation of each row (argsort's output), in which case slot
    ``order[i]`` is visited i-th and the take comes back in ``cap``'s own
    order.  Raises for anything else (:func:`check_args`).
    """
    B, N, shared = check_args(cap, target, order)
    if cap.device.type == "cpu":
        return waterfill_ref(cap, target, order)
    out = torch.empty_like(cap)
    if B and N:
        pl = plan(B, N, sm_count(cap.get_device()))
        scratch = (torch.empty(pl.scratch, dtype=I64, device=cap.device)
                   if pl.scratch else None)
        launch("waterfill", cap, "repro_waterfill",
               *kernel_args(cap, target, order, out, scratch, pl, shared))
    return out


def greedy_give_waterfill(prio, room, idle):
    """Greedy ascending-priority give of ``idle`` nodes over ``room``.

    Slots are visited by ``(prio, slot)`` -- a stable argsort keeps the
    FCFS tie-break of the bisection give -- and the kernel gathers, gives
    and scatters back in one launch.  Mirrors
    ``repro.core.passes._pallas_give``.
    """
    order = torch.argsort(prio, dim=-1, stable=True)
    return waterfill(room, idle, order=order)


def greedy_shrink_waterfill(alloc, floor, priority, need):
    """:func:`repro_torch.core.passes.greedy_shrink` over the waterfill
    kernel (the reference's ``greedy_shrink_pallas``): each job gives up
    its surplus over ``floor``, highest ``priority`` first (ties in slot
    order), until ``need`` nodes are freed.  A row ``(N,)`` (or rows
    ``(B, N)`` with one ``need`` each) on any device; one launch on
    ``cuda``, the plain version on the CPU.  Returns the int32 allocation.
    """
    alloc = torch.as_tensor(alloc).to(I32)
    surplus = torch.clamp(
        alloc - torch.as_tensor(floor, device=alloc.device).to(I32), min=0)
    prio = torch.as_tensor(priority, device=alloc.device)
    order = torch.argsort(-prio, dim=-1, stable=True)
    return alloc - waterfill(surplus, _target(need, alloc), order=order)


def greedy_expand_waterfill(alloc, cap, priority, idle):
    """:func:`repro_torch.core.passes.greedy_expand` over the waterfill
    kernel (the reference's ``greedy_expand_pallas``): each job grows
    toward ``cap``, lowest ``priority`` first (ties in slot order), until
    ``idle`` nodes are spent.  Shapes and devices as
    :func:`greedy_shrink_waterfill`."""
    alloc = torch.as_tensor(alloc).to(I32)
    room = torch.clamp(
        torch.as_tensor(cap, device=alloc.device).to(I32) - alloc, min=0)
    prio = torch.as_tensor(priority, device=alloc.device)
    order = torch.argsort(prio, dim=-1, stable=True)
    return alloc + waterfill(room, _target(idle, alloc), order=order)


def _target(amount, alloc):
    """A Python int as it is, a tensor as int32 on ``alloc``'s device."""
    if torch.is_tensor(amount):
        return amount.to(device=alloc.device, dtype=I32)
    return amount


# one name for the module and its wrapper: calling the module calls it
sys.modules[__name__].__class__ = KernelModule
