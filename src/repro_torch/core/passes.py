"""The scheduling passes (paper §2.1 Steps 1-3): numpy DES and PyTorch.

The port of ``repro.core.passes``, in its three families:

1. the exact argsort redistribution (:func:`greedy_shrink`,
   :func:`greedy_expand`, :func:`balanced_shrink`, :func:`balanced_expand`)
   and
2. the exact sequential EASY backfill (:func:`fcfs_prefix_exact`,
   :func:`easy_reservation_exact`, :func:`easy_backfill_scan_exact`) are
   numpy copies of the reference's, consumed by the host DES
   (:mod:`repro_torch.core.simulator`) with ``xp=np``;
3. the masked fixed-shape pass in PyTorch, the one the batched engine runs
   once per scan step: slot arrays are ``(..., W)`` in queue order, leading
   axes are lanes, and every phase is a masked cumulative sum, reduction or
   integer/float bisection -- no sort on the reference path.

Every structure of the strategy registry runs here: ``greedy`` (EASY / MIN
/ PREF / KEEPPREF), ``balanced`` (AVG), ``pooled`` (PREF_COMMON_POOL: a
common-pool start pass after Step 2) and ``stealing`` (STEAL_AGREEMENT: a
shrink-to-average transfer after Step 2).  Two static flags widen the
queue: ``with_classes`` puts queued on-demand slots ahead of the others
(:func:`priority_head`, :func:`queue_ranks`, :func:`queue_cumsum`), and
``with_sjf`` runs the pass over slots permuted by ``sort_key`` (a stable
argsort) and restores slot order after it.

``expand_backend`` picks how a lane runs on the card:

* ``"fused"`` -- a greedy, class-free lane (FCFS or SJF-permuted) runs
  the whole pass as the hand-written CUDA kernel
  (:mod:`repro_torch.kernels.schedule_tick`); the default on ``cuda``;
  other lanes run this module's pass with the greedy give below;
* ``"waterfill"`` -- this module's pass with the Step-3 greedy give through
  the CUDA prefix-waterfill kernel (:mod:`repro_torch.kernels.waterfill`),
  the counterpart of the JAX package's ``"pallas"``;
* ``"bisect"`` -- this module's pass alone, the only value allowed on the
  CPU.

Under every backend but ``bisect`` the greedy give of a lane that runs this
module's pass (pooled, stealing, classes, or ``waterfill``) goes through
the waterfill kernel, as the JAX pass sends it through Pallas; balanced
lanes have no greedy give.  The JAX pass skips whole phases with
``lax.cond`` on batch-wide predicates; each skip is a per-lane value
identity (no head admits nothing, ``need == 0`` takes nothing, ``idle ==
0`` gives nothing, ``taken == 0`` pools nothing, ``transfer == 0`` steals
nothing), so here every phase runs unconditionally and no step waits on
the host.

Integer arithmetic stays in int32 (``cumsum``/``sum`` are told so), float
in float32, and ``//`` on the negative bisection bounds is floor division,
as in JAX with x64 off.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .jobs import QUEUED, RUNNING
from .speedup import amdahl_speedup
from .strategies import STRUCTURES

I32 = torch.int32
F32 = torch.float32

_BISECT_ITERS = 24  # family 1's level bisection: 2^-24 resolution, exact
                    # after integer rounding for any cluster size
# Shadow-time bisection rounds: 26 halvings of [0, t_max] separate any two
# distinct f32 end estimates over the traces' spans (same as the JAX pass).
SHADOW_ITERS = 26
_SHADOW_EPS = 1e-3  # absolute slack on "finishes before the reservation"

EXPAND_BACKENDS = ("fused", "waterfill", "bisect")


# ======================================================================
# Start policies (paper §2.1 Step 1 parameters, per strategy)
# ======================================================================
def start_policies(strategy, malleable, mn, pref, req, xp=np):
    """Per-job ``(want, floor, shrink_floor, prio_ref)`` policy arrays.

    Non-malleable jobs (and every job under a rigid strategy) use their
    rigid request for all four.
    """
    if not strategy.malleable:
        return req, req, req, req

    def pick(which):
        return strategy.pick(which, mn, pref, req)

    want = xp.where(malleable, pick(strategy.start_want), req)
    floor = xp.where(malleable, pick(strategy.start_floor), req)
    sfloor = xp.where(malleable, pick(strategy.shrink_floor), req)
    prio_ref = pick("min" if strategy.priority == "min" else "pref")
    return want, floor, sfloor, prio_ref


# ======================================================================
# 1. Exact argsort-based redistribution (Steps 2-3 reference semantics)
# ======================================================================
def _stable_argsort(key):
    return np.argsort(key, kind="stable")


def greedy_shrink(alloc, floor, priority, need, xp=np):
    """Shrink jobs to ``floor`` in descending priority until >= need freed.

    Returns the new allocation array.  Shrinks the *smallest number of jobs*:
    jobs are fully lowered to floor in priority order; the marginal job is
    lowered only as far as needed.  If total surplus < need, frees what it can.
    """
    alloc = xp.asarray(alloc)
    surplus = xp.maximum(alloc - floor, 0)
    order = _stable_argsort(-xp.asarray(priority))
    s_sorted = surplus[order]
    cum = xp.cumsum(s_sorted)
    target = xp.minimum(xp.asarray(need, dtype=cum.dtype), cum[-1] if cum.shape[0] else 0)
    prev = cum - s_sorted
    amt_sorted = xp.clip(target - prev, 0, s_sorted)
    amt = np.empty_like(np.asarray(s_sorted))
    amt[np.asarray(order)] = amt_sorted
    return alloc - amt.astype(alloc.dtype)


def greedy_expand(alloc, cap, priority, idle, xp=np):
    """Expand jobs to ``cap`` in ascending priority until idle exhausted."""
    alloc = xp.asarray(alloc)
    room = xp.maximum(cap - alloc, 0)
    order = _stable_argsort(xp.asarray(priority))
    r_sorted = room[order]
    cum = xp.cumsum(r_sorted)
    target = xp.minimum(xp.asarray(idle, dtype=cum.dtype), cum[-1] if cum.shape[0] else 0)
    prev = cum - r_sorted
    amt_sorted = xp.clip(target - prev, 0, r_sorted)
    amt = np.empty_like(np.asarray(r_sorted))
    amt[np.asarray(order)] = amt_sorted
    return alloc + amt.astype(alloc.dtype)


def _level_targets_xp(level, mn, mx, xp):
    """Integer allocation at relative level ``level`` in [0, 1]."""
    span = (mx - mn) * 1.0  # promote to the backend's default float
    return mn + xp.floor(level * span + 1e-9).astype(mn.dtype)


def balanced_shrink(alloc, mn, mx, need, xp=np):
    """AVG shrink: lower all jobs toward a common relative level.

    Finds the largest level ``r`` such that shrinking every job to
    ``min(alloc, mn + r (mx - mn))`` frees at least ``need`` nodes, then
    returns excess (integer-rounding) capacity back to the jobs shrunk the
    deepest, so exactly ``min(need, freeable)`` is freed.
    """
    alloc = xp.asarray(alloc)
    freeable = xp.sum(xp.maximum(alloc - mn, 0))
    need_eff = xp.minimum(xp.asarray(need, dtype=freeable.dtype), freeable)

    lo = xp.zeros(()); hi = xp.ones(())
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        t = xp.minimum(alloc, _level_targets_xp(mid, mn, mx, xp))
        freed = xp.sum(alloc - t)
        ok = freed >= need_eff           # level low enough to free need
        lo = xp.where(ok, mid, lo)
        hi = xp.where(ok, hi, mid)
    t = xp.minimum(alloc, _level_targets_xp(lo, mn, mx, xp))
    freed = xp.sum(alloc - t)
    # Return integer-rounding excess to the most-shrunk jobs (largest delta).
    excess = freed - need_eff
    delta = alloc - t
    giveback = greedy_expand(t, alloc, -delta, excess, xp=xp)
    return giveback


def balanced_expand(alloc, mn, mx, idle, xp=np):
    """AVG expand: raise all jobs toward a common relative level."""
    alloc = xp.asarray(alloc)
    room = xp.sum(xp.maximum(mx - alloc, 0))
    idle_eff = xp.minimum(xp.asarray(idle, dtype=room.dtype), room)

    lo = xp.zeros(()); hi = xp.ones(())
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        t = xp.maximum(alloc, xp.minimum(_level_targets_xp(mid, mn, mx, xp), mx))
        used = xp.sum(t - alloc)
        ok = used <= idle_eff
        lo = xp.where(ok, mid, lo)
        hi = xp.where(ok, hi, mid)
    t = xp.maximum(alloc, xp.minimum(_level_targets_xp(lo, mn, mx, xp), mx))
    used = xp.sum(t - alloc)
    # Hand out the remaining few nodes to the least-utilized jobs first.
    leftover = idle_eff - used
    span = xp.maximum(mx - mn, 1)
    balance = (t - mn) / span
    return greedy_expand(t, mx, balance, leftover, xp=xp)


# ======================================================================
# 2. Exact sequential EASY backfill (Step 1, consumed by the numpy DES)
# ======================================================================
def fcfs_prefix_exact(want, floor, free: int):
    """Start the FCFS queue prefix; each job takes ``min(want, free)``.

    Stops at the first job whose ``floor`` does not fit.  Returns the
    per-position allocations of started jobs and the remaining free nodes.
    """
    allocs = []
    for w_, f_ in zip(want, floor):
        if int(f_) > free:
            break
        a = int(min(int(w_), free))
        allocs.append(a)
        free -= a
    return allocs, free


def easy_reservation_exact(ests, release, free: int, head_floor: int
                           ) -> Tuple[float, int]:
    """EASY head reservation: ``(shadow, extra)`` from exact end estimates.

    ``shadow`` is the earliest time the blocked head's ``head_floor`` nodes
    accumulate (walltime-padded estimates, ascending-finish order);
    ``extra`` is how many nodes beyond the head's need are free at that
    moment — the pool backfill jobs running past ``shadow`` may draw from.
    """
    srt = np.argsort(ests, kind="stable")
    cumfree = free + np.cumsum(np.asarray(release)[srt])
    k = int(np.searchsorted(cumfree, head_floor))
    k = min(k, len(ests) - 1)
    return float(np.asarray(ests)[srt][k]), int(cumfree[k]) - int(head_floor)


def easy_backfill_scan_exact(want, floor, wall_work, pfrac, t: float,
                             shadow: float, extra: int, free: int,
                             eps: float = 1e-9):
    """EASY backfill scan over queued candidates (head excluded), in order.

    A candidate is started at ``a = min(want, free)`` (falling back to
    ``floor``) when it either finishes before ``shadow`` at that allocation
    or fits inside the ``extra`` spare-node pool — the head's reservation
    is never delayed.  Returns ``(starts, free, extra)`` where ``starts``
    is a list of ``(candidate_index, alloc)``.
    """
    starts = []
    for i in range(len(want)):
        if free == 0:
            break
        floor_i = int(floor[i])
        if floor_i > free:
            continue
        want_i = int(want[i])
        for a_try in dict.fromkeys([min(want_i, free), floor_i]):
            est = wall_work[i] / amdahl_speedup(float(a_try), pfrac[i])
            if t + est <= shadow + eps:
                pass  # finishes before the reservation
            elif a_try <= extra:
                extra -= a_try  # runs past shadow inside spare nodes
            else:
                continue
            starts.append((i, a_try))
            free -= a_try
            break
    return starts, free, extra


# ======================================================================
# 3. Masked fixed-shape vectorized passes (the batched engine)
# ======================================================================
class PassParams(NamedTuple):
    """Per-slot job/policy tensors for :func:`schedule_tick`, ``(..., W)``.

    ``wall_work`` is ``walltime * S(nodes_req)``, so the walltime-padded
    remaining-duration estimate at allocation ``a`` is
    ``remaining * wall_work / S(a)``.  The three optional fields are read
    by one flag or structure each: ``on_demand`` (queued on-demand slots
    outrank the rest) only under ``with_classes=True``, ``pref_nodes``
    (the preferred allocation) only by ``structure="pooled"``, and
    ``sort_key`` (the queue-order key: submit rank under FCFS, walltime
    estimate under SJF; ``inf`` on padding) only under ``with_sjf=True``.
    """

    malleable: torch.Tensor   # bool
    min_nodes: torch.Tensor   # i32
    max_nodes: torch.Tensor   # i32
    want: torch.Tensor        # i32 Step-1 target allocation
    floor: torch.Tensor       # i32 smallest start allocation
    shrink_floor: torch.Tensor  # i32 smallest Step-2 allocation
    prio_ref: torch.Tensor    # i32 greedy priority = alloc - prio_ref
    pfrac: torch.Tensor       # f32 Amdahl parallel fraction
    wall_work: torch.Tensor   # f32 walltime * S(nodes_req)
    on_demand: object = None   # bool queue-priority class
    pref_nodes: object = None  # i32 preferred allocation
    sort_key: object = None    # f32 queue-order key


def bisect_rounds(lo0: int, hi0: int) -> int:
    """Integer-bisection rounds of :func:`take_desc_prefix` over (lo0, hi0]."""
    return int(math.ceil(math.log2(max(hi0 - lo0, 1)))) + 1


def _amdahl_den(n, p):
    """``1 / S(n)`` of Amdahl's law in float32 (``n`` at least 1)."""
    return (1.0 - p) + p / torch.clamp(n.to(F32), min=1.0)


def speedup_f32(n, p):
    """Amdahl S(n) in float32; divisions are tensor/tensor so CUDA keeps
    IEEE division (a Python-scalar divisor becomes a reciprocal multiply)."""
    den = _amdahl_den(n, p)
    return torch.ones_like(den) / den


def rate_f32(n, p, ref):
    """``speedup_f32(n, p) / ref`` as XLA computes it for the JAX
    simulator: its algebraic simplifier turns ``(1 / den) / ref`` into
    ``1 / (den * ref)``, which otherwise rounds differently in the last
    bit."""
    den = _amdahl_den(n, p)
    return torch.ones_like(den) / (den * ref)


def _clip(x, lo, hi):
    """``jnp.clip``: ``min(max(x, lo), hi)`` (tensor or scalar bounds)."""
    return torch.clamp(x, lo, hi)


def _rowsum(x):
    return torch.sum(x, dim=-1, dtype=I32)


def _rowcumsum(x):
    return torch.cumsum(x, dim=-1, dtype=I32)


def first_true(mask):
    """Mask of the first True slot per lane (all-False lanes stay empty)."""
    return mask & (_rowcumsum(mask.to(I32)) == 1)


def priority_head(queued, on_demand):
    """Mask of the queue head under class priority: the first queued
    on-demand slot when any exists, else the first queued slot."""
    q_od = queued & on_demand
    return torch.where(q_od.any(dim=-1, keepdim=True), first_true(q_od),
                       first_true(queued & ~on_demand))


def queue_ranks(queued, on_demand=None):
    """1-based per-slot queue position (head == 1) in queue order: slot
    order without classes; with classes every queued on-demand slot ranks
    ahead of every other.  Non-queued slots get arbitrary ranks."""
    if on_demand is None:
        return _rowcumsum(queued.to(I32))
    q_od = queued & on_demand
    return torch.where(on_demand, _rowcumsum(q_od.to(I32)),
                       _rowsum(q_od)[..., None]
                       + _rowcumsum((queued & ~on_demand).to(I32)))


def queue_cumsum(amount, mask, on_demand=None):
    """Cumulative ``amount`` over ``mask`` slots in queue order: slot order
    without classes; with classes every on-demand slot accumulates before
    any other."""
    if on_demand is None:
        return _rowcumsum(torch.where(mask, amount, 0))
    a_od = torch.where(mask & on_demand, amount, 0)
    a_n = torch.where(mask & ~on_demand, amount, 0)
    return torch.where(on_demand, _rowcumsum(a_od),
                       _rowsum(a_od)[..., None] + _rowcumsum(a_n))


def take_desc_prefix(prio, amount, need, lo0: int, hi0: int):
    """Per-slot take with sum == min(need, sum(amount)), highest-prio first.

    ``lo0``/``hi0`` bound every slot with ``amount > 0``:
    ``lo0 < prio <= hi0``.  Ties break in slot (FCFS) order; the threshold
    is found by integer bisection instead of a sort.
    """
    lanes = prio.shape[:-1]
    lo = torch.full(lanes, lo0, dtype=I32, device=prio.device)
    hi = torch.full(lanes, hi0, dtype=I32, device=prio.device)
    s_hi = torch.zeros_like(need)
    for _ in range(bisect_rounds(lo0, hi0)):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        s = _rowsum(torch.where(prio > mid[..., None], amount, 0))
        ok = s <= need
        hi = torch.where(ok, mid, hi)
        s_hi = torch.where(ok, s, s_hi)
        lo = torch.where(ok, lo, mid)
    theta = hi[..., None]
    rem = (need - s_hi)[..., None]
    tie = prio == theta
    before = _rowcumsum(torch.where(tie, amount, 0))
    tie_take = torch.minimum(torch.clamp(rem - (before - amount), min=0),
                             amount)
    return torch.where(prio > theta, amount, torch.where(tie, tie_take, 0))


def give_asc_prefix(prio, room, idle, lo0: int, hi0: int):
    """Per-slot give with sum == min(idle, sum(room)), lowest-prio first."""
    return take_desc_prefix(-prio, room, idle, -hi0 - 1, -lo0 + 1)


def level_targets(level, mn, mx):
    """Integer allocation at relative level ``level`` in [0, 1]."""
    span = (mx - mn).to(F32)
    return mn + torch.floor(level * span + 1e-9).to(mn.dtype)


def shadow_reservation(est, release, free, head_floor,
                       iters: int = SHADOW_ITERS):
    """Sort-free EASY head reservation: ``(shadow, extra)`` per lane.

    ``est`` holds the running slots' walltime-padded end estimates (``inf``
    elsewhere), ``release`` their allocations.  ``shadow`` is the smallest
    estimate at which ``free + released-by-then >= head_floor``, found by
    bisecting time and snapping the upper bound onto estimate values.
    """
    neg = float("-inf")
    finite = torch.isfinite(est)
    rel = torch.where(finite, release, 0)
    need = head_floor - free

    def by(tau):  # slots released by time tau
        return finite & (est <= tau[..., None])

    hi = torch.where(finite, est, neg).amax(dim=-1)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        m = by(mid)
        ok = _rowsum(torch.where(m, rel, 0)) >= need
        snap = torch.where(m, est, neg).amax(dim=-1)
        hi = torch.where(ok, snap, hi)
        lo = torch.where(ok, lo, mid)
    extra = free + _rowsum(torch.where(by(hi), rel, 0)) - head_floor
    return hi, extra


def check_backend(expand_backend: str, device: torch.device) -> None:
    """Refuse backends the device cannot run: only ``bisect`` on the CPU."""
    if expand_backend not in EXPAND_BACKENDS:
        raise ValueError(f"unknown expand_backend {expand_backend!r}; "
                         f"choose from {EXPAND_BACKENDS}")
    if torch.device(device).type != "cuda" and expand_backend != "bisect":
        raise ValueError(
            f"expand_backend={expand_backend!r} launches a CUDA kernel; "
            "only 'bisect' runs on the CPU")


def resolve_backend(expand_backend: str, device) -> str:
    """``auto`` -> ``fused`` on cuda, ``bisect`` on the CPU; others checked."""
    if expand_backend == "auto":
        return "fused" if torch.device(device).type == "cuda" else "bisect"
    check_backend(expand_backend, device)
    return expand_backend


def schedule_tick(p: PassParams, state, alloc, remaining, start_t, act,
                  capacity, t_now, *, structure: str = "greedy",
                  fill_rounds: int, prio_lo: int, prio_hi: int,
                  span_max: int, shadow_iters: int = SHADOW_ITERS,
                  expand_backend: str = "bisect", backfill_depth=None,
                  with_classes: bool = False, with_sjf: bool = False,
                  pool_share=None, steal_margin=None):
    """One Steps-1..3 scheduling pass on queue-ordered slot tensors.

    Same contract as ``repro.core.passes.schedule_tick``: ``act`` masks
    slots eligible for state changes, ``capacity``/``t_now`` are per-lane,
    ``backfill_depth`` (per-lane or ``None``) bounds the EASY scan to the
    first ``depth`` queued candidates behind the head, and the static
    ``prio_lo``/``prio_hi`` bound ``alloc - prio_ref`` while ``span_max``
    bounds ``max_nodes - min_nodes``.  ``pool_share`` (f32) and
    ``steal_margin`` (i32) are per-lane parameters of the pooled and
    stealing structures.  Returns ``(state, alloc, start_t)``.

    ``with_sjf`` permutes every slot tensor by a stable argsort of
    ``p.sort_key``, runs the pass with ``with_sjf=False`` and restores
    slot order; per-lane tensors are not permuted.  ``act`` is broadcast
    to the slots and permuted, except when it is one flag a lane (a
    trailing axis of 1), which every permutation leaves as it is.  An
    FCFS lane's key is monotone, so its permutation is the identity.
    """
    if structure not in STRUCTURES:
        raise ValueError(f"unknown pass structure {structure!r}")
    check_backend(expand_backend, state.device)
    if with_sjf:
        perm = torch.argsort(p.sort_key, dim=-1, stable=True)
        inv = torch.empty_like(perm).scatter_(
            -1, perm, torch.arange(perm.shape[-1], device=perm.device)
            .expand_as(perm))

        def fwd(a):
            return torch.gather(a, -1, perm)

        def rev(a):
            return torch.gather(a, -1, inv)

        per_lane = act.dim() == state.dim() and act.shape[-1] == 1
        out = schedule_tick(
            PassParams(*(None if f is None else fwd(f) for f in p)),
            fwd(state), fwd(alloc), fwd(remaining), fwd(start_t),
            act if per_lane else fwd(act.expand(state.shape)), capacity,
            t_now, structure=structure, fill_rounds=fill_rounds,
            prio_lo=prio_lo, prio_hi=prio_hi, span_max=span_max,
            shadow_iters=shadow_iters, expand_backend=expand_backend,
            backfill_depth=backfill_depth, with_classes=with_classes,
            with_sjf=False, pool_share=pool_share,
            steal_margin=steal_margin)
        return tuple(rev(a) for a in out)
    if (expand_backend == "fused" and structure == "greedy"
            and not with_classes):
        from repro_torch.kernels.schedule_tick import fused_schedule_tick
        return fused_schedule_tick(
            p, state, alloc, remaining, start_t, act, capacity, t_now,
            fill_rounds=fill_rounds, prio_lo=prio_lo, prio_hi=prio_hi,
            shadow_iters=shadow_iters, backfill_depth=backfill_depth)
    return plain_tick(
        p, state, alloc, remaining, start_t, act, capacity, t_now,
        structure=structure, fill_rounds=fill_rounds, prio_lo=prio_lo,
        prio_hi=prio_hi, span_max=span_max, shadow_iters=shadow_iters,
        waterfill_give=expand_backend != "bisect",
        backfill_depth=backfill_depth, with_classes=with_classes,
        pool_share=pool_share, steal_margin=steal_margin)


def plain_tick(p: PassParams, state, alloc, remaining, start_t, act,
               capacity, t_now, *, structure: str, fill_rounds: int,
               prio_lo: int, prio_hi: int, span_max: int,
               shadow_iters: int = SHADOW_ITERS,
               waterfill_give: bool = False, backfill_depth=None,
               with_classes: bool = False, pool_share=None,
               steal_margin=None):
    """The pass in plain PyTorch, over slots already in queue order.

    ``waterfill_give`` routes the greedy Step-3 give through the CUDA
    prefix-waterfill kernel in sorted priority order.  Without
    ``with_classes`` every class-aware helper takes its class-free form.
    """
    inf = float("inf")
    balanced = structure == "balanced"
    level_iters = int(math.ceil(math.log2(span_max + 2))) + 1
    tn = t_now[..., None]
    od = p.on_demand if with_classes else None

    def head(queued):
        return first_true(queued) if od is None else priority_head(queued,
                                                                   od)

    running = state == RUNNING
    free = capacity - _rowsum(torch.where(running, alloc, 0))

    # -- Step 1: queue prefix + head fallback -----------------------------
    queued = (state == QUEUED) & act
    if od is None:
        cumw = _rowcumsum(torch.where(queued, p.want, 0))
        s1 = queued & (cumw <= free[..., None])
        used = torch.where(s1, cumw, 0).amax(dim=-1)
        leftover = free - used
    else:
        # queued on-demand slots start first; the others join the prefix
        # only once every queued on-demand job has started
        q_od = queued & od
        cumw_od = _rowcumsum(torch.where(q_od, p.want, 0))
        s1o = q_od & (cumw_od <= free[..., None])
        all_od = ~(q_od & ~s1o).any(dim=-1)
        rem = free - torch.where(s1o, cumw_od, 0).amax(dim=-1)
        q_n = queued & ~od
        cumw_n = _rowcumsum(torch.where(q_n, p.want, 0))
        s1 = s1o | (q_n & (cumw_n <= rem[..., None]) & all_od[..., None])
        leftover = rem - torch.where(s1 & ~od, cumw_n, 0).amax(dim=-1)
    h_mask = head(queued & ~s1)
    hfloor = _rowsum(torch.where(h_mask, p.floor, 0))
    hwant = _rowsum(torch.where(h_mask, p.want, 0))
    h_ok = (hfloor > 0) & (hfloor <= leftover)
    h_alloc = _clip(leftover, hfloor, hwant)

    h_upd = h_mask & h_ok[..., None]
    started = s1 | h_upd
    alloc = torch.where(s1, p.want, alloc)
    alloc = torch.where(h_upd, h_alloc[..., None], alloc)
    state = torch.where(started, RUNNING, state)
    start_t = torch.where(started, tn, start_t)
    free = leftover - torch.where(h_ok, h_alloc, 0)

    # -- EASY backfill under the head's shadow-time reservation -----------
    queued = (state == QUEUED) & act
    h_mask = head(queued)
    hfloor = _rowsum(torch.where(h_mask, p.floor, 0))
    hwant = _rowsum(torch.where(h_mask, p.want, 0))
    has_head = hfloor > 0
    if backfill_depth is None:
        depth_ok = True
    else:
        # rank cutoff over the queue snapshot at scan entry: the head
        # holds rank 1, candidates 1..depth behind it ranks 2..depth+1
        depth_ok = queue_ranks(queued, od) <= backfill_depth[..., None] + 1
    run = state == RUNNING
    est = torch.where(
        run, tn + remaining * p.wall_work / speedup_f32(alloc, p.pfrac), inf)
    sh_b, ex_b = shadow_reservation(est, alloc, free, hfloor,
                                    iters=shadow_iters)
    blocked = has_head & (hfloor > free)
    shadow = torch.where(blocked, sh_b,
                         torch.where(has_head, t_now, inf))
    extra = torch.where(blocked, ex_b,
                        torch.where(has_head, free - hfloor, free))

    def cumfit(amount, mask, lim):
        cum = queue_cumsum(amount, mask, od)
        s = mask & (cum <= lim[..., None])
        return s, torch.where(s, cum, 0).amax(dim=-1)

    tfit = (tn + p.wall_work / speedup_f32(p.want, p.pfrac)
            <= shadow[..., None] + _SHADOW_EPS)
    for _ in range(fill_rounds):
        cand = (state == QUEUED) & act & ~h_mask & depth_ok
        # (a) finishes before the reservation: free nodes only
        s, take1 = cumfit(p.want, cand & tfit & (p.want <= free[..., None]),
                          free)
        free = free - take1
        # (b) runs past the reservation: spare-node pool, at want
        lim = torch.minimum(free, extra)
        s2, take2 = cumfit(p.want,
                           cand & ~s & ~tfit & (p.want <= lim[..., None]),
                           lim)
        # (c) spare-node pool at floor (want did not fit)
        lim3 = torch.minimum(free - take2, extra - take2)
        s3, take3 = cumfit(
            p.floor, cand & ~s & ~s2 & ~tfit & (p.floor <= lim3[..., None]),
            lim3)
        free = free - take2 - take3
        extra = extra - take2 - take3
        new = s | s2 | s3
        alloc = torch.where(s | s2, p.want,
                            torch.where(s3, p.floor, alloc))
        state = torch.where(new, RUNNING, state)
        start_t = torch.where(new, tn, start_t)

    # -- Step 2: shrink running malleable jobs to admit the head ----------
    deficit = torch.where(has_head, hfloor - free, 0)
    shrinkable = (state == RUNNING) & p.malleable
    fl = torch.where(shrinkable, torch.minimum(p.shrink_floor, alloc), alloc)
    surplus = torch.clamp(alloc - fl, min=0)
    tot_surplus = _rowsum(surplus)
    need = torch.where((deficit > 0) & (tot_surplus >= deficit), deficit, 0)

    if balanced:
        mn_eff = torch.where(shrinkable, fl, alloc)
        mx_eff = torch.where(shrinkable, p.max_nodes, alloc)
        lo = torch.zeros(need.shape, dtype=F32, device=need.device)
        hi = torch.ones_like(lo)
        freed_lo = tot_surplus
        for _ in range(level_iters):
            mid = 0.5 * (lo + hi)
            tgt = torch.minimum(alloc,
                                level_targets(mid[..., None], mn_eff, mx_eff))
            freed = _rowsum(alloc - tgt)
            ok = freed >= need
            lo = torch.where(ok, mid, lo)
            hi = torch.where(ok, hi, mid)
            freed_lo = torch.where(ok, freed, freed_lo)
        tgt = torch.minimum(alloc,
                            level_targets(lo[..., None], mn_eff, mx_eff))
        # return integer-rounding excess to the most-shrunk jobs
        delta = alloc - tgt
        give = give_asc_prefix(-delta, delta, freed_lo - need,
                               -span_max - 1, 0)
        alloc = alloc - (delta - give)
    else:
        prio = _clip(alloc - p.prio_ref, prio_lo, prio_hi)
        alloc = alloc - take_desc_prefix(prio, surplus, need,
                                         prio_lo - 1, prio_hi)
    free = free + need  # the take sums to exactly `need` by construction

    h_ok = has_head & (hfloor <= free)
    h_alloc = _clip(free, hfloor, hwant)
    h_upd = h_mask & h_ok[..., None]
    alloc = torch.where(h_upd, h_alloc[..., None], alloc)
    state = torch.where(h_upd, RUNNING, state)
    start_t = torch.where(h_upd, tn, start_t)
    free = free - torch.where(h_ok, h_alloc, 0)

    # -- Step 2b: the pooled / stealing structure's extra pass ------------
    if structure == "pooled":
        # running malleable jobs' surplus above preferred is a common pool;
        # queued malleable candidates behind the head start at their floor
        # from it in queue order, and donors shrink back toward preferred
        run_m = (state == RUNNING) & p.malleable
        over_pref = torch.where(
            run_m, torch.clamp(alloc - p.pref_nodes, min=0), 0)
        pool_amt = _rowsum(over_pref)
        share = 1.0 if pool_share is None else pool_share
        # f32 product truncated to int32, as XLA converts it
        budget = torch.minimum((share * pool_amt.to(F32)).to(I32), pool_amt)
        q_pool = (state == QUEUED) & act
        cand = q_pool & p.malleable & ~head(q_pool)
        cumf = queue_cumsum(p.floor, cand, od)
        sp = cand & (cumf <= budget[..., None])
        taken = torch.where(sp, cumf, 0).amax(dim=-1)
        pr = _clip(alloc - p.prio_ref, prio_lo, prio_hi)
        alloc = alloc - take_desc_prefix(pr, over_pref, taken,
                                         prio_lo - 1, prio_hi)
        alloc = torch.where(sp, p.floor, alloc)
        state = torch.where(sp, RUNNING, state)
        start_t = torch.where(sp, tn, start_t)
    elif structure == "stealing":
        # over-average running malleable jobs (beyond the margin) donate
        # their surplus above max(average, shrink floor), highest priority
        # first; under-average ones take up to min(average, max_nodes),
        # lowest priority first
        run_m = (state == RUNNING) & p.malleable
        n_run = _rowsum(run_m)
        avg = torch.div(_rowsum(torch.where(run_m, alloc, 0)),
                        torch.clamp(n_run, min=1), rounding_mode="floor")
        margin = 0 if steal_margin is None else steal_margin
        sfl = torch.where(run_m, torch.minimum(p.shrink_floor, alloc), alloc)
        donor = run_m & (alloc > (avg + margin)[..., None])
        donor_amt = torch.where(
            donor, torch.clamp(alloc - torch.maximum(avg[..., None], sfl),
                               min=0), 0)
        taker_room = torch.where(
            run_m, torch.clamp(torch.minimum(avg[..., None], p.max_nodes)
                               - alloc, min=0), 0)
        transfer = torch.minimum(_rowsum(donor_amt), _rowsum(taker_room))
        pr = _clip(alloc - p.prio_ref, prio_lo, prio_hi)
        alloc = (alloc
                 - take_desc_prefix(pr, donor_amt, transfer,
                                    prio_lo - 1, prio_hi)
                 + give_asc_prefix(pr, taker_room, transfer,
                                   prio_lo - 1, prio_hi))

    # -- Step 3: expand into remaining idle nodes -------------------------
    expandable = (state == RUNNING) & p.malleable
    idle = torch.clamp(torch.where(expandable.any(dim=-1), free, 0), min=0)
    if balanced:
        mn_eff = torch.where(expandable, p.min_nodes, alloc)
        cap_eff = torch.where(expandable, p.max_nodes, alloc)
        room_tot = _rowsum(torch.clamp(cap_eff - alloc, min=0))
        idle_eff = torch.minimum(idle, room_tot)
        lo = torch.zeros(idle.shape, dtype=F32, device=idle.device)
        hi = torch.ones_like(lo)
        used_lo = torch.zeros_like(idle_eff)
        for _ in range(level_iters):
            mid = 0.5 * (lo + hi)
            tgt = torch.maximum(alloc, torch.minimum(
                level_targets(mid[..., None], mn_eff, cap_eff), cap_eff))
            spent = _rowsum(tgt - alloc)
            ok = spent <= idle_eff
            lo = torch.where(ok, mid, lo)
            hi = torch.where(ok, hi, mid)
            used_lo = torch.where(ok, spent, used_lo)
        tgt = torch.maximum(alloc, torch.minimum(
            level_targets(lo[..., None], mn_eff, cap_eff), cap_eff))
        # hand the leftover to the least-utilized jobs (2^-16 levels)
        span = torch.clamp(cap_eff - mn_eff, min=1)
        balance_q = torch.div((tgt - mn_eff) * 65536, span,
                              rounding_mode="floor")
        room = torch.clamp(cap_eff - tgt, min=0)
        alloc = tgt + give_asc_prefix(balance_q, room, idle_eff - used_lo,
                                      -1, 65537)
    else:
        room = torch.where(expandable,
                           torch.clamp(p.max_nodes - alloc, min=0), 0)
        pr = _clip(alloc - p.prio_ref, prio_lo, prio_hi)
        if waterfill_give:
            from repro_torch.kernels.waterfill import greedy_give_waterfill
            give = greedy_give_waterfill(pr, room, idle)
        else:
            give = give_asc_prefix(pr, room, idle, prio_lo - 1, prio_hi)
        alloc = alloc + give
    return state, alloc, start_t
