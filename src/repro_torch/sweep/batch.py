"""Event-stepped batched scheduling engine for sweep grids, in PyTorch.

The port of ``repro.sweep.batch``: many (strategy, proportion, seed --
and workload) lanes of the paper's grid advance in lockstep on one device.
The scheduling pass itself is :func:`repro_torch.core.passes.schedule_tick`,
for every structure of the strategy registry (a batch holds one), with the
on-demand queue priority and the SJF queue order switched on by the lane
statics ``with_classes`` / ``with_sjf`` (:func:`lane_statics`).  This module
owns the simulation substrate, with the JAX engine's semantics:

1. **Event-quantized steps.**  Each scan step jumps a lane to the tick of
   its next submission or completion; a pass that changed state while jobs
   stayed queued re-triggers the next tick (``retrig``).
2. **Active-set windowing over a bucketed ladder.**  Every ``chunk`` steps
   each lane's queued + running jobs plus a prefetch reserve of upcoming
   arrivals are compacted into a ``W``-slot window in FCFS order; ``W``
   walks the power-of-two ladder of :func:`window_ladder`, escalating when
   the active set would not fit (or no lane advanced) and de-escalating with
   hysteresis onto rungs already run.
3. **Event compression.**  A step retires up to ``events`` per-lane events
   whose scheduling pass is provably a no-op before its one pass, so
   results are bit-identical for any ``events``.
4. **Multi-trace padded batching.**  ``capacity``/``tick`` are lane data and
   shorter traces are padded with never-arriving jobs (:func:`concat_lanes`).

The JAX scan over ``K`` steps is a Python loop here; no step waits on the
host (the JAX engine's ``lax.cond`` skips are per-lane value identities and
run unconditionally), so the host synchronises once per chunk, to pick the
next window.  JAX drops out-of-bounds scatter writes silently and
``torch.scatter_`` raises, so compaction and scatter-back write into one
spare column that is sliced off.

Job arrays stay in submit-sorted order; ``compile_s``, ``retraces`` and
``compile_variants`` are kept as execution-only fields and are 0 (PyTorch
runs eagerly).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.jobs import DONE, PENDING, QUEUED, RUNNING, Workload
from repro_torch.core.passes import (PassParams, resolve_backend,
                                     schedule_tick, speedup_f32,
                                     start_policies)
from repro_torch.core.scenario import DEFAULT_BACKFILL_DEPTH
from repro_torch.core.speedup import (TransformConfig, amdahl_speedup,
                                      batched_malleable_params)
from repro_torch.core.strategies import Strategy, effective_queue_order

# Bump when engine semantics change: invalidates the port's cache entries.
# v1: the JAX engine's v4 semantics (shadow-time EASY backfill with a depth
# cutoff, per-lane capacity/tick, multi-trace batching, event compression),
# for every structure, job-class mix and queue order.
ENGINE_VERSION = 1

_TICK_EPS = 1e-6   # ceil guard, matches the DES event quantization
_REM_EPS = 1e-5    # remaining-work completion threshold (fraction of job)
_I32_MAX = 2 ** 31 - 1

I32, F32 = torch.int32, torch.float32


class SweepEngineError(RuntimeError):
    """The engine cannot make progress even at the maximum window size."""


class BatchedLanes(NamedTuple):
    """Fixed-shape lane batch: one lane per (workload, strategy, prop, seed).

    Jobs are sorted by submission time so index == FCFS rank; padding slots
    carry ``submit == +inf`` and never arrive.
    """

    submit: torch.Tensor        # f32 (B, n) ascending; +inf on padding
    malleable: torch.Tensor     # bool (B, n)
    min_nodes: torch.Tensor     # i32 (B, n)
    max_nodes: torch.Tensor     # i32 (B, n)
    pfrac: torch.Tensor         # f32 (B, n)
    inv_ref: torch.Tensor       # f32 (B, n): 1 / (S(nodes_req) * runtime)
    wall_work: torch.Tensor     # f32 (B, n): walltime * S(nodes_req)
    want: torch.Tensor          # i32 (B, n) start-pass target allocation
    floor: torch.Tensor         # i32 (B, n) smallest start allocation
    shrink_floor: torch.Tensor  # i32 (B, n) smallest Step-2 allocation
    prio_ref: torch.Tensor      # i32 (B, n): greedy priority = alloc - ref
    on_demand: torch.Tensor     # bool (B, n) queue-priority class
    pref_nodes: torch.Tensor    # i32 (B, n) preferred allocation
    sort_key: torch.Tensor      # f32 (B, n) queue-order key
    capacity: torch.Tensor      # i32 (B,) cluster nodes of the lane
    tick: torch.Tensor          # f32 (B,) scheduling granularity
    backfill_depth: torch.Tensor  # i32 (B,) EASY scan bound
    pool_share: torch.Tensor    # f32 (B,) shared-pool fraction
    steal_margin: torch.Tensor  # i32 (B,) slack above average

    @property
    def n_lanes(self) -> int:
        return self.malleable.shape[0]

    @property
    def n_jobs(self) -> int:
        return self.malleable.shape[1]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    structure: str = "greedy"   # greedy | balanced | pooled | stealing
    window: int = 0             # ladder floor; 0 = start at the rung that
                                # covers the lane-statics peak-active bound
    chunk: int = 160            # scan steps between compactions
    fill_rounds: int = 2        # shadow-backfill fill rounds per pass
    reserve_slack: int = 64     # min arrival-prefetch slots in the window
    max_steps_factor: int = 16  # step budget = factor * n_jobs + 2048
    expand_backend: str = "auto"  # fused | waterfill | bisect; auto =
                                  # fused on cuda, bisect on the CPU
    events: int = 4             # max per-lane events retired per scan step


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def build_lanes(
    workload: Workload,
    cluster_nodes: int,
    lanes: Sequence[Tuple[Strategy, float, int]],
    config: TransformConfig = TransformConfig(),
    tick: float = 1.0,
    backfill_depth: int = DEFAULT_BACKFILL_DEPTH,
    queue_order: str = "fcfs",
    device=None,
) -> Tuple[BatchedLanes, np.ndarray]:
    """Stack (strategy, proportion, seed) lanes into tensors on ``device``.

    All malleable strategies in ``lanes`` must share one pass structure.
    Returns the batch plus ``order``, the submit-sort permutation.
    """
    dev = resolve_device(device)
    if len({s.structure for s, _, _ in lanes if s.malleable}) > 1:
        raise ValueError(
            "lanes mix engine pass structures (greedy/balanced/pooled/"
            "stealing); group lanes by strategy.structure")
    order = np.argsort(workload.submit, kind="stable")
    w = workload.take(order)
    params = batched_malleable_params(
        w, [(prop, seed) for _, prop, seed in lanes], cluster_nodes, config)

    B = len(lanes)
    n = w.n_jobs
    req = np.tile(w.nodes_req, (B, 1))
    mall = params["malleable"]
    mn, mx = params["min_nodes"], params["max_nodes"]
    pref, pfrac = params["pref_nodes"], params["pfrac"]

    want = np.empty_like(req)
    floor = np.empty_like(req)
    sfloor = np.empty_like(req)
    prio_ref = np.empty_like(req)
    sort_key = np.empty((B, n), np.float32)
    pool_share = np.empty((B,), np.float32)
    steal_margin = np.empty((B,), np.int32)
    fcfs_key = np.arange(n, dtype=np.float32)  # monotone: identity perm
    for b, (strat, _, _) in enumerate(lanes):
        if not strat.malleable:
            mall[b] = False
            mn[b] = mx[b] = req[b]
        want[b], floor[b], sfloor[b], prio_ref[b] = start_policies(
            strat, mall[b], mn[b], pref[b], req[b])
        sjf = effective_queue_order(strat, queue_order) == "sjf"
        sort_key[b] = w.walltime if sjf else fcfs_key
        pool_share[b] = strat.pool_share
        steal_margin[b] = strat.steal_margin

    s_ref = amdahl_speedup(req, pfrac)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a).astype(dtype))).to(dev)

    batch = BatchedLanes(
        submit=t(np.tile(w.submit, (B, 1)), np.float32),
        malleable=t(mall, np.bool_),
        min_nodes=t(mn, np.int32),
        max_nodes=t(mx, np.int32),
        pfrac=t(pfrac, np.float32),
        inv_ref=t(1.0 / (s_ref * w.runtime[None, :]), np.float32),
        wall_work=t(w.walltime[None, :] * s_ref, np.float32),
        want=t(want, np.int32),
        floor=t(floor, np.int32),
        shrink_floor=t(sfloor, np.int32),
        prio_ref=t(prio_ref, np.int32),
        on_demand=t(np.tile(w.on_demand, (B, 1)), np.bool_),
        pref_nodes=t(pref, np.int32),
        sort_key=t(sort_key, np.float32),
        capacity=t(np.full((B,), int(cluster_nodes)), np.int32),
        tick=t(np.full((B,), float(tick)), np.float32),
        backfill_depth=t(np.full((B,), int(backfill_depth)), np.int32),
        pool_share=t(pool_share, np.float32),
        steal_margin=t(steal_margin, np.int32),
    )
    return batch, order


_PAD_FILL = {
    "submit": float("inf"), "malleable": False, "min_nodes": 1,
    "max_nodes": 1, "pfrac": 0.0, "inv_ref": 1.0, "wall_work": 1.0,
    "want": 1, "floor": 1, "shrink_floor": 1, "prio_ref": 0,
    "on_demand": False, "pref_nodes": 1,
    "sort_key": float("inf"),  # padding sorts behind every real job
}


def concat_lanes(batches: Sequence[BatchedLanes]) -> BatchedLanes:
    """Concatenate lane batches of *different* workloads into one batch.

    Shorter traces are right-padded with never-arriving jobs; per-lane
    results are bit-identical to each workload's batch run alone.
    """
    n_max = max(b.n_jobs for b in batches)

    def pad(name, arr, n):
        if arr.ndim == 1 or n == n_max:  # (B,) per-lane fields need no pad
            return arr
        fill = torch.full((arr.shape[0], n_max - n), _PAD_FILL[name],
                          dtype=arr.dtype, device=arr.device)
        return torch.cat([arr, fill], dim=1)

    return BatchedLanes(*[
        torch.cat([pad(name, getattr(b, name), b.n_jobs) for b in batches],
                  dim=0)
        for name in BatchedLanes._fields
    ])


def take_lanes(batch: BatchedLanes, lo: int, hi: int) -> BatchedLanes:
    """Slice a contiguous lane range ``[lo, hi)`` out of a batch."""
    return BatchedLanes(*[getattr(batch, name)[lo:hi]
                          for name in BatchedLanes._fields])


def pad_lanes(batch: BatchedLanes, width: int) -> BatchedLanes:
    """Right-pad a batch to ``width`` lanes by repeating its first lane."""
    b = batch.n_lanes
    if width < b:
        raise ValueError(f"cannot pad {b} lanes down to {width}")
    if width == b:
        return batch
    idx = torch.cat([torch.arange(b), torch.zeros(width - b,
                                                  dtype=torch.int64)])
    idx = idx.to(batch.submit.device)
    return BatchedLanes(*[getattr(batch, name).index_select(0, idx)
                          for name in BatchedLanes._fields])


def _peak_active_bound(batch: BatchedLanes) -> int:
    """Lower bound on the largest per-lane peak active (queued+running) set:
    the max of the no-wait interval-overlap peak and the fluid backlog peak
    (arrivals minus the most completions the cluster's node-seconds budget
    could have served).  Only guides the starting window rung."""
    submit = _np(batch.submit).astype(np.float64)
    finite = np.isfinite(submit)
    if not np.any(finite):
        return 0
    inv_ref = _np(batch.inv_ref).astype(np.float64)
    pfrac = _np(batch.pfrac).astype(np.float64)
    mx = np.maximum(_np(batch.max_nodes).astype(np.float64), 1.0)
    s_max = 1.0 / ((1.0 - pfrac) + pfrac / mx)
    dur_min = 1.0 / np.maximum(inv_ref * s_max, 1e-30)

    # (a) no-wait interval overlap peak (+1 at submit, -1 at earliest end)
    t_pts = np.concatenate(
        [np.where(finite, submit, np.inf),
         np.where(finite, submit + dur_min, np.inf)], axis=1)
    delta = np.concatenate(
        [finite.astype(np.int64), -finite.astype(np.int64)], axis=1)
    order = np.argsort(t_pts, axis=1, kind="stable")
    overlap = int(np.max(np.cumsum(
        np.take_along_axis(delta, order, axis=1), axis=1)))

    # (b) fluid backlog: arrivals minus node-seconds-capped completions
    cap = _np(batch.capacity).astype(np.float64)[:, None]
    ns_min = np.where(finite, 1.0 / np.maximum(inv_ref, 1e-30), np.inf)
    ns_sorted = np.sort(ns_min, axis=1)
    cum_ns = np.cumsum(np.where(np.isfinite(ns_sorted), ns_sorted, 0.0),
                       axis=1)
    sub_sorted = np.sort(np.where(finite, submit, np.inf), axis=1)
    t0 = sub_sorted[:, :1]
    budget = np.where(np.isfinite(sub_sorted),
                      cap * (sub_sorted - t0), np.inf)
    backlog = 0
    arrived = np.arange(1, budget.shape[1] + 1)
    for b in range(budget.shape[0]):
        real = np.isfinite(sub_sorted[b])
        if not np.any(real):
            continue
        done_max = np.searchsorted(cum_ns[b], budget[b], side="right")
        backlog = max(backlog, int(np.max((arrived - done_max)[real])))
    return max(overlap, backlog)


def lane_statics(batch: BatchedLanes) -> Dict[str, int]:
    """Batch-level static parameters derived from lane data: the priority
    and level-bisection bounds, the class / queue-order flags, the smallest
    depth and the peak-active bound that picks the starting window."""
    sk = _np(batch.sort_key).astype(np.float64)
    sk = np.where(np.isfinite(sk), sk, np.finfo(np.float64).max)
    prio_ref = _np(batch.prio_ref)
    max_nodes = _np(batch.max_nodes)
    return {
        "prio_lo": -int(np.max(prio_ref)),
        "prio_hi": int(np.max(max_nodes - prio_ref)),
        "span_max": int(np.max(max_nodes - _np(batch.min_nodes))),
        "with_classes": bool(np.any(_np(batch.on_demand))),
        "with_sjf": bool(np.any(np.diff(sk, axis=-1) < 0)),
        "min_depth": int(np.min(_np(batch.backfill_depth))),
        "peak_active": _peak_active_bound(batch),
    }


def window_ladder(floor: int, n: int) -> Tuple[int, ...]:
    """The window-bucket menu: ``floor * 2^k`` capped at ``n``."""
    floor = max(1, min(floor, n))
    rungs = [floor]
    while rungs[-1] < n:
        rungs.append(min(2 * rungs[-1], n))
    return tuple(rungs)


def _ladder_cover(ladder: Tuple[int, ...], need: int) -> int:
    """Smallest rung >= ``need`` (the top rung when none is)."""
    for w in ladder:
        if w >= need:
            return w
    return ladder[-1]


@torch.inference_mode()
def simulate_lanes(batch: BatchedLanes, cfg: EngineConfig,
                   verbose: bool = False,
                   statics: Optional[Dict[str, int]] = None
                   ) -> Dict[str, np.ndarray]:
    """Run every lane to completion; returns per-job outcomes + timeline.

    Output dict (numpy, job axes in submit-sorted order), key-for-key with
    ``repro.sweep.batch.simulate_lanes``: ``state, alloc, start_t, end_t,
    expand_ops, shrink_ops`` (B, n); ``trace_t, trace_busy, trace_qlen``
    (B, S) event-step timeline (``trace_busy[k]`` holds on
    ``[trace_t[k], trace_t[k+1])``; repeated timestamps are zero-width);
    ``bf_starts, sched_steps`` (B,); ``steps, window, finished``; and the
    execution-only ``compile_s, execute_s, compile_variants, retraces,
    warm_hits, escalations, compressed_events``.  Lanes unfinished when the
    step budget runs out keep ``end_t = nan``.
    """
    n, B = batch.n_jobs, batch.n_lanes
    dev = batch.submit.device
    backend = resolve_backend(cfg.expand_backend, dev)
    st = lane_statics(batch) if statics is None else statics
    prio_lo, prio_hi = st["prio_lo"], st["prio_hi"]
    span_max = st["span_max"]
    min_depth = st["min_depth"]
    ladder = window_ladder(int(cfg.window or 128), n)
    predicted = _ladder_cover(
        ladder, min(int(st.get("peak_active", 0)) + cfg.reserve_slack, n))
    W0 = ladder[0] if cfg.window else predicted
    W = W0

    real = torch.isfinite(batch.submit)  # padding slots are born DONE
    full = dict(
        state=torch.where(real, PENDING, DONE).to(I32),
        alloc=torch.zeros((B, n), dtype=I32, device=dev),
        remaining=torch.where(real, 1.0, 0.0).to(F32),
        start_t=torch.full((B, n), float("nan"), dtype=F32, device=dev),
        end_t=torch.full((B, n), float("nan"), dtype=F32, device=dev),
        expand_ops=torch.zeros((B, n), dtype=I32, device=dev),
        shrink_ops=torch.zeros((B, n), dtype=I32, device=dev),
    )
    counters = dict(
        k=torch.full((B,), -1, dtype=I32, device=dev),  # last tick index
        retrig=torch.zeros((B,), dtype=torch.bool, device=dev),
        bf=torch.zeros((B,), dtype=I32, device=dev),    # backfill starts
        nact=torch.zeros((B,), dtype=I32, device=dev),  # processed ticks
        ncomp=torch.zeros((B,), dtype=I32, device=dev),  # compressed events
    )

    traces: List[Tuple[np.ndarray, ...]] = []
    steps = 0
    w_peak = W
    low_streak = 0
    escalations = 0
    execute_s = 0.0
    ran = set()  # rungs already run: the port's "compiled" rungs

    def escalate(need):
        nonlocal W, low_streak, escalations
        W = _ladder_cover(ladder, min(need, n))
        low_streak = 0
        escalations += 1

    max_steps = cfg.max_steps_factor * n + 2048
    while steps < max_steps:
        active = (full["state"] == QUEUED) | (full["state"] == RUNNING)
        n_active = int(active.sum(dim=-1).max())
        need = n_active + cfg.reserve_slack
        if need > W and W < n:
            escalate(need)
            if verbose:
                print(f"[sweep.batch] active={n_active} -> window W={W}")
        elif W > W0 and need <= W // 2:
            low_streak += 1
            if low_streak >= 2:
                down = [w for w in ladder
                        if W0 <= w < W and w >= need and w in ran]
                if down:
                    W, low_streak = min(down), 0
        else:
            low_streak = 0
        w_peak = max(w_peak, W)
        ran.add(W)

        k_before = counters["k"].clone()
        t_call = time.monotonic()
        full, counters, ys, all_done = _chunk(
            batch, full, counters, W=W, cfg=cfg, prio_lo=prio_lo,
            prio_hi=prio_hi, span_max=span_max,
            depth_bounded=min_depth < W, backend=backend,
            with_classes=st["with_classes"], with_sjf=st["with_sjf"])
        traces.append(tuple(_np(y) for y in ys))
        done_now = bool(all_done)
        execute_s += time.monotonic() - t_call
        steps += cfg.chunk
        if done_now:
            break
        if torch.equal(k_before, counters["k"]):
            # nothing advanced: every lane is frozen waiting for arrivals
            # that do not fit -> the window must grow
            if W >= n:
                raise SweepEngineError(
                    "engine stalled with the window at the full job count")
            escalate(2 * W)

    out = {kk: _np(v) for kk, v in full.items()}
    out["trace_t"] = np.concatenate([t for t, _, _ in traces], axis=1)
    out["trace_busy"] = np.concatenate([b for _, b, _ in traces], axis=1)
    out["trace_qlen"] = np.concatenate([q for _, _, q in traces], axis=1)
    out["bf_starts"] = _np(counters["bf"])
    out["sched_steps"] = _np(counters["nact"])
    out["steps"] = steps
    out["window"] = w_peak
    out["finished"] = bool(np.all(out["state"] == DONE))
    out["compile_s"] = 0.0
    out["execute_s"] = execute_s
    out["compile_variants"] = 0
    out["retraces"] = 0
    out["warm_hits"] = 0
    out["escalations"] = escalations
    out["compressed_events"] = int(np.sum(_np(counters["ncomp"])))
    return out


def _f32_to_i32(x):
    """float32 -> int32 saturating at the top (XLA's conversion of ``inf``)."""
    return torch.where(x >= 2.0 ** 31, _I32_MAX,
                       torch.clamp(x, min=-2.0 ** 31).to(I32))


def _rowsum(x):
    return torch.sum(x, dim=-1, dtype=I32)


def _chunk(batch: BatchedLanes, full, counters, *, W: int, cfg: EngineConfig,
           prio_lo: int, prio_hi: int, span_max: int, depth_bounded: bool,
           backend: str, with_classes: bool, with_sjf: bool):
    """Compaction + ``cfg.chunk`` scan steps + scatter-back for one window.

    ``with_classes`` / ``with_sjf`` are the batch's lane statics: they turn
    on the pass's on-demand queue priority and queue-order permutation.

    Returns ``(full, counters, (trace_t, trace_busy, trace_qlen), all_done)``
    with the three trace tensors ``(B, chunk * events)``.
    """
    B, n = batch.submit.shape
    dev = batch.submit.device
    K = cfg.chunk
    E = max(1, int(cfg.events))
    inf = float("inf")

    state = full["state"]
    active = (state == QUEUED) | (state == RUNNING)
    n_active = _rowsum(active)
    pending = state == PENDING
    ar = torch.arange(n, dtype=I32, device=dev)[None, :]
    # first still-pending slot (n when everything arrived)
    aptr = torch.where(pending, ar, n).amin(dim=-1)

    # -- compact active + arrival reserve into W slots (FCFS order) -------
    reserve = torch.clamp(W - n_active, min=0)
    sel = active | (pending & (ar < (aptr + reserve)[:, None]))
    pos = torch.cumsum(sel, dim=-1, dtype=I32) - 1
    pos = torch.where(sel & (pos < W), pos, W)  # column W: spare, sliced off
    idx = torch.full((B, W + 1), n, dtype=I32, device=dev).scatter_(
        1, pos.long(), ar.expand(B, n))[:, :W]
    slot_ok = idx < n
    gidx = torch.clamp(idx, max=n - 1).long()

    def g2(a, fill):
        return torch.where(slot_ok, torch.gather(a, 1, gidx), fill)

    bj = BatchedLanes(
        submit=g2(batch.submit, inf),
        malleable=g2(batch.malleable, False),
        min_nodes=g2(batch.min_nodes, 1),
        max_nodes=g2(batch.max_nodes, 1),
        pfrac=g2(batch.pfrac, 0.0),
        inv_ref=g2(batch.inv_ref, 1.0),
        wall_work=g2(batch.wall_work, 1.0),
        want=g2(batch.want, 1),
        floor=g2(batch.floor, 1),
        shrink_floor=g2(batch.shrink_floor, 1),
        prio_ref=g2(batch.prio_ref, 0),
        on_demand=g2(batch.on_demand, False),
        pref_nodes=g2(batch.pref_nodes, 1),
        sort_key=g2(batch.sort_key, inf),
        capacity=batch.capacity, tick=batch.tick,
        backfill_depth=batch.backfill_depth,
        pool_share=batch.pool_share, steal_margin=batch.steal_margin,
    )
    n_prefetch = _rowsum(sel & pending)
    lim_idx = aptr + n_prefetch
    arrival_limit = torch.where(
        lim_idx < n,
        torch.gather(batch.submit, 1,
                     torch.clamp(lim_idx, max=n - 1)[:, None].long())[:, 0],
        inf)
    capacity, tick = batch.capacity, batch.tick
    depth = batch.backfill_depth if depth_bounded else None
    params = PassParams(
        malleable=bj.malleable, min_nodes=bj.min_nodes,
        max_nodes=bj.max_nodes, want=bj.want, floor=bj.floor,
        shrink_floor=bj.shrink_floor, prio_ref=bj.prio_ref,
        pfrac=bj.pfrac, wall_work=bj.wall_work, on_demand=bj.on_demand,
        pref_nodes=bj.pref_nodes,
        sort_key=bj.sort_key if with_sjf else None)

    bstate = g2(state, DONE)
    balloc = g2(full["alloc"], 0)
    brem = g2(full["remaining"], 0.0)
    bstart = g2(full["start_t"], float("nan"))
    bend = g2(full["end_t"], float("nan"))
    beops = g2(full["expand_ops"], 0)
    bsops = g2(full["shrink_ops"], 0)
    k, retrig = counters["k"], counters["retrig"]
    bf, nact, ncomp = counters["bf"], counters["nact"], counters["ncomp"]
    frozen = torch.zeros((B,), dtype=torch.bool, device=dev)
    steps_out = []

    for _ in range(K):
        halted = torch.zeros_like(frozen)
        n_adv = torch.zeros((B,), dtype=I32, device=dev)
        emits = []
        # progress rate of every job running at the step's start; within
        # the step only completions change an allocation, and a completed
        # job's rate is never read again (every use is masked to running)
        rate = speedup_f32(balloc, bj.pfrac) * bj.inv_ref
        for _e in range(E):
            # Retire one per-lane event.  A lane halts at the first event
            # whose post-advance state needs a real scheduling pass; with
            # every lane halted or frozen this emits exactly the JAX
            # engine's zero-width duplicate entry, so it runs
            # unconditionally.
            t = k.to(F32) * tick
            running = bstate == RUNNING
            pend = bstate == PENDING
            ev = torch.where(running, t[:, None] + brem / rate,
                             torch.where(pend, bj.submit, inf))
            t_event = torch.minimum(ev.amin(dim=-1),
                                    torch.where(retrig, t + tick, inf))
            # strictly-future tick: <= k*tick was already processed
            k_cand = torch.maximum(
                _f32_to_i32(torch.ceil(t_event / tick - _TICK_EPS)), k + 1)
            t_cand = k_cand.to(F32) * tick
            # freeze before swallowing an arrival that was not prefetched
            live = ~(halted | frozen)
            newly_frozen = (t_cand + 0.5 * tick >= arrival_limit) & live
            act = live & ~newly_frozen & torch.isfinite(t_event)
            k = torch.where(act, k_cand, k)
            t_next = k.to(F32) * tick
            dt = torch.clamp(t_next - t, min=0.0)

            # progress + tick-quantized completions
            brem = torch.where(running, brem - dt[:, None] * rate, brem)
            done_now = running & (brem <= _REM_EPS) & act[:, None]
            bstate = torch.where(done_now, DONE, bstate)
            bend = torch.where(done_now, t_next[:, None], bend)
            balloc = torch.where(done_now, 0, balloc)
            brem = torch.where(done_now, 0.0, brem)

            # arrivals (half-tick slack absorbs f32 rounding of the ceil;
            # mirrored from the JAX engine, ROADMAP.md §C1)
            arrived = pend & act[:, None] & (
                bj.submit <= (t_next + 0.5 * tick)[:, None])
            bstate = torch.where(arrived, QUEUED, bstate)

            # halting predicate: the pass is a bitwise no-op iff nothing is
            # queued and expand has no free nodes or no headroom
            run_now = bstate == RUNNING
            queued_ct = _rowsum(bstate == QUEUED)
            busy = _rowsum(torch.where(run_now, balloc, 0))
            free_now = capacity - busy
            room_tot = _rowsum(torch.where(
                run_now & bj.malleable,
                torch.clamp(bj.max_nodes - balloc, min=0), 0))
            noop = (queued_ct == 0) & ((free_now <= 0) | (room_tot == 0))
            retrig = torch.where(act & noop, False, retrig)
            halted = halted | (act & ~noop)
            frozen = frozen | newly_frozen
            nact = nact + act.to(I32)
            n_adv = n_adv + act.to(I32)
            emits.append((t_next, busy, queued_ct))

        running0 = bstate == RUNNING
        alloc0 = balloc
        state0 = bstate
        t_now = k.to(F32) * tick
        # one Steps-1..3 pass per step, on the lanes that halted
        bstate, balloc, bstart = schedule_tick(
            params, bstate, balloc, brem, bstart, halted[:, None],
            capacity, t_now, structure=cfg.structure,
            fill_rounds=cfg.fill_rounds, prio_lo=prio_lo, prio_hi=prio_hi,
            span_max=span_max, expand_backend=backend,
            backfill_depth=depth, with_classes=with_classes,
            with_sjf=with_sjf, pool_share=bj.pool_share,
            steal_margin=bj.steal_margin)

        # net per-invocation op accounting (jobs running before & after)
        still = running0 & (bstate == RUNNING)
        d = balloc - alloc0
        beops = beops + (still & (d > 0)).to(I32)
        bsops = bsops + (still & (d < 0)).to(I32)

        # a start with an earlier job left queued is out of order (EASY
        # backfill / shrink-admitted start)
        started_now = (state0 == QUEUED) & (bstate == RUNNING)
        qd = (bstate == QUEUED).to(I32)
        earlier_q = torch.cumsum(qd, dim=-1, dtype=I32) - qd
        bf = bf + _rowsum(started_now & (earlier_q > 0))
        ncomp = ncomp + torch.clamp(n_adv - 1, min=0)

        busy = _rowsum(torch.where(bstate == RUNNING, balloc, 0))
        qlen = _rowsum(qd)
        # rerun next tick while a pass changed state and jobs stayed queued;
        # only lanes whose halting event got a real pass rewrite the flag
        changed = ((balloc != alloc0) | (bstate != state0)).any(dim=-1)
        retrig = torch.where(halted, changed & (qlen > 0), retrig)

        # timeline fixup: the halting event's entry (and every zero-width
        # duplicate after it) takes the post-schedule values
        ts = torch.stack([e[0] for e in emits])       # (E, B)
        busy_e = torch.stack([e[1] for e in emits])
        qlen_e = torch.stack([e[2] for e in emits])
        fix = (torch.arange(E, device=dev)[:, None]
               >= torch.clamp(n_adv - 1, min=0)[None, :])
        busy_e = torch.where(fix, busy[None, :], busy_e)
        qlen_e = torch.where(fix, qlen[None, :], qlen_e)
        steps_out.append((ts, busy_e, qlen_e))

    def sc(a, buf):  # idx == n goes to the spare column, sliced off
        ext = torch.cat([a, a[:, :1]], dim=1)
        return ext.scatter_(1, idx.long(), buf)[:, :n]

    full = dict(
        state=sc(full["state"], bstate),
        alloc=sc(full["alloc"], balloc),
        remaining=sc(full["remaining"], brem),
        start_t=sc(full["start_t"], bstart),
        end_t=sc(full["end_t"], bend),
        expand_ops=sc(full["expand_ops"], beops),
        shrink_ops=sc(full["shrink_ops"], bsops),
    )
    counters = dict(k=k, retrig=retrig, bf=bf, nact=nact, ncomp=ncomp)
    all_done = (full["state"] == DONE).all()

    def flat(i):  # (K, E, B) -> (B, K * E)
        return torch.stack([s[i] for s in steps_out]).reshape(K * E, B).T

    return full, counters, (flat(0), flat(1), flat(2)), all_done
