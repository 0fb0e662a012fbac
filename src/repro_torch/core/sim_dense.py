"""Dense per-tick malleable-scheduling engine: one pass a tick, whole jobs.

The port of ``repro.core.sim_jax``: fixed-size job tensors, one Python-loop
step per tick, and the same scheduling pass
(:func:`repro_torch.core.passes.schedule_tick`) as the batched sweep engine
-- this module is the dense per-tick loop around the shared policy core.
:func:`simulate_dense` is the counterpart of ``simulate_jax``;
:func:`simulate_scan_batch` runs ``B`` variants as ``B`` rows of one loop
where the reference vmaps :func:`simulate_scan`.

Every step runs on the job tensors' device and none waits on the host: the
tick's time comes from a precomputed row, the per-tick ``busy`` /
``queue_len`` trace is written into preallocated ``(T, B)`` tensors, and
nothing leaves the device until the caller reads the result.

``expand_backend`` picks how the pass runs (as in
:mod:`repro_torch.sweep.batch`): ``"fused"`` (the default on ``cuda``: a
greedy class-free lane launches the CUDA tick kernel, pooled / stealing /
class lanes run the plain pass with the CUDA waterfill give),
``"waterfill"`` (the plain pass with the waterfill give) or ``"bisect"``
(the plain pass alone, the only backend on the CPU).  Every backend gives
the same bits.

Fidelity differences vs. the reference DES (``simulator.py``) are the
reference engine's: completions are quantized to tick boundaries, EASY
backfill uses the shared vectorized shadow-time reservation, and the Step-2
shrink is applied once per tick rather than to fixpoint.  Arrivals are
``submit <= t`` with no slack: this engine starts no job before its
submission.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

from .jobs import DONE, PENDING, QUEUED, RUNNING, Workload
from .passes import (PassParams, rate_f32, resolve_backend, schedule_tick,
                     speedup_f32, start_policies)
from .scenario import DEFAULT_BACKFILL_DEPTH
from .strategies import Strategy, effective_queue_order

I32, F32 = torch.int32, torch.float32


class JobArrays(NamedTuple):
    """Device-resident SoA mirror of :class:`repro_torch.core.jobs.Workload`
    (fields ``(n,)``, or ``(B, n)`` after :meth:`stack`)."""

    submit: torch.Tensor      # f32
    runtime: torch.Tensor     # f32
    walltime: torch.Tensor    # f32 reservation estimates use this
    nodes_req: torch.Tensor   # i32
    malleable: torch.Tensor   # bool
    min_nodes: torch.Tensor   # i32
    max_nodes: torch.Tensor   # i32
    pref_nodes: torch.Tensor  # i32
    pfrac: torch.Tensor       # f32
    rank: torch.Tensor        # i32 FCFS order (argsort of submit)
    on_demand: torch.Tensor   # bool queue-priority class

    @staticmethod
    def from_workload(w: Workload, device=None) -> "JobArrays":
        """The workload's arrays on ``device`` (``cuda`` unless told)."""
        dev = resolve_device(device)
        order = np.argsort(w.submit, kind="stable")
        rank = np.empty(w.n_jobs, dtype=np.int32)
        rank[order] = np.arange(w.n_jobs, dtype=np.int32)

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a).astype(dtype))).to(dev)

        return JobArrays(
            submit=t(w.submit, np.float32),
            runtime=t(w.runtime, np.float32),
            walltime=t(w.walltime, np.float32),
            nodes_req=t(w.nodes_req, np.int32),
            malleable=t(w.malleable, np.bool_),
            min_nodes=t(w.min_nodes, np.int32),
            max_nodes=t(w.max_nodes, np.int32),
            pref_nodes=t(w.pref_nodes, np.int32),
            pfrac=t(w.pfrac, np.float32),
            rank=t(rank, np.int32),
            on_demand=t(w.on_demand, np.bool_),
        )

    @staticmethod
    def stack(variants: Sequence["JobArrays"]) -> "JobArrays":
        """Stack same-length variants into batched (B, n) tensors."""
        return JobArrays(*[torch.stack(a) for a in zip(*variants)])


class SimState(NamedTuple):
    state: torch.Tensor      # i32 PENDING/QUEUED/RUNNING/DONE
    alloc: torch.Tensor      # i32
    remaining: torch.Tensor  # f32 fraction of work left
    start_t: torch.Tensor    # f32 (NaN until started)
    end_t: torch.Tensor      # f32 (NaN until done)
    expand_ops: torch.Tensor  # i32
    shrink_ops: torch.Tensor  # i32


class SimTrace(NamedTuple):
    busy: torch.Tensor       # i32 (T,) busy nodes after each tick's pass
    queue_len: torch.Tensor  # i32 (T,)


def _rowsum(x):
    return torch.sum(x, dim=-1, dtype=I32)


@torch.inference_mode()
def _simulate_rows(jobs: JobArrays, strategy: Strategy, capacity: int,
                   tick: float, n_ticks: int, depth: torch.Tensor,
                   with_classes: bool, queue_order: str,
                   expand_backend: str) -> Tuple[SimState, SimTrace]:
    """The tick loop over ``(B, n)`` job rows (``depth``: ``(B,)`` int32);
    returns ``(B, n)`` state fields and a ``(B, T)`` trace."""
    dev = jobs.submit.device
    backend = resolve_backend(expand_backend, dev)
    B, n = jobs.submit.shape
    # The shared pass wants slots in FCFS order: simulate in submit-rank
    # order and scatter results back to the caller's job order at the end.
    order = torch.argsort(jobs.rank, dim=-1)
    sj = JobArrays(*[torch.gather(a, -1, order) for a in jobs])
    want, floor, sfloor, prio_ref = start_policies(
        strategy, sj.malleable, sj.min_nodes, sj.pref_nodes, sj.nodes_req,
        xp=torch)
    s_ref = speedup_f32(sj.nodes_req, sj.pfrac)
    ref_time = s_ref * sj.runtime
    with_sjf = effective_queue_order(strategy, queue_order) == "sjf"
    params = PassParams(
        malleable=sj.malleable & bool(strategy.malleable),
        min_nodes=sj.min_nodes, max_nodes=sj.max_nodes,
        want=want, floor=floor, shrink_floor=sfloor, prio_ref=prio_ref,
        pfrac=sj.pfrac, wall_work=sj.walltime * s_ref,
        on_demand=sj.on_demand, pref_nodes=sj.pref_nodes,
        sort_key=sj.walltime if with_sjf else None)
    # conservative static pass bounds: every allocation and priority
    # reference lies within a few multiples of the cluster size
    prio_lo, prio_hi = -4 * int(capacity), 4 * int(capacity)
    span_max = 4 * int(capacity)
    structure = strategy.structure if strategy.malleable else "greedy"
    cap = torch.full((B,), int(capacity), dtype=I32, device=dev)
    act = torch.ones((B, 1), dtype=torch.bool, device=dev)
    pool_share = torch.full((B,), strategy.pool_share, dtype=F32, device=dev)
    steal_margin = torch.full((B,), strategy.steal_margin, dtype=I32,
                              device=dev)
    tick_t = torch.tensor(tick, dtype=F32, device=dev)
    # schedule at the end of tick k: t = (k + 1) * tick in f32, one row a
    # tick (the kernel takes one contiguous time a lane)
    times = ((torch.arange(n_ticks, dtype=F32, device=dev) + 1.0)
             * tick_t)[:, None].expand(n_ticks, B).contiguous()

    state = torch.full((B, n), PENDING, dtype=I32, device=dev)
    alloc = torch.zeros((B, n), dtype=I32, device=dev)
    remaining = torch.ones((B, n), dtype=F32, device=dev)
    start_t = torch.full((B, n), float("nan"), dtype=F32, device=dev)
    end_t = torch.full((B, n), float("nan"), dtype=F32, device=dev)
    expand_ops = torch.zeros((B, n), dtype=I32, device=dev)
    shrink_ops = torch.zeros((B, n), dtype=I32, device=dev)
    busy = torch.empty((n_ticks, B), dtype=I32, device=dev)
    qlen = torch.empty((n_ticks, B), dtype=I32, device=dev)

    for k in range(n_ticks):
        t = times[k]
        # 1. progress running jobs over this tick
        running = state == RUNNING
        rate = rate_f32(alloc, sj.pfrac, ref_time)
        remaining = torch.where(running, remaining - tick_t * rate,
                                remaining)
        # 2. completions (quantized to tick end)
        done_now = running & (remaining <= 1e-6)
        state = torch.where(done_now, DONE, state)
        end_t = torch.where(done_now, t[:, None], end_t)
        alloc = torch.where(done_now, 0, alloc)
        remaining = torch.where(done_now, 0.0, remaining)
        # 3. arrivals
        arrived = (state == PENDING) & (sj.submit <= t[:, None])
        state = torch.where(arrived, QUEUED, state)

        running0 = state == RUNNING
        alloc0 = alloc

        # 4. shared Steps 1-3 scheduling pass (policy core)
        state, alloc, start_t = schedule_tick(
            params, state, alloc, remaining, start_t, act, cap, t,
            structure=structure, fill_rounds=2, prio_lo=prio_lo,
            prio_hi=prio_hi, span_max=span_max, expand_backend=backend,
            backfill_depth=depth, with_classes=with_classes,
            with_sjf=with_sjf, pool_share=pool_share,
            steal_margin=steal_margin)

        # 5. net per-tick op accounting (jobs running before & after)
        still = running0 & (state == RUNNING)
        d = alloc - alloc0
        expand_ops = expand_ops + (still & (d > 0)).to(I32)
        shrink_ops = shrink_ops + (still & (d < 0)).to(I32)

        busy[k] = _rowsum(torch.where(state == RUNNING, alloc, 0))
        qlen[k] = _rowsum(state == QUEUED)

    back = jobs.rank.long()  # back to the caller's job order
    final = SimState(*[torch.gather(a, -1, back) for a in (
        state, alloc, remaining, start_t, end_t, expand_ops, shrink_ops)])
    return final, SimTrace(busy=busy.T.contiguous(),
                           queue_len=qlen.T.contiguous())


def _depths(backfill_depth, B: int, device) -> torch.Tensor:
    """A scalar or ``(B,)`` backfill depth as ``(B,)`` int32 on ``device``."""
    if torch.is_tensor(backfill_depth):
        d = backfill_depth.to(device=device, dtype=I32)
    else:
        d = torch.as_tensor(np.asarray(backfill_depth, dtype=np.int32),
                            device=device)
    return torch.broadcast_to(d, (B,)).contiguous()


def simulate_scan(
    jobs: JobArrays,
    strategy: Strategy,
    capacity: int,
    tick: float,
    n_ticks: int,
    backfill_depth: int = DEFAULT_BACKFILL_DEPTH,
    with_classes: bool = False,
    queue_order: str = "fcfs",
    expand_backend: str = "auto",
) -> Tuple[SimState, SimTrace]:
    """Run ``n_ticks`` scheduler ticks over ``(n,)`` job tensors on their
    device; returns final state + per-tick trace (``(n,)`` / ``(T,)``)."""
    rows = JobArrays(*[a[None] for a in jobs])
    st, tr = _simulate_rows(
        rows, strategy, capacity, tick, n_ticks,
        _depths(backfill_depth, 1, jobs.submit.device), with_classes,
        queue_order, expand_backend)
    return (SimState(*[a[0] for a in st]), SimTrace(*[a[0] for a in tr]))


def simulate_dense(workload: Workload, capacity: int, tick: float,
                   n_ticks: int, strategy: Strategy,
                   backfill_depth: int = DEFAULT_BACKFILL_DEPTH,
                   queue_order: str = "fcfs", device=None,
                   expand_backend: str = "auto",
                   ) -> Tuple[SimState, SimTrace]:
    """Convenience wrapper: Workload -> device tensors -> tick loop (the
    counterpart of ``repro.core.sim_jax.simulate_jax``); runs on ``cuda``
    unless ``device`` says otherwise."""
    return simulate_scan(JobArrays.from_workload(workload, device), strategy,
                         int(capacity), float(tick), int(n_ticks),
                         backfill_depth,
                         with_classes=bool(np.any(workload.on_demand)),
                         queue_order=queue_order,
                         expand_backend=expand_backend)


def simulate_scan_batch(jobs: JobArrays, strategy: Strategy, capacity: int,
                        tick: float, n_ticks: int,
                        backfill_depth=None,
                        queue_order: str = "fcfs",
                        expand_backend: str = "auto",
                        ) -> Tuple[SimState, SimTrace]:
    """Batched entry point: ``jobs`` fields are (B, n); one lane per variant.

    The strategy is shared; proportion / seed variants ride the leading
    batch axis as rows of one loop.  ``backfill_depth`` may be a scalar or
    a (B,) array.  For the event-stepped engine use
    :mod:`repro_torch.sweep.batch` instead -- this wrapper runs the dense
    per-tick loop and is meant for moderate grids and property tests.
    """
    B = jobs.submit.shape[0]
    if backfill_depth is None:
        backfill_depth = DEFAULT_BACKFILL_DEPTH
    with_classes = bool(torch.any(jobs.on_demand))
    return _simulate_rows(jobs, strategy, capacity, tick, n_ticks,
                          _depths(backfill_depth, B, jobs.submit.device),
                          with_classes, str(queue_order), expand_backend)
