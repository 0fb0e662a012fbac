"""Event-quantized-tick discrete-event simulator (ElastiSim-equivalent).

A copy of ``repro.core.simulator``, the reference numpy DES, so the port
imports nothing of ``repro``; it runs on the host, as in the reference, and
``tests/test_torch_des.py`` holds it to the original byte for byte.

ElastiSim invokes the scheduler every tick (paper Table 2: 1 s / 10 s).  All
five strategies are *deterministic functions of cluster state*, and state
only changes at job submission/completion; scheduler decisions therefore can
only change on the first tick after an event.  This engine runs the scheduler
exactly at those ticks and is bit-equivalent to dense per-tick simulation
(verified in the reference by ``tests/test_simulator.py``) while being
O(#events) instead of O(#ticks).

Scheduling per invocation (paper §2.1):
  Step 1  EASY-backfill start pass (per-strategy start allocations).
  Step 2  While the queue head cannot start and running malleable jobs can be
          shrunk enough to admit it: shrink (greedy in priority order, or
          balanced for AVG) and start.
  Step 2b Structure-specific extra pass (``docs/strategies.md``): the
          ``pooled`` structure starts queued malleable jobs from the
          shared surplus-above-preferred pool; ``stealing`` transfers
          nodes from over-average running jobs to under-average ones.
  Step 3  Expand running malleable jobs into any remaining idle nodes
          (greedy lowest-priority-first, or balanced for AVG).

The queue itself is kept in ``(class, queue-key, submit)`` order, where the
queue key is the submit rank under FCFS and the walltime estimate under SJF
(``queue_order='sjf'`` or a strategy that pins it, e.g. ``rigid_sjf``).

Expand/shrink operations are counted as the *net* per-invocation allocation
change of each running malleable job, matching ElastiSim's one-reconfiguration
-per-scheduling-point semantics.
"""
from __future__ import annotations

import dataclasses
import time as _time
from collections import deque
from typing import Optional

import numpy as np

from .cluster import Cluster
from .jobs import DONE, PENDING, QUEUED, RUNNING, Workload
from .passes import (balanced_expand, balanced_shrink,
                     easy_backfill_scan_exact, easy_reservation_exact,
                     fcfs_prefix_exact, greedy_expand, greedy_shrink,
                     start_policies)
from .scenario import DEFAULT_BACKFILL_DEPTH
from .speedup import amdahl_speedup
from .strategies import Strategy, effective_queue_order

_EPS = 1e-9


@dataclasses.dataclass
class SimResult:
    """Per-job outcomes plus the piecewise-constant utilization timeline."""

    start: np.ndarray
    end: np.ndarray
    expand_ops: np.ndarray
    shrink_ops: np.ndarray
    util_t: np.ndarray       # breakpoint times
    util_nodes: np.ndarray   # busy nodes on [util_t[k], util_t[k+1])
    n_sched_calls: int
    sim_seconds: float       # wall-clock cost of the simulation itself
    finished: bool
    end_time: float

    def busy_integral(self, t0: float, t1: float) -> float:
        """∫ busy dt over [t0, t1] from the breakpoint timeline."""
        ts = np.append(self.util_t, max(self.end_time, self.util_t[-1]))
        lo = np.maximum(ts[:-1], t0)
        hi = np.minimum(ts[1:], t1)
        return float(np.sum(np.maximum(hi - lo, 0.0) * self.util_nodes))


class _RunningSet:
    """Append/compress int-id set backed by a preallocated array."""

    def __init__(self, capacity: int):
        self._buf = np.empty(capacity, dtype=np.int64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def ids(self) -> np.ndarray:
        return self._buf[: self._n]

    def add(self, job: int) -> None:
        self._buf[self._n] = job
        self._n += 1

    def remove_mask(self, done_mask: np.ndarray) -> np.ndarray:
        """Drop ids where done_mask is True; returns the dropped ids."""
        ids = self.ids
        dropped = ids[done_mask].copy()
        kept = ids[~done_mask]
        self._buf[: len(kept)] = kept
        self._n = len(kept)
        return dropped


class Simulator:
    """Simulate ``workload`` on ``cluster`` under ``strategy``."""

    def __init__(
        self,
        workload: Workload,
        cluster: Cluster,
        strategy: Strategy,
        backfill_depth: int = DEFAULT_BACKFILL_DEPTH,
        dense_ticks: bool = False,
        queue_order: str = "fcfs",
    ):
        workload.validate(cluster.nodes)
        self.w = workload
        self.cluster = cluster
        self.strategy = strategy
        self.backfill_depth = backfill_depth
        self.queue_order = effective_queue_order(strategy, queue_order)
        self.dense_ticks = dense_ticks  # force per-tick scheduling (tests)
        w = workload
        self._s_ref = amdahl_speedup(w.nodes_req, w.pfrac)
        # Static per-job start policies (paper §2.1 Step 1), shared with
        # the vectorized engines via the policy core.
        (self._start_want, self._start_floor,
         self._shrink_floor, _) = start_policies(
            strategy, w.malleable, w.min_nodes, w.pref_nodes, w.nodes_req)
        # est remaining duration at alloc a = remaining * _wall_work / S(a)
        self._wall_work = w.walltime * self._s_ref

    def _est_duration(self, jobs, alloc, remaining) -> np.ndarray:
        """Walltime-padded remaining-duration estimate at allocation alloc."""
        s = amdahl_speedup(alloc, self.w.pfrac[jobs])
        return remaining * self._wall_work[jobs] / s

    # -- main loop ------------------------------------------------------
    def run(self, horizon: Optional[float] = None) -> SimResult:
        wall0 = _time.monotonic()
        w, cl, strat = self.w, self.cluster, self.strategy
        n = w.n_jobs
        tick = cl.tick
        start_want, start_floor = self._start_want, self._start_floor
        shrink_floor = self._shrink_floor
        pfrac, s_ref, wall_work = w.pfrac, self._s_ref, self._wall_work

        state = np.full(n, PENDING, dtype=np.int8)
        alloc = np.zeros(n, dtype=np.int64)
        remaining = np.ones(n, dtype=np.float64)
        start_t = np.full(n, np.nan)
        end_t = np.full(n, np.nan)
        expand_ops = np.zeros(n, dtype=np.int64)
        shrink_ops = np.zeros(n, dtype=np.int64)

        order = np.argsort(w.submit, kind="stable")
        aptr = 0
        queue: deque = deque()
        od = w.on_demand
        has_od = bool(np.any(od))

        sjf = self.queue_order == "sjf"

        def enqueue(j: int) -> None:
            # On-demand jobs take queue priority (Fan & Lan): an arriving
            # on-demand job is inserted behind the queued on-demand jobs
            # but ahead of every normal one, so the queue stays in
            # (class, submit) order and the FCFS machinery below —
            # prefix, head reservation, backfill slice — needs no change.
            # Under SJF queue ordering the same trick applies one level
            # deeper: stable insertion keeps the queue in
            # (class, walltime estimate, submit) order, so shorter jobs
            # overtake longer ones while equal estimates stay FCFS.
            if sjf:
                key = (0 if (has_od and od[j]) else 1, float(w.walltime[j]))
                pos = 0
                for q in queue:
                    kq = (0 if (has_od and od[q]) else 1,
                          float(w.walltime[q]))
                    if kq <= key:  # stable: equal keys keep submit order
                        pos += 1
                    else:
                        break
                queue.insert(pos, j)
            elif has_od and od[j]:
                queue.insert(sum(1 for q in queue if od[q]), j)
            else:
                queue.append(j)

        running = _RunningSet(n)
        busy = 0
        t = 0.0
        util_t = [0.0]
        util_nodes = [0]
        n_sched = 0

        def record_busy(at: float) -> None:
            if util_nodes[-1] != busy:
                if util_t[-1] == at:
                    util_nodes[-1] = busy
                    if len(util_t) > 1 and util_nodes[-2] == busy:
                        util_t.pop(); util_nodes.pop()
                else:
                    util_t.append(at)
                    util_nodes.append(busy)

        def rates_of(ids: np.ndarray) -> np.ndarray:
            s = amdahl_speedup(alloc[ids], pfrac[ids])
            return s / (s_ref[ids] * w.runtime[ids])

        def advance_to(t_target: float) -> None:
            nonlocal t, busy
            while True:
                ids = running.ids
                if len(ids) == 0:
                    t = t_target
                    return
                r = rates_of(ids)
                fins = t + remaining[ids] / r
                tmin = fins.min()
                if tmin <= t_target + _EPS:
                    dt = max(tmin - t, 0.0)
                    remaining[ids] -= dt * r
                    t = tmin
                    done = remaining[ids] <= _EPS
                    dropped = running.remove_mask(done)
                    state[dropped] = DONE
                    end_t[dropped] = t
                    remaining[dropped] = 0.0
                    busy -= int(alloc[dropped].sum())
                    record_busy(t)
                else:
                    remaining[ids] -= (t_target - t) * r
                    t = t_target
                    return

        # -- one scheduler invocation (Steps 1-3) ------------------------
        sched_changed = False  # any start/resize in the current pass

        def do_start(j: int, a: int) -> None:
            nonlocal busy, sched_changed
            state[j] = RUNNING
            alloc[j] = a
            start_t[j] = t
            running.add(j)
            busy += int(a)
            sched_changed = True

        def start_pass() -> None:
            # greedy FCFS prefix (policy core: exact first-fit order)
            head_jobs = list(queue)
            prefix, _ = fcfs_prefix_exact(start_want[head_jobs],
                                          start_floor[head_jobs],
                                          cl.nodes - busy)
            for a in prefix:
                do_start(queue.popleft(), a)
            if not queue:
                return
            # head blocked: single EASY reservation + bounded backfill scan
            free = cl.nodes - busy
            head = queue[0]
            floor_h = int(start_floor[head])
            ids = running.ids
            if len(ids) == 0:
                return  # unreachable: head always fits an empty cluster
            ests = t + self._est_duration(ids, alloc[ids], remaining[ids])
            shadow, extra = easy_reservation_exact(ests, alloc[ids], free,
                                                   floor_h)
            cands = np.asarray(list(queue)[1 : 1 + self.backfill_depth],
                               dtype=np.int64)
            starts, _, _ = easy_backfill_scan_exact(
                start_want[cands], start_floor[cands], wall_work[cands],
                pfrac[cands], t, shadow, extra, free, eps=_EPS)
            if starts:
                for i, a in starts:
                    do_start(int(cands[i]), int(a))
                sset = {int(cands[i]) for i, _ in starts}
                remain = [j for j in queue if j not in sset]
                queue.clear()
                queue.extend(remain)

        def resize_running(new_alloc_m: np.ndarray, m_ids: np.ndarray) -> None:
            nonlocal busy, sched_changed
            delta = new_alloc_m - alloc[m_ids]
            if np.any(delta != 0):
                sched_changed = True
            alloc[m_ids] = new_alloc_m
            busy += int(delta.sum())

        def _running_malleable() -> np.ndarray:
            ids = running.ids
            return ids[w.malleable[ids]]

        def _priority_of(m: np.ndarray) -> np.ndarray:
            return strat.priority_fn(alloc[m], w.min_nodes[m],
                                     w.max_nodes[m], w.pref_nodes[m], np)

        def pooled_pass() -> None:
            # Common-pool start (docs/strategies.md § pref_common_pool):
            # the surplus above preferred allocations of running malleable
            # jobs forms a shared pool; queued malleable candidates behind
            # the head draw their start floor from it in queue order, the
            # first non-fitting malleable candidate blocking the rest.
            # Pool draws never touch free nodes (the head's reservation is
            # unaffected): every start is paid for by shrinking donors back
            # toward preferred.
            m = _running_malleable()
            if len(m) == 0:
                return
            over = np.maximum(alloc[m] - w.pref_nodes[m], 0)
            pool = int(over.sum())
            budget = min(int(strat.pool_share * pool), pool)
            if budget <= 0:
                return
            started, acc = [], 0
            for qi, j in enumerate(list(queue)):
                if qi == 0:
                    continue  # head starts via reservation + Step 2 only
                if not w.malleable[j]:
                    continue
                f = int(start_floor[j])
                if acc + f > budget:
                    break
                acc += f
                started.append(j)
            if acc <= 0:
                return
            pr = _priority_of(m)
            new_alloc = greedy_shrink(alloc[m], alloc[m] - over, pr, acc,
                                      xp=np)
            resize_running(new_alloc, m)
            sset = set(started)
            remain = [j for j in queue if j not in sset]
            queue.clear()
            queue.extend(remain)
            for j in started:
                do_start(j, int(start_floor[j]))

        def stealing_pass() -> None:
            # Steal-agreement (docs/strategies.md § steal_agreement):
            # running malleable jobs above the average running allocation
            # (plus the steal margin) donate their surplus above
            # max(average, shrink floor); under-average jobs steal up to
            # min(average, max_nodes).  Busy is conserved.
            m = _running_malleable()
            if len(m) == 0:
                return
            avg = int(alloc[m].sum()) // len(m)
            sfl = np.minimum(shrink_floor[m], alloc[m])
            donor = alloc[m] > avg + strat.steal_margin
            donor_amt = np.where(
                donor, np.maximum(alloc[m] - np.maximum(avg, sfl), 0), 0)
            taker_room = np.maximum(
                np.minimum(avg, w.max_nodes[m]) - alloc[m], 0)
            transfer = int(min(donor_amt.sum(), taker_room.sum()))
            if transfer <= 0:
                return
            pr = _priority_of(m)
            new_alloc = greedy_shrink(alloc[m], alloc[m] - donor_amt, pr,
                                      transfer, xp=np)
            new_alloc = greedy_expand(new_alloc, new_alloc + taker_room, pr,
                                      transfer, xp=np)
            resize_running(new_alloc, m)

        def schedule_once() -> None:
            nonlocal busy
            start_pass()
            if strat.malleable:
                # Step 2: shrink to admit the blocked head, repeatedly.
                while queue:
                    head = queue[0]
                    floor_h = int(start_floor[head])
                    free = cl.nodes - busy
                    deficit = floor_h - free
                    if deficit <= 0:
                        break  # start_pass already ran; nothing blocked
                    ids = running.ids
                    m = ids[w.malleable[ids]]
                    if len(m) == 0:
                        break
                    floor_arr = np.minimum(shrink_floor[m], alloc[m])
                    surplus = int(np.sum(alloc[m] - floor_arr))
                    if surplus < deficit:
                        break  # shrinking cannot admit the head
                    if strat.balanced:
                        new_alloc = balanced_shrink(
                            alloc[m], floor_arr, w.max_nodes[m], deficit, xp=np)
                    else:
                        pr = strat.priority_fn(alloc[m], w.min_nodes[m],
                                               w.max_nodes[m],
                                               w.pref_nodes[m], np)
                        new_alloc = greedy_shrink(alloc[m], floor_arr, pr,
                                                  deficit, xp=np)
                    resize_running(new_alloc, m)
                    start_pass()
                # Step 2b: structure-specific extra pass (see
                # docs/strategies.md and the torch mirror in passes.py).
                if strat.structure == "pooled":
                    pooled_pass()
                elif strat.structure == "stealing":
                    stealing_pass()
                # Step 3: expand running malleable jobs into idle nodes.
                free = cl.nodes - busy
                ids = running.ids
                m = ids[w.malleable[ids]]
                if len(m) > 0 and not np.any(alloc[m] < w.max_nodes[m]):
                    m = m[:0]  # everything at max: expansion is a no-op
                if free > 0 and len(m) > 0:
                    if strat.balanced:
                        new_alloc = balanced_expand(
                            alloc[m], w.min_nodes[m], w.max_nodes[m], free, xp=np)
                    else:
                        pr = strat.priority_fn(alloc[m], w.min_nodes[m],
                                               w.max_nodes[m],
                                               w.pref_nodes[m], np)
                        new_alloc = greedy_expand(alloc[m], w.max_nodes[m], pr,
                                                  free, xp=np)
                    resize_running(new_alloc, m)

        def schedule() -> None:
            """Run steps 1-3 to fixpoint.

            A single 1-2-3 pass is not idempotent: Step-3 expansion changes
            running jobs' estimated ends, which can widen the backfill
            window seen by the *next* invocation.  Dense per-tick ElastiSim
            converges over subsequent (event-free) ticks; iterating to
            fixpoint here reproduces exactly that converged schedule and
            keeps event-quantization bit-equivalent (test_tick_equivalence).
            """
            nonlocal n_sched, sched_changed
            n_sched += 1
            ids0 = running.ids.copy()
            m0 = ids0[w.malleable[ids0]]
            alloc0 = alloc[m0].copy()

            for _ in range(10_000):
                sched_changed = False
                schedule_once()
                if not sched_changed:
                    break
            else:  # pragma: no cover
                raise RuntimeError("scheduler failed to reach a fixpoint")

            # net per-invocation op accounting on jobs running throughout
            if len(m0):
                still = state[m0] == RUNNING
                d = alloc[m0] - alloc0
                expand_ops[m0[still & (d > 0)]] += 1
                shrink_ops[m0[still & (d < 0)]] += 1
            record_busy(t)

        # -- event loop ---------------------------------------------------
        submit_sorted = w.submit[order]
        finished = True
        while aptr < n or len(running):
            ids = running.ids
            if len(ids):
                r = rates_of(ids)
                t_fin = float((t + remaining[ids] / r).min())
            else:
                t_fin = np.inf
            t_sub = float(submit_sorted[aptr]) if aptr < n else np.inf
            t_event = min(t_fin, t_sub)
            if not np.isfinite(t_event):
                break
            if horizon is not None and t_event > horizon:
                finished = False
                advance_to(horizon)
                break
            if self.dense_ticks:
                t_sched = np.floor(t / tick + 1.0) * tick
                t_sched = min(t_sched, np.ceil(t_event / tick - _EPS) * tick)
            else:
                t_sched = np.ceil(t_event / tick - _EPS) * tick
            t_sched = max(float(t_sched), 0.0)
            advance_to(t_sched)
            while aptr < n and submit_sorted[aptr] <= t + _EPS:
                j = int(order[aptr])
                state[j] = QUEUED
                enqueue(j)
                aptr += 1
            schedule()

        return SimResult(
            start=start_t, end=end_t,
            expand_ops=expand_ops, shrink_ops=shrink_ops,
            util_t=np.asarray(util_t), util_nodes=np.asarray(util_nodes),
            n_sched_calls=n_sched,
            sim_seconds=_time.monotonic() - wall0,
            finished=finished, end_time=t,
        )


def simulate(workload: Workload, cluster: Cluster, strategy: Strategy,
             **kw) -> SimResult:
    return Simulator(workload, cluster, strategy, **kw).run()
