"""Reference-DES experiment backend: cell-parallel, on the host.

The port of ``repro.experiments.backend_des``: runs each grid cell through
the port's copy of the numpy discrete-event simulator
(:func:`repro_torch.core.simulate`), optionally fanned out over processes
with ``concurrent.futures``.  The DES is the reference the batched engine
is crosschecked against; it is asked for by name (``engine="des"``) and
never stands in for the card.  Every cell is a pure function of (spec, workload
name, cell) — the trace is regenerated deterministically inside each
worker process and memoized there — so the parallel schedule cannot change
results: serial and parallel runs are bit-identical, and a run interrupted
mid-grid resumes from the cells already written to the store.

Each cell's metrics carry the ``sched_*`` scheduling counters
(:func:`repro_torch.core.metrics.scheduling_counters`): execution-side
observability that rides in the metric dict (and therefore the cell
store) but never in a fingerprint.  Spans/heartbeat: serial cells are
traced individually (``des.cell``); pool workers are separate processes
where the default tracer is disabled — the documented limitation of
``--trace`` with ``--workers N`` (the per-cell wall-clock is still
recorded in ``info["cells"]`` either way).  The pool starts its workers
with ``spawn``: the parent may already hold a CUDA context and its
threads, which a forked child must not inherit.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import time
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core import (get_strategy, run_metrics, scheduling_counters,
                              simulate, transform_rigid_to_malleable)
from repro_torch.sweep.cache import SweepCache

from .spec import Cell, ExperimentSpec, prepare_workload

# Per-process memo of realized workloads: regenerating a trace for every
# cell would dominate small grids; keyed by everything that determines it.
_WORKLOAD_MEMO: Dict[tuple, tuple] = {}


def _realized(spec: ExperimentSpec, name: str):
    key = (name, spec.trace_seed, spec.scale, spec.scenario)
    if key not in _WORKLOAD_MEMO:
        _WORKLOAD_MEMO[key] = prepare_workload(spec, name)
        if len(_WORKLOAD_MEMO) > 8:  # bound worker memory across specs
            _WORKLOAD_MEMO.pop(next(iter(_WORKLOAD_MEMO)))
    return _WORKLOAD_MEMO[key]


def simulate_cell(spec: ExperimentSpec, name: str,
                  cell: Cell) -> Dict[str, float]:
    """Metrics of one (workload, strategy, proportion, seed) cell."""
    cl, w_rigid, window = _realized(spec, name)
    strat, prop, seed = cell
    wm = (w_rigid if prop == 0.0 else
          transform_rigid_to_malleable(w_rigid, prop, seed, cl.nodes,
                                       spec.transform))
    res = simulate(wm, cl, get_strategy(strat),
                   backfill_depth=spec.scenario.backfill_depth,
                   queue_order=spec.scenario.queue_order)
    return {**run_metrics(res, wm, cl, window),
            **scheduling_counters(res, wm)}


def _worker(task: Tuple[ExperimentSpec, str, Cell]):
    spec, name, cell = task
    t0 = time.monotonic()
    m = simulate_cell(spec, name, cell)
    return (name, cell), m, time.monotonic() - t0


def run_cells(spec: ExperimentSpec,
              todo: List[Tuple[str, Cell]],
              store: Optional[SweepCache],
              fingerprints: Dict[Tuple[str, Cell], Dict],
              options: Optional[Dict] = None,
              verbose: bool = True) -> Tuple[Dict, Dict]:
    """Run ``todo`` cells; returns (metrics by (workload, cell), info).

    ``options["workers"]``: 0/1 = serial in-process (default); N > 1 = a
    process pool of N; -1 = one per CPU.  ``options["progress"]`` prints a
    per-cell heartbeat line with an ETA.  Completed cells are written to
    ``store`` as they finish, so an interrupted run resumes.
    ``info["cells"]`` records per-cell wall-clock in completion order.
    """
    opts = options or {}
    workers = int(opts.get("workers") or 0)
    if workers < 0:
        workers = os.cpu_count() or 1
    t0 = time.monotonic()
    metrics: Dict[Tuple[str, Cell], Dict[str, float]] = {}
    cell_walls: List[Dict] = []
    heartbeat = obs.Heartbeat(len(todo), label=f"progress:{spec.engine}",
                              unit="cell",
                              enabled=bool(opts.get("progress")))

    def record(key, m, wall_s):
        metrics[key] = m
        name, (strat, prop, seed) = key
        cell_walls.append({"workload": name, "strategy": strat,
                           "proportion": prop, "seed": seed,
                           "wall_s": wall_s})
        if store is not None:
            store.put(fingerprints[key], m)
        heartbeat.tick(cells_flushed=1 if store is not None else 0)
        if verbose:
            print(f"[experiment-des:{name}] {strat}@{int(prop * 100)}%"
                  f"/s{seed}: turnaround={m['turnaround_mean']:,.0f} "
                  f"wait={m['wait_mean']:,.0f} "
                  f"util={m['utilization']:.3f}", flush=True)

    if workers > 1 and len(todo) > 1:
        tasks = [(spec, name, cell) for name, cell in todo]
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(workers, len(tasks)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = [pool.submit(_worker, t) for t in tasks]
            for fut in concurrent.futures.as_completed(futures):
                key, m, wall_s = fut.result()
                record(key, m, wall_s)
    else:
        for name, cell in todo:
            t_cell = time.monotonic()
            with obs.span("des.cell", workload=name, strategy=cell[0],
                          proportion=cell[1], seed=cell[2]):
                m = simulate_cell(spec, name, cell)
            record((name, cell), m, time.monotonic() - t_cell)

    info = {"sim_seconds": time.monotonic() - t0,
            "workers": max(workers, 1), "computed_cells": len(todo),
            "cells": cell_walls}
    return metrics, info
