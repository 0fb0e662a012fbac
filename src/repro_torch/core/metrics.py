"""Evaluation metrics (paper §2.1 "Metrics", §2.3).

A copy of ``repro.core.metrics`` so the port imports nothing of ``repro``:
the window and seed aggregation the batched engine needs, and the per-run
metrics and scheduling counters of a DES run.  Per-run metrics are computed inside the
window ``[warmup_end, last_submission]``; across seeds the paper reports
means and interquartile ranges.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .cluster import Cluster
from .jobs import Workload
from .simulator import SimResult

WARMUP_SECONDS = 12 * 3600.0  # paper §2.3


@dataclasses.dataclass(frozen=True)
class Window:
    """Measurement window [t0, t1]."""

    t0: float
    t1: float

    @staticmethod
    def for_workload(workload: Workload,
                     warmup: float = WARMUP_SECONDS) -> "Window":
        """Paper window: skip ``warmup``, stop at the last submission.

        For scaled-down traces the 12 h warm-up is capped at 20% of the
        trace span so the window never degenerates.
        """
        last_submit = float(np.max(workload.submit))
        t0 = min(warmup, 0.2 * last_submit)
        return Window(t0=t0, t1=last_submit)


def run_metrics(
    result: SimResult,
    workload: Workload,
    cluster: Cluster,
    window: Window | None = None,
) -> Dict[str, float]:
    """Metrics of a single simulation run.

    Job metrics average over jobs *submitted* inside the window; utilization
    integrates busy nodes over the window.  Expand/shrink ops are reported
    per malleable job (submitted in-window), matching the paper's
    "operations per job" panels (Figs. 6e/f …).
    """
    w = workload
    if window is None:
        window = Window.for_workload(w)
    in_win = (w.submit >= window.t0) & (w.submit <= window.t1)
    done = np.isfinite(result.end)
    sel = in_win & done
    n_sel = int(np.sum(sel))

    wait = result.start[sel] - w.submit[sel]
    makespan = result.end[sel] - result.start[sel]
    turnaround = result.end[sel] - w.submit[sel]

    dur = max(window.t1 - window.t0, 1e-9)
    util = result.busy_integral(window.t0, window.t1) / (cluster.nodes * dur)

    msel = sel & w.malleable
    n_mall = int(np.sum(msel))
    expand = float(np.sum(result.expand_ops[msel])) / max(n_mall, 1)
    shrink = float(np.sum(result.shrink_ops[msel])) / max(n_mall, 1)

    return {
        "n_jobs": float(n_sel),
        "n_malleable": float(n_mall),
        "wait_mean": float(np.mean(wait)) if n_sel else np.nan,
        "wait_p50": float(np.median(wait)) if n_sel else np.nan,
        "makespan_mean": float(np.mean(makespan)) if n_sel else np.nan,
        "turnaround_mean": float(np.mean(turnaround)) if n_sel else np.nan,
        "turnaround_p50": float(np.median(turnaround)) if n_sel else np.nan,
        "utilization": float(util),
        "expand_per_job": expand,
        "shrink_per_job": shrink,
        "unfinished": float(np.sum(in_win & ~done)),
    }


def backfill_starts(submit: np.ndarray, start: np.ndarray) -> int:
    """Out-of-order starts: jobs started while an earlier job still waited.

    A job counts iff its start time is *strictly* below the running
    maximum of earlier-submitted jobs' starts (never-started jobs count as
    ``+inf``, so everything that jumps a still-waiting job is counted).
    Under tick-quantized scheduling this is exactly "started by the EASY
    backfill scan or a shrink-admission while an earlier arrival stayed
    queued through that invocation" — the definition the batched engine
    accumulates on device (``repro_torch.sweep.batch``), which is how the two
    engines' counters are comparable.
    """
    order = np.argsort(submit, kind="stable")
    s = np.where(np.isfinite(start), start, np.inf)[order]
    prev_max = np.maximum.accumulate(
        np.concatenate([[-np.inf], s[:-1]]))
    return int(np.sum(s < prev_max))


def scheduling_counters(result: SimResult,
                        workload: Workload) -> Dict[str, float]:
    """Whole-run scheduler-behavior counters of a DES run.

    Execution-side observability (reconfiguration churn, queue-jump
    pressure, scheduler work) reported alongside — never inside — the
    paper metrics.  Keys carry the ``sched_`` prefix; none of them may
    enter a spec or cell fingerprint.  ``sched_invocations`` is
    engine-specific by design: the DES counts in-tick fixpoint
    invocations, the batched engine counts processed scheduling ticks
    (it converges over subsequent ticks instead), so only the backfill/
    shrink/expand counters are comparable across engines.
    """
    return {
        "sched_backfill_starts": float(
            backfill_starts(workload.submit, result.start)),
        "sched_shrink_events": float(np.sum(result.shrink_ops)),
        "sched_expand_events": float(np.sum(result.expand_ops)),
        "sched_invocations": float(result.n_sched_calls),
    }


def iqr(values: Sequence[float]) -> float:
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    if len(v) == 0:
        return np.nan
    return float(np.percentile(v, 75) - np.percentile(v, 25))


def aggregate_seeds(per_seed: List[Dict[str, float]]) -> Dict[str, float]:
    """Mean and IQR over seed runs, over the union of keys (a missing value
    degrades that key to nan)."""
    out: Dict[str, float] = {}
    keys = list(dict.fromkeys(k for m in per_seed for k in m))
    for k in keys:
        vals = [m.get(k, np.nan) for m in per_seed]
        finite = [v for v in vals if np.isfinite(v)]
        out[f"{k}_mean"] = float(np.mean(finite)) if finite else np.nan
        out[f"{k}_iqr"] = iqr(vals)
    return out


def improvement(baseline: float, value: float) -> float:
    """Relative improvement in % (positive = better for time metrics)."""
    if baseline == 0:
        return np.nan
    return 100.0 * (baseline - value) / baseline
