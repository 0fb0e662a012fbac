"""Measurement window and seed aggregation (paper §2.1 "Metrics", §2.3).

The part of ``repro.core.metrics`` the batched engine needs, copied so the
port imports nothing of ``repro``.  Per-run metrics are computed inside the
window ``[warmup_end, last_submission]``; across seeds the paper reports
means and interquartile ranges.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .jobs import Workload

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
