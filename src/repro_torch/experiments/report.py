"""Renderers over the shared artifact schema (Figs. 6-9 tables, summary).

The port of ``repro.experiments.report``: consumers of experiment results
render from the aggregate schema
:func:`repro_torch.experiments.run_experiment` produces:
``{"rigid": metrics, "<strategy>@<pct>": aggregated, "_meta": {...}}``.

The scenario-sensitivity reporter (``--compare-scenarios``) also lives
here: :data:`SCENARIO_AXES` names every sweepable scenario axis,
:func:`scenario_variant` derives the per-value :class:`ScenarioConfig`,
and :func:`render_scenario_table` renders the sensitivity table alongside
the Figs. 6-9 analogues.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.core import improvement
from repro_torch.core.scenario import JobClasses, ScenarioConfig
from repro_torch.core.strategies import MALLEABLE_STRATEGY_NAMES

# Sweepable scenario axes for --compare-scenarios: axis name -> how a
# swept value lands in the ScenarioConfig.  Plain fields replace
# themselves; the job-class mix axes rewrite the JobClasses partition
# (the malleable-eligible fraction absorbs the remainder); queue_order
# is the one *categorical* axis (values "fcfs" / "sjf", not numbers).
SCENARIO_AXES = ("walltime_factor", "walltime_jitter",
                 "arrival_compression", "backfill_depth",
                 "queue_order",
                 "on_demand_frac", "rigid_frac")


def axis_key(value):
    """Canonical dict key for a swept axis value: float when numeric
    (the historical artifact keys, e.g. ``"256.0"``), the string itself
    for categorical axes (``"sjf"``)."""
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)


def axis_label(axis: str, value) -> str:
    """``axis=value`` column label, ``%g``-formatted when numeric."""
    key = axis_key(value)
    return (f"{axis}={key:g}" if isinstance(key, float)
            else f"{axis}={key}")


def scenario_variant(base: ScenarioConfig, axis: str,
                     value) -> ScenarioConfig:
    """``base`` with the swept ``axis`` set to ``value``."""
    if axis not in SCENARIO_AXES:
        raise ValueError(f"unknown scenario axis {axis!r}; "
                         f"choose from {SCENARIO_AXES}")
    if axis == "queue_order":
        return dataclasses.replace(base, queue_order=str(value))
    if axis == "backfill_depth":
        return dataclasses.replace(base, backfill_depth=int(value))
    if axis in ("on_demand_frac", "rigid_frac"):
        jc = base.job_classes
        rigid = jc.rigid if axis == "on_demand_frac" else float(value)
        on_demand = float(value) if axis == "on_demand_frac" \
            else jc.on_demand
        return dataclasses.replace(base, job_classes=JobClasses(
            rigid=rigid, on_demand=on_demand,
            malleable=1.0 - rigid - on_demand, seed=jc.seed))
    return dataclasses.replace(base, **{axis: float(value)})


def render_scenario_table(axis: str, results_by_value: Dict[float, Dict],
                          metrics: Sequence[str] = (
                              "turnaround_mean", "wait_mean",
                              "utilization")) -> str:
    """Sensitivity table: strategies x swept scenario-axis values.

    ``results_by_value`` maps each swept value to one workload's results
    in the shared artifact schema (all from the same base spec).  Each
    metric block shows the rigid baseline and every strategy at the
    spec's highest malleable proportion, one column per axis value.
    """
    # one axis sweeps one value type (all-float, or all-str for the
    # categorical queue_order axis); the type tag keeps mixed dicts sortable
    values = sorted(results_by_value,
                    key=lambda v: (isinstance(v, str), v))
    first = results_by_value[values[0]]
    meta = first["_meta"]
    pct = max(int(p * 100) for p in meta["proportions"])
    labels = [axis_label(axis, v) for v in values]
    width = max(16, max(len(lb) for lb in labels) + 2)
    out = [f"== Scenario sensitivity: {meta['workload']} x {axis} "
           f"(scale {meta['scale']}, {meta['seeds']} seeds, "
           f"strategies at {pct}% malleable) =="]
    for metric in metrics:
        out.append(f"  {metric}:")
        out.append("    strategy  " + "".join(
            lb.rjust(width) for lb in labels))
        rows = [("rigid", metric, "")] + [
            (s, f"{metric}_mean", f"{s}@{pct}")
            for s in _strategies_of(first)]
        table = []
        for label, key, cell in rows:
            vals = []
            for v in values:
                r = results_by_value[v]
                src = r["rigid"] if label == "rigid" else r.get(cell, {})
                vals.append(src.get(key, float("nan")))
            table.append((label, vals))
        finite = [v for _, vals in table for v in vals if np.isfinite(v)]
        # fraction-valued metrics (e.g. utilization) need the decimals a
        # cross-value comparison lives on; big second-valued ones don't
        dec = 3 if finite and max(abs(v) for v in finite) < 10 else 1
        for label, vals in table:
            out.append(f"    {label:<9}" + "".join(
                f"{v:>{width},.{dec}f}" if np.isfinite(v)
                else f"{'-':>{width}}" for v in vals))
    return "\n".join(out)


def _strategies_of(results: Dict) -> Sequence[str]:
    return results.get("_meta", {}).get("strategies",
                                        MALLEABLE_STRATEGY_NAMES)


def render_sweep_table(results: Dict, metrics: Sequence[str] = (
        "turnaround_mean", "wait_mean", "utilization")) -> str:
    """Figs 6-9 analogue: strategy x proportion metric tables."""
    meta = results["_meta"]
    props = [int(p * 100) for p in meta["proportions"]]
    out = [f"== Fig 6-9 analogue: {meta['workload']} "
           f"(scale {meta['scale']}, {meta['seeds']} seeds) =="]
    for metric in metrics:
        out.append(f"  {metric}:")
        hdr = "    strategy  " + "".join(f"{p:>12d}%" for p in props)
        out.append(hdr)
        rigid_v = results["rigid"].get(metric, float("nan"))
        for strat in _strategies_of(results):
            cells = []
            for p in props:
                if p == 0:
                    # malleable strategies degenerate to the rigid
                    # baseline at 0%; a pinned-order rigid strategy
                    # (rigid_sjf) carries its own aggregate there
                    r = results.get(f"{strat}@0", {})
                    v = r.get(f"{metric}_mean", rigid_v)
                else:
                    r = results.get(f"{strat}@{p}", {})
                    v = r.get(f"{metric}_mean", float("nan"))
                cells.append(f"{v:>13,.1f}" if np.isfinite(v) else
                             f"{'-':>13}")
            out.append(f"    {strat:<9}" + "".join(cells))
    return "\n".join(out)


def best_improvements(results: Dict) -> Dict[str, Dict[str, float]]:
    """Paper-abstract summary: best strategy at 100% vs rigid, per metric."""
    rigid = results["rigid"]
    strategies = _strategies_of(results)
    out = {}
    for metric, key in (("turnaround", "turnaround_mean"),
                        ("makespan", "makespan_mean"),
                        ("wait", "wait_mean")):
        best, best_strat = None, None
        for strat in strategies:
            r = results.get(f"{strat}@100")
            if not r:
                continue
            v = r.get(f"{key}_mean", np.nan)
            if np.isfinite(v) and (best is None or v < best):
                best, best_strat = v, strat
        if best is not None:
            out[metric] = {"rigid": rigid[key], "best": best,
                           "strategy": best_strat,
                           "improvement_pct": improvement(rigid[key], best)}
    # utilization: higher is better
    best, best_strat = None, None
    for strat in strategies:
        r = results.get(f"{strat}@100")
        if not r:
            continue
        v = r.get("utilization_mean", np.nan)
        if np.isfinite(v) and (best is None or v > best):
            best, best_strat = v, strat
    if best is not None:
        out["utilization"] = {
            "rigid": rigid["utilization"], "best": best,
            "strategy": best_strat,
            "improvement_pct": 100.0 * (best - rigid["utilization"])
            / max(rigid["utilization"], 1e-9)}
    return out
