"""Execute an :class:`ExperimentSpec`: store -> backend -> artifact.

The port of ``repro.experiments.run``; :func:`run_experiment` is what
``python -m repro_torch.experiments`` runs:

1. fingerprint every (workload, cell) of the spec and read the shared
   cell store (:mod:`repro_torch.sweep.cache`) — cells either engine
   already paid for are not recomputed;
2. hand the remaining cells to the spec's backend
   (:mod:`backend_torch` on the card / :mod:`backend_des` on the host;
   both write completed cells back through the store, so interrupted runs
   resume, and neither ever stores a cell cut off by the step budget);
3. aggregate per-workload into the shared artifact schema::

       {"rigid": metrics, "<strat>@<pct>": aggregate_seeds(...),
        "_meta": {..., "spec": fingerprint, "spec_key": sha256},
        "_engine": {...}, ["_crosscheck": {...}]}

   ``_meta["spec_key"]`` is the content hash of the single-workload spec
   slice — artifact consumers key reuse on it, which is what makes stale
   artifacts (different scale/seeds/scenario/engine version) impossible
   to replay silently.  A ``des`` spec's key equals the JAX package's for
   the same spec.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional

from repro_torch import obs
from repro_torch.core import aggregate_seeds
from repro_torch.core.strategies import STRATEGIES
from repro_torch.sweep.cache import SweepCache

from . import backend_des, backend_torch
from .spec import ExperimentSpec


BACKENDS = {"des": backend_des, "torch": backend_torch}


def run_experiment(spec: ExperimentSpec, *,
                   cache_dir: Optional[str] = None,
                   backend_options: Optional[Dict] = None,
                   crosscheck: int = 0,
                   crosscheck_seed: int = 0,
                   verbose: bool = True) -> Dict[str, Dict]:
    """Run ``spec``; returns ``{workload: results}`` in the artifact schema.

    ``cache_dir`` enables the shared per-cell store (both engines read and
    write it).  ``backend_options`` are results-neutral knobs (des:
    ``workers``, ``progress``; torch: ``device``, ``expand_backend``,
    ``window``, ``chunk``, ``events``, ``progress``).  ``crosscheck N``
    re-runs N seeded-sampled cells per workload through the reference DES
    (torch engine only; the DES *is* the reference — requesting it on a
    DES spec raises rather than passing vacuously).
    """
    if crosscheck and spec.engine != "torch":
        raise ValueError("crosscheck compares the torch engine against the "
                         "reference DES; it is meaningless for engine="
                         f"{spec.engine!r}")
    cells = spec.cells()
    with obs.span("experiment.fingerprint", engine=spec.engine,
                  cells=len(cells) * len(spec.workloads)):
        fingerprints = {(name, cell): spec.cell_fingerprint(name, cell)
                        for name in spec.workloads for cell in cells}
    store = SweepCache(cache_dir) if cache_dir else None

    metrics: Dict[tuple, Dict[str, float]] = {}
    if store is not None:
        with obs.span("experiment.store_read", cells=len(fingerprints)):
            for key, fp in fingerprints.items():
                hit = store.get(fp)
                if hit is not None:
                    metrics[key] = hit

    todo = [(name, c) for name in spec.workloads for c in cells
            if (name, c) not in metrics]
    engine_info: Dict[str, object] = {
        "engine": spec.engine, "workloads": len(spec.workloads),
        "cache_hits": len(metrics), "computed_cells": 0, "sim_seconds": 0.0,
        # the cells a pure-store run would have to compute, in the stable
        # "workload/strategy@pct/sN" shape --expect-cached reports on miss
        "missed_cells": [f"{n}/{s}@{int(p * 100)}/s{sd}"
                         for n, (s, p, sd) in todo],
    }
    if todo:
        computed, info = BACKENDS[spec.engine].run_cells(
            spec, todo, store, fingerprints, options=backend_options,
            verbose=verbose)
        metrics.update(computed)
        engine_info.update(info)
    # cells whose lane never ran to completion (step-budget cutoff): their
    # metrics are partial and must poison downstream whole-file reuse
    incomplete = set(engine_info.pop("incomplete", []))
    # whole-run split: computed (complete, stored) vs. incomplete
    # (attempted, not stored) — computed_cells alone must never imply
    # full coverage of the todo list
    engine_info["incomplete_cells_total"] = len(incomplete)

    # -- assemble the shared artifact schema per workload -----------------
    out: Dict[str, Dict] = {}
    for name in spec.workloads:
        wl_metrics = {c: metrics[(name, c)] for c in cells}
        rigid = wl_metrics[("easy", 0.0, 0)]
        results: Dict[str, Dict] = {"rigid": rigid}
        for strat in spec.strategies:
            if not STRATEGIES[strat].malleable:
                # proportion-invariant (rigid_sjf): its single cell fills
                # every proportion column so renderers need no special case
                agg = aggregate_seeds([wl_metrics[(strat, 0.0, 0)]])
                for prop in spec.proportions:
                    results[f"{strat}@{int(prop * 100)}"] = agg
                if verbose:
                    print(f"[experiment:{name}] {strat} (rigid, all "
                          f"proportions): turnaround="
                          f"{agg['turnaround_mean_mean']:,.0f} "
                          f"wait={agg['wait_mean_mean']:,.0f} "
                          f"util={agg['utilization_mean']:.3f}")
                continue
            for prop in spec.proportions:
                if prop == 0.0:
                    results[f"{strat}@0"] = rigid
                    continue
                per_seed = [wl_metrics[(strat, float(prop), sd)]
                            for sd in range(spec.seeds)]
                agg = aggregate_seeds(per_seed)
                results[f"{strat}@{int(prop * 100)}"] = agg
                if verbose:
                    print(f"[experiment:{name}] {strat}@{int(prop * 100)}%: "
                          f"turnaround={agg['turnaround_mean_mean']:,.0f}"
                          f"±{agg['turnaround_mean_iqr']:,.0f} "
                          f"wait={agg['wait_mean_mean']:,.0f} "
                          f"util={agg['utilization_mean']:.3f} "
                          f"expand/job={agg['expand_per_job_mean']:.1f} "
                          f"shrink/job={agg['shrink_per_job_mean']:.1f}")
        wl_spec = spec.for_workload(name)
        results["_meta"] = {
            "workload": name, "scale": spec.scale, "seeds": spec.seeds,
            "proportions": list(spec.proportions),
            "strategies": list(spec.strategies),
            "engine": spec.engine,
            "spec": wl_spec.fingerprint(),
            "spec_key": wl_spec.key(),
        }
        # engine stats are whole-run (the torch path stacks every
        # workload's lanes into one batch); only the lane count is
        # per-workload
        results["_engine"] = {
            **engine_info, "scope": "batch",
            "workload_lanes": sum(1 for n, _ in todo if n == name),
            "incomplete_cells": sum(1 for n, _ in incomplete if n == name),
        }
        if crosscheck:
            from .crosscheck import crosscheck_cells
            # incomplete (step-budget-cut) lanes have partial metrics: a
            # fidelity comparison against them would report a misleading
            # tolerance breach, so they are not eligible samples
            complete = {c: m for c, m in wl_metrics.items()
                        if (name, c) not in incomplete}
            results["_crosscheck"] = crosscheck_cells(
                spec, name, complete, n_cells=crosscheck,
                rng_seed=crosscheck_seed, store=store, verbose=verbose)
        out[name] = results
    return out


def sweep_scenario_axis(spec: ExperimentSpec, axis: str,
                        values, **run_kwargs) -> Dict[float, Dict]:
    """Run ``spec`` once per swept scenario-axis value.

    Returns ``{value: {workload: results}}``.  Every variant differs from
    ``spec`` only in the swept axis, so with a ``cache_dir`` the variants
    share every cell the axis does not invalidate (and re-runs of the
    whole sweep are pure store hits).  Rendering lives in
    :func:`repro_torch.experiments.report.render_scenario_table`.
    """
    import dataclasses

    from .report import axis_key, scenario_variant

    out: Dict = {}
    for value in values:
        variant = dataclasses.replace(
            spec, scenario=scenario_variant(spec.scenario, axis, value))
        # numeric axes keep the historical float keys; the categorical
        # queue_order axis keys by the value string itself ("sjf")
        out[axis_key(value)] = run_experiment(variant, **run_kwargs)
    return out


def write_artifact(path, results: Dict, summary: Optional[Dict] = None
                   ) -> pathlib.Path:
    """Write one workload's results (+ optional summary) as JSON."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"results": results}
    if summary is not None:
        payload["summary"] = summary
    path.write_text(json.dumps(payload, indent=1, default=float))
    return path


def load_artifact_results(path, spec: ExperimentSpec,
                          workload: str) -> Optional[Dict]:
    """Results from an artifact iff it matches this spec's fingerprint.

    Returns None when the file is missing, unreadable, or was produced by
    a *different* experiment (other scale, seeds, trace seed, scenario,
    transform config, engine, or engine version), or whose cells were cut
    off by the step budget — the stale-artifact guard for whole-file
    reuse.
    """
    path = pathlib.Path(path)
    if not path.exists():
        return None
    try:
        results = json.loads(path.read_text())["results"]
    except (OSError, json.JSONDecodeError, KeyError):
        return None
    if not isinstance(results, dict):
        return None
    want = spec.for_workload(workload).key()
    if results.get("_meta", {}).get("spec_key") != want:
        return None
    if results.get("_engine", {}).get("incomplete_cells"):
        return None  # partial metrics (step-budget cutoff): never replay
    return results
