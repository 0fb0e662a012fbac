"""Seeded DES crosscheck of batched-engine cells (the fidelity gate).

The port of ``repro.experiments.crosscheck``: re-runs sampled torch-engine
cells through the reference numpy DES — with the *same spec* (trace,
transform, scenario axes) — and reports per-metric deltas against the
documented engine fidelity gaps.  When a cell store is
available, reference values are read from (and newly-computed ones written
to) the store under the *des-engine* fingerprint, so the crosscheck reuses
DES cells any earlier run already paid for.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.sweep.cache import SweepCache

from .backend_des import simulate_cell
from .spec import Cell, ExperimentSpec

# Crosscheck tolerances vs. the numpy DES: (relative, absolute), the
# reference's unchanged: the port's batched engine schedules as the JAX
# one does, bit for bit.  The two engines differ by documented
# approximations (tick-quantized completions,
# cumulative-round shadow-time backfill vs. the DES's sequential scan,
# FCFS tie-breaks, converge-over-ticks scheduling), so these bound the
# *expected* methodology gap, not float noise.  Tightened for engine v2:
# the batched engine now honours the EASY head reservation (shadow time),
# which removed the dominant backfill-lite error term.  Absolute floors
# are in the metric's own unit and matter where the reference value is
# near zero (e.g. wait at low contention).
CROSSCHECK_TOLERANCES = {
    "turnaround_mean": (0.08, 45.0),
    "makespan_mean": (0.08, 45.0),
    "wait_mean": (0.20, 90.0),
    "utilization": (0.05, 0.015),
}


def crosscheck_cells(spec: ExperimentSpec, name: str,
                     metrics: Dict[Cell, Dict[str, float]], *,
                     n_cells: int, rng_seed: int = 0,
                     store: Optional[SweepCache] = None,
                     verbose: bool = True) -> Dict:
    """Re-run sampled cells through the numpy DES; report metric deltas.

    Cells are drawn without replacement from the *sorted* cell list by a
    generator seeded with ``rng_seed``, so repeated runs over the same grid
    (e.g. CI) always check the same cells.
    """
    t0 = time.monotonic()
    # same trace/transform/scenario; the engine field only keys the store
    des_spec = dataclasses.replace(spec, engine="des")
    cells = sorted(metrics)
    rng = np.random.default_rng(rng_seed)
    picked = [cells[i] for i in
              rng.choice(len(cells), size=min(n_cells, len(cells)),
                         replace=False)]
    records = []
    store_hits = 0
    for cell in picked:
        strat, prop, seed = cell
        fp = des_spec.cell_fingerprint(name, cell) if store else None
        ref = store.get(fp) if store else None
        if ref is None:
            ref = simulate_cell(des_spec, name, cell)
            if store is not None:
                store.put(fp, ref)
        else:
            store_hits += 1
        got = metrics[cell]
        deltas = {}
        ok = True
        for key, (rtol, atol) in CROSSCHECK_TOLERANCES.items():
            a, b = ref[key], got[key]
            if not (np.isfinite(a) and np.isfinite(b)):
                continue
            err = abs(b - a)
            within = bool(err <= max(rtol * abs(a), atol))
            ok &= within
            deltas[key] = {"des": a, "torch": b, "abs_err": err,
                           "within": within}
        records.append({"cell": f"{strat}@{int(prop * 100)}%/s{seed}",
                        "within_tolerance": ok, "deltas": deltas})
        if verbose:
            worst = max(deltas.values(),
                        key=lambda d: d["abs_err"] / max(abs(d["des"]), 1e-9))
            print(f"[crosscheck:{name}] {strat}@{int(prop * 100)}%/s{seed}: "
                  f"{'OK' if ok else 'EXCEEDS TOLERANCE'} "
                  f"(worst rel err "
                  f"{worst['abs_err'] / max(abs(worst['des']), 1e-9):.1%})")
    return {"cells": records,
            "rng_seed": rng_seed,
            "store_hits": store_hits,
            "requested": n_cells,
            # an empty sample (every lane incomplete) verified nothing and
            # must fail a --require-crosscheck gate, not pass vacuously
            "all_within_tolerance": bool(records) and all(
                r["within_tolerance"] for r in records),
            # DES re-runs are reference work, not engine time: recorded so
            # benchmarks can separate them from the engine wall-clock
            "seconds": time.monotonic() - t0}
