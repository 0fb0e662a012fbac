"""Speedup model and the rigid -> malleable transform (paper §2.2).

A copy of ``repro.core.speedup`` (plus :func:`batched_malleable_params`, the
batched engine's form of the transform), kept so the port imports nothing
of ``repro``.  Each job follows an Amdahl curve

    S(n) = 1 / ((1 - p) + p / n),        E(n) = S(n) / n,

with ``p`` calibrated so the job's observed allocation ``nodes_req`` runs at
a sampled reference efficiency ``e_ref ~ U(e_ref_range)``; the malleable
range follows from efficiency thresholds:

    pref = largest n with E(n) >= e_pref
    max  = largest n with E(n) >= e_min
    min  = max(1, nodes_req // 2)

capped by multiples of the rigid request and the cluster size.  The draws
come from numpy's seeded generator, so cells are bit-identical to the JAX
package's for the same (proportion, seed).  :func:`progress_rate` is the
simulators' rate of work, and :class:`TabulatedSpeedup` a roofline-derived
S(n) table for ML jobs (beyond the paper).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .jobs import Workload


def amdahl_speedup(n, p):
    """S(n) for parallel fraction p (float64 numpy)."""
    n = np.maximum(np.asarray(n, dtype=np.float64), 1.0)
    return 1.0 / ((1.0 - p) + p / n)


def amdahl_efficiency(n, p):
    return amdahl_speedup(n, p) / np.maximum(np.asarray(n, dtype=np.float64), 1.0)


def pfrac_for_reference_efficiency(n_ref, e_ref):
    """Parallel fraction p such that E(n_ref) == e_ref.

    E(n) = 1 / (n (1-p) + p)  ==>  p = (n - 1/e) / (n - 1)   for n > 1.
    Single-node jobs are calibrated at n = 2 instead (p = 2 - 1/e).
    """
    n = np.asarray(n_ref, dtype=np.float64)
    e = np.asarray(e_ref, dtype=np.float64)
    multi = n > 1.0
    p_multi = (n - 1.0 / e) / np.maximum(n - 1.0, 1e-12)
    p_single = 2.0 - 1.0 / e
    p = np.where(multi, p_multi, p_single)
    return np.clip(p, 0.0, 1.0 - 1e-9)


def nodes_at_efficiency(p, e):
    """Largest n with E(n) >= e:  n <= (1/e - p) / (1 - p)."""
    p = np.asarray(p, dtype=np.float64)
    n = (1.0 / e - p) / np.maximum(1.0 - p, 1e-12)
    return np.maximum(np.floor(n + 1e-9).astype(np.int64), 1)


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """Knobs of the rigid -> malleable transformation."""

    e_ref_range: tuple = (0.75, 0.9)  # sampled reference efficiency at n_req
    e_pref: float = 0.7               # efficiency threshold for pref nodes
    e_min: float = 0.5                # efficiency threshold for max nodes
    min_divisor: int = 2              # min = max(1, n_req // min_divisor)
    pref_cap_factor: int = 2          # pref <= pref_cap_factor * n_req
    max_cap_factor: int = 4           # max  <= max_cap_factor * n_req


def _malleable_ranges(nodes_req, e_ref, cluster_nodes, config):
    """Per-job (pfrac, min, pref, max) from sampled reference efficiencies."""
    p = pfrac_for_reference_efficiency(nodes_req, e_ref)

    pref = nodes_at_efficiency(p, config.e_pref)
    mx = nodes_at_efficiency(p, config.e_min)
    mn = np.maximum(1, nodes_req // config.min_divisor)

    pref = np.minimum(pref, config.pref_cap_factor * nodes_req)
    mx = np.minimum(mx, config.max_cap_factor * nodes_req)
    mx = np.minimum(mx, cluster_nodes)
    pref = np.minimum(pref, mx)
    pref = np.maximum(pref, mn)
    mx = np.maximum(mx, pref)
    mn = np.minimum(mn, pref)
    return p, mn, pref, mx


def _seed_draws(workload: Workload, seed: int, config: TransformConfig):
    """The per-seed draws: job permutation, then reference efficiencies.

    The permutation comes first so malleable selections nest across
    proportions at a fixed seed.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(workload.n_jobs)
    e_ref = rng.uniform(*config.e_ref_range, size=workload.n_jobs)
    return perm, e_ref


def transform_rigid_to_malleable(
    workload: Workload,
    proportion: float,
    seed: int,
    cluster_nodes: int,
    config: TransformConfig = TransformConfig(),
) -> Workload:
    """Convert a random ``proportion`` of jobs to malleable variants.

    Matches the paper's methodology (§2.3): the *same* workload is reused
    across proportions; a pseudo-random seed selects which jobs become
    malleable, and results are averaged over seeds.  Jobs pinned rigid by
    a workload-class assignment (``job_class != CLASS_NORMAL``, see
    :mod:`repro_torch.core.scenario`) are never converted: the selection still
    consumes the same permutation prefix, so the malleable subset nests
    across proportions and stays bit-identical to the batched transform.
    """
    if not 0.0 <= proportion <= 1.0:
        raise ValueError(f"proportion must be in [0,1], got {proportion}")
    w = workload.copy()
    n = w.n_jobs
    perm, e_ref = _seed_draws(w, seed, config)
    k = int(round(proportion * n))
    chosen = perm[:k]
    chosen = chosen[workload.transformable[chosen]]

    p, mn, pref, mx = _malleable_ranges(w.nodes_req, e_ref, cluster_nodes,
                                        config)

    mask = np.zeros(n, dtype=bool)
    mask[chosen] = True
    w.malleable = mask
    w.pfrac = np.where(mask, p, w.pfrac)
    w.min_nodes = np.where(mask, mn, w.nodes_req)
    w.max_nodes = np.where(mask, mx, w.nodes_req)
    w.pref_nodes = np.where(mask, pref, w.nodes_req)
    w.validate(cluster_nodes)
    return w


def batched_malleable_params(
    workload: Workload,
    cells: Sequence[tuple],
    cluster_nodes: int,
    config: TransformConfig = TransformConfig(),
):
    """Stacked (B, n) malleable parameters for ``cells`` of (proportion, seed).

    Returns a dict of numpy arrays: ``malleable`` (B, n) bool and
    ``pfrac/min_nodes/max_nodes/pref_nodes`` (B, n).  Jobs pinned rigid by a
    workload class are never converted.
    """
    n = workload.n_jobs
    by_seed = {}
    for prop, seed in cells:
        if not 0.0 <= prop <= 1.0:
            raise ValueError(f"proportion must be in [0,1], got {prop}")
        if seed not in by_seed:
            perm, e_ref = _seed_draws(workload, seed, config)
            by_seed[seed] = (perm, _malleable_ranges(
                workload.nodes_req, e_ref, cluster_nodes, config))

    B = len(cells)
    out = {
        "malleable": np.zeros((B, n), dtype=bool),
        "pfrac": np.tile(workload.pfrac, (B, 1)),
        "min_nodes": np.tile(workload.nodes_req, (B, 1)),
        "max_nodes": np.tile(workload.nodes_req, (B, 1)),
        "pref_nodes": np.tile(workload.nodes_req, (B, 1)),
    }
    for b, (prop, seed) in enumerate(cells):
        perm, (p, mn, pref, mx) = by_seed[seed]
        chosen = perm[: int(round(prop * n))]
        chosen = chosen[workload.transformable[chosen]]
        out["malleable"][b, chosen] = True
        out["pfrac"][b, chosen] = p[chosen]
        out["min_nodes"][b, chosen] = mn[chosen]
        out["max_nodes"][b, chosen] = mx[chosen]
        out["pref_nodes"][b, chosen] = pref[chosen]
    return out


# ----------------------------------------------------------------------
# Rate helpers used by the simulators.  A job's total work is normalized to
# 1.0; at allocation ``a`` it progresses at ``rate(a)`` fractions/second so
# that running at the reference allocation reproduces the trace runtime:
#     rate(a) = S(a) / (S(n_req) * runtime_ref).
def progress_rate(alloc, pfrac, nodes_req, runtime):
    s_ref = amdahl_speedup(nodes_req, pfrac)
    s_cur = amdahl_speedup(alloc, pfrac)
    return s_cur / (s_ref * np.asarray(runtime, dtype=np.float64))


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TabulatedSpeedup:
    """Roofline-derived speedup table for ML jobs (beyond-paper).

    ``nodes`` must be ascending; ``speedup`` is S(nodes[i]) relative to
    nodes[0].  Lookup interpolates geometrically between entries.
    """

    nodes: Sequence[int]
    speedup: Sequence[float]

    def __call__(self, n) -> np.ndarray:
        xs = np.log(np.asarray(self.nodes, dtype=np.float64))
        ys = np.log(np.asarray(self.speedup, dtype=np.float64))
        q = np.log(np.maximum(np.asarray(n, dtype=np.float64), 1.0))
        return np.exp(np.interp(q, xs, ys))

    @staticmethod
    def from_roofline(
        nodes: Sequence[int],
        compute_s: float,
        memory_s: float,
        collective_s_per_node: Optional[Sequence[float]] = None,
    ) -> "TabulatedSpeedup":
        """Build S(n) from per-job roofline terms measured at n=1.

        T(n) = max(compute_s / n, memory_s / n, coll(n)); collective term
        defaults to a ring all-reduce model ~ 2*(n-1)/n * grad_bytes/link,
        here abstracted as a provided per-n sequence.
        """
        ts = []
        for i, n in enumerate(nodes):
            coll = collective_s_per_node[i] if collective_s_per_node else 0.0
            ts.append(max(compute_s / n, memory_s / n, coll))
        s = [ts[0] / t for t in ts]
        return TabulatedSpeedup(nodes=list(nodes), speedup=s)
