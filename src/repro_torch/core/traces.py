"""Synthetic statistical twins of the paper's workload traces + cleaning.

A copy of ``repro.core.traces``, kept so the port imports nothing of
``repro``: :func:`generate` gives byte-identical
:class:`~repro_torch.core.jobs.Workload` arrays to the JAX package's for the
same ``(name, seed, scale)``.  The twins follow every distribution the paper
publishes:

  * Haswell (Figs. 3a/3b): 50% single-node, 97.8% <= 32 nodes; 75% of
    runtimes <= 1000 s; 28,259 jobs / 5 days; burst near t = 300,000 s.
  * KNL (Figs. 5a/5b): 63% exactly 4 nodes; 41,524 jobs / 5 days.
  * Eagle (Figs. 5c/5d): 96.6% single-node; 143,829 jobs / 28 days.
  * Theta (Figs. 5e/5f): node peaks at 1, 8 and 256; 2,550 jobs / 28 days.

``scale`` < 1 shrinks duration and job count together (submission rate and
cluster capacity preserved); ``scale=1`` reproduces paper-size traces.

The cleaning pipeline (paper §2.2, Table 1, Fig. 1): :func:`corrupt_trace`
re-introduces the artifacts the paper found in the raw Cori data (daily
split entries, shared-node jobs, GPU nodes) and :func:`clean_trace` removes
them (merge splits, drop shared/GPU jobs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .cluster import CLUSTERS, Cluster
from .jobs import Workload

DAY = 86400.0


@dataclasses.dataclass(frozen=True)
class LogNormalMix:
    """Mixture of lognormals given as (weight, median_seconds, sigma)."""

    components: Tuple[Tuple[float, float, float], ...]

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        ws = np.array([c[0] for c in self.components])
        ws = ws / ws.sum()
        comp = rng.choice(len(ws), size=n, p=ws)
        med = np.array([c[1] for c in self.components])[comp]
        sig = np.array([c[2] for c in self.components])[comp]
        out = med * np.exp(sig * rng.standard_normal(n))
        return np.clip(out, 30.0, 7 * DAY)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    duration: float
    n_jobs: int
    node_values: Tuple[int, ...]
    node_probs: Tuple[float, ...]
    runtime: LogNormalMix
    rigid_util: float               # paper's 0%-malleable node utilization
    diurnal_amp: float = 0.3
    burst: Tuple[float, float, float] | None = None  # (center, width, weight)
    load_factor: float = 1.0        # offered-load calibration factor

    @property
    def cluster(self) -> Cluster:
        return CLUSTERS[self.name]


HASWELL_SPEC = TraceSpec(
    name="haswell", duration=5 * DAY, n_jobs=28_259,
    node_values=(1, 2, 3, 4, 8, 16, 24, 32, 64, 128, 256, 512),
    node_probs=(0.50, 0.13, 0.04, 0.10, 0.08, 0.07, 0.02, 0.038,
                0.012, 0.006, 0.003, 0.001),
    runtime=LogNormalMix(((0.75, 180.0, 1.0), (0.25, 5000.0, 1.0))),
    rigid_util=0.7233,
    burst=(300_000.0, 7_200.0, 0.02),
    load_factor=0.95,
)

KNL_SPEC = TraceSpec(
    name="knl", duration=5 * DAY, n_jobs=41_524,
    node_values=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
    node_probs=(0.10, 0.06, 0.63, 0.07, 0.05, 0.034,
                0.03, 0.015, 0.008, 0.003),
    runtime=LogNormalMix(((0.35, 700.0, 0.08), (0.45, 250.0, 1.0),
                          (0.20, 4000.0, 1.0))),
    rigid_util=0.855,
    load_factor=1.012,
)

EAGLE_SPEC = TraceSpec(
    name="eagle", duration=28 * DAY, n_jobs=143_829,
    node_values=(1, 2, 4, 8, 16, 36),
    node_probs=(0.966, 0.012, 0.010, 0.006, 0.004, 0.002),
    runtime=LogNormalMix(((0.87, 800.0, 1.3), (0.13, 40_000.0, 0.8))),
    rigid_util=0.2871,
    load_factor=1.0,
)

THETA_SPEC = TraceSpec(
    name="theta", duration=28 * DAY, n_jobs=2_550,
    node_values=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048),
    node_probs=(0.348, 0.03, 0.05, 0.203, 0.05, 0.04, 0.04, 0.065,
                0.126, 0.03, 0.015, 0.003),
    runtime=LogNormalMix(((0.55, 1200.0, 1.2), (0.33, 4000.0, 0.8),
                          (0.12, 30_000.0, 0.6))),
    rigid_util=0.7267,
    load_factor=1.05,
)

SPECS: Dict[str, TraceSpec] = {
    s.name: s for s in (HASWELL_SPEC, KNL_SPEC, EAGLE_SPEC, THETA_SPEC)
}


def _submission_times(spec: TraceSpec, rng: np.random.Generator,
                      n: int, duration: float) -> np.ndarray:
    """Inverse-CDF sampling from a diurnal (+ optional burst) intensity."""
    grid = np.linspace(0.0, duration, 2048)
    lam = 1.0 + spec.diurnal_amp * np.sin(2 * np.pi * grid / DAY - np.pi / 2)
    if spec.burst is not None:
        rel = duration / spec.duration
        center, width, weight = spec.burst
        center, width = center * rel, width * rel
        if center < duration:
            lam = lam + weight * len(grid) * np.exp(
                -0.5 * ((grid - center) / width) ** 2) / np.sqrt(2 * np.pi)
    cdf = np.cumsum(lam)
    cdf = cdf / cdf[-1]
    u = np.sort(rng.uniform(0, 1, size=n))
    t = np.interp(u, cdf, grid)
    t = np.sort(t + rng.uniform(0, duration / 2048, size=n))
    return np.clip(t, 0.0, duration)


def _calibrate_offered_load(runtime: np.ndarray, nodes: np.ndarray,
                            rate_per_s: float, capacity: int,
                            target_util: float) -> np.ndarray:
    """Correlate runtimes with job size to hit the paper's rigid utilization
    (bisected exponent ``gamma`` on ``nodes**gamma``, then a global factor)."""
    target_ns = target_util * capacity / rate_per_s

    def offered(gamma):
        return float(np.mean(runtime * nodes ** (1.0 + gamma)))

    lo, hi = 0.0, 1.5
    if offered(hi) < target_ns:
        gamma = hi
    elif offered(lo) > target_ns:
        gamma = lo
    else:
        for _ in range(50):
            mid = 0.5 * (lo + hi)
            if offered(mid) < target_ns:
                lo = mid
            else:
                hi = mid
        gamma = 0.5 * (lo + hi)
    rt = runtime * nodes ** gamma
    rt *= target_ns / float(np.mean(rt * nodes))
    return np.clip(rt, 30.0, 14 * DAY)


def generate(name: str, seed: int = 0, scale: float = 1.0) -> Workload:
    """Generate a rigid workload twin; ``scale`` shrinks duration & jobs."""
    spec = SPECS[name]
    rng = np.random.default_rng(seed + 0xC0FFEE)
    n = max(int(round(spec.n_jobs * scale)), 10)
    duration = spec.duration * scale
    submit = _submission_times(spec, rng, n, duration)
    probs = np.asarray(spec.node_probs, dtype=np.float64)
    probs = probs / probs.sum()
    nodes = rng.choice(np.asarray(spec.node_values), size=n, p=probs)
    runtime = spec.runtime.sample(rng, n)
    runtime = _calibrate_offered_load(
        runtime, nodes, rate_per_s=spec.n_jobs / spec.duration,
        capacity=spec.cluster.nodes,
        target_util=spec.rigid_util * spec.load_factor)
    return Workload.rigid(submit=submit, runtime=runtime, nodes_req=nodes)


# ----------------------------------------------------------------------
# Raw-trace corruption + cleaning (paper §2.2, Fig. 1, Table 1)
@dataclasses.dataclass
class RawTrace:
    """A 'raw' accounting dump with the artifacts the paper had to fix."""

    orig_id: np.ndarray    # job id before daily splitting
    submit: np.ndarray
    runtime: np.ndarray
    nodes: np.ndarray
    node_fraction: np.ndarray  # < 1.0 => shared-node (oversubscribed) job
    gpu: np.ndarray            # GPU-partition job (excluded by the paper)

    @property
    def n_rows(self) -> int:
        return len(self.submit)


@dataclasses.dataclass(frozen=True)
class CleaningReport:
    raw_rows: int
    raw_jobs: int
    cleaned_jobs: int
    runtime_loss_hours: float
    runtime_loss_pct: float


def corrupt_trace(w: Workload, seed: int = 0, shared_frac: float = 0.2,
                  gpu_frac: float = 0.0) -> RawTrace:
    """Re-introduce raw-trace artifacts into a clean workload.

    1. Jobs crossing midnight boundaries are split into daily segments that
       share an ``orig_id`` (the paper's Fig. 1a artifact that inflated
       Haswell utilization past physical capacity).
    2. ``shared_frac`` extra *shared-node* rows are appended (node_fraction
       < 1), modelling oversubscribed jobs the paper removes.
    3. ``gpu_frac`` of rows are marked as GPU-partition jobs.
    """
    rng = np.random.default_rng(seed + 0xBAD)
    oid: List[int] = []
    sub: List[float] = []
    run: List[float] = []
    nod: List[int] = []
    for i in range(w.n_jobs):
        s, r = float(w.submit[i]), float(w.runtime[i])
        # accounting segments split at each midnight after (approximate) start
        start = s  # raw accounting uses submission-day binning
        end = start + r
        seg_start = start
        while True:
            day_end = (np.floor(seg_start / DAY) + 1) * DAY
            seg_end = min(end, day_end)
            oid.append(i)
            sub.append(seg_start)
            run.append(seg_end - seg_start)
            nod.append(int(w.nodes_req[i]))
            if seg_end >= end:
                break
            seg_start = seg_end
    n_rows = len(oid)
    frac = np.ones(n_rows)
    gpu = np.zeros(n_rows, dtype=bool)

    # appended shared-node rows
    n_shared = int(shared_frac * w.n_jobs)
    if n_shared:
        sh_sub = rng.uniform(0, float(np.max(w.submit)), size=n_shared)
        sh_run = rng.lognormal(np.log(3000.0), 1.0, size=n_shared)
        oid.extend(range(w.n_jobs, w.n_jobs + n_shared))
        sub.extend(sh_sub.tolist())
        run.extend(sh_run.tolist())
        nod.extend(rng.integers(1, 4, size=n_shared).tolist())
        frac = np.concatenate([frac, rng.uniform(0.05, 0.5, size=n_shared)])
        gpu = np.concatenate([gpu, np.zeros(n_shared, dtype=bool)])
    if gpu_frac > 0:
        flip = rng.uniform(size=len(oid)) < gpu_frac
        gpu = gpu | flip
    return RawTrace(
        orig_id=np.asarray(oid), submit=np.asarray(sub),
        runtime=np.asarray(run), nodes=np.asarray(nod, dtype=np.int64),
        node_fraction=np.asarray(frac), gpu=np.asarray(gpu),
    )


def clean_trace(raw: RawTrace) -> Tuple[Workload, CleaningReport]:
    """Merge daily splits, drop shared-node and GPU jobs (paper §2.2)."""
    total_hours = float(np.sum(raw.runtime * raw.nodes)) / 3600.0

    keep = (raw.node_fraction >= 1.0) & (~raw.gpu)
    lost_hours = float(np.sum((raw.runtime * raw.nodes)[~keep])) / 3600.0

    ids = raw.orig_id[keep]
    uniq, inv = np.unique(ids, return_inverse=True)
    n = len(uniq)
    submit = np.full(n, np.inf)
    runtime = np.zeros(n)
    nodes = np.zeros(n, dtype=np.int64)
    np.minimum.at(submit, inv, raw.submit[keep])
    np.add.at(runtime, inv, raw.runtime[keep])
    np.maximum.at(nodes, inv, raw.nodes[keep])
    runtime = np.maximum(runtime, 1.0)

    w = Workload.rigid(submit=submit, runtime=runtime, nodes_req=nodes)
    report = CleaningReport(
        raw_rows=raw.n_rows,
        raw_jobs=len(np.unique(raw.orig_id)),
        cleaned_jobs=n,
        runtime_loss_hours=lost_hours,
        runtime_loss_pct=100.0 * lost_hours / max(total_hours, 1e-9),
    )
    return w, report


def raw_utilization_timeline(raw: RawTrace, grid_s: float = 3600.0,
                             duration: float | None = None):
    """Naive busy-node timeline from raw rows (reproduces Fig. 1a's
    over-capacity artifact when splits/shared jobs are present)."""
    if duration is None:
        duration = float(np.max(raw.submit + raw.runtime))
    edges = np.arange(0.0, duration + grid_s, grid_s)
    busy = np.zeros(len(edges) - 1)
    s = raw.submit
    e = raw.submit + raw.runtime
    for k in range(len(edges) - 1):
        lo, hi = edges[k], edges[k + 1]
        ov = np.maximum(np.minimum(e, hi) - np.maximum(s, lo), 0.0)
        busy[k] = np.sum(ov * raw.nodes) / grid_s
    return edges[:-1], busy
