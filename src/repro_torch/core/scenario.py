"""Scenario axes: what-if transformations of a rigid trace (beyond §2.3).

A copy of ``repro.core.scenario``: the port must realize bit-identical
workloads without importing ``repro``.

The paper evaluates the malleability grid on the traces *as recorded*.
The related work asks follow-up questions the experiment layer makes
sweepable:

  * **Walltime accuracy** (Chadha et al., dynamic resource-aware batch
    scheduling): EASY's shadow-time reservation plans with the *requested*
    walltime, so per-job estimate quality changes backfill behavior.
    ``walltime_factor`` rescales each job's walltime *slack*:

        walltime' = runtime * (1 + f * (walltime / runtime - 1))

    ``f = 1`` keeps the trace (the paper's 125% rule => 25% padding),
    ``f = 0`` makes every estimate exact, ``f = 4`` inflates the paper's
    padding to 100%.  Note that on the synthetic twins the 125% rule is
    *uniform*, and a global rescaling of homogeneous slack provably
    cancels out of every EASY shadow/fit comparison (all estimated
    durations scale by the same factor, and so does the shadow horizon) —
    the schedule is bit-identical (tested in ``tests/test_experiments.
    py``).  What changes schedules is estimate *heterogeneity*:
    ``walltime_jitter = s`` spreads each job's slack by a deterministic
    per-job unit-mean factor drawn from ``walltime_dist`` with the
    spec-seeded generator ``walltime_seed`` — the Chadha-style per-user
    accuracy *distribution*, not just a global factor:

      - ``lognormal``: slack *= exp(s*g_j - s^2/2) (unit mean; the
        classic heavy-tailed over-estimation spread);
      - ``uniform``: slack *= U[1-a, 1+a] with a = min(sqrt(3)*s, 1)
        (unit mean, standard deviation ~ s, bounded support);
      - ``exact_frac``: a fraction ``min(s, 1)`` of jobs get *exact*
        estimates (slack 0) and the rest keep theirs — the bimodal
        "some users request precisely" population.

  * **Arrival compression / burstiness** (Fan & Lan, hybrid workload
    scheduling): ``arrival_compression = c`` divides all submission times
    by ``c``, raising the offered arrival rate c-fold without touching job
    shapes — queue-pressure sensitivity at fixed work mix.

  * **Backfill depth**: how many queued candidates behind the blocked head
    the EASY scan may consider.  Honoured bit-consistently by all three
    engines since the policy core bounds the scan itself
    (:func:`repro_torch.core.passes.schedule_tick` masks candidates past the
    depth'th queue rank; the DES slices its queue).

  * **Queue order** (``fcfs`` | ``sjf``): the order waiting jobs are
    scanned in.  ``sjf`` keys the queue on *walltime estimates* (so it
    composes with the walltime-accuracy axes above and with EASY's
    estimate-driven reservation), reordering the queue the FCFS prefix,
    head reservation and depth-bounded backfill scan all walk — in every
    engine (the DES inserts into a sorted queue, the vectorized passes
    permute slots by a per-lane sort key).  A strategy that pins its own
    order (``rigid_sjf``) overrides the axis per lane
    (:func:`repro_torch.core.strategies.effective_queue_order`).

  * **Job classes** (Fan & Lan hybrid workloads): :class:`JobClasses`
    partitions the trace into *rigid* (pinned rigid, normal queue rank),
    *on-demand* (pinned rigid + queue priority over every non-on-demand
    waiting job) and *malleable-eligible* jobs, with sweepable mix
    fractions.  The cell's malleable ``proportion`` then applies on top:
    only eligible jobs it selects are actually transformed, so the class
    mix replaces the single global proportion as the only mix knob.

All workload transformations are pure and engine-agnostic: backends apply
:func:`apply_scenario` to the generated rigid trace *before* the
rigid->malleable transform, so DES and JAX lanes see bit-identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .jobs import CLASS_NORMAL, CLASS_ON_DEMAND, CLASS_RIGID, Workload

DEFAULT_BACKFILL_DEPTH = 256
DEFAULT_WALLTIME_SEED = 0xE57

WALLTIME_DISTS = ("lognormal", "uniform", "exact_frac")


@dataclasses.dataclass(frozen=True)
class JobClasses:
    """Workload-class mix: fractions must partition the trace (sum to 1).

    Every job lands in exactly one class (a seeded permutation assigns
    ``round(rigid * n)`` jobs to the pinned-rigid class, the next
    ``round(on_demand * n)`` to on-demand, the rest stay eligible for the
    malleable transform) — property-tested in ``tests/test_experiments.py``.
    """

    rigid: float = 0.0      # pinned rigid, normal queue rank
    on_demand: float = 0.0  # pinned rigid + queue priority
    malleable: float = 1.0  # eligible for the rigid->malleable transform
    seed: int = 0           # class-assignment permutation seed

    def __post_init__(self) -> None:
        for name in ("rigid", "on_demand", "malleable"):
            if not 0.0 <= getattr(self, name) <= 1.0:
                raise ValueError(f"job-class fraction {name} outside [0, 1]")
        total = self.rigid + self.on_demand + self.malleable
        if abs(total - 1.0) > 1e-9:
            raise ValueError(
                f"job-class fractions must sum to 1 (got {total})")

    @property
    def is_default(self) -> bool:
        return self.rigid == 0.0 and self.on_demand == 0.0


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Declarative what-if axes applied on top of a generated trace."""

    walltime_factor: float = 1.0       # scales walltime slack (0 = exact)
    walltime_jitter: float = 0.0       # per-job slack spread (see dist)
    walltime_dist: str = "lognormal"   # named jitter distribution
    walltime_seed: int = DEFAULT_WALLTIME_SEED  # spec-seeded jitter RNG
    arrival_compression: float = 1.0   # divides submit times (>1 = burstier)
    backfill_depth: int = DEFAULT_BACKFILL_DEPTH
    job_classes: JobClasses = JobClasses()
    queue_order: str = "fcfs"          # fcfs | sjf (walltime-keyed)

    def __post_init__(self) -> None:
        if isinstance(self.job_classes, dict):  # JSON round-trips
            object.__setattr__(self, "job_classes",
                               JobClasses(**self.job_classes))
        if self.queue_order not in ("fcfs", "sjf"):
            raise ValueError(f"unknown queue_order "
                             f"{self.queue_order!r}; choose from "
                             f"('fcfs', 'sjf')")
        if self.walltime_factor < 0.0:
            raise ValueError("walltime_factor must be >= 0")
        if self.walltime_jitter < 0.0:
            raise ValueError("walltime_jitter must be >= 0")
        if self.walltime_dist not in WALLTIME_DISTS:
            raise ValueError(f"unknown walltime_dist "
                             f"{self.walltime_dist!r}; choose from "
                             f"{WALLTIME_DISTS}")
        if self.arrival_compression <= 0.0:
            raise ValueError("arrival_compression must be > 0")
        if self.backfill_depth < 1:
            raise ValueError("backfill_depth must be >= 1")

    def canonical(self) -> "ScenarioConfig":
        """Result-equivalent copy with no-effect knobs reset to defaults.

        ``walltime_dist``/``walltime_seed`` only reach the RNG when the
        jitter is non-zero (and the jitter itself only scales non-zero
        slack), and the job-class seed only matters when some fraction is
        non-default.  Fingerprints hash this canonical form so sweeping a
        dead knob cannot spuriously invalidate stored cells.
        """
        out = self
        if out.walltime_factor == 0.0 and out.walltime_jitter != 0.0:
            out = dataclasses.replace(out, walltime_jitter=0.0)
        if out.walltime_jitter == 0.0 and (
                out.walltime_dist != "lognormal"
                or out.walltime_seed != DEFAULT_WALLTIME_SEED):
            out = dataclasses.replace(
                out, walltime_dist="lognormal",
                walltime_seed=DEFAULT_WALLTIME_SEED)
        if out.job_classes.is_default and out.job_classes != JobClasses():
            out = dataclasses.replace(out, job_classes=JobClasses())
        return out


def assign_job_classes(n_jobs: int, classes: JobClasses) -> np.ndarray:
    """Deterministic per-job class codes partitioning ``n_jobs`` jobs.

    A permutation drawn from ``classes.seed`` assigns the first
    ``round(rigid * n)`` jobs to CLASS_RIGID, the next
    ``round(on_demand * n)`` to CLASS_ON_DEMAND; everybody else stays
    CLASS_NORMAL.  Every job lands in exactly one class.
    """
    out = np.full(n_jobs, CLASS_NORMAL, dtype=np.int8)
    if classes.is_default:
        return out
    rng = np.random.default_rng(classes.seed)
    perm = rng.permutation(n_jobs)
    k_rigid = int(round(classes.rigid * n_jobs))
    k_od = min(int(round(classes.on_demand * n_jobs)), n_jobs - k_rigid)
    out[perm[:k_rigid]] = CLASS_RIGID
    out[perm[k_rigid:k_rigid + k_od]] = CLASS_ON_DEMAND
    return out


def _jitter_multiplier(scenario: ScenarioConfig, n_jobs: int) -> np.ndarray:
    """Per-job slack multiplier of the named distribution.

    ``lognormal`` and ``uniform`` are unit-mean (the jitter spreads
    estimates without moving the mean slack); ``exact_frac`` is a 0/1
    mask with mean ``1 - min(s, 1)`` — it *removes* slack from the exact
    fraction, so the mean shifts down by construction.
    """
    s = scenario.walltime_jitter
    rng = np.random.default_rng(scenario.walltime_seed)
    if scenario.walltime_dist == "lognormal":
        g = rng.standard_normal(n_jobs)
        return np.exp(s * g - 0.5 * s * s)
    if scenario.walltime_dist == "uniform":
        a = min(np.sqrt(3.0) * s, 1.0)
        return rng.uniform(1.0 - a, 1.0 + a, n_jobs)
    # exact_frac: fraction min(s, 1) of jobs get exact estimates
    return (rng.random(n_jobs) >= min(s, 1.0)).astype(np.float64)


def apply_scenario(workload: Workload,
                   scenario: ScenarioConfig) -> Workload:
    """Return ``workload`` with the scenario axes applied (copy on change).

    Order-preserving: submission times are divided by a positive constant
    and walltimes stay >= runtime, so the result is a valid workload with
    the same FCFS order.  Job classes only pin/prioritize jobs; shapes are
    untouched.
    """
    if (scenario.walltime_factor == 1.0
            and scenario.walltime_jitter == 0.0
            and scenario.arrival_compression == 1.0
            and scenario.job_classes.is_default):
        return workload
    w = workload.copy()
    if scenario.arrival_compression != 1.0:
        w.submit = w.submit / scenario.arrival_compression
    if (scenario.walltime_factor != 1.0
            or scenario.walltime_jitter != 0.0):
        slack = np.maximum(w.walltime / w.runtime - 1.0, 0.0)
        slack = slack * scenario.walltime_factor
        if scenario.walltime_jitter != 0.0:
            # spec-seeded generator: the jitter draw is part of the
            # scenario's identity, bit-identical for both backends
            slack = slack * _jitter_multiplier(scenario, w.n_jobs)
        w.walltime = w.runtime * (1.0 + slack)
    if not scenario.job_classes.is_default:
        w.job_class = assign_job_classes(w.n_jobs, scenario.job_classes)
    return w
