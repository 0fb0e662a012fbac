"""The scheduling-strategy registry (paper §2.1 + ported ElastiSim policies).

A copy of ``repro.core.strategies`` with the full registry, so every
strategy name resolves in the port.

Each strategy is a small declarative :class:`StrategySpec` consumed
uniformly by all three simulators.  *Structure* (which pass shapes run)
is one of four static flags — ``greedy`` / ``balanced`` / ``pooled`` /
``stealing`` — while every remaining knob is plain data, so lanes of
different strategies share one compiled engine per structure bucket:

  * ``start_want``  — allocation a malleable job *attempts* to start with
                      (Step 1).
  * ``start_floor`` — smallest allocation it may start with.  PREF falls
                      back to fewer nodes (floor = min); KEEPPREF never
                      starts below pref.
  * ``shrink_floor``— smallest allocation Step 2 may shrink a running job
                      to.  KEEPPREF only shrinks jobs above pref.
  * ``priority``    — Eqs. 1-3 by id; Step 2 shrinks highest-priority
                      first, Step 3 expands lowest-priority first.
  * ``structure``   — the static pass shape: AVG redistributes across
                      *all* malleable jobs (``balanced``); ``pooled``
                      adds the common-pool start pass; ``stealing`` adds
                      the shrink-to-average transfer pass; everything
                      else is ``greedy``.
  * ``queue_order`` — ``fcfs`` (default) or ``sjf``: a strategy may pin
                      SJF queue ordering (``rigid_sjf``); otherwise the
                      scenario axis decides (:func:`effective_queue_order`).
  * ``pool_share``  — [pooled] fraction of the surplus above preferred
                      allocations reserved as the shared start pool.
  * ``steal_margin``— [stealing] slack above the average allocation a
                      group may keep before it becomes a steal donor.

The full semantics of all eight registry entries (Step-1/2/3 parameters
and pass structures) are specified in ``docs/strategies.md``.

The priority functions are pure and take the array module as ``xp``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def priority_min(cur, mn, mx, pref, xp):
    """Eq. 1: surplus of allocated over minimum nodes."""
    del mx, pref, xp
    return cur - mn


def priority_pref(cur, mn, mx, pref, xp):
    """Eq. 2: surplus of allocated over preferred nodes."""
    del mn, mx, xp
    return cur - pref


def priority_avg(cur, mn, mx, pref, xp):
    """Eq. 3: relative utilization within the [min, max] range."""
    del pref
    span = xp.maximum(mx - mn, 1)
    return (cur - mn) / span


# Priority-function ids: the registry stores the id (hashable data), the
# engines look the callable up here.
PRIORITY_FUNCS = {"min": priority_min, "pref": priority_pref,
                  "avg": priority_avg}

STRUCTURES = ("greedy", "balanced", "pooled", "stealing")
QUEUE_ORDERS = ("fcfs", "sjf")


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    name: str
    malleable: bool             # False => rigid EASY-BACKFILL baseline
    start_want: str = "req"     # one of req|min|pref
    start_floor: str = "req"    # one of req|min|pref
    shrink_floor: str = "min"   # one of min|pref
    structure: str = "greedy"   # greedy|balanced|pooled|stealing
    priority: str = "min"       # Eqs. 1-3 id: min|pref|avg
    queue_order: str = "fcfs"   # fcfs|sjf ("sjf" pins the queue order)
    pool_share: float = 1.0     # [pooled] shared-pool fraction
    steal_margin: int = 0       # [stealing] slack kept above average

    def __post_init__(self):
        if self.structure not in STRUCTURES:
            raise ValueError(f"unknown structure {self.structure!r}; "
                             f"choose from {STRUCTURES}")
        if self.priority not in PRIORITY_FUNCS:
            raise ValueError(f"unknown priority id {self.priority!r}; "
                             f"choose from {sorted(PRIORITY_FUNCS)}")
        if self.queue_order not in QUEUE_ORDERS:
            raise ValueError(f"unknown queue_order {self.queue_order!r}; "
                             f"choose from {QUEUE_ORDERS}")
        if not 0.0 <= self.pool_share <= 1.0:
            raise ValueError("pool_share must be within [0, 1]")

    @property
    def balanced(self) -> bool:
        """Back-compat view of the AVG structure flag."""
        return self.structure == "balanced"

    @property
    def priority_fn(self):
        """The Eqs. 1-3 callable behind the ``priority`` id."""
        return PRIORITY_FUNCS[self.priority]

    def pick(self, which: str, mn, pref, req):
        """Select an allocation array by policy name."""
        return {"min": mn, "pref": pref, "req": req}[which]


# Back-compat alias: pre-registry code constructed/annotated `Strategy`.
Strategy = StrategySpec


# Rigid baseline: malleable metadata ignored; every job starts at its rigid
# request and is never resized.
EASY = StrategySpec(name="easy", malleable=False)

# MIN (paper Eq. 1): start at min; shrink floor min; smallest #jobs resized.
MIN = StrategySpec(
    name="min", malleable=True,
    start_want="min", start_floor="min",
    shrink_floor="min", priority="min",
)

# PREF (paper Eq. 2): attempt preferred, fall back to fewer (>= min).
PREF = StrategySpec(
    name="pref", malleable=True,
    start_want="pref", start_floor="min",
    shrink_floor="min", priority="pref",
)

# AVG (paper Eq. 3): start at min; balanced redistribution over all jobs.
AVG = StrategySpec(
    name="avg", malleable=True,
    start_want="min", start_floor="min",
    shrink_floor="min", structure="balanced", priority="avg",
)

# KEEPPREF (novel in the paper): always start at preferred; only shrink jobs
# currently above preferred (shrink floor = pref).
KEEPPREF = StrategySpec(
    name="keeppref", malleable=True,
    start_want="pref", start_floor="pref",
    shrink_floor="pref", priority="pref",
)

# STEAL_AGREEMENT (ported from the authors' ElastiSim
# average_steal_agreement policy): start at min like MIN, but before
# Step 3 expands, shrink over-average agreement groups toward the mean
# running allocation and hand the stolen nodes to under-average groups
# (docs/strategies.md § steal_agreement).
STEAL_AGREEMENT = StrategySpec(
    name="steal_agreement", malleable=True,
    start_want="min", start_floor="min",
    shrink_floor="min", structure="stealing", priority="min",
)

# PREF_COMMON_POOL (ported from pref_common_pool): running jobs' surplus
# above their preferred allocation forms a shared pool that queued
# malleable jobs may draw from at start — shrinking the donors back to
# pref on demand (docs/strategies.md § pref_common_pool).
PREF_COMMON_POOL = StrategySpec(
    name="pref_common_pool", malleable=True,
    start_want="pref", start_floor="min",
    shrink_floor="pref", structure="pooled", priority="pref",
)

# RIGID_SJF (ported from rigid_shortest_job_first): the EASY baseline
# under shortest-job-first queue ordering (walltime-estimate keyed, so it
# composes with the walltime_dist scenario axis).
RIGID_SJF = StrategySpec(
    name="rigid_sjf", malleable=False, queue_order="sjf",
)


STRATEGIES = {s.name: s for s in (EASY, MIN, PREF, AVG, KEEPPREF,
                                  STEAL_AGREEMENT, PREF_COMMON_POOL,
                                  RIGID_SJF)}


def register_strategy(spec: StrategySpec,
                      replace: bool = False) -> StrategySpec:
    """Add ``spec`` to the registry (the CLI/name-set source of truth).

    Registration widens :func:`registered_strategy_names` — and with it
    CLI choices and the full-registry CI crosscheck — but never the
    default sweep grid, which is pinned to the explicit
    :data:`MALLEABLE_STRATEGY_NAMES` paper subset (regression-tested in
    ``tests/test_experiments.py``).
    """
    if spec.name in STRATEGIES and not replace:
        raise ValueError(f"strategy {spec.name!r} is already registered")
    STRATEGIES[spec.name] = spec
    return spec


# The paper's sweep grid (§2.3): malleable strategies crossed with
# malleable-proportion levels.  This is the *explicit, frozen* paper
# subset — default grids and committed artifacts depend on it, so it is
# deliberately NOT derived from the registry (registering a strategy
# must never silently change the default grid).
MALLEABLE_STRATEGY_NAMES = ("min", "pref", "avg", "keeppref")
PAPER_FIVE = ("easy",) + MALLEABLE_STRATEGY_NAMES
SWEEP_PROPORTIONS = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def registered_strategy_names(sweepable_only: bool = False) -> Tuple[str, ...]:
    """Registry-derived name set (registration order).

    ``sweepable_only`` drops names that cannot appear in a spec's
    strategy list: non-malleable FCFS strategies are exactly the implied
    rigid baseline (proportion 0).  ``rigid_sjf`` *is* sweepable — its
    queue order distinguishes it from the baseline.
    """
    if not sweepable_only:
        return tuple(STRATEGIES)
    return tuple(n for n, s in STRATEGIES.items()
                 if s.malleable or s.queue_order != "fcfs")


def effective_queue_order(strategy: StrategySpec,
                          scenario_queue_order: str = "fcfs") -> str:
    """The queue order a lane actually runs under.

    A strategy that pins a non-FCFS order (``rigid_sjf``) overrides the
    scenario axis; otherwise the scenario's ``queue_order`` decides.
    """
    if strategy.queue_order != "fcfs":
        return strategy.queue_order
    return scenario_queue_order


def get_strategy(name: str) -> StrategySpec:
    try:
        return STRATEGIES[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; choose from {sorted(STRATEGIES)}"
        ) from None
