"""Numpy scheduling model and DES (copies of ``repro.core``) plus the
torch passes."""
from .cluster import CLUSTERS, Cluster, EAGLE, HASWELL, KNL, THETA
from .jobs import DONE, PENDING, QUEUED, RUNNING, Workload
from .metrics import (Window, aggregate_seeds, backfill_starts,
                      improvement, run_metrics, scheduling_counters)
from .scenario import DEFAULT_BACKFILL_DEPTH, ScenarioConfig, apply_scenario
from .simulator import SimResult, Simulator, simulate
from .speedup import (TransformConfig, amdahl_speedup,
                      batched_malleable_params, transform_rigid_to_malleable)
from .strategies import STRATEGIES, Strategy, get_strategy
from . import traces

__all__ = [
    "CLUSTERS", "Cluster", "EAGLE", "HASWELL", "KNL", "THETA",
    "DONE", "PENDING", "QUEUED", "RUNNING", "Workload",
    "Window", "aggregate_seeds", "backfill_starts", "improvement",
    "run_metrics", "scheduling_counters",
    "DEFAULT_BACKFILL_DEPTH", "ScenarioConfig", "apply_scenario",
    "SimResult", "Simulator", "simulate",
    "TransformConfig", "amdahl_speedup", "batched_malleable_params",
    "transform_rigid_to_malleable",
    "STRATEGIES", "Strategy", "get_strategy", "traces",
]
