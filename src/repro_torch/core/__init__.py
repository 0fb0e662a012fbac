"""Numpy scheduling model (copies of ``repro.core``) plus the torch passes."""
from .cluster import CLUSTERS, Cluster, EAGLE, HASWELL, KNL, THETA
from .jobs import DONE, PENDING, QUEUED, RUNNING, Workload
from .metrics import Window, aggregate_seeds, improvement
from .scenario import DEFAULT_BACKFILL_DEPTH, ScenarioConfig, apply_scenario
from .speedup import TransformConfig, amdahl_speedup, batched_malleable_params
from .strategies import STRATEGIES, Strategy, get_strategy
from . import traces

__all__ = [
    "CLUSTERS", "Cluster", "EAGLE", "HASWELL", "KNL", "THETA",
    "DONE", "PENDING", "QUEUED", "RUNNING", "Workload",
    "Window", "aggregate_seeds", "improvement",
    "DEFAULT_BACKFILL_DEPTH", "ScenarioConfig", "apply_scenario",
    "TransformConfig", "amdahl_speedup", "batched_malleable_params",
    "STRATEGIES", "Strategy", "get_strategy", "traces",
]
