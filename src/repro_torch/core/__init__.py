"""The scheduling core of the port: the numpy model and DES (copies of
``repro.core``), the torch passes and the dense per-tick engine.

- strategies: EASY-BACKFILL (rigid) + MIN / PREF / AVG / KEEPPREF (paper
  §2.1) and the rest of the registry
- simulator:  event-quantized-tick DES (numpy, byte copy of the reference)
- passes:     the scheduling passes, numpy (the DES) and torch (the engines)
- sim_dense:  the dense per-tick engine, one pass a tick over whole job
  tensors (the port of ``repro.core.sim_jax``)
- speedup:    efficiency-threshold rigid->malleable transform (paper §2.2)
- traces:     statistical twins of Haswell/KNL/Eagle/Theta + cleaning
- metrics:    turnaround/makespan/wait/utilization with warm-up & drain-down
"""
from .cluster import CLUSTERS, Cluster, EAGLE, HASWELL, KNL, THETA
from .jobs import (CLASS_NORMAL, CLASS_ON_DEMAND, CLASS_RIGID, DONE,
                   PENDING, QUEUED, RUNNING, Workload)
from .metrics import (Window, aggregate_seeds, backfill_starts,
                      improvement, iqr, run_metrics, scheduling_counters)
from .passes import (balanced_expand, balanced_shrink, greedy_expand,
                     greedy_shrink)
from .scenario import (DEFAULT_BACKFILL_DEPTH, JobClasses, ScenarioConfig,
                       apply_scenario, assign_job_classes)
from .simulator import SimResult, Simulator, simulate
from .speedup import (TabulatedSpeedup, TransformConfig, amdahl_efficiency,
                      amdahl_speedup, batched_malleable_params,
                      nodes_at_efficiency, pfrac_for_reference_efficiency,
                      progress_rate, transform_rigid_to_malleable)
from .strategies import (AVG, EASY, KEEPPREF, MIN, PREF, STRATEGIES, Strategy,
                         get_strategy)
from . import traces

__all__ = [
    "CLUSTERS", "Cluster", "EAGLE", "HASWELL", "KNL", "THETA",
    "CLASS_NORMAL", "CLASS_ON_DEMAND", "CLASS_RIGID",
    "DONE", "PENDING", "QUEUED", "RUNNING", "Workload",
    "Window", "aggregate_seeds", "backfill_starts", "improvement",
    "iqr", "run_metrics", "scheduling_counters",
    "balanced_expand", "balanced_shrink", "greedy_expand", "greedy_shrink",
    "DEFAULT_BACKFILL_DEPTH", "JobClasses", "ScenarioConfig",
    "apply_scenario", "assign_job_classes",
    "SimResult", "Simulator", "simulate",
    "TabulatedSpeedup", "TransformConfig", "amdahl_efficiency",
    "amdahl_speedup", "batched_malleable_params", "nodes_at_efficiency",
    "pfrac_for_reference_efficiency", "progress_rate",
    "transform_rigid_to_malleable",
    "AVG", "EASY", "KEEPPREF", "MIN", "PREF", "STRATEGIES", "Strategy",
    "get_strategy", "traces",
]
