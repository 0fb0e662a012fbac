"""The batched sweep engine of the port: the paper's (strategy x
proportion x seed) grid as fixed-shape lanes on one device.

- batch:   event-stepped, active-set-windowed batched simulator
- shard:   chunked, resumable, card-split execution plans over the lane
           axis (results-neutral by construction)
- metrics: on-device ``run_metrics`` over the lanes (the reference's
           ``metrics_jax``)
- cache:   engine-agnostic content-hash cell store (shared with the DES
           backend of :mod:`repro_torch.experiments`)
- runner:  ``python -m repro_torch.sweep`` and the wrappers over the
           experiment layer (the reference's ``*_jax`` names as
           ``*_torch``)

Exports resolve lazily (PEP 562), so the cell store can be imported
without the engine.
"""
import importlib
from typing import TYPE_CHECKING

_EXPORTS = {
    "BatchedLanes": "batch", "EngineConfig": "batch",
    "SweepEngineError": "batch", "build_lanes": "batch",
    "concat_lanes": "batch", "simulate_lanes": "batch",
    "lane_statics": "batch", "pad_lanes": "batch", "take_lanes": "batch",
    "ChunkResult": "shard", "ShardConfig": "shard",
    "chunk_plan": "shard", "describe_plan": "shard",
    "simulate_lanes_chunked": "shard",
    "SweepCache": "cache", "cell_fingerprint": "cache",
    "engine_version": "cache",
    "batched_metrics": "metrics",
    "sweep_workload_torch": "runner", "sweep_workloads_torch": "runner",
}

__all__ = sorted(_EXPORTS)

if TYPE_CHECKING:  # pragma: no cover
    from .batch import (BatchedLanes, EngineConfig, SweepEngineError,
                        build_lanes, concat_lanes, lane_statics, pad_lanes,
                        simulate_lanes, take_lanes)
    from .cache import SweepCache, cell_fingerprint, engine_version
    from .metrics import batched_metrics
    from .runner import sweep_workload_torch, sweep_workloads_torch
    from .shard import (ChunkResult, ShardConfig, chunk_plan, describe_plan,
                        simulate_lanes_chunked)


def __dir__():
    return sorted(set(globals()) | set(__all__))


def __getattr__(name):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(f".{module}", __name__), name)
