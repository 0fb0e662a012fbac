"""On-disk cell store for the port's experiment grids.

A copy of ``repro.sweep.cache`` for the ``torch`` engine: a cell's key is
the SHA-256 of a canonical-JSON fingerprint of everything that determines
its metrics (trace identity, cluster, strategy / proportion / seed,
transform and scenario) plus ``engine="torch"`` and the port's own
``ENGINE_VERSION``, so torch cells never land under the JAX package's
``des`` / ``jax`` keys even when both packages share one store directory.
Entries are one small JSON file per cell, sharded by the first two hex
characters of the key.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Dict, Optional

from repro_torch.core.scenario import ScenarioConfig
from repro_torch.core.speedup import TransformConfig

ENGINE = "torch"


def engine_version(engine: str = ENGINE) -> int:
    """Cache-invalidation version of the port's engine."""
    if engine != ENGINE:
        raise ValueError(f"unknown engine {engine!r}; the port is "
                         f"engine {ENGINE!r}")
    from .batch import ENGINE_VERSION
    return ENGINE_VERSION


def cell_fingerprint(workload: str, trace_seed: int, scale: float,
                     capacity: int, tick: float, strategy: str,
                     proportion: float, seed: int, engine: str = ENGINE,
                     config: TransformConfig = TransformConfig(),
                     scenario: ScenarioConfig = ScenarioConfig()) -> Dict:
    """The canonical content of a cell's cache key (JSON-serializable)."""
    return {
        "workload": workload,
        "trace_seed": int(trace_seed),
        "scale": float(scale),
        "capacity": int(capacity),
        "tick": float(tick),
        "strategy": strategy,
        "proportion": float(proportion),
        "seed": int(seed),
        "engine": engine,
        "engine_version": engine_version(engine),
        "transform": dataclasses.asdict(config),
        "scenario": dataclasses.asdict(scenario.canonical()),
    }


class SweepCache:
    """Content-addressed store of per-cell metric dicts."""

    def __init__(self, root) -> None:
        self.root = pathlib.Path(root)
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(fingerprint: Dict) -> str:
        blob = json.dumps(fingerprint, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    def _path(self, key: str) -> pathlib.Path:
        return self.root / key[:2] / f"{key}.json"

    def get(self, fingerprint: Dict) -> Optional[Dict[str, float]]:
        path = self._path(self.key(fingerprint))
        try:
            entry = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            self.misses += 1
            return None
        self.hits += 1
        return entry["metrics"]

    def put(self, fingerprint: Dict, metrics: Dict[str, float]) -> None:
        path = self._path(self.key(fingerprint))
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"fingerprint": fingerprint, "metrics": metrics}, indent=1,
            default=float))
        tmp.replace(path)
