"""On-disk cell store for the port's experiment grids.

A copy of ``repro.sweep.cache`` for the port's two engines: a cell's key
is the SHA-256 of a canonical-JSON fingerprint of everything that
determines its metrics (trace identity, cluster, strategy / proportion /
seed, transform and scenario) plus the engine and its version.

* ``"torch"`` cells carry the port's own ``ENGINE_VERSION``, so they never
  land under the JAX package's ``jax`` keys;
* ``"des"`` cells carry :data:`DES_ENGINE_VERSION`, the reference's: the
  port's DES (:mod:`repro_torch.core.simulator`) is a byte-for-byte copy of
  the reference's, so its fingerprints equal the reference's dict for dict
  and one store shared by both packages reuses DES cells either one paid
  for.

Entries are one small JSON file per cell, sharded by the first two hex
characters of the key.  ``get`` / ``put`` count ``store.hit`` /
``store.miss`` / ``store.put`` on the flight recorder
(:mod:`repro_torch.obs`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Dict, Optional

from repro_torch import obs
from repro_torch.core.scenario import ScenarioConfig
from repro_torch.core.speedup import TransformConfig

ENGINE = "torch"
# Version of the reference numpy DES (``core/simulator.py``), the value of
# ``repro.sweep.cache.DES_ENGINE_VERSION``: v2 added the on-demand queue
# priority and the job_classes / walltime_dist scenario fields, v3 the
# pooled / stealing structures and the queue-order axis.
DES_ENGINE_VERSION = 3


def engine_version(engine: str = ENGINE) -> int:
    """Cache-invalidation version of ``engine`` (``torch`` or ``des``)."""
    if engine == "des":
        return DES_ENGINE_VERSION
    if engine != ENGINE:
        raise ValueError(f"unknown engine {engine!r}; choose {ENGINE} or "
                         "des")
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
            obs.counter("store.miss")
            return None
        self.hits += 1
        obs.counter("store.hit")
        return entry["metrics"]

    def put(self, fingerprint: Dict, metrics: Dict[str, float]) -> None:
        obs.counter("store.put")
        path = self._path(self.key(fingerprint))
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"fingerprint": fingerprint, "metrics": metrics}, indent=1,
            default=float))
        tmp.replace(path)
