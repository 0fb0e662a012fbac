"""Declarative experiment specs for the port: one description of the grid.

The port of ``repro.experiments.spec``: an :class:`ExperimentSpec` names
everything that determines a sweep's results (workloads, trace seed and
scale, transform, strategies, proportions, seeds, scenario, engine) and
nothing that doesn't (device, window, expand backend and worker count
are backend options).  Its engines are ``"torch"``, the batched engine on
the card, and ``"des"``, the reference numpy DES on the host; a cell's
fingerprint carries the engine and its version
(:mod:`repro_torch.sweep.cache`), so a ``des`` cell's key equals the JAX
package's for the same cell.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Tuple

from repro_torch import obs
from repro_torch.core import CLUSTERS, Window, apply_scenario, traces
from repro_torch.core.cluster import Cluster
from repro_torch.core.jobs import Workload
from repro_torch.core.scenario import ScenarioConfig
from repro_torch.core.speedup import TransformConfig
from repro_torch.core.strategies import (MALLEABLE_STRATEGY_NAMES,
                                         STRATEGIES, SWEEP_PROPORTIONS)
from repro_torch.sweep.cache import cell_fingerprint, engine_version

ENGINES = ("torch", "des")

# A cell is (strategy_name, proportion, transform_seed).
Cell = Tuple[str, float, int]


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Everything that determines a sweep's results, and nothing else."""

    workloads: Tuple[str, ...]
    scale: float = 0.2
    trace_seed: int = 0
    seeds: int = 3
    proportions: Tuple[float, ...] = SWEEP_PROPORTIONS
    strategies: Tuple[str, ...] = MALLEABLE_STRATEGY_NAMES
    engine: str = "torch"
    transform: TransformConfig = TransformConfig()
    scenario: ScenarioConfig = ScenarioConfig()

    def __post_init__(self) -> None:
        object.__setattr__(self, "workloads", tuple(
            [self.workloads] if isinstance(self.workloads, str)
            else self.workloads))
        object.__setattr__(self, "proportions",
                           tuple(float(p) for p in self.proportions))
        object.__setattr__(self, "strategies", tuple(self.strategies))
        if isinstance(self.scenario, dict):
            object.__setattr__(self, "scenario",
                               ScenarioConfig(**self.scenario))
        if isinstance(self.transform, dict):
            t = dict(self.transform)
            if "e_ref_range" in t:
                t["e_ref_range"] = tuple(t["e_ref_range"])
            object.__setattr__(self, "transform", TransformConfig(**t))
        if not self.workloads:
            raise ValueError("spec needs at least one workload")
        for name in self.workloads:
            if name not in CLUSTERS:
                raise ValueError(f"unknown workload {name!r}; "
                                 f"choose from {sorted(CLUSTERS)}")
        for strat in self.strategies:
            if strat not in STRATEGIES:
                raise ValueError(f"unknown strategy {strat!r}")
            s = STRATEGIES[strat]
            if not s.malleable and s.queue_order == "fcfs":
                raise ValueError(f"strategy {strat!r} is the rigid baseline;"
                                 " it is implied by proportion 0")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"choose from {ENGINES}")
        if self.seeds < 1:
            raise ValueError("seeds must be >= 1")
        if not 0.0 < self.scale:
            raise ValueError("scale must be > 0")
        for p in self.proportions:
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"proportion {p} outside [0, 1]")

    def cells(self) -> List[Cell]:
        """One rigid baseline + strategy x prop>0 x seed (non-malleable
        sweepable strategies contribute one proportion-0 cell)."""
        out: List[Cell] = [("easy", 0.0, 0)]
        for strat in self.strategies:
            if not STRATEGIES[strat].malleable:
                out.append((strat, 0.0, 0))
                continue
            for prop in self.proportions:
                if prop == 0.0:
                    continue
                for seed in range(self.seeds):
                    out.append((strat, float(prop), seed))
        return out

    def for_workload(self, name: str) -> "ExperimentSpec":
        if name not in self.workloads:
            raise ValueError(f"{name!r} not in spec workloads")
        return dataclasses.replace(self, workloads=(name,))

    def fingerprint(self) -> Dict:
        """Canonical JSON-able content of the whole experiment."""
        return {
            "workloads": list(self.workloads),
            "scale": float(self.scale),
            "trace_seed": int(self.trace_seed),
            "seeds": int(self.seeds),
            "proportions": [float(p) for p in self.proportions],
            "strategies": list(self.strategies),
            "engine": self.engine,
            "engine_version": engine_version(self.engine),
            "transform": dataclasses.asdict(self.transform),
            "scenario": dataclasses.asdict(self.scenario.canonical()),
        }

    def key(self) -> str:
        blob = json.dumps(self.fingerprint(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    def cell_fingerprint(self, workload: str, cell: Cell) -> Dict:
        """Cell-store key content for one (workload, cell) of this spec."""
        cl = CLUSTERS[workload]
        strat, prop, seed = cell
        return cell_fingerprint(
            workload, self.trace_seed, self.scale, cl.nodes, cl.tick,
            strat, prop, seed, engine=self.engine, config=self.transform,
            scenario=self.scenario)


def prepare_workload(spec: ExperimentSpec, name: str
                     ) -> Tuple[Cluster, Workload, Window]:
    """Realize one workload of a spec: generate + scenario + window (the
    window is computed after the scenario transform)."""
    cl = CLUSTERS[name]
    with obs.span("trace.generate", workload=name, scale=spec.scale,
                  seed=spec.trace_seed):
        w = traces.generate(name, seed=spec.trace_seed, scale=spec.scale)
    with obs.span("scenario.apply", workload=name, jobs=int(w.n_jobs)):
        w = apply_scenario(w, spec.scenario)
    return cl, w, Window.for_workload(w)
