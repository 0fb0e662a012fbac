"""Cluster description for the malleable-scheduling simulator.

A copy of ``repro.core.cluster`` so the port imports nothing of ``repro``.

A cluster is a set of interchangeable nodes scheduled at a fixed tick
granularity (ElastiSim-style).  For the ML-cluster adaptation a "node" is a
host (or pod slice); the simulator is agnostic.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A homogeneous cluster of ``nodes`` nodes scheduled every ``tick`` s.

    Attributes:
      name: human-readable identifier (e.g. ``"haswell"``).
      nodes: total number of schedulable nodes.
      tick: scheduling granularity in seconds (paper Table 2: 1 s or 10 s).
        Resize/start decisions are quantized to tick boundaries, which
        approximates reconfiguration overheads (paper §2.3).
    """

    name: str
    nodes: int
    tick: float = 1.0

    def __post_init__(self) -> None:
        if self.nodes <= 0:
            raise ValueError(f"cluster needs >=1 node, got {self.nodes}")
        if self.tick <= 0:
            raise ValueError(f"tick must be positive, got {self.tick}")


# Paper Table 2 clusters (node counts after GPU-node exclusion).
THETA = Cluster("theta", nodes=4392, tick=1.0)
EAGLE = Cluster("eagle", nodes=2568, tick=10.0)
KNL = Cluster("knl", nodes=9688, tick=10.0)
HASWELL = Cluster("haswell", nodes=2388, tick=1.0)

CLUSTERS = {c.name: c for c in (THETA, EAGLE, KNL, HASWELL)}
