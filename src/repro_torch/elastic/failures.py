"""Fault tolerance: failure injection, straggler detection/mitigation.

Policies are deterministic state machines driven by an injectable clock, so
they are unit-testable without real hardware:

  * ``FailureInjector`` — seeded node-failure schedule (MTBF model).  The
    elastic trainer treats a failure as a scheduler-initiated *shrink* to
    the surviving width at the last checkpoint (checkpoint/restart).
  * ``StragglerMonitor`` — per-step deadline from a running latency EWMA;
    a straggling host triggers (1) one grace step, then (2) eviction =
    shrink, mirroring the paper's malleable shrink operation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class FailureInjector:
    """Exponential (memoryless) per-node failures with a fixed seed."""

    n_nodes: int
    mtbf_seconds: float
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # pre-draw each node's first failure time
        self._next_fail = rng.exponential(self.mtbf_seconds,
                                          size=self.n_nodes)
        self._rng = rng

    def failed_nodes(self, t: float) -> List[int]:
        """Nodes whose failure time has passed (and not yet replaced)."""
        return [i for i in range(self.n_nodes) if self._next_fail[i] <= t]

    def replace(self, node: int, t: float) -> None:
        """Node repaired/replaced at time t; schedule its next failure."""
        self._next_fail[node] = t + self._rng.exponential(self.mtbf_seconds)


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA-based straggler detection with grace-then-evict policy."""

    n_nodes: int
    threshold: float = 2.0     # straggler if latency > threshold * ewma
    alpha: float = 0.2
    grace_steps: int = 1

    def __post_init__(self):
        self._ewma: Optional[float] = None
        self._strikes = np.zeros(self.n_nodes, dtype=np.int64)

    def observe(self, step_latencies: np.ndarray) -> List[int]:
        """Feed per-node step latencies; returns nodes to evict (shrink)."""
        lat = np.asarray(step_latencies, dtype=np.float64)
        med = float(np.median(lat))
        self._ewma = (med if self._ewma is None
                      else (1 - self.alpha) * self._ewma + self.alpha * med)
        slow = lat > self.threshold * self._ewma
        self._strikes = np.where(slow, self._strikes + 1, 0)
        evict = np.flatnonzero(self._strikes > self.grace_steps)
        for i in evict:
            self._strikes[i] = 0
        return evict.tolist()

    @property
    def ewma(self) -> Optional[float]:
        return self._ewma
