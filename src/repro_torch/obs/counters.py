"""Thread-safe counters/gauges registry for the flight recorder.

Counters are monotonic accumulators (``add``), gauges hold the last set
value (``gauge``) — both keyed by dotted names (``store.hit``,
``sweep.retraces``).  The registry is deliberately dumb: no types, no
labels, no export protocol — :meth:`snapshot` returns plain dicts that
ride along in the JSONL event log and in engine info blocks.
"""
from __future__ import annotations

import threading
from typing import Dict


class CounterRegistry:
    """Named counters + gauges behind one lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    def add(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {"counters": dict(self._counts),
                    "gauges": dict(self._gauges)}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._gauges.clear()
