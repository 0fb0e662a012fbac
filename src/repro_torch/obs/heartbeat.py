"""Progress heartbeat for chunked grid runs: units done, cells flushed,
ETA extrapolated from per-unit wall-clock.

A *unit* is whatever the run streams — structure batches on the torch
engine, cells on the DES.  The ETA model is intentionally the simplest
defensible one (:func:`eta_seconds`): remaining units x mean wall-clock
per completed unit.

The clock is injectable so the arithmetic is unit-testable without
sleeping (``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import sys
import time
from typing import Optional


def eta_seconds(done: int, total: int, elapsed_s: float) -> float:
    """Remaining wall-clock estimate: remaining x mean seconds per unit.

    ``nan`` until the first unit completes (no rate to extrapolate from).
    """
    if done <= 0 or total <= done:
        return float("nan") if done <= 0 else 0.0
    return (total - done) * (elapsed_s / done)


def format_duration(seconds: float) -> str:
    """``1h02m``/``4m07s``/``12s`` rendering; ``--`` for nan."""
    if seconds != seconds:  # nan
        return "--"
    s = max(int(round(seconds)), 0)
    if s >= 3600:
        return f"{s // 3600}h{(s % 3600) // 60:02d}m"
    if s >= 60:
        return f"{s // 60}m{s % 60:02d}s"
    return f"{s}s"


class Heartbeat:
    """Prints one live progress line per completed unit.

    ``[progress:eagle] chunk 3/12 · cells 24/96 · 41.2s/chunk · eta 6m11s``
    """

    def __init__(self, total: int, label: str = "progress",
                 unit: str = "chunk", enabled: bool = True,
                 stream=None, clock=time.monotonic) -> None:
        self.total = int(total)
        self.label = label
        self.unit = unit
        self.enabled = enabled
        self.stream = stream if stream is not None else sys.stdout
        self._clock = clock
        self._t0 = clock()
        self.done = 0
        self.cells_flushed = 0

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def eta(self) -> float:
        return eta_seconds(self.done, self.total, self.elapsed())

    def tick(self, cells_flushed: int = 0, extra: str = "") -> Optional[str]:
        """One unit finished; returns (and prints) the progress line."""
        self.done += 1
        self.cells_flushed += int(cells_flushed)
        if not self.enabled:
            return None
        elapsed = self.elapsed()
        per_unit = elapsed / max(self.done, 1)
        line = (f"[{self.label}] {self.unit} {self.done}/{self.total}"
                f" · cells {self.cells_flushed}"
                f" · {per_unit:.1f}s/{self.unit}"
                f" · eta {format_duration(self.eta())}")
        if extra:
            line += f" · {extra}"
        print(line, file=self.stream, flush=True)
        return line
