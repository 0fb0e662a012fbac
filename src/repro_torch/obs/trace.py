"""Span tracer: Chrome trace-event JSON + JSONL, zero dependencies.

One process-wide :class:`Tracer` (``get_tracer()``) records *spans* —
named, nested, wall-clock intervals — via a context-manager API::

    from repro_torch import obs

    with obs.span("experiment.fingerprint", cells=82):
        ...

Design constraints (the "flight recorder" contract):

* **Near-zero overhead when disabled.**  The default tracer is disabled;
  ``span()`` then returns a shared no-op singleton, so instrumented hot
  paths pay one attribute check + one call per span and allocate nothing.
  Enable with :func:`configure` (CLIs expose ``--trace``).
* **Thread-safe nesting.**  Each thread keeps its own span stack
  (``threading.local``), so spans nest correctly per thread; finished
  events append under a lock.  Process pools are *not* traced — a worker
  process inherits the disabled default, which is the documented
  limitation for ``--engine des --workers N``.
* **Monotonic clocks.**  Timestamps come from ``time.monotonic_ns``
  relative to tracer creation; wall-of-day never appears in a trace.
* **Chrome trace-event output.**  :meth:`Tracer.chrome_events` returns a
  plain list of complete (``"ph": "X"``) trace events — microsecond
  ``ts``/``dur``, ``pid``/``tid`` — which ``chrome://tracing`` and
  Perfetto load directly.  :meth:`Tracer.write` also emits a JSONL event
  log (one span per line, plus a final counters record) for grep/jq-style
  post-processing.

Counters/gauges live in the sibling registry
(:class:`repro_torch.obs.counters.CounterRegistry`) attached at
``tracer.counters``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .counters import CounterRegistry


class _NullSpan:
    """Shared no-op span: what ``span()`` hands out while disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span; records itself into the tracer on ``__exit__``."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict) -> None:
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self.args["parent"] = stack[-1] if stack else None
        stack.append(self.name)
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur_ns = time.monotonic_ns() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self._tracer._record(self.name, self._t0, dur_ns, self.args)
        return False


class Tracer:
    """Span recorder + counters registry; see the module docstring."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self.counters = CounterRegistry()
        self._events: List[Dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._epoch_ns = time.monotonic_ns()

    # -- span API -------------------------------------------------------
    def span(self, name: str, **args):
        """A context manager timing ``name`` (no-op while disabled)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name: str, t0_ns: int, dur_ns: int,
                args: Dict) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1000.0,  # µs, Chrome unit
            "dur": dur_ns / 1000.0,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        with self._lock:
            self._events.append(ev)

    # -- export ---------------------------------------------------------
    def events(self) -> List[Dict]:
        """Snapshot of finished span events (insertion order)."""
        with self._lock:
            return list(self._events)

    def chrome_events(self) -> List[Dict]:
        """The trace as a plain list of Chrome ``"ph": "X"`` events.

        ``chrome://tracing`` / Perfetto accept a bare JSON array, so the
        on-disk file is exactly ``json.dumps(chrome_events())``.
        """
        return self.events()

    def write(self, trace_path=None, jsonl_path=None) -> None:
        """Write the Chrome JSON trace and/or the JSONL event log."""
        events = self.events()
        if trace_path:
            p = _prepared(trace_path)
            p.write_text(json.dumps(events, default=str))
        if jsonl_path:
            p = _prepared(jsonl_path)
            with p.open("w") as f:
                for ev in events:
                    f.write(json.dumps({"kind": "span", **ev},
                                       default=str) + "\n")
                f.write(json.dumps({"kind": "counters",
                                    **self.counters.snapshot()}) + "\n")

    def record_span(self, name: str, start_ns: int, **args) -> None:
        """Record a completed span from an explicit start timestamp.

        For cross-thread intervals that a ``with`` block cannot scope —
        e.g. a request enqueued on one thread and resolved on another
        (the serve layer's per-query latency spans).  ``start_ns`` is a
        ``time.monotonic_ns()`` reading; duration is measured to *now*.
        Does not touch the per-thread nesting stack.
        """
        if not self.enabled:
            return
        t0 = int(start_ns)
        self._record(name, t0, time.monotonic_ns() - t0, args)

    def reset(self) -> None:
        """Drop recorded events and counters (tests, repeated runs)."""
        with self._lock:
            self._events.clear()
        self.counters.reset()
        self._epoch_ns = time.monotonic_ns()


def _prepared(path):
    import pathlib

    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    return p


# -- the process-wide default tracer ------------------------------------
_DEFAULT = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _DEFAULT


def configure(enabled: bool = True) -> Tracer:
    """Enable (or disable) the default tracer; returns it."""
    _DEFAULT.enabled = enabled
    return _DEFAULT


def enabled() -> bool:
    return _DEFAULT.enabled


def span(name: str, **args):
    """Module-level shorthand for ``get_tracer().span(...)``."""
    if not _DEFAULT.enabled:
        return _NULL_SPAN
    return _Span(_DEFAULT, name, args)


def counter(name: str, value: float = 1) -> None:
    """Bump a counter on the default tracer (no-op while disabled)."""
    if _DEFAULT.enabled:
        _DEFAULT.counters.add(name, value)


def gauge(name: str, value: float) -> None:
    """Set a gauge on the default tracer (no-op while disabled)."""
    if _DEFAULT.enabled:
        _DEFAULT.counters.gauge(name, value)


def record_span(name: str, start_ns: int, **args) -> None:
    """Record a completed span on the default tracer (see
    :meth:`Tracer.record_span`); no-op while disabled."""
    _DEFAULT.record_span(name, start_ns, **args)


def flush(trace_path=None, jsonl_path: Optional[str] = None) -> None:
    """Write the default tracer's outputs (paths may be None to skip)."""
    _DEFAULT.write(trace_path, jsonl_path)
