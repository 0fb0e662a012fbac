"""Flight recorder: structured tracing, counters and progress heartbeats.

A copy of ``repro.obs`` so the port imports nothing of ``repro``.
Zero-dependency observability for the experiment pipeline:

* :func:`span` — nested, thread-safe wall-clock spans, exported as Chrome
  trace-event JSON (``chrome://tracing`` / Perfetto) plus a JSONL log;
* :func:`counter` / :func:`gauge` — a process-wide metrics registry;
* :class:`Heartbeat` — live chunk/cell progress lines with ETA.

Everything is **off by default** and near-free while off: the module is
imported by the experiment backends and the cell store, so a disabled
``span()`` must cost one attribute check.  CLIs enable it with ``--trace``
/ ``--progress``; tracing can never change results, and nothing
obs-related may ever enter a spec or cell fingerprint
(``tests/test_torch_obs.py``).
"""
from .counters import CounterRegistry
from .heartbeat import Heartbeat, eta_seconds, format_duration
from .trace import (Tracer, configure, counter, enabled, flush, gauge,
                    get_tracer, record_span, span)

__all__ = [
    "CounterRegistry", "Heartbeat", "Tracer", "configure", "counter",
    "enabled", "eta_seconds", "flush", "format_duration", "gauge",
    "get_tracer", "record_span", "span",
]
