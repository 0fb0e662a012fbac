"""Serving layer of the port: persistent front-ends over its engines.

- ``whatif``: the what-if scheduling query service -- hits from the cell
  store at memory speed, misses coalesced into one padded lane batch on
  the card (``python -m repro_torch.serve``);
- ``engine``: batched LLM serving (prefill + continuous-batching decode).

Exports resolve lazily (PEP 562), so importing the LLM ``engine`` does not
import the what-if service, nor the other way round.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "EngineClosedError": "whatif", "MonotonicClock": "whatif",
    "QueryFailedError": "whatif", "QueueFullError": "whatif",
    "WhatIfEngine": "whatif", "WhatIfQuery": "whatif",
    "sample_queries": "whatif",
    "ServeEngine": "engine",
}

__all__ = sorted(_EXPORTS) + ["engine", "whatif"]

if TYPE_CHECKING:  # pragma: no cover
    from . import engine, whatif
    from .engine import ServeEngine
    from .whatif import (EngineClosedError, MonotonicClock,
                         QueryFailedError, QueueFullError, WhatIfEngine,
                         WhatIfQuery, sample_queries)


def __dir__():
    return sorted(set(globals()) | set(__all__))


def __getattr__(name):
    import importlib

    if name in ("engine", "whatif"):
        return importlib.import_module(f".{name}", __name__)
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    return getattr(importlib.import_module(f".{module}", __name__), name)
