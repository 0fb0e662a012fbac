"""``python -m repro_torch.sweep``: the batched-engine sweep as a
declarative experiment.

The port of ``repro.sweep.runner``, the back-compat layer over the
experiment layer (:mod:`repro_torch.experiments`):

  * ``python -m repro_torch.sweep`` == ``python -m repro_torch.experiments
    --engine torch`` (same flags, scenario axes and chunked / split
    execution knobs included), on ``cuda`` unless ``--device cpu``;
  * :func:`sweep_workload_torch` / :func:`sweep_workloads_torch` (the
    reference's ``sweep_workload_jax`` / ``sweep_workloads_jax``), which
    build an :class:`~repro_torch.experiments.ExperimentSpec` and run it;
  * the :data:`CROSSCHECK_TOLERANCES` re-export.

The reference also re-exports ``enable_compilation_cache``, JAX's
persistent XLA cache; PyTorch runs eagerly and the kernels are built once
a checkout, so it has no counterpart here.

CLI::

  PYTHONPATH=src python -m repro_torch.sweep --workload haswell \
      --scale 0.05 --seeds 4 --crosscheck 4 --out artifacts/sweep.json
  PYTHONPATH=src python -m repro_torch.sweep --workload theta \
      --scale 0.01 --seeds 1 --device cpu
"""
from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

from repro_torch.core.strategies import (MALLEABLE_STRATEGY_NAMES,
                                         SWEEP_PROPORTIONS)
from repro_torch.experiments import ExperimentSpec, run_experiment
from repro_torch.experiments.crosscheck import (  # noqa: F401 (re-export)
    CROSSCHECK_TOLERANCES)

PROPORTIONS = SWEEP_PROPORTIONS
MALLEABLE_STRATEGIES = MALLEABLE_STRATEGY_NAMES

# Shown by ``python -m repro_torch.sweep --help`` below the shared flags.
_CLI_EPILOG = """\
chunked / split execution (torch engine):
  --chunk-lanes N (alias --max-lane-width) caps how many grid lanes are
  device-resident at once: the batch streams as sequential chunks, and
  every completed chunk's cells are flushed to --cache-dir before the next
  chunk starts, so an interrupted paper-scale run resumes chunk-by-chunk
  (re-run the same command; --expect-cached asserts a finished grid).
  --devices N splits each chunk across N cards, one thread a card
  (0 = every visible card).  Both knobs are results-neutral and never part
  of a spec fingerprint: chunked / split cells are bit-identical to the
  monolithic batch.
"""


def sweep_workloads_torch(
    names: Sequence[str],
    *,
    scale: float = 0.2,
    seeds: int = 3,
    proportions: Sequence[float] = PROPORTIONS,
    strategies: Sequence[str] = MALLEABLE_STRATEGIES,
    trace_seed: int = 0,
    crosscheck: int = 0,
    crosscheck_seed: int = 0,
    cache_dir: Optional[str] = None,
    window_slots: int = 0,
    chunk: int = 160,
    chunk_lanes: int = 0,
    devices: int = 0,
    expand_backend: str = "auto",
    device=None,
    verbose: bool = True,
) -> Dict[str, Dict]:
    """Batched-engine sweep over one or more workloads.

    Builds an :class:`~repro_torch.experiments.ExperimentSpec` (engine
    ``torch``) and delegates to
    :func:`~repro_torch.experiments.run_experiment` -- new code should do
    that directly.  ``window_slots``, ``chunk``, ``chunk_lanes``,
    ``devices``, ``expand_backend`` and ``device`` (``cuda`` unless told)
    are results-neutral execution knobs passed through as backend options
    (never spec fields).  Returns ``{workload: results}`` in the shared
    artifact schema.
    """
    spec = ExperimentSpec(
        workloads=tuple(names), scale=scale, trace_seed=trace_seed,
        seeds=seeds, proportions=tuple(proportions),
        strategies=tuple(strategies), engine="torch")
    return run_experiment(
        spec, cache_dir=cache_dir,
        backend_options={"window": window_slots, "chunk": chunk,
                         "chunk_lanes": chunk_lanes, "devices": devices,
                         "expand_backend": expand_backend,
                         "device": device},
        crosscheck=crosscheck, crosscheck_seed=crosscheck_seed,
        verbose=verbose)


def sweep_workload_torch(name: str, **kw) -> Dict:
    """Single-workload wrapper around :func:`sweep_workloads_torch`."""
    return sweep_workloads_torch([name], **kw)[name]


def main(argv=None) -> int:
    """Delegate to the experiment CLI with the torch engine.

    The flags are exactly ``python -m repro_torch.experiments``'s; only
    the prog name and the chunked-execution epilogue differ.
    """
    from repro_torch.experiments.__main__ import main as experiments_main
    argv = list(sys.argv[1:] if argv is None else argv)
    return experiments_main(["--engine", "torch"] + argv,
                            prog="python -m repro_torch.sweep",
                            epilog=_CLI_EPILOG)


if __name__ == "__main__":
    raise SystemExit(main())
