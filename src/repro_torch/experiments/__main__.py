"""Run a grid of the strategy registry on the port's batched engine.

Example::

  PYTHONPATH=src python -m repro_torch.experiments --workload theta \
      --scale 1.0 --seeds 2 [--device cpu] \
      [--expand-backend fused|waterfill|bisect] \
      [--strategies min pref_common_pool steal_agreement rigid_sjf] \
      [--queue-order sjf] [--on-demand-frac 0.1] [--window 0 --chunk 160]

Prints one line of metrics per cell, then the wall time and the number of
cells per second.  The defaults are the paper grid (its four malleable
strategies and the EASY baseline, theta at scale 1.0, 2 seeds); every
registered strategy and scenario axis has a flag
(:mod:`repro_torch.experiments.cli`).  Runs on ``cuda`` unless ``--device
cpu`` is given (on the CPU only ``--expand-backend bisect`` runs).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.sweep.cache import SweepCache

from .backend_torch import run_cells
from .cli import (add_execution_arguments, add_spec_arguments,
                  execution_options_from_args, spec_from_args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments",
                                 description=__doc__.splitlines()[0])
    add_spec_arguments(ap)
    add_execution_arguments(ap)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--expand-backend", default="auto",
                    choices=["auto", "fused", "waterfill", "bisect"])
    ap.add_argument("--cache-dir", default="",
                    help="write completed cells to this cell store")
    args = ap.parse_args(argv)

    spec = spec_from_args(args)
    todo = [(name, cell) for name in spec.workloads for cell in spec.cells()]
    fps = {k: spec.cell_fingerprint(*k) for k in todo}
    store = SweepCache(args.cache_dir) if args.cache_dir else None
    t0 = time.monotonic()
    metrics, info = run_cells(
        spec, todo, store, fps,
        options={"device": args.device,
                 "expand_backend": args.expand_backend,
                 **execution_options_from_args(args)}, verbose=False)
    wall = time.monotonic() - t0
    for (name, (strat, prop, seed)), m in metrics.items():
        print(f"{name} {strat:>16s} p={prop:.1f} seed={seed} "
              f"turnaround={m['turnaround_mean']:.1f} "
              f"wait={m['wait_mean']:.1f} util={m['utilization']:.4f} "
              f"expand={m['expand_per_job']:.3f} "
              f"shrink={m['shrink_per_job']:.3f}")
    print(f"[repro_torch:{'+'.join(spec.workloads)}] device={info['device']} "
          f"cells={len(todo)} incomplete={len(info['incomplete'])} "
          f"wall={wall:.2f}s cells_per_s={len(todo) / wall:.2f}")
    return 1 if info["incomplete"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
