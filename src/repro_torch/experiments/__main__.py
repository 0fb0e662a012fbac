"""Run the paper grid on the port's batched engine.

Example::

  PYTHONPATH=src python -m repro_torch.experiments --workload theta \
      --scale 1.0 --seeds 2 [--device cpu] \
      [--expand-backend fused|waterfill|bisect]

Prints one line of metrics per cell, then the wall time and the number of
cells per second.  Runs on ``cuda`` unless ``--device cpu`` is given (on
the CPU only ``--expand-backend bisect`` runs).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.sweep.cache import SweepCache

from .backend_torch import run_cells
from .spec import ExperimentSpec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="+", default=["theta"])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--expand-backend", default="auto",
                    choices=["auto", "fused", "waterfill", "bisect"])
    ap.add_argument("--cache-dir", default="",
                    help="write completed cells to this cell store")
    args = ap.parse_args(argv)

    spec = ExperimentSpec(workloads=tuple(args.workload), scale=args.scale,
                          seeds=args.seeds, trace_seed=args.trace_seed)
    todo = [(name, cell) for name in spec.workloads for cell in spec.cells()]
    fps = {k: spec.cell_fingerprint(*k) for k in todo}
    store = SweepCache(args.cache_dir) if args.cache_dir else None
    t0 = time.monotonic()
    metrics, info = run_cells(
        spec, todo, store, fps,
        options={"device": args.device,
                 "expand_backend": args.expand_backend}, verbose=False)
    wall = time.monotonic() - t0
    for (name, (strat, prop, seed)), m in metrics.items():
        print(f"{name} {strat:>8s} p={prop:.1f} seed={seed} "
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
