"""The port's experiment CLI: one declarative spec, either engine.

The port of ``python -m repro.experiments``: spec -> cell store -> backend
-> aggregate -> artifact.  ``--engine torch`` (the default) runs the
batched engine on ``cuda`` unless ``--device cpu`` is given (on the CPU
only ``--expand-backend bisect`` runs); ``--engine des`` runs the
reference numpy DES on the host.  Examples::

  PYTHONPATH=src python -m repro_torch.experiments --workload haswell \
      --scale 0.02 --seeds 2 --crosscheck 2 --require-crosscheck \
      --cache-dir artifacts/torch_store --out artifacts/haswell.json
  PYTHONPATH=src python -m repro_torch.experiments --workload theta \
      --scale 1.0 --seeds 2 --expand-backend waterfill \
      --strategies min pref_common_pool --queue-order sjf
  PYTHONPATH=src python -m repro_torch.experiments --workload knl \
      --engine des --workers 2 --walltime-factor 0.0

``--expect-cached`` exits non-zero unless *every* cell came from the
shared store — the CI assertion that a re-run of the same spec is a 100%
cache hit (the resume path works).

``--compare-scenarios AXIS --scenario-values V1 V2 ...`` sweeps one
scenario axis (the other flags fix the base scenario) across the whole
strategy grid and renders the sensitivity table alongside the Figs. 6-9
analogues::

  PYTHONPATH=src python -m repro_torch.experiments --workload knl \
      --scale 0.01 --compare-scenarios backfill_depth \
      --scenario-values 1 4 256
"""
from __future__ import annotations

import argparse
import json
import pathlib

from .cli import (add_backend_arguments, add_spec_arguments,
                  backend_options_from_args, configure_observability,
                  flush_observability, spec_from_args)
from .report import (SCENARIO_AXES, axis_key, best_improvements,
                     render_scenario_table, render_sweep_table)
from .run import run_experiment, sweep_scenario_axis, write_artifact


def main(argv=None, prog=None, epilog=None) -> int:
    """Run the experiment CLI; returns the exit code.  ``prog`` / ``epilog``
    let a delegating entry point (``python -m repro_torch.sweep``) keep its
    own ``--help`` identity and document its own flags."""
    ap = argparse.ArgumentParser(
        prog=prog or "python -m repro_torch.experiments",
        description=__doc__.splitlines()[0],
        epilog=epilog,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_spec_arguments(ap)
    add_backend_arguments(ap)
    ap.add_argument("--crosscheck", type=int, default=0,
                    help="[torch] re-run N seeded-sampled cells through the "
                         "numpy DES (per workload)")
    ap.add_argument("--crosscheck-seed", type=int, default=0)
    ap.add_argument("--require-crosscheck", action="store_true",
                    help="exit non-zero when any crosschecked cell exceeds "
                         "CROSSCHECK_TOLERANCES (the fidelity gate)")
    ap.add_argument("--expect-cached", action="store_true",
                    help="exit non-zero unless every cell was a store hit")
    ap.add_argument("--compare-scenarios", default="", metavar="AXIS",
                    choices=["", *SCENARIO_AXES],
                    help="sweep one scenario axis across the strategy "
                         "grid and render the sensitivity table "
                         f"(axes: {', '.join(SCENARIO_AXES)})")
    ap.add_argument("--scenario-values", type=axis_key, nargs="+",
                    default=None,
                    help="values of the swept --compare-scenarios axis "
                         "(numbers, or fcfs/sjf for queue_order)")
    ap.add_argument("--out", default="",
                    help="artifact path; with several workloads one file "
                         "holding {results: {workload: ...}} is written")
    args = ap.parse_args(argv)
    if args.require_crosscheck and not args.crosscheck:
        ap.error("--require-crosscheck needs --crosscheck N")
    if args.crosscheck and args.engine != "torch":
        ap.error("--crosscheck needs --engine torch "
                 "(the DES is the reference)")
    if args.expect_cached and not args.cache_dir:
        ap.error("--expect-cached needs --cache-dir")
    if bool(args.compare_scenarios) != (args.scenario_values is not None):
        ap.error("--compare-scenarios and --scenario-values go together")
    if args.compare_scenarios and (args.expect_cached or args.crosscheck
                                   or args.require_crosscheck):
        # refuse rather than pass vacuously: the sensitivity sweep runs
        # one experiment per value and does not thread these gates
        ap.error("--compare-scenarios cannot be combined with "
                 "--expect-cached / --crosscheck / --require-crosscheck")

    configure_observability(args)
    spec = spec_from_args(args)
    if args.compare_scenarios:
        rc = compare_scenarios(spec, args)
        flush_observability(args)
        return rc
    all_results = run_experiment(
        spec, cache_dir=args.cache_dir or None,
        backend_options=backend_options_from_args(args),
        crosscheck=args.crosscheck, crosscheck_seed=args.crosscheck_seed)

    tag = "+".join(spec.workloads)
    info = next(iter(all_results.values()))["_engine"]
    incomplete_total = int(info.get("incomplete_cells_total", 0))
    computed, wall = info["computed_cells"], info["sim_seconds"]
    print(f"[experiment:{tag}] spec {spec.key()[:12]} engine={spec.engine} "
          f"wall {wall:.1f}s cache_hits={info['cache_hits']} "
          f"computed={computed} incomplete={incomplete_total}"
          + (f" device={info['device']}" if "device" in info else "")
          + (f" cells_per_s={computed / wall:.2f}" if computed else ""))
    if incomplete_total:
        print(f"[experiment:{tag}] WARNING: {incomplete_total} cell(s) hit "
              "the step budget before completing; they were not written to "
              "the store and their metrics are partial")
    for name, results in all_results.items():
        print(f"\n[experiment:{name}] best-vs-rigid (100% malleable):")
        for metric, r in best_improvements(results).items():
            print(f"  {metric}: {r['rigid']:,.1f} -> {r['best']:,.1f} "
                  f"({r['improvement_pct']:+.1f}% via {r['strategy']})")

    if args.out:
        out = pathlib.Path(args.out)
        if len(all_results) == 1:
            results = next(iter(all_results.values()))
            write_artifact(out, results, best_improvements(results))
        else:  # multi-workload layout: one combined file
            write_artifact(out, all_results)
        print(f"[experiment:{tag}] wrote {out}")

    rc = 0
    if args.expect_cached and (info["computed_cells"] or incomplete_total):
        print(f"[experiment:{tag}] FAIL: expected a 100% store hit but "
              f"computed {info['computed_cells']} cells "
              f"(+{incomplete_total} incomplete)")
        missed = list(info.get("missed_cells", []))
        shown = missed[:20]
        print(f"[experiment:{tag}] missed cells ({len(missed)}): "
              + ", ".join(shown)
              + (f", ... +{len(missed) - len(shown)} more" if
                 len(missed) > len(shown) else ""))
        rc = 1
    if args.require_crosscheck:
        bad = [name for name, r in all_results.items()
               if not r.get("_crosscheck", {}).get("all_within_tolerance",
                                                   True)]
        if bad:
            print(f"[experiment:{tag}] crosscheck EXCEEDED tolerance for: "
                  f"{', '.join(bad)}")
            rc = 1
    flush_observability(args)
    return rc


def compare_scenarios(spec, args) -> int:
    """Sweep one scenario axis; render sensitivity + Figs. 6-9 tables."""
    axis = args.compare_scenarios
    by_value = sweep_scenario_axis(
        spec, axis, args.scenario_values,
        cache_dir=args.cache_dir or None,
        backend_options=backend_options_from_args(args),
        verbose=False)
    base_value = axis_key(args.scenario_values[0])
    for name in spec.workloads:
        print(render_scenario_table(
            axis, {v: res[name] for v, res in by_value.items()}))
        print()
        print(render_sweep_table(by_value[base_value][name]))
        print()
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "axis": axis,
            "values": [axis_key(v) for v in args.scenario_values],
            "results": {str(axis_key(v)): res
                        for v, res in by_value.items()},
            "tables": {name: render_scenario_table(
                axis, {v: res[name] for v, res in by_value.items()})
                for name in spec.workloads},
        }
        out.write_text(json.dumps(payload, indent=1, default=float))
        print(f"[compare-scenarios:{axis}] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
