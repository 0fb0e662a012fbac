"""Argparse wiring of the port's grid CLI: flags <-> :class:`ExperimentSpec`.

The port of ``repro.experiments.cli``: the spec and scenario flags, so
every strategy of the registry and every scenario axis can be asked for
from ``python -m repro_torch.experiments``, ``--engine {torch,des}``, and
the backend knobs that never change results and never enter a
fingerprint: ``--device``, ``--expand-backend``, ``--window``,
``--events``, ``--chunk``, ``--chunk-lanes`` (alias ``--max-lane-width``)
and ``--devices`` (torch; shared with ``python -m repro_torch.serve``),
``--workers`` (des), the cell store (``--cache-dir``) and the flight
recorder (``--trace``, ``--trace-jsonl``, ``--progress``).  The
reference's ``--no-aot-warmup`` is an XLA knob and has no counterpart.
"""
from __future__ import annotations

import argparse

from repro_torch import obs
from repro_torch.core import CLUSTERS
from repro_torch.core.scenario import (DEFAULT_BACKFILL_DEPTH,
                                       DEFAULT_WALLTIME_SEED, WALLTIME_DISTS,
                                       JobClasses, ScenarioConfig)
from repro_torch.core.strategies import (MALLEABLE_STRATEGY_NAMES,
                                         SWEEP_PROPORTIONS,
                                         registered_strategy_names)

from .spec import ENGINES, ExperimentSpec


def add_spec_arguments(ap: argparse.ArgumentParser) -> None:
    """Flags that define the experiment (everything in the fingerprint);
    the defaults are the paper grid on theta at full scale."""
    ap.add_argument("--workload", nargs="+", default=["theta"],
                    choices=sorted(CLUSTERS),
                    help="one workload, or several to run as one batch "
                         "per structure")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="trace scale (1.0 = paper-size workloads)")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="trace-generator seed")
    ap.add_argument("--seeds", type=int, default=2,
                    help="transform seeds per (strategy, proportion)")
    ap.add_argument("--proportions", type=float, nargs="*",
                    default=list(SWEEP_PROPORTIONS))
    # choices follow the registry; the default stays the paper's subset
    ap.add_argument("--strategies", nargs="*",
                    default=list(MALLEABLE_STRATEGY_NAMES),
                    choices=list(registered_strategy_names(
                        sweepable_only=True)))
    ap.add_argument("--engine", choices=list(ENGINES), default="torch",
                    help="torch: the batched engine on the card "
                         "(default); des: the reference numpy DES on the "
                         "host (cell-parallel)")
    add_scenario_arguments(ap)


def add_scenario_arguments(ap: argparse.ArgumentParser) -> None:
    """The scenario axes (:mod:`repro_torch.core.scenario`), one flag each."""
    ap.add_argument("--walltime-factor", type=float, default=1.0,
                    help="scales walltime slack: 0 = exact estimates, "
                         "1 = the trace's padding, 4 = 4x padding")
    ap.add_argument("--walltime-jitter", type=float, default=0.0,
                    help="per-job spread of walltime slack (0 = uniform; "
                         "distribution set by --walltime-dist)")
    ap.add_argument("--walltime-dist", choices=list(WALLTIME_DISTS),
                    default="lognormal",
                    help="per-job walltime-accuracy distribution the "
                         "jitter draws from")
    ap.add_argument("--walltime-seed", type=int,
                    default=DEFAULT_WALLTIME_SEED,
                    help="seed of the jitter draw")
    ap.add_argument("--arrival-compression", type=float, default=1.0,
                    help="divides submission times: 2.0 doubles the "
                         "arrival rate at a fixed work mix")
    ap.add_argument("--backfill-depth", type=int,
                    default=DEFAULT_BACKFILL_DEPTH,
                    help="EASY backfill scan depth")
    ap.add_argument("--queue-order", choices=["fcfs", "sjf"],
                    default="fcfs",
                    help="waiting-queue order: fcfs (default) or sjf keyed "
                         "on walltime estimates (rigid_sjf pins sjf)")
    ap.add_argument("--rigid-frac", type=float, default=0.0,
                    help="job-class mix: fraction pinned rigid")
    ap.add_argument("--on-demand-frac", type=float, default=0.0,
                    help="job-class mix: fraction on-demand (pinned rigid, "
                         "ahead of the others in the queue)")
    ap.add_argument("--class-seed", type=int, default=0,
                    help="job-class assignment permutation seed")


def scenario_from_args(args: argparse.Namespace) -> ScenarioConfig:
    return ScenarioConfig(
        walltime_factor=args.walltime_factor,
        walltime_jitter=args.walltime_jitter,
        walltime_dist=args.walltime_dist,
        walltime_seed=args.walltime_seed,
        arrival_compression=args.arrival_compression,
        backfill_depth=args.backfill_depth,
        queue_order=args.queue_order,
        job_classes=JobClasses(
            rigid=args.rigid_frac,
            on_demand=args.on_demand_frac,
            malleable=1.0 - args.rigid_frac - args.on_demand_frac,
            seed=args.class_seed),
    )


def spec_from_args(args: argparse.Namespace) -> ExperimentSpec:
    return ExperimentSpec(
        workloads=tuple(args.workload),
        scale=args.scale,
        trace_seed=args.trace_seed,
        seeds=args.seeds,
        proportions=tuple(args.proportions),
        strategies=tuple(args.strategies),
        engine=args.engine,
        scenario=scenario_from_args(args),
    )


def add_backend_arguments(ap: argparse.ArgumentParser) -> None:
    """Knobs that never change results (never fingerprinted)."""
    ap.add_argument("--cache-dir", default="",
                    help="shared per-cell result store ('' = none)")
    ap.add_argument("--workers", type=int, default=0,
                    help="[des] cell-parallel worker processes (0/1 "
                         "serial, -1 per CPU)")
    add_execution_arguments(ap)
    add_observability_arguments(ap)


def add_execution_arguments(ap: argparse.ArgumentParser) -> None:
    """The torch engine's results-neutral knobs: where and how the lanes
    run (chunked and split runs give the same cells bit for bit), so none
    of them ever enters a fingerprint."""
    ap.add_argument("--device", default=None,
                    help="[torch] cuda (default) or cpu")
    ap.add_argument("--expand-backend", default="auto",
                    choices=["auto", "fused", "waterfill", "bisect"],
                    help="[torch] the greedy pass: the CUDA tick kernel "
                         "(fused, auto's choice on cuda), the CUDA "
                         "waterfill give, or the plain pass (bisect, the "
                         "only one on the CPU)")
    ap.add_argument("--window", type=int, default=0,
                    help="active-set window ladder floor (0 = start at the "
                         "rung the lane statics predict)")
    ap.add_argument("--events", type=int, default=4,
                    help="per-lane events retired per scan step (event "
                         "compression; 1 disables)")
    ap.add_argument("--chunk", type=int, default=160,
                    help="scan steps between window compactions")
    ap.add_argument("--chunk-lanes", "--max-lane-width", dest="chunk_lanes",
                    type=int, default=0, metavar="N",
                    help="[torch] max device-resident lanes per chunk; the "
                         "batch streams as sequential chunks, each written "
                         "to the cell store on completion so an interrupted "
                         "run resumes chunk by chunk (0 = whole batch)")
    ap.add_argument("--devices", type=int, default=0,
                    help="[torch] split each chunk across N cards, one "
                         "thread a card (0 = every visible card, 1 = no "
                         "split)")


def execution_options_from_args(args: argparse.Namespace) -> dict:
    return {"device": args.device, "expand_backend": args.expand_backend,
            "window": args.window, "events": args.events,
            "chunk": args.chunk, "chunk_lanes": args.chunk_lanes,
            "devices": args.devices}


def add_observability_arguments(ap: argparse.ArgumentParser) -> None:
    """Flight-recorder flags (:mod:`repro_torch.obs`): results-neutral and
    never fingerprinted; a run with tracing on writes the same cells as
    one with it off."""
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(chrome://tracing or ui.perfetto.dev); enables "
                         "span recording")
    ap.add_argument("--trace-jsonl", default="", metavar="PATH",
                    help="also write the spans and the final counters as "
                         "JSON lines")
    ap.add_argument("--progress", action="store_true",
                    help="print a heartbeat line per structure batch "
                         "(torch) / cell (des): done/total, cells "
                         "flushed, ETA")


def configure_observability(args: argparse.Namespace) -> None:
    """Enable the process tracer when a ``--trace*`` flag asks for it."""
    if args.trace or args.trace_jsonl:
        obs.configure(enabled=True)


def flush_observability(args: argparse.Namespace,
                        verbose: bool = True) -> None:
    """Write the trace files the ``--trace*`` flags ask for."""
    if not (args.trace or args.trace_jsonl):
        return
    obs.flush(trace_path=args.trace or None,
              jsonl_path=args.trace_jsonl or None)
    if verbose:
        for p in (args.trace, args.trace_jsonl):
            if p:
                print(f"[obs] wrote {p}")


def backend_options_from_args(args: argparse.Namespace) -> dict:
    return {"workers": args.workers, "progress": args.progress,
            **execution_options_from_args(args)}
