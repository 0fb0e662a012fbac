"""The port's grid CLI: its specs equal the reference CLI's, and
``python -m repro_torch.experiments`` runs the registry and scenario axes.
"""
import argparse
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.experiments import cli as jcli  # noqa: E402
from repro_torch.experiments import cli as tcli  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REGISTRY_ARGS = ["--workload", "theta", "--scale", "0.02", "--seeds", "1",
                 "--strategies", "steal_agreement", "pref_common_pool",
                 "rigid_sjf", "--queue-order", "sjf", "--on-demand-frac",
                 "0.1"]

ARGVS = [
    ["--workload", "theta"],
    ["--workload", "knl", "eagle", "--scale", "0.5", "--seeds", "2",
     "--trace-seed", "3", "--proportions", "0.0", "0.5", "1.0"],
    ["--workload", "haswell", "--strategies", "min", "steal_agreement",
     "pref_common_pool", "rigid_sjf", "--queue-order", "sjf"],
    ["--workload", "theta", "--walltime-factor", "0.5", "--walltime-jitter",
     "0.3", "--walltime-dist", "uniform", "--walltime-seed", "11",
     "--arrival-compression", "2.0", "--backfill-depth", "8"],
    ["--workload", "theta", "--rigid-frac", "0.1", "--on-demand-frac", "0.1",
     "--class-seed", "5", "--strategies", "pref", "avg"],
    REGISTRY_ARGS,
]


def _spec(module, argv):
    ap = argparse.ArgumentParser()
    module.add_spec_arguments(ap)
    return module.spec_from_args(ap.parse_args(argv))


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_spec_from_args_equals_the_reference_cli(argv):
    ref, got = _spec(jcli, argv), _spec(tcli, argv)
    # the port's defaults of --scale and --seeds are the paper grid's
    given = [f for f in ("scale", "seeds") if f"--{f}" in argv]
    for field in ["workloads", "trace_seed", "proportions", "strategies",
                  *given]:
        assert getattr(got, field) == getattr(ref, field), field
    assert dataclasses.asdict(got.scenario) == dataclasses.asdict(
        ref.scenario)
    assert dataclasses.asdict(got.transform) == dataclasses.asdict(
        ref.transform)
    assert got.engine == "torch"


def test_strategy_choices_are_the_registry():
    ap = argparse.ArgumentParser()
    tcli.add_spec_arguments(ap)
    with pytest.raises(SystemExit):
        ap.parse_args(["--strategies", "easy"])  # the implied baseline


def test_module_runs_the_registry_axes_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", *REGISTRY_ARGS,
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    # the two malleable strategies at five proportions, rigid_sjf once
    # (the EASY baseline is the "rigid" entry), then the summary line
    assert sum("] pref_common_pool@" in ln for ln in lines) == 5
    assert sum("] steal_agreement@" in ln for ln in lines) == 5
    assert sum("] rigid_sjf (rigid" in ln for ln in lines) == 1
    summary = [ln for ln in lines if " engine=torch wall " in ln]
    assert len(summary) == 1
    assert "computed=12 incomplete=0 device=cpu" in summary[0]


def _steady(lines):
    """Output without the run's wall clock and the window escalations
    (which the ``--window`` floor changes by design)."""
    return [ln for ln in lines
            if " wall " not in ln and not ln.startswith("[sweep.batch]")]


def test_execution_flags_reach_the_engine_and_change_no_result(
        capsys, monkeypatch):
    from repro_torch.experiments import __main__ as entry
    from repro_torch.experiments import backend_torch
    seen, results = [], []

    def run_cells(*args, options, **kw):
        seen.append(options)
        out = real(*args, options=options, **kw)
        results.append(out[0])
        return out
    real = backend_torch.run_cells
    monkeypatch.setattr(backend_torch, "run_cells", run_cells)
    argv = REGISTRY_ARGS + ["--device", "cpu"]
    assert entry.main(argv) == 0
    default = capsys.readouterr().out.splitlines()
    assert entry.main(argv + ["--window", "32", "--chunk", "48",
                              "--events", "1"]) == 0
    knobs = capsys.readouterr().out.splitlines()
    assert _steady(knobs) == _steady(default)
    assert len(_steady(default)) == len(default) - 1
    # every metric of every cell, at full precision, NaN equal to NaN
    base, moved = results
    assert base.keys() == moved.keys() and len(base) == 12
    for key in base:
        assert base[key].keys() == moved[key].keys(), key
        for name, value in base[key].items():
            other = moved[key][name]
            assert value == other or (math.isnan(value)
                                      and math.isnan(other)), (key, name)
    assert [(o["window"], o["chunk"], o["events"]) for o in seen] == [
        (0, 160, 4), (32, 48, 1)]


def test_without_a_device_the_module_raises_on_a_cpu_box():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA device")
    from repro_torch.experiments.__main__ import main
    with pytest.raises(RuntimeError):
        main(REGISTRY_ARGS)
