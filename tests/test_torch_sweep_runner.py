"""``python -m repro_torch.sweep``: the experiment CLI under its own name.

The port of ``repro.sweep.runner``: ``main`` is ``python -m
repro_torch.experiments --engine torch`` with its own ``prog`` and the
chunked-execution epilogue (through ``experiments.__main__.main(argv,
prog, epilog)``), and the ``sweep_workload(s)_torch`` wrappers build an
``ExperimentSpec(engine="torch")`` and run it.  Runs on the CPU with
``--device cpu`` / ``device="cpu"``.
"""
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.experiments import ExperimentSpec, run_experiment  # noqa
from repro_torch.experiments import __main__ as emain  # noqa: E402
from repro_torch.sweep import (sweep_workload_torch,  # noqa: E402
                               sweep_workloads_torch)
from repro_torch.sweep import runner  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
ARGV = ["--workload", "theta", "--scale", "0.01", "--seeds", "1",
        "--device", "cpu"]


def _cells(path):
    """The artifact's per-cell metrics and its spec key."""
    results = json.loads(pathlib.Path(path).read_text())["results"]
    return ({k: v for k, v in results.items() if not k.startswith("_")},
            results["_meta"]["spec_key"])


def test_help_shows_its_own_prog_and_epilogue():
    out = subprocess.run([sys.executable, "-m", "repro_torch.sweep",
                          "--help"], capture_output=True, text=True,
                         timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: python -m repro_torch.sweep")
    assert "chunked / split execution (torch engine):" in out.stdout
    assert "--chunk-lanes" in out.stdout and "--expand-backend" in out.stdout


def test_experiments_cli_keeps_its_own_identity(capsys):
    with pytest.raises(SystemExit):
        emain.main(["--help"])
    out = capsys.readouterr().out
    assert out.startswith("usage: python -m repro_torch.experiments")
    assert "chunked / split execution" not in out


def test_main_gives_the_experiment_cli_cells(tmp_path, capsys):
    assert runner.main(ARGV + ["--out", str(tmp_path / "s.json")]) == 0
    out = capsys.readouterr().out
    assert "engine=torch" in out and "device=cpu" in out
    assert emain.main(ARGV + ["--engine", "torch",
                              "--out", str(tmp_path / "e.json")]) == 0
    sweep, sweep_key = _cells(tmp_path / "s.json")
    exp, exp_key = _cells(tmp_path / "e.json")
    assert sweep_key == exp_key and len(sweep) == 25  # rigid + 4 x 6
    assert sweep == exp


def test_wrappers_run_the_spec_they_build():
    kw = dict(scale=0.005, seeds=1, proportions=(0.0, 1.0),
              strategies=("min", "avg"), verbose=False)
    got = sweep_workload_torch("theta", device="cpu", **kw)
    spec = ExperimentSpec(workloads=("theta",), scale=0.005, seeds=1,
                          proportions=(0.0, 1.0), strategies=("min", "avg"),
                          engine="torch")
    want = run_experiment(spec, backend_options={"device": "cpu"},
                          verbose=False)["theta"]
    assert got["_meta"]["spec_key"] == want["_meta"]["spec_key"]
    cells = [k for k in want if not k.startswith("_")]
    assert cells and all(got[k] == want[k] for k in cells)
    both = sweep_workloads_torch(["theta", "haswell"], device="cpu", **kw)
    assert set(both) == {"theta", "haswell"}
    assert runner.PROPORTIONS == (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    assert runner.MALLEABLE_STRATEGIES == ("min", "pref", "avg", "keeppref")
    assert set(runner.CROSSCHECK_TOLERANCES) >= {"turnaround_mean",
                                                 "wait_mean"}
