"""The port's ``run_cells`` vs the JAX backend, cell for cell.

Both backends run the same spec (theta + haswell at scale 0.02, 2 seeds:
the paper's five strategies, 41 cells per workload) on the CPU.  The
schedules are bit-equal (``test_torch_batch.py``); the metrics reduce
float32 sums in another order than XLA, so means and utilization are held
to ``rtol=1e-5`` (float32 rounding of a sum over a few hundred jobs), while
counts, medians and the scheduling counters must be exact.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.experiments import backend_jax  # noqa: E402
from repro.experiments import spec as jspec  # noqa: E402
from repro_torch.experiments import backend_torch  # noqa: E402
from repro_torch.experiments import spec as tspec  # noqa: E402
from repro_torch.sweep.cache import SweepCache  # noqa: E402

KW = dict(workloads=("theta", "haswell"), scale=0.02, seeds=2)
EXACT_KEYS = ("n_jobs", "n_malleable", "wait_p50", "turnaround_p50",
              "expand_per_job", "shrink_per_job", "unfinished",
              "sched_backfill_starts", "sched_shrink_events",
              "sched_expand_events", "sched_invocations")
CLOSE_KEYS = ("wait_mean", "makespan_mean", "turnaround_mean",
              "utilization")
RTOL = 1e-5


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    js, ts = jspec.ExperimentSpec(**KW, engine="jax"), tspec.ExperimentSpec(
        **KW)
    todo = [(w, c) for w in ts.workloads for c in ts.cells()]
    jm, jinfo = backend_jax.run_cells(js, todo, None, {}, verbose=False)
    store = SweepCache(tmp_path_factory.mktemp("store"))
    fps = {k: ts.cell_fingerprint(*k) for k in todo}
    tm, tinfo = backend_torch.run_cells(ts, todo, store, fps,
                                        options={"device": "cpu"},
                                        verbose=False)
    return todo, jm, jinfo, tm, tinfo, store, fps


def _same(a, b):
    return a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("key", EXACT_KEYS)
def test_exact_metrics_equal_jax(both, key):
    todo, jm, _, tm, _, _, _ = both
    bad = [k for k in todo if not _same(jm[k][key], tm[k][key])]
    assert not bad, (key, bad[:3])


@pytest.mark.parametrize("key", CLOSE_KEYS)
def test_float_metrics_match_jax_within_rtol(both, key):
    todo, jm, _, tm, _, _, _ = both
    ref = np.array([jm[k][key] for k in todo])
    got = np.array([tm[k][key] for k in todo])
    np.testing.assert_allclose(got, ref, rtol=RTOL, equal_nan=True)


def test_every_cell_completes_and_is_stored(both):
    todo, jm, jinfo, tm, tinfo, store, fps = both
    assert len(todo) == 82
    assert set(tm) == set(jm) == set(todo)
    assert tinfo["incomplete"] == [] and tinfo["computed_cells"] == 82
    assert all(0.0 <= tm[k]["utilization"] <= 1.0 for k in todo)
    assert all(store.get(fps[k]) == tm[k] for k in todo)
    assert tinfo["greedy_lanes"] == jinfo["greedy_lanes"] == 62
    assert tinfo["balanced_lanes"] == jinfo["balanced_lanes"] == 20
    assert tinfo["sched_steps"] == jinfo["sched_steps"]


def test_cli_prints_cells_and_rate(capsys):
    from repro_torch.experiments.__main__ import main
    rc = main(["--workload", "theta", "--scale", "0.01", "--seeds", "1",
               "--device", "cpu", "--expand-backend", "bisect"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    # 4 malleable strategies x 5 proportions, aggregated over the seed
    # (the 21st cell is the EASY baseline), then the summary line
    assert sum(ln.startswith("[experiment:theta] ") and "%: turnaround="
               in ln for ln in out) == 20
    summary = [ln for ln in out if " engine=torch wall " in ln]
    assert len(summary) == 1
    assert "computed=21 incomplete=0 device=cpu cells_per_s=" in summary[0]
