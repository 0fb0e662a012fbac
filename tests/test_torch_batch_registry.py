"""The port's batched engine and backend over the whole strategy registry.

``simulate_lanes`` of the port vs ``repro.sweep.batch.simulate_lanes`` on
numpy-built lanes (the JAX batch carried across) for the pooled and
stealing structures, on-demand job classes, the SJF queue order, a mixed
FCFS / ``rigid_sjf`` batch and SJF at backfill depth 2: the ``EXACT``
fields of ``tests/test_torch_batch.py`` bit-equal, the timeline equal as a
step function.  Then ``run_cells`` of both backends on a registry spec
(every sweepable strategy, SJF, on-demand classes) over knl and eagle, the
two 10 s-tick clusters, with the tolerances of
``tests/test_torch_backend.py``.  Last, the C1 pin (ROADMAP.md §C1): the
JAX engine starts a job before its submission under SJF, and the port
mirrors it.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import STRATEGIES as JS, Workload  # noqa: E402
from repro.core.scenario import (JobClasses as JClasses,  # noqa: E402
                                 ScenarioConfig as JScenario,
                                 apply_scenario)
from repro.core.strategies import StrategySpec as JSpec  # noqa: E402
from repro.experiments import backend_jax  # noqa: E402
from repro.experiments import spec as jspec  # noqa: E402
from repro.sweep import batch as jb  # noqa: E402
from repro_torch.core.scenario import JobClasses, ScenarioConfig  # noqa
from repro_torch.core.strategies import (StrategySpec,  # noqa: E402
                                         registered_strategy_names)
from repro_torch.experiments import backend_torch  # noqa: E402
from repro_torch.experiments import spec as tspec  # noqa: E402
from repro_torch.sweep import batch as tb  # noqa: E402

from test_torch_backend import CLOSE_KEYS, EXACT_KEYS, RTOL  # noqa: E402
from test_torch_batch import EXACT, _carry, _step_function  # noqa: E402


def _wl(seed=0, n=24, hi=120.0):
    rng = np.random.default_rng(seed)
    return Workload.rigid(submit=np.sort(rng.uniform(0, hi, n)),
                          runtime=rng.uniform(20, 120, n),
                          nodes_req=rng.choice([1, 2, 4, 8], n))


def _classed(seed=0):
    """A quarter of the jobs on-demand, a tenth pinned rigid."""
    return apply_scenario(_wl(seed), JScenario(job_classes=JClasses(
        rigid=0.1, on_demand=0.25, malleable=0.65, seed=seed)))


def _lanes(names):
    return [(JS[s], p, sd) for s, p, sd in names]


POOLED = [("easy", 0.0, 0), ("pref_common_pool", 0.6, 0),
          ("pref_common_pool", 1.0, 1)]
STEALING = [("easy", 0.0, 0), ("steal_agreement", 0.6, 0),
            ("steal_agreement", 1.0, 1)]
GREEDY = [("easy", 0.0, 0), ("min", 0.6, 0), ("pref", 1.0, 1),
          ("keeppref", 0.8, 0)]

CASES = {
    # name: (workload, lanes, structure, queue order, backfill depth)
    "pooled": (lambda: _wl(1), POOLED, "pooled", "fcfs", 256),
    "stealing": (lambda: _wl(2), STEALING, "stealing", "fcfs", 256),
    "greedy-classes": (lambda: _classed(3), GREEDY, "greedy", "fcfs", 256),
    "pooled-classes": (lambda: _classed(4), POOLED, "pooled", "fcfs", 256),
    "sjf-greedy": (lambda: _wl(5), GREEDY, "greedy", "sjf", 256),
    "mixed-fcfs-sjf": (lambda: _wl(6), [("easy", 0.0, 0),
                                        ("rigid_sjf", 0.0, 0),
                                        ("min", 0.6, 0)],
                       "greedy", "fcfs", 256),
    "sjf-depth2": (lambda: _wl(7), GREEDY, "greedy", "sjf", 2),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (make, lanes, structure, order, depth) in CASES.items():
        batch, _ = jb.build_lanes(make(), 10, _lanes(lanes),
                                  queue_order=order, backfill_depth=depth)
        kw = dict(structure=structure, window=16, chunk=64)
        out[name] = (jb.simulate_lanes(batch, jb.EngineConfig(**kw)),
                     tb.simulate_lanes(_carry(batch), tb.EngineConfig(**kw)),
                     jb.lane_statics(batch))
    return out


def test_cases_drive_the_registry_flags(runs):
    """Each case runs the flags it names (classes, SJF, a bounded depth)."""
    for name, (_ref, _got, st) in runs.items():
        assert st["with_classes"] == ("classes" in name), name
        assert st["with_sjf"] == ("sjf" in name), name
    assert runs["sjf-depth2"][2]["min_depth"] == 2


@pytest.mark.parametrize("field", EXACT)
@pytest.mark.parametrize("case", sorted(CASES))
def test_outcomes_bit_equal_to_jax(runs, case, field):
    ref, got, _ = runs[case]
    assert got["finished"] and ref["finished"]
    np.testing.assert_array_equal(np.asarray(ref[field]), got[field],
                                  err_msg=f"{case}:{field}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_timeline_equal_as_step_function(runs, case):
    ref, got, _ = runs[case]
    keys = ("trace_t", "trace_busy", "trace_qlen")
    for lane in range(got["trace_t"].shape[0]):
        assert _step_function(*(np.asarray(ref[k])[lane] for k in keys)) \
            == _step_function(*(got[k][lane] for k in keys))


# -- run_cells on the registry spec, knl + eagle --------------------------
REGISTRY = dict(workloads=("knl", "eagle"), seeds=1,
                strategies=registered_strategy_names(sweepable_only=True))
SCALES = {"knl": 0.005, "eagle": 0.002}


@pytest.fixture(scope="module")
def registry_cells():
    """Both backends on the registry spec, one workload at a time (each at
    its own scale), metrics merged."""
    scen = dict(queue_order="sjf")
    classes = dict(rigid=0.1, on_demand=0.1, malleable=0.8)
    out = {"todo": [], "jax": {}, "torch": {}, "info": []}
    for name, scale in SCALES.items():
        kw = dict(REGISTRY, workloads=(name,), scale=scale)
        js = jspec.ExperimentSpec(**kw, engine="jax", scenario=JScenario(
            **scen, job_classes=JClasses(**classes)))
        ts = tspec.ExperimentSpec(**kw, scenario=ScenarioConfig(
            **scen, job_classes=JobClasses(**classes)))
        todo = [(name, c) for c in ts.cells()]
        jm, _ = backend_jax.run_cells(js, todo, None, {}, verbose=False)
        tm, tinfo = backend_torch.run_cells(ts, todo, None, {},
                                            options={"device": "cpu"},
                                            verbose=False)
        out["todo"] += todo
        out["jax"].update(jm)
        out["torch"].update(tm)
        out["info"].append(tinfo)
    return out


def _same(a, b):
    return a == b or (math.isnan(a) and math.isnan(b))


def test_registry_spec_runs_every_structure_on_both_clusters(registry_cells):
    assert set(REGISTRY["strategies"]) >= {"steal_agreement",
                                           "pref_common_pool", "rigid_sjf"}
    for info in registry_cells["info"]:
        assert info["incomplete"] == []
        for s in ("greedy", "balanced", "pooled", "stealing"):
            assert info[f"{s}_lanes"] > 0, s
    assert set(registry_cells["torch"]) == set(registry_cells["todo"])


@pytest.mark.parametrize("key", EXACT_KEYS)
def test_registry_exact_metrics_equal_jax(registry_cells, key):
    jm, tm = registry_cells["jax"], registry_cells["torch"]
    bad = [k for k in registry_cells["todo"]
           if not _same(jm[k][key], tm[k][key])]
    assert not bad, (key, bad[:3])


@pytest.mark.parametrize("key", CLOSE_KEYS)
def test_registry_float_metrics_match_jax_within_rtol(registry_cells, key):
    todo = registry_cells["todo"]
    ref = np.array([registry_cells["jax"][k][key] for k in todo])
    got = np.array([registry_cells["torch"][k][key] for k in todo])
    np.testing.assert_allclose(got, ref, rtol=RTOL, equal_nan=True)


# -- C1: a job started before its submission (ROADMAP.md §C1) -------------
# tests/test_strategies_properties.py's workload on its 10-node cluster,
# and the spec hypothesis found: greedy, priority min, req/req, SJF.
_RNG = np.random.default_rng(21)
_N = 12
_W = Workload.rigid(submit=np.sort(_RNG.uniform(0, 200, _N)),
                    runtime=_RNG.uniform(20, 80, _N),
                    nodes_req=_RNG.choice([1, 2, 4], _N))
_C1 = dict(name="prop", malleable=True, start_want="req", start_floor="req",
           shrink_floor="min", structure="greedy", priority="min",
           queue_order="sjf")


@pytest.fixture(scope="module")
def c1_runs():
    batch, _ = jb.build_lanes(_W, 10, [(JSpec(**_C1), 0.6, 1)])
    cfg = dict(structure="greedy", window=16, chunk=64)
    own, _ = tb.build_lanes(_W, 10, [(StrategySpec(**_C1), 0.6, 1)],
                            device="cpu")
    return (jb.simulate_lanes(batch, jb.EngineConfig(**cfg)),
            tb.simulate_lanes(own, tb.EngineConfig(**cfg)), own)


def test_c1_port_mirrors_the_jax_engine(c1_runs):
    ref, got, _ = c1_runs
    for field in EXACT:
        np.testing.assert_array_equal(np.asarray(ref[field]), got[field],
                                      err_msg=field)


@pytest.mark.xfail(strict=True, reason="C1: the half-tick arrival slack "
                   "admits an SJF job before its submission, mirrored from "
                   "the JAX engine for bit parity (ROADMAP.md §C1)")
def test_c1_no_job_starts_before_its_submission(c1_runs):
    _, got, own = c1_runs
    submit = own.submit.numpy()[0]
    start = got["start_t"][0]
    assert np.all(start >= submit), np.flatnonzero(start < submit)
