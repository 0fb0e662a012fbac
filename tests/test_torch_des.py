"""The port's copy of the reference DES equals the reference, byte for byte.

The experiment layer's ``des`` engine and the crosscheck run the port's
own copy of the numpy discrete-event simulator (``core/simulator.py``),
of ``passes.py`` families 1-2, of ``transform_rigid_to_malleable`` and of
the per-run metrics.  Both packages' DES cells share store keys, so the
copies must give the reference's outputs exactly: every ``SimResult``
array by ``tobytes()``, and the metric dicts key for key.
"""
import dataclasses
import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import passes as jpasses  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import passes as tpasses  # noqa: E402

STRATEGIES = ["easy", *jcore.strategies.registered_strategy_names(
    sweepable_only=True)]
# the two small traces barely queue; theta at 0.2 (510 jobs) backs up, so
# the EASY reservation, the backfill scan and SJF's reordering all run
WORKLOADS = [("haswell", 0.003), ("theta", 0.01), ("theta", 0.2)]
CLASSES = {"none": {}, "classes": dict(rigid=0.1, on_demand=0.1,
                                       malleable=0.8)}


def _same(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def _dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert _same(a[k], b[k]), (k, a[k], b[k])


def _run(core, name, scale, strat, queue_order, classes):
    scenario = core.ScenarioConfig(queue_order=queue_order, **(
        {"job_classes": core.scenario.JobClasses(**classes)}
        if classes else {}))
    cl = core.CLUSTERS[name]
    w = core.apply_scenario(core.traces.generate(name, 0, scale), scenario)
    prop = 0.6 if core.STRATEGIES[strat].malleable else 0.0
    wm = core.transform_rigid_to_malleable(w, prop, 1, cl.nodes)
    res = core.simulate(wm, cl, core.get_strategy(strat),
                        backfill_depth=scenario.backfill_depth,
                        queue_order=scenario.queue_order)
    metrics = {**core.run_metrics(res, wm, cl, core.Window.for_workload(w)),
               **core.scheduling_counters(res, wm)}
    return wm, res, metrics


@pytest.mark.parametrize("classes", sorted(CLASSES))
@pytest.mark.parametrize("queue_order", ["fcfs", "sjf"])
@pytest.mark.parametrize("strat", STRATEGIES)
@pytest.mark.parametrize("name,scale", WORKLOADS,
                         ids=[f"{w}-{s}" for w, s in WORKLOADS])
def test_des_equals_the_reference(name, scale, strat, queue_order, classes):
    jw, jres, jm = _run(jcore, name, scale, strat, queue_order,
                        CLASSES[classes])
    tw, tres, tm = _run(tcore, name, scale, strat, queue_order,
                        CLASSES[classes])
    for f in dataclasses.fields(jw):
        a, b = getattr(jw, f.name), getattr(tw, f.name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
    for f in dataclasses.fields(jres):
        if f.name == "sim_seconds":  # the run's own wall clock
            continue
        a, b = getattr(jres, f.name), getattr(tres, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    assert jres.finished
    _dicts_equal(jm, tm)


@pytest.mark.parametrize("proportion", [0.2, 0.6, 1.0])
def test_transform_equals_the_reference(proportion):
    scenario = dict(job_classes=dict(rigid=0.2, on_demand=0.1,
                                     malleable=0.7))
    cl = jcore.CLUSTERS["haswell"]
    ws = [core.apply_scenario(core.traces.generate("haswell", 0, 0.01),
                              core.ScenarioConfig(**scenario))
          for core in (jcore, tcore)]
    for seed in (1, 3):
        a = jcore.transform_rigid_to_malleable(ws[0], proportion, seed,
                                               cl.nodes)
        b = tcore.transform_rigid_to_malleable(ws[1], proportion, seed,
                                               cl.nodes)
        assert a.malleable.any()
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f.name


# ---------------------------------------------------------------- families
def _redistribution_case(rng, n):
    mn = rng.integers(1, 8, n)
    mx = mn + rng.integers(0, 40, n)
    alloc = mn + (rng.random(n) * (mx - mn + 1)).astype(np.int64)
    alloc = np.minimum(alloc, mx)
    prio = rng.integers(-20, 20, n)
    amount = int(rng.integers(0, int(np.sum(mx)) + 3))
    return alloc, mn, mx, prio, amount


def _check_redistribution(alloc, mn, mx, prio, amount):
    for fn, args in (
            ("greedy_shrink", (alloc, mn, prio, amount)),
            ("greedy_expand", (alloc, mx, prio, amount)),
            ("balanced_shrink", (alloc, mn, mx, amount)),
            ("balanced_expand", (alloc, mn, mx, amount))):
        a = getattr(jpasses, fn)(*args, xp=np)
        b = getattr(tpasses, fn)(*args, xp=np)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), fn


def _check_backfill(rng, n):
    want = rng.integers(1, 30, n)
    floor = np.minimum(want, rng.integers(1, 30, n))
    free = int(rng.integers(0, 60))
    assert jpasses.fcfs_prefix_exact(want, floor, free) == \
        tpasses.fcfs_prefix_exact(want, floor, free)
    ests = rng.uniform(0, 1000, n)
    release = rng.integers(1, 20, n)
    head = int(rng.integers(1, int(release.sum()) + free + 1))
    assert jpasses.easy_reservation_exact(ests, release, free, head) == \
        tpasses.easy_reservation_exact(ests, release, free, head)
    wall_work = rng.uniform(1, 500, n)
    pfrac = rng.uniform(0, 1, n)
    shadow = float(rng.uniform(0, 600))
    extra = int(rng.integers(0, 20))
    assert jpasses.easy_backfill_scan_exact(
        want, floor, wall_work, pfrac, 100.0, shadow, extra, free) == \
        tpasses.easy_backfill_scan_exact(
            want, floor, wall_work, pfrac, 100.0, shadow, extra, free)


@pytest.mark.parametrize("seed", range(8))
def test_families_equal_the_reference_on_seeded_inputs(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 5, 37):
        _check_redistribution(*_redistribution_case(rng, n))
        _check_backfill(rng, n)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2 ** 32 - 1), st.integers(1, 64))
def test_families_equal_the_reference_on_hypothesis_inputs(seed, n):
    rng = np.random.default_rng(seed)
    _check_redistribution(*_redistribution_case(rng, n))
    _check_backfill(rng, n)
