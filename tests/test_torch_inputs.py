"""The port's inputs equal the JAX package's, array for array.

Trace generation, the scenario transform, lane construction and the
batch-level statics are numpy code copied into the port; these tests hold
the copies to the reference byte for byte at a small scale.  The model
configs (``configs/base.py`` and the arch modules) are copied whole and
held to the reference file for file; ``train/data.py`` too, but for its
config import; ``elastic/failures.py`` byte for byte, with the reference's
straggler test run on the copy.
"""
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.experiments import spec as jspec  # noqa: E402
from repro.sweep import batch as jbatch  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.experiments import spec as tspec  # noqa: E402
from repro_torch.sweep import batch as tbatch  # noqa: E402
from repro_torch.sweep import cache as tcache  # noqa: E402

WORKLOADS = ("theta", "haswell")
SCENARIOS = {
    "default": {},
    "jitter": dict(walltime_factor=0.5, walltime_jitter=0.4,
                   walltime_dist="uniform", arrival_compression=2.0),
    "exact": dict(walltime_factor=0.0, backfill_depth=8),
}
GREEDY = [("easy", 0.0, 0), ("min", 0.6, 0), ("pref", 1.0, 1),
          ("keeppref", 0.4, 1)]
BALANCED = [("avg", 0.2, 0), ("avg", 1.0, 1)]


def _workloads(name, scenario):
    w_j = jcore.apply_scenario(jcore.traces.generate(name, 0, 0.01),
                               jcore.ScenarioConfig(**scenario))
    w_t = tcore.apply_scenario(tcore.traces.generate(name, 0, 0.01),
                               tcore.ScenarioConfig(**scenario))
    return w_j, w_t


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("name", WORKLOADS)
def test_generated_workload_is_byte_identical(name, scenario):
    w_j, w_t = _workloads(name, SCENARIOS[scenario])
    for f in dataclasses.fields(w_j):
        a, b = getattr(w_j, f.name), getattr(w_t, f.name)
        assert a.dtype == b.dtype, f.name
        assert a.tobytes() == b.tobytes(), f.name


@pytest.mark.parametrize("lanes", [GREEDY, BALANCED],
                         ids=["greedy", "balanced"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_build_lanes_matches_reference(name, lanes):
    w_j, w_t = _workloads(name, {})
    cl = jcore.CLUSTERS[name]
    jb, jorder = jbatch.build_lanes(
        w_j, cl.nodes, [(jcore.STRATEGIES[s], p, sd) for s, p, sd in lanes],
        tick=cl.tick)
    tb, torder = tbatch.build_lanes(
        w_t, cl.nodes, [(tcore.STRATEGIES[s], p, sd) for s, p, sd in lanes],
        tick=cl.tick, device="cpu")
    np.testing.assert_array_equal(jorder, torder)
    assert jbatch.BatchedLanes._fields == tbatch.BatchedLanes._fields
    for f in jbatch.BatchedLanes._fields:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f
    assert jbatch.lane_statics(jb) == tbatch.lane_statics(tb)


def test_concat_lanes_pads_like_reference():
    cl = jcore.CLUSTERS
    parts_j, parts_t = [], []
    for name, lanes in (("theta", GREEDY[:2]), ("haswell", GREEDY[2:])):
        w_j, w_t = _workloads(name, {})
        parts_j.append(jbatch.build_lanes(
            w_j, cl[name].nodes,
            [(jcore.STRATEGIES[s], p, sd) for s, p, sd in lanes],
            tick=cl[name].tick)[0])
        parts_t.append(tbatch.build_lanes(
            w_t, cl[name].nodes,
            [(tcore.STRATEGIES[s], p, sd) for s, p, sd in lanes],
            tick=cl[name].tick, device="cpu")[0])
    jb, tb = jbatch.concat_lanes(parts_j), tbatch.concat_lanes(parts_t)
    for f in jbatch.BatchedLanes._fields:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    sub_j = jbatch.pad_lanes(jbatch.take_lanes(jb, 1, 3), 4)
    sub_t = tbatch.pad_lanes(tbatch.take_lanes(tb, 1, 3), 4)
    for f in jbatch.BatchedLanes._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sub_j, f)),
                                      getattr(sub_t, f).numpy(), err_msg=f)


@pytest.mark.parametrize("floor,n", [(128, 100), (128, 2550), (16, 30),
                                     (4, 1000)])
def test_window_ladder_matches_reference(floor, n):
    assert jbatch.window_ladder(floor, n) == tbatch.window_ladder(floor, n)


@pytest.mark.parametrize("name", WORKLOADS)
def test_window_and_aggregation_match_reference(name):
    w_j, w_t = _workloads(name, {})
    assert (dataclasses.astuple(jmetrics.Window.for_workload(w_j))
            == dataclasses.astuple(tmetrics.Window.for_workload(w_t)))
    per_seed = [{"a": 1.0, "b": 2.5}, {"a": 3.0}, {"a": np.nan, "b": 1.0}]
    j, t = jmetrics.aggregate_seeds(per_seed), tmetrics.aggregate_seeds(
        per_seed)
    assert j.keys() == t.keys()
    np.testing.assert_array_equal(list(j.values()), list(t.values()))
    assert jmetrics.improvement(10.0, 7.5) == tmetrics.improvement(10.0, 7.5)


def test_spec_grid_and_fingerprints():
    """The port's spec yields the JAX spec's cells; its fingerprints carry
    engine ``torch`` and never collide with des / jax cell keys."""
    kw = dict(workloads=("theta",), scale=0.02, seeds=2)
    j, t = jspec.ExperimentSpec(**kw), tspec.ExperimentSpec(**kw)
    assert j.cells() == t.cells()
    assert len(t.cells()) == 41
    for cell in t.cells()[:5]:
        fp_t = t.cell_fingerprint("theta", cell)
        fp_j = j.cell_fingerprint("theta", cell)
        assert fp_t["engine"] == "torch"
        assert fp_t["engine_version"] == tbatch.ENGINE_VERSION
        assert {k: v for k, v in fp_t.items()
                if not k.startswith("engine")} == {
            k: v for k, v in fp_j.items() if not k.startswith("engine")}
        assert tcache.SweepCache.key(fp_t) != tcache.SweepCache.key(fp_j)
    with pytest.raises(ValueError):
        tspec.ExperimentSpec(workloads=("theta",), engine="jax")


def test_cell_store_roundtrip(tmp_path):
    store = tcache.SweepCache(tmp_path)
    fp = tcache.cell_fingerprint("haswell", 0, 0.05, 2388, 1.0, "min", 0.6,
                                 3)
    assert store.get(fp) is None
    store.put(fp, {"turnaround_mean": 123.0})
    assert store.get(fp) == {"turnaround_mean": 123.0}
    assert store.hits == 1 and store.misses == 1
    with pytest.raises(ValueError):
        tcache.cell_fingerprint("haswell", 0, 0.05, 2388, 1.0, "min", 0.6,
                                3, engine="jax")


CONFIG_FILES = sorted(
    p.name for p in (pathlib.Path(jcore.__file__).parents[1] / "configs")
    .glob("*.py") if p.name not in ("__init__.py", "workloads.py"))


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_module_is_a_byte_copy(name):
    """``configs/base.py`` and the arch modules are copied whole."""
    ref = pathlib.Path(jcore.__file__).parents[1] / "configs" / name
    port = pathlib.Path(tcore.__file__).parents[1] / "configs" / name
    assert port.read_bytes() == ref.read_bytes()


def test_train_data_module_is_a_copy_but_for_its_config_import():
    """``train/data.py`` (the synthetic token pipeline) is copied whole;
    only its config import names the port's package."""
    import repro.train.data as jdata
    import repro_torch.train.data as tdata
    ref = pathlib.Path(jdata.__file__).read_text()
    port = pathlib.Path(tdata.__file__).read_text()
    assert ref.count("from repro.configs.base import") == 1
    assert port == ref.replace("from repro.configs.base import",
                               "from repro_torch.configs.base import")


def test_elastic_failures_module_is_a_byte_copy():
    """``elastic/failures.py`` (the failure injector and the straggler
    monitor) imports no JAX and is copied whole."""
    import repro.elastic.failures as jfail
    import repro_torch.elastic.failures as tfail
    assert pathlib.Path(tfail.__file__).read_bytes() == \
        pathlib.Path(jfail.__file__).read_bytes()


def test_straggler_monitor_flags_slow_host():
    """The reference's test (``tests/test_elastic.py``) on the copy."""
    from repro_torch.elastic.failures import StragglerMonitor
    mon = StragglerMonitor(n_nodes=4, threshold=2.0, grace_steps=1)
    lat = np.asarray([0.1, 0.1, 0.1, 0.1])
    for _ in range(10):
        assert mon.observe(lat) == []
    slow = lat.copy()
    slow[2] = 0.5
    assert mon.observe(slow) == []      # one grace step
    assert mon.observe(slow) == [2]     # persistent straggler evicted
    assert mon.observe(lat) == []       # recovered after eviction/reset


def test_failure_injector_draws_as_the_reference():
    from repro.elastic.failures import FailureInjector as J
    from repro_torch.elastic.failures import FailureInjector as T
    j, t = J(8, 100.0, seed=3), T(8, 100.0, seed=3)
    for now in (10.0, 50.0, 200.0):
        assert t.failed_nodes(now) == j.failed_nodes(now)
        for node in j.failed_nodes(now):
            j.replace(node, now)
            t.replace(node, now)


def test_config_registry_matches_reference():
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    assert tconfigs.ALL_ARCHS == jconfigs.ALL_ARCHS
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in jconfigs.ALL_ARCHS:
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (dataclasses.asdict(t.reduced())
                == dataclasses.asdict(j.reduced()))
