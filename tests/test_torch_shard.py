"""The port's chunked, card-split lane execution (``repro_torch.sweep.shard``).

Chunking and splitting are execution choices, never experiment choices:

* ``chunk_plan`` / ``describe_plan`` equal the reference's over a grid of
  lane counts, budgets and device counts;
* a chunked or split stream gives every lane the monolithic batch's
  result bit for bit -- greedy (FCFS and SJF lanes in one batch),
  balanced, and on-demand class lanes on haswell at scale 0.003 -- with
  both pieces of a split on the CPU, and equals the reference's chunked
  stream on the same lanes;
* ``run_cells`` with ``chunk_lanes`` writes the same cells under the same
  keys as without, execution knobs never reach a fingerprint, and an
  interrupted chunked run resumes from the store;
* asking for more cards than are visible raises.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sweep.batch as jbatch  # noqa: E402
import repro.sweep.shard as jshard  # noqa: E402
from repro.core import STRATEGIES as JSTRATEGIES  # noqa: E402
from repro.experiments.spec import ExperimentSpec as JSpec  # noqa: E402
from repro.experiments.spec import \
    prepare_workload as jprepare  # noqa: E402
from repro_torch.core import STRATEGIES  # noqa: E402
from repro_torch.core.scenario import JobClasses, ScenarioConfig  # noqa: E402
from repro_torch.experiments import (ExperimentSpec,  # noqa: E402
                                     backend_torch, run_experiment)
from repro_torch.experiments.spec import prepare_workload  # noqa: E402
from repro_torch.sweep import shard  # noqa: E402
from repro_torch.sweep.batch import (EngineConfig, build_lanes,  # noqa: E402
                                     lane_statics, pad_lanes, simulate_lanes,
                                     take_lanes)
from repro_torch.sweep.cache import SweepCache  # noqa: E402

TINY_SPEC = dict(workloads=("haswell",), scale=0.003, seeds=2,
                 proportions=(0.0, 1.0), strategies=("min", "avg"))
OPTS = {"device": "cpu", "window": 32, "chunk": 64}
FIELDS = ("state", "alloc", "start_t", "end_t", "expand_ops", "shrink_ops",
          "bf_starts", "sched_steps")

# (structure, scenario, lanes): each case's lanes differ in what a
# chunk-local lane_statics would read (SJF and FCFS lanes in one greedy
# batch, AVG lanes of different spans, on-demand class lanes)
CASES = {
    "greedy-fcfs-sjf": ("greedy", {}, [
        ("easy", 0.0, 0), ("rigid_sjf", 0.0, 0), ("min", 0.6, 0),
        ("pref", 1.0, 1), ("keeppref", 0.6, 0)]),
    "balanced": ("balanced", {}, [
        ("avg", 0.3, 0), ("avg", 0.8, 0), ("avg", 1.0, 1)]),
    "classes": ("greedy", dict(job_classes=dict(
        rigid=0.1, on_demand=0.1, malleable=0.8)), [
        ("easy", 0.0, 0), ("pref", 0.6, 0), ("rigid_sjf", 0.0, 0),
        ("min", 1.0, 1)]),
}
PLANS = [shard.ShardConfig(chunk_lanes=1, devices=1),
         shard.ShardConfig(chunk_lanes=3, devices=1),
         shard.ShardConfig(chunk_lanes=0, devices=2),
         shard.ShardConfig(chunk_lanes=3, devices=2)]


def _ids(plan):
    return f"chunk{plan.chunk_lanes}-dev{plan.devices}"


# ----------------------------------------------------------------- plan
@pytest.mark.parametrize("n_devices", [1, 2, 3])
@pytest.mark.parametrize("chunk_lanes", [0, 1, 3, 4, 64])
@pytest.mark.parametrize("n_lanes", [1, 2, 7, 10, 41])
def test_chunk_plan_equals_the_reference(n_lanes, chunk_lanes, n_devices):
    assert shard.chunk_plan(n_lanes, chunk_lanes, n_devices) == \
        jshard.chunk_plan(n_lanes, chunk_lanes, n_devices)
    cfg = dict(chunk_lanes=chunk_lanes, devices=n_devices)
    assert shard.describe_plan(n_lanes, shard.ShardConfig(**cfg),
                               n_devices=n_devices) == \
        jshard.describe_plan(n_lanes, jshard.ShardConfig(**cfg),
                             n_devices=n_devices)


def test_plan_refusals_equal_the_reference():
    for mod in (shard, jshard):
        with pytest.raises(ValueError):
            mod.chunk_plan(0, 1)
        with pytest.raises(ValueError):
            mod.ShardConfig(chunk_lanes=-1)
        with pytest.raises(ValueError):
            mod.ShardConfig(devices=-1)


def test_more_cards_than_visible_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        shard.resolve_devices(2)
    assert shard.resolve_devices(0) == [torch.device("cuda", 0)]
    # an indexed card or the CPU takes every piece itself
    assert shard.resolve_devices(3, "cuda:0") == [torch.device("cuda", 0)] * 3
    assert shard.resolve_devices(2, "cpu") == [torch.device("cpu")] * 2
    assert shard.resolve_devices(0, "cpu") == [torch.device("cpu")]


# ------------------------------------------------------------ lanes
def _realized(scenario):
    spec = ExperimentSpec(workloads=("haswell",), scale=0.003,
                          scenario=ScenarioConfig(**{
                              k: (JobClasses(**v) if k == "job_classes"
                                  else v) for k, v in scenario.items()}))
    return spec, prepare_workload(spec, "haswell")


def _batch(case):
    structure, scenario, lanes = CASES[case]
    spec, (cl, w, _window) = _realized(scenario)
    batch, _ = build_lanes(
        w, cl.nodes, [(STRATEGIES[s], p, sd) for s, p, sd in lanes],
        config=spec.transform, tick=cl.tick,
        backfill_depth=spec.scenario.backfill_depth,
        queue_order=spec.scenario.queue_order, device="cpu")
    return structure, batch


def test_take_and_pad_lanes_round_trip():
    _, batch = _batch("greedy-fcfs-sjf")
    sub = take_lanes(batch, 1, 3)
    assert sub.n_lanes == 2 and sub.n_jobs == batch.n_jobs
    padded = pad_lanes(sub, 5)
    assert padded.n_lanes == 5
    assert pad_lanes(sub, 2) is sub
    with pytest.raises(ValueError):
        pad_lanes(sub, 1)
    for name in batch._fields:
        full = getattr(batch, name).numpy()
        np.testing.assert_array_equal(getattr(sub, name).numpy(),
                                      full[1:3], err_msg=name)
        # padding repeats the first lane, so lane statics are unchanged
        np.testing.assert_array_equal(getattr(padded, name).numpy(),
                                      full[[1, 2, 1, 1, 1]], err_msg=name)
    assert lane_statics(padded) == lane_statics(sub)
    # pieces and chunks at every offset concatenate back to the batch
    back = [take_lanes(batch, lo, min(lo + 2, batch.n_lanes))
            for lo in range(0, batch.n_lanes, 2)]
    for name in batch._fields:
        np.testing.assert_array_equal(
            np.concatenate([getattr(b, name).numpy() for b in back]),
            getattr(batch, name).numpy(), err_msg=name)


def _cfg(structure):
    return EngineConfig(structure=structure, window=16, chunk=64)


@pytest.fixture(scope="module")
def monolithic():
    out = {}
    for case in CASES:
        structure, batch = _batch(case)
        out[case] = (structure, batch,
                     simulate_lanes(batch, _cfg(structure)))
    return out


@pytest.mark.parametrize("plan", PLANS, ids=_ids)
@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_and_split_equal_monolithic(monolithic, case, plan):
    structure, batch, mono = monolithic[case]
    chunks = list(shard.simulate_lanes_chunked(batch, _cfg(structure), plan))
    width, ranges = shard.chunk_plan(batch.n_lanes, plan.chunk_lanes,
                                     plan.devices)
    assert [(c.lo, c.hi) for c in chunks] == ranges
    win = (np.zeros(batch.n_lanes), np.full(batch.n_lanes, 1e9))
    caps = batch.capacity.numpy()
    mono_m = backend_torch.chunk_metrics(
        shard.ChunkResult(0, batch.n_lanes, mono, 0.0, batch.n_lanes, 1),
        batch, *win, caps)
    for c in chunks:
        assert c.results["finished"] and c.lane_width == width
        assert c.n_devices == max(1, plan.devices)
        for k in FIELDS:
            np.testing.assert_array_equal(
                c.results[k], mono[k][c.lo:c.hi],
                err_msg=f"{case} {_ids(plan)} [{c.lo},{c.hi}) {k}")
        got = backend_torch.chunk_metrics(c, batch, *win, caps)
        assert json.dumps(got) == json.dumps(mono_m[c.lo:c.hi])
    if plan.chunk_lanes == 1 and case != "classes":
        # the case is one where a chunk-local statics would differ
        local = [lane_statics(take_lanes(batch, i, i + 1))
                 for i in range(batch.n_lanes)]
        assert any(s != lane_statics(batch) for s in local)


def test_chunked_stream_equals_the_reference_stream(monolithic):
    case = "greedy-fcfs-sjf"
    structure, _scenario, lanes = CASES[case]
    jspec = JSpec(workloads=("haswell",), scale=0.003, engine="jax")
    cl, w, _ = jprepare(jspec, "haswell")
    jb, _ = jbatch.build_lanes(
        w, cl.nodes, [(JSTRATEGIES[s], p, sd) for s, p, sd in lanes],
        config=jspec.transform, tick=cl.tick)
    jcfg = jbatch.EngineConfig(structure=structure, window=16, chunk=64)
    ref = list(jshard.simulate_lanes_chunked(
        jb, jcfg, jshard.ShardConfig(chunk_lanes=2, devices=1)))
    _, batch, _ = monolithic[case]
    got = list(shard.simulate_lanes_chunked(
        batch, _cfg(structure), shard.ShardConfig(chunk_lanes=2, devices=2)))
    assert [(c.lo, c.hi, c.lane_width) for c in ref] == [
        (c.lo, c.hi, c.lane_width) for c in got]
    for r, g in zip(ref, got):
        for k in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(r.results[k]), g.results[k],
                err_msg=f"{case} [{g.lo},{g.hi}) {k}")


# ------------------------------------------------- run_cells and store
def _keys(root):
    return sorted(p.name for p in pathlib.Path(root).rglob("*.json"))


def _results_equal(a, b):
    for k in a:
        if not k.startswith("_"):
            assert json.dumps(a[k]) == json.dumps(b[k]), k


def test_chunked_run_cells_same_cells_same_store_keys(tmp_path):
    spec = ExperimentSpec(**TINY_SPEC)
    n_cells = len(spec.cells())
    mono = run_experiment(spec, cache_dir=tmp_path / "mono",
                          backend_options=OPTS, verbose=False)["haswell"]
    chunked = run_experiment(
        spec, cache_dir=tmp_path / "chunked",
        backend_options={**OPTS, "chunk_lanes": 2, "devices": 2},
        verbose=False)["haswell"]
    _results_equal(mono, chunked)
    assert mono["_meta"]["spec_key"] == chunked["_meta"]["spec_key"]
    assert _keys(tmp_path / "mono") == _keys(tmp_path / "chunked")
    store_m, store_c = SweepCache(tmp_path / "mono"), \
        SweepCache(tmp_path / "chunked")
    for c in spec.cells():
        fp = spec.cell_fingerprint("haswell", c)
        assert json.dumps(store_m.get(fp)) == json.dumps(store_c.get(fp))

    assert len(mono["_engine"]["chunks"]) == 2  # greedy + balanced
    info = chunked["_engine"]
    assert info["peak_lane_width"] == 2 and info["devices"] == 2
    assert sum(c["lanes"] for c in info["chunks"]) == n_cells
    for c in info["chunks"]:
        assert c["hi"] - c["lo"] == c["lanes"] and c["lane_width"] == 2
        assert c["devices"] == 2 and c["wall_s"] >= 0.0
    for structure in ("greedy", "balanced"):
        assert info[f"{structure}_steps"] == sum(
            c["steps"] for c in info["chunks"]
            if c["structure"] == structure)

    # a chunked rerun against the monolithic store is a pure hit
    again = run_experiment(spec, cache_dir=tmp_path / "mono",
                           backend_options={**OPTS, "chunk_lanes": 1},
                           verbose=False)["haswell"]["_engine"]
    assert again["cache_hits"] == n_cells and again["computed_cells"] == 0


def test_execution_knobs_absent_from_fingerprints():
    spec = ExperimentSpec(**TINY_SPEC)
    blob = json.dumps(spec.fingerprint()) + json.dumps(
        spec.cell_fingerprint("haswell", ("min", 1.0, 0)))
    for knob in ("chunk_lanes", "devices", "device", "window", "workers",
                 "expand_backend", "max_lane_width", "max_batch",
                 "max_wait"):
        assert knob not in blob, knob


def test_interrupted_chunked_run_resumes_from_store(tmp_path, monkeypatch):
    """A kill mid-grid loses only the in-flight chunk: completed chunks
    were already stored, and the rerun computes just the rest."""
    spec = ExperimentSpec(**TINY_SPEC)
    n_cells = len(spec.cells())
    real = backend_torch.simulate_lanes_chunked

    def killed_after_first_chunk(*a, **kw):
        it = real(*a, **kw)
        yield next(it)
        raise KeyboardInterrupt("killed mid-grid")

    monkeypatch.setattr(backend_torch, "simulate_lanes_chunked",
                        killed_after_first_chunk)
    opts = {**OPTS, "chunk_lanes": 1}
    with pytest.raises(KeyboardInterrupt):
        run_experiment(spec, cache_dir=tmp_path, backend_options=opts,
                       verbose=False)
    monkeypatch.undo()

    store = SweepCache(tmp_path)
    stored = [c for c in spec.cells()
              if store.get(spec.cell_fingerprint("haswell", c)) is not None]
    assert len(stored) == 1  # exactly the first chunk's cell

    resumed = run_experiment(spec, cache_dir=tmp_path, backend_options=opts,
                             verbose=False)["haswell"]
    info = resumed["_engine"]
    assert info["cache_hits"] == 1
    assert info["computed_cells"] == n_cells - 1
    clean = run_experiment(spec, backend_options=OPTS,
                           verbose=False)["haswell"]
    _results_equal(clean, resumed)


# ------------------------------------------------------------ metrics
@pytest.mark.parametrize("n", [1, 2, 3, 8, 85, 2550])
def test_tree_sum_is_a_fixed_pairwise_tree(n):
    from repro_torch.sweep.metrics import _tree_sum
    rng = np.random.default_rng(n)
    x = rng.uniform(0.0, 1e4, (3, n)).astype(np.float32)
    x[rng.random((3, n)) < 0.3] = 0.0

    def tree(row):  # the nonzero terms in order, one float32 add at a time
        vals = [np.float32(v) for v in row if v != 0]
        vals += [np.float32(0.0)] * ((1 << max(0, (n - 1).bit_length()))
                                     - len(vals))
        while len(vals) > 1:
            half = len(vals) // 2
            vals = [np.float32(a + b) for a, b in zip(vals[:half],
                                                       vals[half:])]
        return vals[0]

    got = _tree_sum(torch.from_numpy(x)).numpy()
    assert [float(v) for v in got] == [float(tree(r)) for r in x]
    # zeros anywhere, and more columns, leave every sum as it was
    spread = np.zeros((3, 3 * n + 5), np.float32)
    spread[:, 1::3][:, :n] = x
    assert [float(v) for v in _tree_sum(torch.from_numpy(spread))] == \
        [float(v) for v in got]


def test_metrics_do_not_move_with_the_lane_position(monolithic):
    """A lane's metrics are the same bits wherever it sits in the batch
    (the float sums are a fixed tree, not a layout-dependent reduction)."""
    structure, batch, mono = monolithic["greedy-fcfs-sjf"]
    perm = [3, 0, 4, 2, 1]
    rows = {k: (v[perm] if isinstance(v, np.ndarray) and v.ndim >= 1
                and v.shape[0] == batch.n_lanes else v)
            for k, v in mono.items()}
    win = (np.zeros(batch.n_lanes), np.full(batch.n_lanes, 1e9))
    caps = batch.capacity.numpy()
    base = backend_torch.chunk_metrics(
        shard.ChunkResult(0, batch.n_lanes, mono, 0.0, batch.n_lanes, 1),
        batch, *win, caps)
    moved = backend_torch.chunk_metrics(
        shard.ChunkResult(0, batch.n_lanes, rows, 0.0, batch.n_lanes, 1),
        take_lanes_at(batch, perm), *win, caps)
    assert json.dumps([base[i] for i in perm]) == json.dumps(moved)


def take_lanes_at(batch, rows):
    idx = torch.tensor(rows)
    return type(batch)(*[getattr(batch, name).index_select(0, idx)
                         for name in batch._fields])
