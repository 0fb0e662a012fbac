"""The port's experiment layer against the reference's ``run_experiment``.

``repro_torch.experiments`` is spec -> cell store -> backend -> aggregate
-> artifact, as ``repro.experiments`` is.  On the CPU, at small scales:

* ``engine="des"`` equals the reference's ``engine="des"`` dict for dict,
  ``_meta.spec_key`` included (the port's DES is a byte copy), except the
  wall-clock fields under ``_engine``;
* ``engine="torch"`` (``device="cpu"``) against the reference's
  ``engine="jax"``: counts, medians and ``sched_*`` exact, means and
  utilization within ``rtol=1e-5`` (the tolerance of
  ``test_torch_backend.py``: float32 sums reduced in another order), and
  the seeded crosscheck picks the same cells with the same verdicts;
* resume from the store, the stale- and incomplete-artifact guards, the
  renderers and the CLI's gates.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.experiments as jexp  # noqa: E402
import repro_torch.experiments as texp  # noqa: E402
from repro_torch.core import DONE  # noqa: E402
from repro_torch.experiments import __main__ as tmain  # noqa: E402
from repro_torch.experiments import backend_torch  # noqa: E402
from repro_torch.sweep.cache import SweepCache  # noqa: E402

DES_SPECS = {
    "paper": dict(workloads=("haswell",), scale=0.003, seeds=2),
    "registry": dict(workloads=("theta",), scale=0.01, seeds=2,
                     proportions=(0.0, 0.5, 1.0),
                     strategies=("min", "avg", "pref_common_pool",
                                 "steal_agreement", "rigid_sjf"),
                     scenario=dict(queue_order="sjf", job_classes=dict(
                         rigid=0.1, on_demand=0.1, malleable=0.8))),
}
TORCH_KW = dict(workloads=("haswell",), scale=0.01, seeds=2,
                proportions=(0.0, 0.5, 1.0))
CROSSCHECK = dict(crosscheck=3, crosscheck_seed=5)
EXACT = ("n_jobs", "n_malleable", "wait_p50", "turnaround_p50",
         "expand_per_job", "shrink_per_job", "unfinished",
         "sched_backfill_starts", "sched_shrink_events",
         "sched_expand_events", "sched_invocations")
CLOSE = ("wait_mean", "makespan_mean", "turnaround_mean", "utilization")
RTOL = 1e-5
WALL_KEYS = ("sim_seconds",)


def _same(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def _metrics_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert _same(a[k], b[k]), (k, a[k], b[k])


def _engine_without_walls(info):
    out = {k: v for k, v in info.items() if k not in WALL_KEYS}
    if "cells" in out:
        out["cells"] = sorted(
            (c["workload"], c["strategy"], c["proportion"], c["seed"])
            for c in out["cells"])
    return out


@pytest.mark.parametrize("case", sorted(DES_SPECS))
def test_des_engine_equals_the_reference(case):
    kw = dict(DES_SPECS[case], engine="des")
    ref = jexp.run_experiment(jexp.ExperimentSpec(**kw), verbose=False)
    got = texp.run_experiment(texp.ExperimentSpec(**kw), verbose=False)
    assert ref.keys() == got.keys()
    for name in ref:
        r, g = ref[name], got[name]
        assert r.keys() == g.keys()
        for label in r:
            if not label.startswith("_"):
                _metrics_equal(r[label], g[label])
        assert r["_meta"] == g["_meta"]  # spec_key included
        assert _engine_without_walls(r["_engine"]) == \
            _engine_without_walls(g["_engine"])


def test_des_cells_are_shared_with_the_reference_store(tmp_path):
    kw = dict(DES_SPECS["paper"], engine="des")
    jexp.run_experiment(jexp.ExperimentSpec(**kw), cache_dir=tmp_path,
                        verbose=False)
    spec = texp.ExperimentSpec(**kw)
    info = texp.run_experiment(spec, cache_dir=tmp_path,
                               verbose=False)["haswell"]["_engine"]
    assert info["cache_hits"] == len(spec.cells())
    assert info["computed_cells"] == 0


@pytest.fixture(scope="module")
def torch_vs_jax(tmp_path_factory):
    tstore = tmp_path_factory.mktemp("torch_store")
    ref = jexp.run_experiment(
        jexp.ExperimentSpec(**TORCH_KW, engine="jax"),
        cache_dir=tmp_path_factory.mktemp("jax_store"), verbose=False,
        **CROSSCHECK)["haswell"]
    spec = texp.ExperimentSpec(**TORCH_KW)
    got = texp.run_experiment(spec, cache_dir=tstore,
                              backend_options={"device": "cpu"},
                              verbose=False, **CROSSCHECK)["haswell"]
    return spec, tstore, ref, got


def _labels(results):
    return [k for k in results if not k.startswith("_")]


@pytest.mark.parametrize("key", EXACT)
def test_torch_engine_exact_metrics_equal_jax(torch_vs_jax, key):
    _, _, ref, got = torch_vs_jax
    assert _labels(ref) == _labels(got)
    for label in _labels(ref):
        # "rigid" and "<strategy>@0" hold one run's metrics, the rest
        # the mean and IQR over seeds
        keys = [key] if key in ref[label] else [f"{key}_mean",
                                                f"{key}_iqr"]
        for k in keys:
            assert _same(ref[label][k], got[label][k]), (label, k)


@pytest.mark.parametrize("key", CLOSE)
def test_torch_engine_means_close_to_jax(torch_vs_jax, key):
    _, _, ref, got = torch_vs_jax
    for label in _labels(ref):
        if key in ref[label]:
            np.testing.assert_allclose(got[label][key], ref[label][key],
                                       rtol=RTOL)
            continue
        mean = ref[label][f"{key}_mean"]
        np.testing.assert_allclose(got[label][f"{key}_mean"], mean,
                                   rtol=RTOL)
        # a seed value off by RTOL * |v| moves the IQR by at most that
        iqr = ref[label][f"{key}_iqr"]
        np.testing.assert_allclose(got[label][f"{key}_iqr"], iqr, rtol=RTOL,
                                   atol=RTOL * (abs(mean) + iqr))


def test_torch_engine_meta_and_counts(torch_vs_jax):
    spec, _, ref, got = torch_vs_jax
    assert got["_meta"]["engine"] == "torch"
    assert got["_meta"]["spec_key"] == spec.for_workload("haswell").key()
    assert got["_meta"]["spec_key"] != ref["_meta"]["spec_key"]
    strip = {"engine", "engine_version"}
    assert {k: v for k, v in got["_meta"]["spec"].items()
            if k not in strip} == {k: v for k, v in
                                   ref["_meta"]["spec"].items()
                                   if k not in strip}
    for info in (got["_engine"], ref["_engine"]):
        assert info["computed_cells"] == len(spec.cells())
        assert info["incomplete_cells_total"] == 0
    assert got["_engine"]["missed_cells"] == ref["_engine"]["missed_cells"]
    for key in ("greedy_lanes", "balanced_lanes", "sched_steps"):
        assert got["_engine"][key] == ref["_engine"][key], key


def test_crosscheck_records_equal_the_reference(torch_vs_jax):
    _, _, ref, got = torch_vs_jax
    r, g = ref["_crosscheck"], got["_crosscheck"]
    for key in ("rng_seed", "requested", "store_hits",
                "all_within_tolerance"):
        assert r[key] == g[key], key
    assert [c["cell"] for c in r["cells"]] == [c["cell"] for c in g["cells"]]
    assert len(g["cells"]) == CROSSCHECK["crosscheck"]
    for rc, gc in zip(r["cells"], g["cells"]):
        assert rc["within_tolerance"] == gc["within_tolerance"]
        assert rc["deltas"].keys() == gc["deltas"].keys()
        for key, rd in rc["deltas"].items():
            gd = gc["deltas"][key]
            assert rd["des"] == gd["des"] and rd["within"] == gd["within"]
            np.testing.assert_allclose(gd["torch"], rd["jax"], rtol=RTOL)


def test_second_run_is_all_store_hits(torch_vs_jax):
    spec, store, _, first = torch_vs_jax
    again = texp.run_experiment(spec, cache_dir=store,
                                backend_options={"device": "cpu"},
                                verbose=False, **CROSSCHECK)["haswell"]
    info = again["_engine"]
    assert info["cache_hits"] == len(spec.cells())
    assert info["computed_cells"] == 0 and info["missed_cells"] == []
    assert again["_crosscheck"]["store_hits"] == CROSSCHECK["crosscheck"]
    for label in _labels(first):
        _metrics_equal(first[label], again[label])


def test_stale_and_incomplete_artifacts_are_refused(torch_vs_jax,
                                                    tmp_path):
    spec, _, _, results = torch_vs_jax
    path = tmp_path / "haswell.json"
    texp.write_artifact(path, results, texp.best_improvements(results))
    assert texp.load_artifact_results(path, spec, "haswell") == json.loads(
        path.read_text())["results"]
    for stale in (dataclasses.replace(spec, scale=0.02),
                  dataclasses.replace(spec, seeds=3),
                  dataclasses.replace(spec, engine="des"),
                  dataclasses.replace(spec, scenario=texp.ScenarioConfig(
                      walltime_factor=0.0))):
        assert texp.load_artifact_results(path, stale, "haswell") is None
    assert texp.load_artifact_results(tmp_path / "none.json", spec,
                                      "haswell") is None
    payload = json.loads(path.read_text())
    payload["results"]["_engine"]["incomplete_cells"] = 2
    path.write_text(json.dumps(payload))
    assert texp.load_artifact_results(path, spec, "haswell") is None


def test_incomplete_cells_are_never_stored(monkeypatch, tmp_path):
    real = backend_torch.simulate_lanes

    def cut_first_lane(batch, cfg, **kw):
        res = real(batch, cfg, **kw)
        res["state"] = np.array(res["state"])
        res["state"][0, -1] = 2  # as if lane 0 hit the step budget
        res["finished"] = bool(np.all(res["state"] == DONE))
        return res

    monkeypatch.setattr(backend_torch, "simulate_lanes", cut_first_lane)
    spec = texp.ExperimentSpec(**dict(TORCH_KW, scale=0.003, seeds=1,
                                      strategies=("min",)))
    results = texp.run_experiment(spec, cache_dir=tmp_path,
                                  backend_options={"device": "cpu"},
                                  verbose=False)["haswell"]
    info = results["_engine"]
    assert info["incomplete_cells_total"] == info["incomplete_cells"] == 1
    assert info["computed_cells"] == len(spec.cells()) - 1
    store = SweepCache(tmp_path)
    stored = sum(store.get(spec.cell_fingerprint("haswell", c)) is not None
                 for c in spec.cells())
    assert stored == info["computed_cells"]
    path = texp.write_artifact(tmp_path / "cut.json", results)
    assert texp.load_artifact_results(path, spec, "haswell") is None


def test_crosscheck_is_refused_on_the_des_engine():
    spec = texp.ExperimentSpec(**DES_SPECS["paper"], engine="des")
    with pytest.raises(ValueError, match="torch engine"):
        texp.run_experiment(spec, crosscheck=1, verbose=False)


def test_renderers_give_the_reference_text():
    kw = dict(DES_SPECS["paper"], engine="des", proportions=(0.0, 0.5, 1.0))
    values = (1, 256)
    ref = jexp.sweep_scenario_axis(jexp.ExperimentSpec(**kw),
                                   "backfill_depth", values, verbose=False)
    got = texp.sweep_scenario_axis(texp.ExperimentSpec(**kw),
                                   "backfill_depth", values, verbose=False)
    assert ref.keys() == got.keys()
    res = {v: r["haswell"] for v, r in got.items()}
    jres = {v: r["haswell"] for v, r in ref.items()}
    assert texp.render_scenario_table("backfill_depth", res) == \
        jexp.render_scenario_table("backfill_depth", jres)
    for v in values:
        assert texp.render_sweep_table(res[float(v)]) == \
            jexp.render_sweep_table(jres[float(v)])
        assert texp.best_improvements(res[float(v)]) == \
            jexp.best_improvements(jres[float(v)])
    for axis, value in (("on_demand_frac", 0.3), ("queue_order", "sjf"),
                        ("walltime_factor", 2)):
        assert dataclasses.asdict(texp.scenario_variant(
            texp.ScenarioConfig(), axis, value)) == dataclasses.asdict(
            jexp.scenario_variant(jexp.ScenarioConfig(), axis, value))


# ---------------------------------------------------------------- the CLI
CLI = ["--workload", "haswell", "--scale", "0.003", "--seeds", "1",
       "--proportions", "0.0", "1.0", "--strategies", "min", "avg"]


def test_cli_expect_cached_and_crosscheck_gate(tmp_path, capsys):
    argv = CLI + ["--device", "cpu", "--cache-dir", str(tmp_path / "s"),
                  "--crosscheck", "1", "--require-crosscheck",
                  "--expect-cached", "--out", str(tmp_path / "h.json")]
    assert tmain.main(argv) == 1  # first run computes every cell
    out = capsys.readouterr().out
    assert "FAIL: expected a 100% store hit but computed 3 cells" in out
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert "cache_hits=3 computed=0 incomplete=0" in out
    payload = json.loads((tmp_path / "h.json").read_text())
    assert payload["results"]["_crosscheck"]["all_within_tolerance"]
    assert set(payload["summary"]) >= {"turnaround", "utilization"}


@pytest.mark.parametrize("extra,message", [
    (["--require-crosscheck"], "--require-crosscheck needs --crosscheck"),
    (["--crosscheck", "2", "--engine", "des"], "--crosscheck needs --engine "
                                               "torch"),
    (["--expect-cached"], "--expect-cached needs --cache-dir"),
    (["--compare-scenarios", "backfill_depth"], "go together")])
def test_cli_refuses_flag_combinations(extra, message, capsys):
    with pytest.raises(SystemExit) as err:
        tmain.main(CLI + extra)
    assert err.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_des_engine_with_workers_and_two_workloads(tmp_path, capsys):
    out = tmp_path / "both.json"
    argv = ["--workload", "haswell", "theta", "--scale", "0.003",
            "--seeds", "1", "--proportions", "0.0", "1.0", "--strategies",
            "min", "--engine", "des", "--workers", "2", "--cache-dir",
            str(tmp_path / "s"), "--out", str(out)]
    assert tmain.main(argv) == 0
    assert "engine=des" in capsys.readouterr().out
    results = json.loads(out.read_text())["results"]
    assert set(results) == {"haswell", "theta"}
    assert all(r["_meta"]["engine"] == "des" for r in results.values())
    serial = texp.run_experiment(texp.ExperimentSpec(
        workloads=("haswell", "theta"), scale=0.003, seeds=1,
        proportions=(0.0, 1.0), strategies=("min",), engine="des"),
        verbose=False)
    for name in results:
        for label in _labels(serial[name]):
            _metrics_equal(json.loads(json.dumps(serial[name][label])),
                           results[name][label])


def test_cli_compare_scenarios_writes_the_tables(tmp_path, capsys):
    out = tmp_path / "cmp.json"
    assert tmain.main(CLI + ["--device", "cpu", "--compare-scenarios",
                             "queue_order", "--scenario-values", "fcfs",
                             "sjf", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "Scenario sensitivity: haswell x queue_order" in text
    payload = json.loads(out.read_text())
    assert payload["axis"] == "queue_order"
    assert set(payload["results"]) == {"fcfs", "sjf"}
    assert payload["tables"]["haswell"] in text
