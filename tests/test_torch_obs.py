"""The port's flight recorder (``repro_torch.obs``) and its wiring.

The recorder is a copy of ``repro.obs``; these tests hold the copy to the
original by its outputs (heartbeat lines, ETA text, trace files), and
check the pipeline's contract: tracing never changes a cell, the Chrome
trace and the JSONL log have the reference's schema (``tests/test_obs.py``)
on the same run, and a run on the torch engine records the spans a user
reads (``experiment.fingerprint``, ``trace.generate``, ``sweep.execute``).
"""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.experiments import __main__ as jmain  # noqa: E402
from repro.experiments import backend_des as jdes  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.experiments import ExperimentSpec, run_experiment  # noqa
from repro_torch.experiments import __main__ as tmain  # noqa: E402
from repro_torch.experiments import backend_des as tdes  # noqa: E402

TINY = dict(workloads=("haswell",), scale=0.003, seeds=2,
            proportions=(0.0, 1.0), strategies=("min", "avg"))
ARGV = ["--workload", "haswell", "--scale", "0.003", "--seeds", "2",
        "--proportions", "0.0", "1.0", "--strategies", "min", "avg"]
EVENT_KEYS = {"name", "ph", "ts", "dur", "pid", "tid", "args"}


@pytest.fixture(autouse=True)
def _clean_tracers():
    """Both packages' default tracers start and end disabled and empty."""
    for mod in (obs, jobs):
        mod.get_tracer().reset()
        mod.configure(enabled=False)
    yield
    for mod in (obs, jobs):
        mod.get_tracer().reset()
        mod.configure(enabled=False)


def test_disabled_span_is_a_shared_noop():
    assert obs.span("a") is obs.span("b")
    with obs.span("outer"):
        obs.counter("hits")
    assert obs.get_tracer().events() == []
    assert obs.get_tracer().counters.snapshot() == {"counters": {},
                                                    "gauges": {}}


def test_spans_nest_and_count_like_the_reference():
    for mod in (obs, jobs):
        mod.configure(enabled=True)
        with mod.span("outer", n=1):
            with mod.span("inner"):
                mod.counter("hits", 2)
            mod.gauge("depth", 7.0)
    t, j = obs.get_tracer(), jobs.get_tracer()
    shape = [(e["name"], e["args"]) for e in t.events()]
    assert shape == [(e["name"], e["args"]) for e in j.events()]
    assert shape[0] == ("inner", {"parent": "outer"})
    assert t.counters.snapshot() == j.counters.snapshot()


def test_heartbeat_and_eta_text_equal_the_reference():
    lines = []
    for mod in (obs, jobs):
        now = [0.0]
        out = io.StringIO()
        hb = mod.Heartbeat(4, label="t", unit="batch", stream=out,
                           clock=lambda: now[0])
        for t, flushed in ((10.0, 3), (20.0, 2), (95.0, 0)):
            now[0] = t
            hb.tick(cells_flushed=flushed, extra="greedy")
        lines.append(out.getvalue())
    assert lines[0] == lines[1] and "batch 2/4 · cells 5" in lines[0]
    for args in ((0, 10, 5.0), (2, 10, 20.0), (10, 10, 20.0)):
        a, b = obs.eta_seconds(*args), jobs.eta_seconds(*args)
        assert a == b or (np.isnan(a) and np.isnan(b))
    for s in (float("nan"), 12, 247, 3720):
        assert obs.format_duration(s) == jobs.format_duration(s)


def _store_cells(root):
    return {p.name: json.loads(p.read_text())
            for p in sorted(root.rglob("*.json"))}


@pytest.mark.parametrize("engine", ["torch", "des"])
def test_tracing_on_writes_the_same_cells_as_off(engine, tmp_path):
    spec = ExperimentSpec(**TINY, engine=engine)
    opts = {"device": "cpu"} if engine == "torch" else None
    off = run_experiment(spec, cache_dir=tmp_path / "off",
                         backend_options=opts, verbose=False)
    obs.configure(enabled=True)
    on = run_experiment(spec, cache_dir=tmp_path / "on",
                        backend_options=opts, verbose=False)
    cells = _store_cells(tmp_path / "off")
    assert len(cells) == len(spec.cells())
    assert cells == _store_cells(tmp_path / "on")
    for label, value in off["haswell"].items():
        if not label.startswith("_"):
            assert json.dumps(value) == json.dumps(on["haswell"][label])
    names = {e["name"] for e in obs.get_tracer().events()}
    assert names >= {"experiment.fingerprint", "experiment.store_read"}
    # the DES memoizes a realized trace per process, the torch engine not
    assert names >= ({"trace.generate", "scenario.apply", "sweep.execute"}
                     if engine == "torch" else {"des.cell"})


def _trace_files(main, tmp_path, argv):
    trace, jsonl = tmp_path / "t.json", tmp_path / "t.jsonl"
    assert main(argv + ["--cache-dir", str(tmp_path / "store"), "--trace",
                        str(trace), "--trace-jsonl", str(jsonl)]) == 0
    events = json.loads(trace.read_text())
    lines = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    return events, lines


def test_trace_schemas_equal_the_reference_on_the_same_run(tmp_path,
                                                           capsys):
    argv = ARGV + ["--engine", "des"]
    for backend in (jdes, tdes):  # both realize the trace in this run
        backend._WORKLOAD_MEMO.clear()
    ref = _trace_files(jmain.main, tmp_path / "ref", argv)
    got = _trace_files(tmain.main, tmp_path / "port", argv)
    capsys.readouterr()
    for events, lines in (ref, got):
        assert isinstance(events, list) and events
        for ev in events:
            assert set(ev) == EVENT_KEYS and ev["ph"] == "X"
            assert ev["ts"] >= 0 and ev["dur"] >= 0
            assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert [ln["kind"] for ln in lines] == ["span"] * len(events) + [
            "counters"]
    # the same pipeline records the same spans, arguments and counters
    assert [(e["name"], e["args"]) for e in ref[0]] == [
        (e["name"], e["args"]) for e in got[0]]
    assert ref[1][-1] == got[1][-1]


def test_torch_run_trace_holds_the_pipeline_spans(tmp_path, capsys):
    events, lines = _trace_files(tmain.main, tmp_path, ARGV + [
        "--device", "cpu", "--progress"])
    out = capsys.readouterr().out
    assert "[progress:haswell] batch 2/2" in out
    by_name = {}
    for ev in events:
        assert set(ev) == EVENT_KEYS
        by_name.setdefault(ev["name"], []).append(ev)
    assert set(by_name) >= {"experiment.fingerprint", "trace.generate",
                            "scenario.apply", "sweep.execute"}
    assert [e["args"]["structure"] for e in by_name["sweep.execute"]] == [
        "greedy", "balanced"]
    counters = lines[-1]["counters"]
    assert counters["store.miss"] == counters["store.put"] == 5
    assert "sweep.escalations" in counters
