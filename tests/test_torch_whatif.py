"""The port's what-if query service (``repro_torch.serve``) against the
reference's (``repro.serve``).

* **Coalescer mechanics**, the reference's cases under a stepped fake
  clock and recording executors: a full batch dispatches at once, max-wait
  fires with a partial batch, overflow spills, a mid-batch failure poisons
  only its query, an unresolved query is rejected, in-flight duplicates
  attach, the queue is bounded, close cancels or drains.
* **Queries**: parsing, validation, cell normalisation, ``to_dict`` and
  the scenario overrides equal the reference's; ``sample_queries`` draws
  the reference's population.
* **Parity**: DES answers land in the store under the reference's keys,
  dict for dict; ``torch`` answers (CPU, ``bisect``) equal the port's
  ``run_experiment`` cells bit for bit in any order and batch width, and
  the reference's ``jax`` answers with the tolerance of
  ``test_torch_experiments.py`` (counts, medians and ``sched_*`` exact,
  means and utilization within 1e-5: float32 sums reduced in another
  order; every per-job outcome is bit-equal, ``test_torch_shard.py``).
* **Entry points**: a CLI storm then its ``--expect-hits`` rerun, one HTTP
  round trip on a free port, and no run without a card unless asked.
"""
import dataclasses
import json
import math
import pathlib
import random
import threading
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import repro.serve.whatif as jwhatif  # noqa: E402
from repro.experiments.spec import ExperimentSpec as JSpec  # noqa: E402
from repro_torch.experiments.run import run_experiment  # noqa: E402
from repro_torch.experiments.spec import ExperimentSpec  # noqa: E402
from repro_torch.serve import __main__ as smain  # noqa: E402
from repro_torch.serve.whatif import (EngineClosedError,  # noqa: E402
                                      QueryFailedError, QueueFullError,
                                      WhatIfEngine, WhatIfQuery,
                                      sample_queries)
from repro_torch.sweep.cache import SweepCache  # noqa: E402

BASE = dict(workloads=("haswell",), scale=0.003, seeds=2, engine="des")
CPU = {"device": "cpu"}
EXACT = ("n_jobs", "n_malleable", "wait_p50", "turnaround_p50",
         "expand_per_job", "shrink_per_job", "unfinished",
         "sched_backfill_starts", "sched_shrink_events",
         "sched_expand_events", "sched_invocations")
RTOL = 1e-5


def base_spec(**over) -> ExperimentSpec:
    return ExperimentSpec(**{**BASE, **over})


# ----------------------------------------------------------------------
# harness: fake clock + fake executors
class FakeClock:
    """Stepped fake time; ``wait`` keeps a short real backstop so the
    dispatcher's loop stays live, but admission keys on ``now()``."""

    def __init__(self) -> None:
        self._t = 0.0
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def wait(self, cv, timeout) -> bool:
        return cv.wait(0.05)

    def advance(self, dt: float, engine: WhatIfEngine) -> None:
        with self._lock:
            self._t += dt
        engine.kick()


class RecordingExecutor:
    """Resolves every pending with a synthetic metric; records batches."""

    def __init__(self) -> None:
        self.batches = []
        self.started = threading.Event()

    def __call__(self, batch) -> None:
        self.batches.append([p.query for p in batch])
        self.started.set()
        for p in batch:
            p.resolve({"cell_tag": float(hash(p.key) % 1000)})

    @property
    def widths(self):
        return [len(b) for b in self.batches]


class GatedExecutor(RecordingExecutor):
    """Blocks mid-batch until the test opens the gate (in-flight dedup)."""

    def __init__(self) -> None:
        super().__init__()
        self.gate = threading.Event()

    def __call__(self, batch) -> None:
        self.started.set()
        assert self.gate.wait(10), "test forgot to open the gate"
        super().__call__(batch)


QA = WhatIfQuery(strategy="min", proportion=0.5, seed=0)
QB = WhatIfQuery(strategy="avg", proportion=0.5, seed=0)
QC = WhatIfQuery(strategy="min", proportion=1.0, seed=1)


def make_engine(executor, *, clock=None, start=False, **over):
    kw = dict(max_batch=16, max_wait_s=10.0)
    kw.update(over)
    return WhatIfEngine(base_spec(), cache_dir=None, executor=executor,
                        clock=clock, start=start, **kw)


# ----------------------------------------------------------------------
# coalescer mechanics (deterministic, no real sleeps)
def test_full_batch_dispatches_without_waiting():
    ex = RecordingExecutor()
    eng = make_engine(ex, clock=FakeClock(), max_batch=3)
    futs = [eng.submit(q) for q in (QA, QB, QC)]
    eng.start()
    results = [f.result(timeout=10) for f in futs]
    assert ex.widths == [3]
    assert [q.to_dict() for q in ex.batches[0]] == \
        [q.to_dict() for q in (QA, QB, QC)]
    assert all(isinstance(r["cell_tag"], float) for r in results)
    stats = eng.stats()
    assert stats["misses"] == 3 and stats["batches"] == 1
    assert stats["max_batch_width"] == 3
    eng.close()


def test_max_wait_fires_with_partial_batch():
    ex = RecordingExecutor()
    clock = FakeClock()
    eng = make_engine(ex, clock=clock, max_batch=16, max_wait_s=10.0,
                      start=True)
    fa = eng.submit(QA)
    fb = eng.submit(QB)
    assert not ex.started.wait(0.3)  # fake time stands still: held open
    assert ex.batches == []
    clock.advance(10.1, eng)
    assert ex.started.wait(5)
    assert fa.result(timeout=10) and fb.result(timeout=10)
    assert ex.widths == [2]
    eng.close()


def test_overflow_spills_into_next_batch():
    ex = RecordingExecutor()
    eng = make_engine(ex, clock=FakeClock(), max_batch=2, max_wait_s=0.0)
    futs = [eng.submit(q) for q in (QA, QB, QC)]
    eng.start()
    for f in futs:
        f.result(timeout=10)
    assert ex.widths == [2, 1]
    eng.close()


def test_midbatch_failure_poisons_only_the_failing_query():
    class MixedExecutor(RecordingExecutor):
        def __call__(self, batch):
            self.batches.append([p.query for p in batch])
            batch[0].resolve({"ok": 1.0})
            batch[1].reject(RuntimeError("lane budget"))
            raise RuntimeError("executor blew up after item 2")

    ex = MixedExecutor()
    clock = FakeClock()
    eng = make_engine(ex, clock=clock, max_batch=3)
    fa, fb, fc = (eng.submit(q) for q in (QA, QB, QC))
    eng.start()
    assert fa.result(timeout=10) == {"ok": 1.0}
    with pytest.raises(QueryFailedError, match="lane budget"):
        fb.result(timeout=10)
    with pytest.raises(QueryFailedError, match="blew up"):
        fc.result(timeout=10)
    # a rejected query is not memoized (a resubmit retries it), and the
    # dispatcher survived to serve the retry
    ex.__class__ = RecordingExecutor
    fb2 = eng.submit(QB)
    clock.advance(10.1, eng)
    assert fb2.result(timeout=10)["cell_tag"] >= 0
    assert eng.submit(QA).result(timeout=10) == {"ok": 1.0}
    stats = eng.stats()
    assert stats["failed"] == 2 and stats["computed"] == 2
    assert stats["memo_hits"] == 1
    eng.close()


def test_unresolved_items_are_rejected_not_hung():
    class ForgetfulExecutor(RecordingExecutor):
        def __call__(self, batch):
            batch[0].resolve({"ok": 1.0})

    eng = make_engine(ForgetfulExecutor(), clock=FakeClock(), max_batch=2)
    fa, fb = eng.submit(QA), eng.submit(QB)
    eng.start()
    assert fa.result(timeout=10) == {"ok": 1.0}
    with pytest.raises(QueryFailedError, match="without resolving"):
        fb.result(timeout=10)
    eng.close()


def test_identical_inflight_queries_deduplicate():
    ex = GatedExecutor()
    eng = make_engine(ex, max_batch=1, max_wait_s=0.0)
    f1 = eng.submit(QA)
    f2 = eng.submit(QA)          # attaches to the queued pending
    eng.start()
    assert ex.started.wait(5)    # the batch is executing, gate closed
    f3 = eng.submit(QA)          # attaches to the executing pending
    ex.gate.set()
    r1, r2, r3 = (f.result(timeout=10) for f in (f1, f2, f3))
    assert r1 == r2 == r3
    stats = eng.stats()
    assert stats["dedup"] == 2 and stats["computed"] == 1
    assert ex.widths == [1]
    eng.close()


def test_bounded_queue_rejects_overflow():
    eng = make_engine(RecordingExecutor(), max_queue=2)
    eng.submit(QA)
    eng.submit(QB)
    with pytest.raises(QueueFullError):
        eng.submit(QC)
    eng.start()
    eng.close()


def test_close_cancels_pending_and_rejects_new_queries():
    eng = make_engine(RecordingExecutor())
    fut = eng.submit(QA)
    eng.close(cancel_pending=True)
    with pytest.raises(QueryFailedError):
        fut.result(timeout=10)
    with pytest.raises(EngineClosedError):
        eng.submit(QB)


def test_close_drains_by_default():
    ex = RecordingExecutor()
    eng = make_engine(ex, max_batch=4, max_wait_s=0.0)
    futs = [eng.submit(q) for q in (QA, QB, QC)]
    eng.start()
    eng.close()
    for f in futs:
        assert f.result(timeout=10)


# ----------------------------------------------------------------------
# queries against the reference's
QUERY_TEXTS = [
    "strategy=avg,proportion=0.5,seed=1,backfill_depth=4,queue_order=sjf",
    "strategy=rigid_sjf,proportion=0.7",
    "strategy=min,proportion=0,seed=1",
    "strategy=keeppref,proportion=1,rigid_frac=0.2,arrival_compression=2.0",
    "strategy=pref_common_pool,proportion=0.25,on_demand_frac=0.1,"
    "class_seed=3,walltime_factor=0.5,walltime_jitter=0.2",
    "strategy=steal_agreement,workload=knl,proportion=0.5",
]


@pytest.mark.parametrize("text", QUERY_TEXTS)
def test_queries_equal_the_reference(text):
    got, ref = WhatIfQuery.parse(text), jwhatif.WhatIfQuery.parse(text)
    assert got.to_dict() == ref.to_dict()
    assert WhatIfQuery.from_dict(got.to_dict()) == got
    assert got.cell() == ref.cell()
    spec = got.spec_for(base_spec())
    jspec = ref.spec_for(JSpec(**BASE))
    # a DES cell's store key is the reference's
    assert spec.cell_fingerprint(spec.workloads[0], got.cell()) == \
        jspec.cell_fingerprint(jspec.workloads[0], ref.cell())


@pytest.mark.parametrize("bad,match", [
    ({"strategy": "nope"}, "unknown strategy"),
    ({"proportion": 1.5}, "proportion"),
    ({"workload": "nope"}, "unknown workload"),
    ({"queue_order": "lifo"}, "queue_order"),
    ({"strategy": "min", "bogus": 1}, "unknown query field")])
def test_query_validation_equals_the_reference(bad, match):
    with pytest.raises(ValueError, match=match) as ref:
        jwhatif.WhatIfQuery.from_dict(bad)
    with pytest.raises(ValueError) as got:
        WhatIfQuery.from_dict(bad)
    assert str(got.value) == str(ref.value)


def test_spec_overrides_and_sample_queries_equal_the_reference():
    base = base_spec()
    spec = WhatIfQuery(strategy="min", backfill_depth=4, queue_order="sjf",
                       rigid_frac=0.2, arrival_compression=2.0
                       ).spec_for(base)
    assert spec.scenario.backfill_depth == 4
    assert spec.scenario.queue_order == "sjf"
    assert spec.scenario.job_classes.rigid == 0.2
    assert spec.scenario.job_classes.malleable == pytest.approx(0.8)
    assert base.scenario.backfill_depth != 4
    assert WhatIfQuery(strategy="min").spec_for(base).scenario \
        is base.scenario
    for seed, kw in ((3, {}), (4, dict(depths=(None, 4), orders=(None,
                                                                  "sjf")))):
        got = sample_queries(seed, 12, workloads=("haswell", "knl"),
                             seeds=2, **kw)
        ref = jwhatif.sample_queries(seed, 12, workloads=("haswell", "knl"),
                                     seeds=2, **kw)
        assert [q.to_dict() for q in got] == [q.to_dict() for q in ref]


# ----------------------------------------------------------------------
# parity on real engines (tiny workloads)
def _cells_for(spec):
    out = []
    for strat in spec.strategies:
        for prop in spec.proportions:
            for seed in range(spec.seeds):
                out.append(WhatIfQuery(strategy=strat, proportion=prop,
                                       seed=seed))
    return out


def _storm(engine, queries):
    futs = [engine.submit(q) for q in queries]
    engine.start()
    out = [f.result(timeout=600) for f in futs]
    stats = engine.stats()
    engine.close()
    return out, stats


def _store_files(root):
    return {p.name: json.loads(p.read_text())
            for p in pathlib.Path(root).rglob("*.json")}


def test_des_answers_land_under_the_reference_keys(tmp_path):
    kw = dict(BASE, proportions=(0.0, 0.5), strategies=("min", "avg"))
    queries = _cells_for(ExperimentSpec(**kw))
    got, stats = _storm(WhatIfEngine(
        ExperimentSpec(**kw), cache_dir=str(tmp_path / "port"), max_batch=8,
        max_wait_s=0.05, start=False), queries)
    ref, _ = _storm(jwhatif.WhatIfEngine(
        JSpec(**kw), cache_dir=str(tmp_path / "ref"), max_batch=8,
        max_wait_s=0.05, start=False),
        [jwhatif.WhatIfQuery(**q.to_dict()) for q in queries])
    assert got == ref
    port, reference = _store_files(tmp_path / "port"), \
        _store_files(tmp_path / "ref")
    assert port == reference and len(port) == stats["computed"]
    assert stats["dedup"] == len(queries) - stats["computed"]


def _same(a, b):
    return a == b or (math.isnan(a) and math.isnan(b))


TORCH_KW = dict(workloads=("haswell",), scale=0.003, seeds=1,
                proportions=(0.0, 0.5), strategies=("min", "avg"),
                engine="torch")


@pytest.fixture(scope="module")
def direct_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("direct")
    run_experiment(ExperimentSpec(**TORCH_KW), cache_dir=str(root),
                   backend_options=CPU, verbose=False)
    return SweepCache(root)


def test_torch_answers_equal_run_experiment_and_the_reference(
        tmp_path, direct_store):
    """Greedy and balanced structures in one storm, plus SJF and depth
    overrides: served cells equal the port's run_experiment cells bit for
    bit under the same keys, and the reference's jax answers."""
    spec = ExperimentSpec(**TORCH_KW)
    queries = _cells_for(spec)
    extra = [WhatIfQuery(strategy="keeppref", proportion=0.5,
                         queue_order="sjf"),
             WhatIfQuery(strategy="pref", proportion=1.0, backfill_depth=4)]
    got, stats = _storm(WhatIfEngine(
        spec, cache_dir=str(tmp_path / "served"), max_batch=8,
        max_wait_s=0.05, start=False, backend_options=CPU),
        queries + extra)
    assert stats["batches"] == 1 and stats["failed"] == 0
    served = SweepCache(tmp_path / "served")
    for q, m in zip(queries, got):
        fp = q.spec_for(spec).cell_fingerprint("haswell", q.cell())
        assert direct_store.get(fp) == m == served.get(fp), q
    for i, (q, m) in enumerate(zip(extra, got[len(queries):])):
        qspec = dataclasses.replace(q.spec_for(spec),
                                    strategies=(q.strategy,),
                                    proportions=(q.proportion,))
        run_experiment(qspec, cache_dir=str(tmp_path / f"extra{i}"),
                       backend_options=CPU, verbose=False)
        fp = qspec.cell_fingerprint("haswell", q.cell())
        assert SweepCache(tmp_path / f"extra{i}").get(fp) == m == \
            served.get(fp), q

    ref, _ = _storm(jwhatif.WhatIfEngine(
        JSpec(**dict(TORCH_KW, engine="jax")), max_batch=8, max_wait_s=0.05,
        start=False, backend_options={"devices": 1}),
        [jwhatif.WhatIfQuery(**q.to_dict()) for q in queries + extra])
    for q, a, b in zip(queries + extra, ref, got):
        assert a.keys() == b.keys(), q
        for k in a:
            if k in EXACT:
                assert _same(a[k], b[k]), (q, k, a[k], b[k])
            else:
                assert b[k] == pytest.approx(a[k], rel=RTOL, nan_ok=True), \
                    (q, k, a[k], b[k])


def test_torch_answers_are_order_and_width_independent(direct_store):
    spec = ExperimentSpec(**dict(TORCH_KW, proportions=(0.0, 0.5, 1.0),
                                 strategies=("min", "keeppref")))
    queries = _cells_for(spec)
    rng = random.Random(0)
    reference = None
    for max_batch in (1, 2, 8):
        order = list(range(len(queries)))
        rng.shuffle(order)
        got, stats = _storm(WhatIfEngine(
            spec, max_batch=max_batch, max_wait_s=0.05, start=False,
            backend_options=CPU), [queries[i] for i in order])
        assert stats["max_batch_width"] <= max_batch
        answers = dict(zip(order, got))
        if reference is None:
            reference = answers
        assert answers == reference, max_batch
    for i, q in enumerate(queries):
        fp = q.spec_for(spec).cell_fingerprint("haswell", q.cell())
        want = direct_store.get(fp)
        if want is not None:  # a cell the run_experiment grid holds too
            assert reference[i] == want, q


# ----------------------------------------------------------------------
# entry points
ARGV = ["--workload", "haswell", "--scale", "0.003", "--seeds", "2",
        "--device", "cpu", "--random", "8", "--clients", "4",
        "--max-wait-ms", "50"]


def test_cli_storm_then_expect_hits(tmp_path, capsys):
    store = ["--cache-dir", str(tmp_path / "store")]
    out = tmp_path / "rows.json"
    assert smain.main(ARGV + store + ["--out", str(out)]) == 0
    first = json.loads(out.read_text())
    assert first["stats"]["misses"] > 0 and first["stats"]["failed"] == 0
    assert smain.main(ARGV + store + ["--expect-hits", "--out",
                                      str(out)]) == 0
    text = capsys.readouterr().out
    again = json.loads(out.read_text())
    assert again["stats"]["misses"] == 0
    assert again["stats"]["hits"] == len(again["results"]) == 8
    assert [r["metrics"] for r in again["results"]] == \
        [r["metrics"] for r in first["results"]]
    assert "8 queries: 8 hits" in text


def test_http_round_trip_on_a_free_port():
    args = smain.build_parser().parse_args(
        ["--workload", "haswell", "--scale", "0.003", "--seeds", "1",
         "--device", "cpu", "--max-wait-ms", "0"])
    engine = smain.engine_from_args(args)
    bound = []
    ready = threading.Event()

    def started(httpd):
        bound.append(httpd)
        ready.set()

    thread = threading.Thread(target=smain.serve_http,
                              args=(engine, "127.0.0.1", 0, started),
                              daemon=True)
    thread.start()
    assert ready.wait(30)
    httpd = bound[0]
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    local = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        try:
            with local.open(url + path, data=data, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    try:
        q = {"strategy": "min", "proportion": 0.5}
        code, body = call("/whatif", q)
        assert code == 200 and body["query"] == WhatIfQuery(**q).to_dict()
        code, again = call("/whatif", q)
        assert code == 200 and again["metrics"] == body["metrics"]
        code, stats = call("/stats")
        assert code == 200 and stats["computed"] == 1 and \
            stats["memo_hits"] == 1
        assert call("/healthz") == (200, {"ok": True})
        code, err = call("/whatif", {"strategy": "nope"})
        assert code == 400 and "unknown strategy" in err["error"]
        assert call("/nowhere")[0] == 404
    finally:
        httpd.shutdown()
        thread.join(30)
    assert not thread.is_alive()


def test_no_card_no_run_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smain.main(["--workload", "haswell", "--scale", "0.003",
                    "--random", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WhatIfEngine(ExperimentSpec(**TORCH_KW), start=False)
    WhatIfEngine(base_spec(), start=False).close()  # des needs no card
    from repro_torch.experiments.__main__ import main as experiments_main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiments_main(["--workload", "haswell", "--scale", "0.003",
                          "--seeds", "1", "--chunk-lanes", "2"])


def test_the_llm_engine_does_not_import_the_whatif_service():
    import subprocess
    import sys
    code = ("import sys\n"
            "from repro_torch.serve import engine\n"
            "import repro_torch.serve as s\n"
            "assert 'repro_torch.serve.whatif' not in sys.modules\n"
            "assert s.WhatIfQuery.__module__ == 'repro_torch.serve.whatif'\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
