"""The port's dense per-tick engine equals the JAX package's, bit for bit.

``repro_torch.core.sim_dense`` (the port of ``repro.core.sim_jax``) runs
on the CPU with ``expand_backend="bisect"`` and is held to
``simulate_jax`` / ``simulate_scan_batch`` in every field of ``SimState``
and ``SimTrace``, byte for byte (NaN start / end times of unstarted jobs
included), with no tolerance: the 8 registry strategies, on-demand job
classes, SJF, backfill depths and per-lane depths in a batch.  The
hypothesis property is in ``test_torch_sim_dense_props.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import sim_jax  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import sim_dense  # noqa: E402

CAP, TICK, TICKS = 10, 1.0, 800


def workload(core, seed=0, n=20, prop=0.6, classes=None):
    """``tests/test_sim_jax.py``'s workload, in ``core``'s classes."""
    rng = np.random.default_rng(seed)
    w = core.Workload.rigid(submit=np.sort(rng.uniform(0, 150, n)),
                            runtime=rng.uniform(20, 120, n),
                            nodes_req=rng.choice([1, 2, 4, 8], n))
    if classes is not None:
        w = core.apply_scenario(w, core.ScenarioConfig(
            job_classes=core.JobClasses(**classes)))
    return core.transform_rigid_to_malleable(w, prop, seed=seed,
                                             cluster_nodes=CAP)


def assert_bit_equal(ref, got):
    """Every field of ``(SimState, SimTrace)`` equal byte for byte."""
    for r, g in zip(ref, got):
        assert type(r)._fields == type(g)._fields
        for f in r._fields:
            a, b = np.asarray(getattr(r, f)), getattr(g, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), (
                f, np.flatnonzero(a.ravel() != b.ravel())[:8])


def both(name, wl=None, ticks=TICKS, **kw):
    wl = wl or {}
    ref = sim_jax.simulate_jax(workload(jcore, **wl), CAP, TICK, ticks,
                               jcore.STRATEGIES[name], **kw)
    got = sim_dense.simulate_dense(workload(tcore, **wl), CAP, TICK, ticks,
                                   tcore.STRATEGIES[name], device="cpu",
                                   **kw)
    return ref, got


@pytest.mark.parametrize("name", sorted(jcore.STRATEGIES))
def test_registry_strategy_matches_sim_jax(name):
    ref, got = both(name)
    assert_bit_equal(ref, got)
    # every job finishes inside the cluster (tests/test_sim_jax.py)
    assert np.all(got[0].state.numpy() == tcore.DONE)
    assert int(got[1].busy.max()) <= CAP


@pytest.mark.parametrize("name,kw", [
    ("pref", dict(wl=dict(classes=dict(rigid=0.1, on_demand=0.1,
                                       malleable=0.8)))),
    ("pref_common_pool", dict(wl=dict(classes=dict(
        rigid=0.2, on_demand=0.2, malleable=0.6), seed=3))),
    ("min", dict(queue_order="sjf")),
    ("keeppref", dict(queue_order="sjf", wl=dict(seed=4, prop=1.0))),
], ids=["classes-pref", "classes-pool", "sjf-min", "sjf-keeppref"])
def test_classes_and_sjf_match_sim_jax(name, kw):
    ref, got = both(name, **kw)
    assert_bit_equal(ref, got)
    if "wl" in kw and "classes" in kw["wl"]:
        assert np.any(workload(tcore, **kw["wl"]).on_demand)


@pytest.mark.parametrize("depth", [1, 4, None], ids=["1", "4", "default"])
@pytest.mark.parametrize("name", ["easy", "min"])
def test_backfill_depth_matches_sim_jax(name, depth):
    kw = {} if depth is None else dict(backfill_depth=depth)
    ref, got = both(name, wl=dict(seed=2, n=24), **kw)
    assert_bit_equal(ref, got)


def test_batch_with_per_lane_depths_matches_the_jax_vmap():
    variants = [dict(seed=1), dict(seed=2, prop=1.0), dict(seed=5, prop=0.3)]
    depths = np.array([1, 4, 256], dtype=np.int32)
    jobs_j = sim_jax.JobArrays.stack(
        [sim_jax.JobArrays.from_workload(workload(jcore, **v))
         for v in variants])
    jobs_t = sim_dense.JobArrays.stack(
        [sim_dense.JobArrays.from_workload(workload(tcore, **v), "cpu")
         for v in variants])
    ref = sim_jax.simulate_scan_batch(jobs_j, jcore.STRATEGIES["min"], CAP,
                                      TICK, 400, backfill_depth=depths)
    got = sim_dense.simulate_scan_batch(jobs_t, tcore.STRATEGIES["min"], CAP,
                                        TICK, 400, backfill_depth=depths)
    assert_bit_equal(ref, got)
    # each row is the single-lane run of its variant
    one = sim_dense.simulate_scan(
        sim_dense.JobArrays.from_workload(workload(tcore, **variants[1]),
                                          "cpu"),
        tcore.STRATEGIES["min"], CAP, TICK, 400, backfill_depth=4)
    for full, row in zip(got[0] + got[1], one[0] + one[1]):
        assert full[1].numpy().tobytes() == row.numpy().tobytes()


def test_job_arrays_match_the_reference_and_keep_caller_order():
    w_j, w_t = workload(jcore, seed=6), workload(tcore, seed=6)
    perm = np.random.default_rng(0).permutation(w_j.n_jobs)
    w_j, w_t = w_j.take(perm), w_t.take(perm)   # submit no longer sorted
    a_j = sim_jax.JobArrays.from_workload(w_j)
    a_t = sim_dense.JobArrays.from_workload(w_t, "cpu")
    assert a_j._fields == a_t._fields
    for f in a_j._fields:
        assert np.asarray(getattr(a_j, f)).tobytes() == \
            getattr(a_t, f).numpy().tobytes(), f
    ref = sim_jax.simulate_jax(w_j, CAP, TICK, 300, jcore.STRATEGIES["avg"])
    got = sim_dense.simulate_dense(w_t, CAP, TICK, 300,
                                   tcore.STRATEGIES["avg"], device="cpu")
    assert_bit_equal(ref, got)


def test_no_job_starts_before_its_submission():
    """The batched engines admit arrivals half a tick early (fault C1,
    ROADMAP §C); the dense engine, like ``sim_jax``, admits none before
    its submission, SJF included."""
    w = workload(tcore, seed=7, prop=0.6)
    st, _ = sim_dense.simulate_dense(w, CAP, TICK, TICKS,
                                     tcore.STRATEGIES["min"], device="cpu",
                                     queue_order="sjf")
    started = ~torch.isnan(st.start_t)
    assert torch.all(st.start_t[started] >= torch.from_numpy(
        w.submit.astype(np.float32))[started])


def test_kernel_backends_refuse_the_cpu():
    w = workload(tcore)
    for backend in ("fused", "waterfill"):
        with pytest.raises(ValueError, match="only 'bisect'"):
            sim_dense.simulate_dense(w, CAP, TICK, 10, tcore.STRATEGIES["min"],
                                     device="cpu", expand_backend=backend)
