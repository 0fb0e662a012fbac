"""The port's batched engine vs ``repro.sweep.batch.simulate_lanes``.

Both engines run the same numpy-built lanes (the JAX batch carried across by
``repro_torch.convert``).  Per-job integer outcomes and the counters must be
bit-equal, and so must the float start/end times (no case needed the
1e-3 s allowance).  The event timeline is compared as a step function: the
two engines may emit different zero-width entries when their window
histories differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import STRATEGIES as JS, Workload  # noqa: E402
from repro.sweep import batch as jb  # noqa: E402
from repro_torch.convert import batch_from_numpy  # noqa: E402
from repro_torch.core import STRATEGIES as TS  # noqa: E402
from repro_torch.sweep import batch as tb  # noqa: E402

GREEDY = [("easy", 0.0, 0), ("min", 0.6, 0), ("pref", 1.0, 1),
          ("keeppref", 0.6, 0)]
BALANCED = [("avg", 0.8, 0), ("avg", 1.0, 1)]
EXACT = ("state", "alloc", "start_t", "end_t", "expand_ops", "shrink_ops",
         "bf_starts", "sched_steps")


def _wl(seed=0, n=20, hi=150.0):
    rng = np.random.default_rng(seed)
    return Workload.rigid(submit=np.sort(rng.uniform(0, hi, n)),
                          runtime=rng.uniform(20, 120, n),
                          nodes_req=rng.choice([1, 2, 4, 8], n))


def _tail_wl():
    """Rigid 1-node jobs arriving together: a queue-drained, no-room tail
    of no-op completion events -- the regime event compression targets."""
    rng = np.random.default_rng(7)
    return Workload.rigid(submit=np.sort(rng.uniform(0, 5.0, 20)),
                          runtime=rng.uniform(20, 120, 20),
                          nodes_req=np.ones(20, dtype=np.int64))


def _lanes(names):
    return [(JS[s], p, sd) for s, p, sd in names]


def _carry(jbatch):
    return batch_from_numpy({f: np.asarray(getattr(jbatch, f))
                             for f in jb.BatchedLanes._fields}, "cpu")


def _concat_batch():
    b_a, _ = jb.build_lanes(_wl(seed=0, n=20), 10, _lanes(GREEDY[:2]),
                            tick=1.0)
    b_b, _ = jb.build_lanes(_wl(seed=9, n=13, hi=100.0), 6,
                            _lanes(GREEDY[2:3]), tick=2.0)
    return jb.concat_lanes([b_a, b_b])


CASES = {
    # name: (batch factory, structure, window, chunk, events)
    "greedy-e1": (lambda: jb.build_lanes(_tail_wl(), 10,
                                         _lanes(GREEDY[:2]))[0],
                  "greedy", 16, 64, 1),
    "greedy-e4": (lambda: jb.build_lanes(_tail_wl(), 10,
                                         _lanes(GREEDY[:2]))[0],
                  "greedy", 16, 64, 4),
    "balanced-e1": (lambda: jb.build_lanes(_wl(seed=3), 10,
                                           _lanes(BALANCED))[0],
                    "balanced", 16, 64, 1),
    "balanced-e4": (lambda: jb.build_lanes(_wl(seed=3), 10,
                                           _lanes(BALANCED))[0],
                    "balanced", 16, 64, 4),
    "escalation": (lambda: jb.build_lanes(_wl(n=30, hi=60.0), 10,
                                          _lanes(GREEDY[:2]))[0],
                   "greedy", 16, 32, 4),
    "concat": (_concat_batch, "greedy", 16, 64, 4),
    "auto-window": (lambda: jb.build_lanes(_wl(seed=5, n=40, hi=200.0), 10,
                                           _lanes(GREEDY))[0],
                    "greedy", 0, 160, 4),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (make, structure, window, chunk, events) in CASES.items():
        batch = make()
        jcfg = jb.EngineConfig(structure=structure, window=window,
                               chunk=chunk, events=events)
        tcfg = tb.EngineConfig(structure=structure, window=window,
                               chunk=chunk, events=events)
        out[name] = (jb.simulate_lanes(batch, jcfg),
                     tb.simulate_lanes(_carry(batch), tcfg))
    return out


@pytest.mark.parametrize("field", EXACT)
@pytest.mark.parametrize("case", sorted(CASES))
def test_outcomes_bit_equal_to_jax(runs, case, field):
    ref, got = runs[case]
    assert got["finished"] and ref["finished"]
    np.testing.assert_array_equal(np.asarray(ref[field]), got[field],
                                  err_msg=f"{case}:{field}")


def _step_function(t, busy, qlen):
    """(start, busy, qlen) pieces: zero-width entries and repeats dropped."""
    keep = np.append(t[1:] > t[:-1], True)
    pieces = []
    for ti, b, q in zip(t[keep], busy[keep], qlen[keep]):
        if pieces and pieces[-1][1:] == (int(b), int(q)):
            continue
        pieces.append((float(ti), int(b), int(q)))
    return pieces


@pytest.mark.parametrize("case", sorted(CASES))
def test_timeline_equal_as_step_function(runs, case):
    ref, got = runs[case]
    for lane in range(got["trace_t"].shape[0]):
        assert _step_function(
            *(np.asarray(ref[k])[lane] for k in ("trace_t", "trace_busy",
                                                 "trace_qlen"))) == \
            _step_function(*(got[k][lane] for k in ("trace_t", "trace_busy",
                                                    "trace_qlen")))


def test_forced_escalation_escalates(runs):
    ref, got = runs["escalation"]
    assert got["escalations"] > 0 and got["window"] > 16
    assert got["window"] == ref["window"]


def test_event_compression_is_results_neutral(runs):
    e1, e4 = runs["greedy-e1"][1], runs["greedy-e4"][1]
    assert e1["compressed_events"] == 0 < e4["compressed_events"]
    for field in EXACT:
        np.testing.assert_array_equal(e1[field], e4[field], err_msg=field)


def test_escalated_run_matches_fresh_larger_bucket(runs):
    forced = runs["escalation"][1]
    batch = _carry(CASES["escalation"][0]())
    fresh = tb.simulate_lanes(batch, tb.EngineConfig(
        window=forced["window"], chunk=32))
    assert fresh["escalations"] == 0
    for field in EXACT:
        np.testing.assert_array_equal(forced[field], fresh[field],
                                      err_msg=field)


def test_concat_lanes_matches_per_workload_runs(runs):
    """Lanes of different clusters stacked into one padded batch reproduce
    each workload's solo run exactly."""
    big = runs["concat"][1]
    cfg = tb.EngineConfig(window=16, chunk=64)
    solo_a = tb.simulate_lanes(_carry(jb.build_lanes(
        _wl(seed=0, n=20), 10, _lanes(GREEDY[:2]), tick=1.0)[0]), cfg)
    for field in ("start_t", "end_t", "expand_ops", "shrink_ops"):
        np.testing.assert_array_equal(big[field][:2], solo_a[field])
    assert np.all(np.isnan(big["start_t"][2:, 13:]))


def test_build_lanes_on_the_port_matches_carried_batch():
    w = _wl(n=25, hi=100.0)
    own, _ = tb.build_lanes(w, 10, [(TS[s], p, sd) for s, p, sd in GREEDY],
                            device="cpu")
    carried = _carry(jb.build_lanes(w, 10, _lanes(GREEDY))[0])
    for f in tb.BatchedLanes._fields:
        assert torch.equal(getattr(own, f), getattr(carried, f)), f
