"""The port's pass over the whole strategy registry vs the JAX package.

Every structure (greedy, balanced, pooled, stealing) with and without the
on-demand queue priority (``with_classes``) and the SJF queue order
(``with_sjf``), unbounded and at backfill depth 2.  Inputs are the random
slot states of ``tests/test_torch_passes.py`` extended with seeded
``on_demand``, ``pref_nodes`` (between min and max) and walltime-like
``sort_key`` values with ties, and per-lane ``pool_share`` in [0.25, 1]
and ``steal_margin`` in 0..3.  State, alloc and start_t must be bit-equal
to ``repro.core.passes.schedule_tick`` (bisect).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import passes as jp  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 result_to_numpy, to_tensors)
from repro_torch.core import STRATEGIES, Workload  # noqa: E402
from repro_torch.core import passes as tp  # noqa: E402
from repro_torch.sweep.batch import (EngineConfig, build_lanes,  # noqa: E402
                                     simulate_lanes)

from test_torch_passes import KW, SLOTS, random_tick_case  # noqa: E402

STRUCTURES = ("greedy", "balanced", "pooled", "stealing")


def registry_tick_case(rng, B=4, W=24):
    """``random_tick_case`` plus the registry's fields: a quarter of the
    slots on-demand, preferred allocations in [min, max], walltime-like
    sort keys drawn from five values (ties), and per-lane pool shares and
    steal margins."""
    params, slots = random_tick_case(rng, B, W)
    mn, mx = params["min_nodes"], params["max_nodes"]
    params["on_demand"] = rng.random((B, W)) < 0.25
    params["pref_nodes"] = np.minimum(
        mn + np.floor(rng.random((B, W)) * (mx - mn + 1)), mx
    ).astype(np.int32)
    params["sort_key"] = (rng.integers(1, 6, (B, W)) * 600.0
                          ).astype(np.float32)
    lane = dict(pool_share=rng.uniform(0.25, 1.0, B).astype(np.float32),
                steal_margin=rng.integers(0, 4, B).astype(np.int32))
    return params, slots, lane


@functools.lru_cache(maxsize=None)
def _jax_tick(structure, with_classes, with_sjf, bounded):
    """The JAX pass, jitted once per static configuration."""
    kw = dict(KW, structure=structure, span_max=8, expand_backend="bisect",
              with_classes=with_classes, with_sjf=with_sjf)

    def run(p, *a):
        *slots, share, margin, depth = a
        return jp.schedule_tick(p, *slots, pool_share=share,
                                steal_margin=margin,
                                backfill_depth=depth if bounded else None,
                                **kw)
    return jax.jit(run)


def _jax_run(params, slots, lane, structure, with_classes, with_sjf, depth):
    B = slots["state"].shape[0]
    p = jp.PassParams(**{k: jnp.asarray(v) for k, v in params.items()})
    args = tuple(jnp.asarray(slots[k]) for k in SLOTS) + (
        jnp.asarray(lane["pool_share"]), jnp.asarray(lane["steal_margin"]),
        jnp.full((B,), 0 if depth is None else depth, jnp.int32))
    return _jax_tick(structure, with_classes, with_sjf,
                     depth is not None)(p, *args)


def _torch_run(params, slots, lane, structure, with_classes, with_sjf,
               depth):
    B = slots["state"].shape[0]
    t = to_tensors(slots, "cpu")
    return tp.schedule_tick(
        params_from_numpy(params, "cpu"), *(t[k] for k in SLOTS),
        structure=structure, span_max=8, expand_backend="bisect",
        with_classes=with_classes, with_sjf=with_sjf,
        pool_share=torch.from_numpy(lane["pool_share"]),
        steal_margin=torch.from_numpy(lane["steal_margin"]),
        backfill_depth=(None if depth is None
                        else torch.full((B,), depth, dtype=torch.int32)),
        **KW)


@pytest.mark.parametrize("trial", range(2))
@pytest.mark.parametrize("depth", [None, 2])
@pytest.mark.parametrize("with_sjf", [False, True], ids=["fcfs", "sjf"])
@pytest.mark.parametrize("with_classes", [False, True],
                         ids=["classfree", "classes"])
@pytest.mark.parametrize("structure", STRUCTURES)
def test_registry_pass_matches_jax_bisect(structure, with_classes, with_sjf,
                                          depth, trial):
    seed = 1000 + 97 * STRUCTURES.index(structure) + 17 * trial \
        + 5 * with_classes + 3 * with_sjf + (depth or 0)
    params, slots, lane = registry_tick_case(np.random.default_rng(seed))
    ref = _jax_run(params, slots, lane, structure, with_classes, with_sjf,
                   depth)
    got = _torch_run(params, slots, lane, structure, with_classes, with_sjf,
                     depth)
    for r, g, name in zip(ref, result_to_numpy(got),
                          ("state", "alloc", "start_t")):
        np.testing.assert_array_equal(np.asarray(r), g, err_msg=name)


def _helper_case(seed, B=3, W=19):
    rng = np.random.default_rng(seed)
    return (rng.random((B, W)) < 0.6, rng.random((B, W)) < 0.3,
            rng.integers(0, 9, (B, W)).astype(np.int32))


@pytest.mark.parametrize("trial", range(3))
def test_priority_head_matches_jax(trial):
    queued, od, _ = _helper_case(80 + trial)
    queued[0] &= ~od[0]          # a lane with no queued on-demand slot
    queued[1] = False            # a lane with nothing queued
    ref = jp.priority_head(jnp.asarray(queued), jnp.asarray(od))
    got = tp.priority_head(torch.from_numpy(queued), torch.from_numpy(od))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("classes", [False, True],
                         ids=["classfree", "classes"])
@pytest.mark.parametrize("trial", range(3))
def test_queue_ranks_and_cumsum_match_jax(trial, classes):
    queued, od, amount = _helper_case(90 + trial)
    j_od = jnp.asarray(od) if classes else None
    t_od = torch.from_numpy(od) if classes else None
    ranks = tp.queue_ranks(torch.from_numpy(queued), t_od)
    cum = tp.queue_cumsum(torch.from_numpy(amount),
                          torch.from_numpy(queued), t_od)
    assert ranks.dtype == cum.dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(jp.queue_ranks(jnp.asarray(queued), j_od)), ranks.numpy())
    np.testing.assert_array_equal(
        np.asarray(jp.queue_cumsum(jnp.asarray(amount), jnp.asarray(queued),
                                   j_od)), cum.numpy())


@pytest.mark.parametrize("structure", STRUCTURES)
def test_fcfs_lanes_inside_an_sjf_pass_are_unpermuted(structure):
    """Lanes whose sort key is monotone (FCFS submit rank) come out of a
    ``with_sjf`` pass bit-identical to the ``with_sjf=False`` pass, while
    the SJF lanes beside them are reordered."""
    params, slots, lane = registry_tick_case(np.random.default_rng(0), B=6)
    W = slots["state"].shape[1]
    params["sort_key"][::2] = np.arange(W, dtype=np.float32)
    sjf = result_to_numpy(_torch_run(params, slots, lane, structure, True,
                                     True, None))
    fcfs = result_to_numpy(_torch_run(params, slots, lane, structure, True,
                                      False, None))
    for s, f in zip(sjf, fcfs):
        np.testing.assert_array_equal(s[::2], f[::2])
    assert any(not np.array_equal(s[1::2], f[1::2]) for s, f in zip(sjf,
                                                                    fcfs))


def test_fcfs_lane_inside_sjf_batch_is_bit_identical():
    """The engine-level form (``tests/test_passes.py``): a mixed
    easy + rigid_sjf batch reproduces the solo EASY lane bit for bit, and
    the SJF lane differs from it."""
    rng = np.random.default_rng(3)
    w = Workload.rigid(submit=np.sort(rng.uniform(0, 150, 18)),
                       runtime=rng.uniform(20, 120, 18),
                       nodes_req=rng.choice([1, 2, 4, 8], 18))
    solo, _ = build_lanes(w, 10, [(STRATEGIES["easy"], 0.0, 0)],
                          device="cpu")
    mixed, _ = build_lanes(w, 10, [(STRATEGIES["easy"], 0.0, 0),
                                   (STRATEGIES["rigid_sjf"], 0.0, 0)],
                           device="cpu")
    cfg = EngineConfig(window=16, chunk=64)
    res_solo = simulate_lanes(solo, cfg)
    res_mixed = simulate_lanes(mixed, cfg)
    for key in ("start_t", "end_t"):
        np.testing.assert_array_equal(res_mixed[key][0], res_solo[key][0])
    assert np.any(res_mixed["start_t"][1] != res_solo["start_t"][0])
