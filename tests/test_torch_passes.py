"""The port's scheduling pass and kernels' plain versions vs the JAX package.

Inputs are made with numpy from a seed and handed to both packages
(``repro_torch.convert``).  Integer and float outputs must be bit-equal:
the port keeps XLA's int32 / float32 arithmetic and evaluation order.
The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import passes as jp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.waterfill import waterfill as j_waterfill  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 result_to_numpy, to_tensors)
from repro_torch.core import passes as tp  # noqa: E402
from repro_torch.kernels.ref import schedule_tick_ref, waterfill_ref  # noqa
from repro_torch.kernels.schedule_tick import fused_schedule_tick  # noqa
from repro_torch.kernels.waterfill import (greedy_give_waterfill,  # noqa
                                           waterfill)

SLOTS = ("state", "alloc", "remaining", "start_t", "act", "capacity",
         "t_now")
KW = dict(fill_rounds=2, prio_lo=-4, prio_hi=12)


def random_tick_case(rng, B=4, W=24):
    """A plausible mid-simulation slot state (tests/test_passes.py's
    ``_random_tick_case`` as numpy arrays)."""
    mn = rng.integers(1, 3, (B, W)).astype(np.int32)
    mx = (mn + rng.integers(0, 6, (B, W))).astype(np.int32)
    want = np.clip(rng.integers(1, 7, (B, W)), mn, mx).astype(np.int32)
    state = rng.choice(4, size=(B, W), p=[0.2, 0.4, 0.3, 0.1])
    state = state.astype(np.int32)
    alloc = np.where(state == 2, want, 0).astype(np.int32)
    params = dict(
        malleable=rng.random((B, W)) < 0.7, min_nodes=mn, max_nodes=mx,
        want=want, floor=mn, shrink_floor=mn,
        prio_ref=rng.integers(0, 3, (B, W)).astype(np.int32),
        pfrac=rng.uniform(0.3, 1.0, (B, W)).astype(np.float32),
        wall_work=rng.uniform(20.0, 200.0, (B, W)).astype(np.float32))
    slots = dict(
        state=state, alloc=alloc,
        remaining=rng.uniform(1.0, 80.0, (B, W)).astype(np.float32),
        start_t=np.where(state == 2, rng.uniform(0.0, 40.0, (B, W)),
                         0.0).astype(np.float32),
        act=(rng.random(B) < 0.8)[:, None],
        capacity=rng.integers(8, 16, B).astype(np.int32),
        t_now=rng.uniform(30.0, 60.0, B).astype(np.float32))
    return params, slots


@functools.lru_cache(maxsize=None)
def _jax_tick(structure, backend, bounded):
    """The JAX pass, jitted once per static configuration (eager dispatch
    of its bisection loops costs seconds per call)."""
    kw = dict(KW, structure=structure, span_max=8, expand_backend=backend)
    if bounded:
        return jax.jit(lambda *a: jp.schedule_tick(*a[:-1],
                                                   backfill_depth=a[-1], **kw))
    return jax.jit(lambda *a: jp.schedule_tick(*a, **kw))


def _jax_run(params, slots, structure, backend, depth):
    args = _jax_args(params, slots)
    if depth is None:
        return _jax_tick(structure, backend, False)(*args)
    B = slots["state"].shape[0]
    return _jax_tick(structure, backend, True)(*args, _depth(depth, B, jnp))


def _jax_args(params, slots):
    p = jp.PassParams(**{k: jnp.asarray(v) for k, v in params.items()})
    return (p,) + tuple(jnp.asarray(slots[k]) for k in SLOTS)


def _torch_args(params, slots):
    t = to_tensors(slots, "cpu")
    return (params_from_numpy(params, "cpu"),) + tuple(t[k] for k in SLOTS)


def _depth(depth, B, xp):
    if depth is None:
        return None
    if xp is torch:
        return torch.full((B,), depth, dtype=torch.int32)
    return jnp.full((B,), depth, jnp.int32)


def _assert_same(ref, got):
    for r, g, name in zip(ref, result_to_numpy(got),
                          ("state", "alloc", "start_t")):
        np.testing.assert_array_equal(np.asarray(r), g, err_msg=name)


@pytest.mark.parametrize("trial", range(6))
@pytest.mark.parametrize("depth", [None, 2])
@pytest.mark.parametrize("structure", ["greedy", "balanced"])
def test_plain_pass_matches_jax_bisect(trial, depth, structure):
    """The port's plain pass is bit-equal to the JAX pass (bisect)."""
    params, slots = random_tick_case(np.random.default_rng(500 + trial))
    B = slots["state"].shape[0]
    kw = dict(KW, structure=structure, span_max=8)
    ref = _jax_run(params, slots, structure, "bisect", depth)
    got = tp.schedule_tick(*_torch_args(params, slots),
                           expand_backend="bisect",
                           backfill_depth=_depth(depth, B, torch), **kw)
    _assert_same(ref, got)


@pytest.mark.parametrize("trial", range(4))
@pytest.mark.parametrize("depth", [None, 2])
def test_schedule_tick_ref_matches_fused_interpret(trial, depth):
    """``schedule_tick_ref`` (what the CUDA kernel computes) equals the JAX
    fused Pallas kernel run in interpret mode."""
    params, slots = random_tick_case(np.random.default_rng(700 + trial))
    B = slots["state"].shape[0]
    ref = _jax_run(params, slots, "greedy", "fused-interpret", depth)
    got = schedule_tick_ref(*_torch_args(params, slots),
                            shadow_iters=tp.SHADOW_ITERS,
                            backfill_depth=_depth(depth, B, torch), **KW)
    _assert_same(ref, got)


def test_fused_wrapper_on_cpu_tensors_is_the_plain_pass():
    params, slots = random_tick_case(np.random.default_rng(3))
    args = _torch_args(params, slots)
    got = fused_schedule_tick(*args, shadow_iters=26, **KW)
    ref = schedule_tick_ref(*args, shadow_iters=26, **KW)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("trial", range(4))
def test_take_desc_prefix_matches_jax(trial):
    rng = np.random.default_rng(40 + trial)
    prio = rng.integers(-6, 7, (3, 17)).astype(np.int32)
    amount = rng.integers(0, 9, (3, 17)).astype(np.int32)
    need = rng.integers(0, 60, 3).astype(np.int32)
    ref = jp.take_desc_prefix(jnp.asarray(prio), jnp.asarray(amount),
                              jnp.asarray(need), -7, 6)
    got = tp.take_desc_prefix(torch.from_numpy(prio),
                              torch.from_numpy(amount),
                              torch.from_numpy(need), -7, 6)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert np.array_equal(got.sum(-1).numpy(),
                          np.minimum(need, amount.sum(-1)))


@pytest.mark.parametrize("trial", range(3))
def test_shadow_reservation_matches_jax(trial):
    rng = np.random.default_rng(60 + trial)
    est = rng.uniform(10.0, 500.0, (3, 20)).astype(np.float32)
    est[rng.random((3, 20)) < 0.4] = np.inf
    release = rng.integers(1, 6, (3, 20)).astype(np.int32)
    free = rng.integers(0, 3, 3).astype(np.int32)
    head = (free + rng.integers(1, 10, 3)).astype(np.int32)
    ref = jp.shadow_reservation(*(jnp.asarray(a) for a in
                                  (est, release, free, head)))
    got = tp.shadow_reservation(*(torch.from_numpy(a) for a in
                                  (est, release, free, head)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("n", [1, 7, 999, 4096])
def test_waterfill_ref_matches_jax_oracle_and_pallas(n):
    rng = np.random.default_rng(n)
    cap = rng.integers(0, 50, size=n).astype(np.int32)
    total = int(cap.sum())
    for tgt in (0, 1, total // 3, total, total + 17):
        got = waterfill_ref(torch.from_numpy(cap), tgt).numpy()
        np.testing.assert_array_equal(got, np.asarray(jref.waterfill(cap,
                                                                     tgt)))
        np.testing.assert_array_equal(
            got, np.asarray(j_waterfill(jnp.asarray(cap), tgt,
                                        interpret=True)))
        assert int(got.sum()) == min(tgt, total)


def test_waterfill_rows_take_per_row_targets():
    rng = np.random.default_rng(8)
    cap = rng.integers(0, 9, (5, 33)).astype(np.int32)
    tgt = rng.integers(0, 200, 5).astype(np.int32)
    got = waterfill(torch.from_numpy(cap), torch.from_numpy(tgt)).numpy()
    for b in range(5):
        np.testing.assert_array_equal(got[b], np.asarray(
            jref.waterfill(cap[b], int(tgt[b]))))


@pytest.mark.parametrize("trial", range(4))
def test_greedy_give_waterfill_matches_jax_pallas_give(trial):
    """The waterfill expand backend gives what the JAX ``pallas`` give and
    the bisection give do, slot for slot."""
    rng = np.random.default_rng(200 + trial)
    prio = rng.integers(-4, 5, (3, 10)).astype(np.int32)
    room = rng.integers(0, 6, (3, 10)).astype(np.int32)
    idle = rng.integers(0, 25, 3).astype(np.int32)
    ref = jp._pallas_give(jnp.asarray(prio), jnp.asarray(room),
                          jnp.asarray(idle), interpret=True)
    got = greedy_give_waterfill(*(torch.from_numpy(a)
                                  for a in (prio, room, idle)))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    bis = tp.give_asc_prefix(*(torch.from_numpy(a)
                               for a in (prio, room, idle)), -5, 5)
    assert torch.equal(bis, got)
