"""The CUDA waterfill kernel's launch plan and its wrapper, on the CPU.

``kernels/waterfill.py::plan`` is what the C launch runs (packed into one
int, decoded in ``bindings.cpp`` and re-checked there): these tests hold
its tier, tiles and coverage of the row at the shapes the engine and the
smoke run give it, and the wrapper's refusals, which hold on both devices.
The give through ``order`` is held to the JAX package's
``_pallas_give`` (the Pallas kernel in interpret mode) and to the
bisection give ``give_asc_prefix``.  ``tests/test_torch_waterfill_host.py``
runs the kernel's own source; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` run it on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import passes as jp  # noqa: E402
from repro_torch.core import passes as tp  # noqa: E402
from repro_torch.kernels import waterfill as wf  # noqa: E402
from repro_torch.kernels.ref import waterfill_ref  # noqa: E402

I32, I64 = torch.int32, torch.int64


@pytest.mark.parametrize("B,N,sms,tier,k,threads,tiles", [
    # theta's captured call, 64 x 1,000, 132 x 2,048, haswell's peak
    # window and Eagle's job count as one row, on an H100 (132 SMs) ...
    (31, 128, 132, "warp", 4, 32, 1),
    (64, 1000, 132, "cta", 4, 256, 1),
    (132, 2048, 132, "cta", 4, 512, 1),
    (16, 16_384, 132, "lookback", 4, 256, 16),
    (1, 143_829, 132, "lookback", 4, 256, 141),
    # ... and on a card of one SM, where every row count fills it
    (31, 128, 1, "warp", 4, 128, 1),
    (64, 1000, 1, "cta", 4, 256, 1),
    (132, 2048, 1, "cta", 4, 512, 1),
    (16, 16_384, 1, "lookback", 4, 256, 16),
    (1, 143_829, 1, "lookback", 4, 256, 141)])
def test_waterfill_plan_at_the_engine_and_smoke_shapes(B, N, sms, tier, k,
                                                       threads, tiles):
    pl = wf.plan(B, N, sms)
    assert (pl.tier, pl.k, pl.threads, pl.tiles) == (tier, k, threads, tiles)
    assert pl.scratch == (1 + B * tiles if tier == "lookback" else 0)


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_waterfill_plan_covers_every_slot_once(sms):
    """Every tier's slots cover the row with no idle warp, each tile holds
    slots, and the code decodes back to the plan (as ``bindings.cpp``
    reads it)."""
    for B in (1, 2, 31, 64, 132, 500):
        for N in (1, 31, 32, 33, 128, 1000, 1024, 1025, 2048, 4097, 16_384,
                  16_385, 65_536, 143_829):
            pl = wf.plan(B, N, sms)
            code = pl.code
            assert wf.TIERS[code & 3] == pl.tier
            assert (code >> 2) & 63 == pl.k
            assert ((code >> 8) & 63) * 32 == pl.threads <= 1024
            assert not code & (wf.VEC_BIT | wf.SHARED_TARGET_BIT)
            if pl.tier == "warp":
                assert N <= wf.WARP_MAX_SLOTS and 32 * pl.k >= N
                assert pl.k == 1 or N > 16 * pl.k  # the smallest k
                assert pl.grid * (pl.threads // 32) >= B
                assert pl.threads == 32 * min(wf.WARP_ROWS, max(1, B // sms))
            elif pl.tier == "cta":
                assert wf.WARP_MAX_SLOTS < N <= wf.CTA_MAX_SLOTS
                assert pl.threads * pl.k >= N > (pl.threads - 32) * pl.k
                assert pl.grid == B
            else:
                assert N > wf.CTA_MAX_SLOTS
                span = pl.threads * pl.k
                assert (pl.tiles - 1) * span < N <= pl.tiles * span
                assert pl.grid == B * pl.tiles and pl.scratch == 1 + pl.grid


def test_waterfill_plan_tier_boundaries():
    assert [wf.plan(8, n, 132).tier for n in (256, 257, 4096, 4097)] == [
        "warp", "cta", "cta", "lookback"]
    assert [wf.plan(b, 128, 132).threads for b in (1, 131, 264, 10_000)] == [
        32, 32, 64, 128]


def _cap(*shape):
    return torch.ones(shape, dtype=I32)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", [
    "int64 cap", "float cap", "3-D cap", "0-d cap", "transposed cap",
    "float target", "int64 target", "target per row too long",
    "Python float target", "target outside int32", "order of another shape",
    "int32 order", "transposed order", "target on another device"])
def test_waterfill_refuses_what_the_kernel_does_not_take(device, case):
    """The wrapper raises on the CPU as it does on the card (the CPU path
    is the plain version of the same contract), and refuses a device
    other than cpu and cuda."""
    cap, target, order = _cap(3, 8), torch.full((3,), 4, dtype=I32), None
    if case == "int64 cap":
        cap = cap.long()
    elif case == "float cap":
        cap = cap.float()
    elif case == "3-D cap":
        cap = _cap(2, 3, 8)
    elif case == "0-d cap":
        cap = torch.tensor(3, dtype=I32)
    elif case == "transposed cap":
        cap = _cap(8, 3).t()
    elif case == "float target":
        target = target.float()
    elif case == "int64 target":
        target = target.long()
    elif case == "target per row too long":
        target = torch.full((4,), 4, dtype=I32)
    elif case == "Python float target":
        target = 2.5
    elif case == "target outside int32":
        target = 2**31
    elif case == "order of another shape":
        order = torch.zeros((3, 7), dtype=I64)
    elif case == "int32 order":
        order = torch.zeros((3, 8), dtype=I32)
    elif case == "transposed order":
        order = torch.zeros((8, 3), dtype=I64).t()
    if device == "meta":
        cap = cap.to("meta")
    elif case == "target on another device":
        target = target.to("meta")
    with pytest.raises((ValueError, TypeError)):
        wf.waterfill(cap, target, order)


def test_waterfill_takes_every_target_it_documents():
    cap = _cap(3, 8)
    ref = waterfill_ref(cap, 5)
    for target in (5, np.int32(5), torch.tensor(5, dtype=I32),
                   torch.full((3,), 5, dtype=I32)):
        assert torch.equal(wf.waterfill(cap, target), ref)
    assert torch.equal(wf.waterfill(cap[0], torch.tensor(5, dtype=I32)),
                       ref[0])
    assert wf.waterfill(torch.empty((0, 8), dtype=I32),
                        torch.empty((0,), dtype=I32)).shape == (0, 8)


def test_kernel_args_cross_a_python_target_by_value():
    cap = _cap(3, 8)
    pl = wf.plan(3, 8, 132)
    out = torch.empty_like(cap)
    args = wf.kernel_args(cap, 7, None, out, None, pl, False)
    assert args[1] is None and args[2] is None and args[4] is None
    assert args[5:8] == (3, 8, 7)
    tgt = torch.tensor(7, dtype=I32)
    args = wf.kernel_args(cap, tgt, None, out, None, pl, True)
    assert args[1] == tgt.data_ptr() and args[8] & wf.SHARED_TARGET_BIT


@pytest.mark.parametrize("B,N,slice_,use_order,vec", [
    (1, 4097, False, False, True),    # one row: aligned whatever N
    (2, 4096, False, False, True),
    (2, 4097, False, False, False),   # rows start off 4-int boundaries
    (1, 4097, True, False, False),    # the row starts 4 bytes past 16
    (2, 4096, False, True, False),    # a gather: no 16-byte loads
    (3, 60, False, False, False)])    # warp plan of k = 2
def test_kernel_args_pick_16_byte_accesses(B, N, slice_, use_order, vec):
    if slice_:
        cap = torch.ones(N + 1, dtype=I32)[1:]
    else:
        cap = _cap(*((N,) if B == 1 else (B, N)))
    order = (torch.argsort(cap, dim=-1, stable=True) if use_order
             else None)
    pl = wf.plan(B, N, 1)
    args = wf.kernel_args(cap, 1, order, torch.empty_like(cap), None, pl,
                          False)
    assert bool(args[8] & wf.VEC_BIT) == vec


@pytest.mark.parametrize("shape", [(1, 1), (3, 10), (4, 33), (2, 300), (50,)])
@pytest.mark.parametrize("trial", range(2))
def test_waterfill_order_is_the_pallas_give(shape, trial):
    """``waterfill_ref(..., order=argsort(prio))`` and the wrapper on the
    CPU give what the JAX package's ``_pallas_give`` (the Pallas kernel
    in interpret mode) and the bisection give do, slot for slot, for
    targets below, inside and above the row totals."""
    rng = np.random.default_rng(300 + 7 * trial + shape[-1])
    prio = rng.integers(-4, 5, shape).astype(np.int32)
    room = (rng.integers(0, 6, shape)
            * (rng.random(shape) < 0.7)).astype(np.int32)
    total = room.sum(axis=-1)
    idle = np.asarray(rng.random(total.shape) * 1.3 * total
                      + rng.integers(-2, 2)).astype(np.int32)
    ref = np.asarray(jp._pallas_give(jnp.asarray(prio), jnp.asarray(room),
                                     jnp.asarray(idle), interpret=True))
    tprio, troom, tidle = (torch.from_numpy(np.array(a))
                           for a in (prio, room, idle))
    order = torch.argsort(tprio, dim=-1, stable=True)
    np.testing.assert_array_equal(waterfill_ref(troom, tidle, order).numpy(),
                                  ref)
    np.testing.assert_array_equal(wf.waterfill(troom, tidle, order).numpy(),
                                  ref)
    np.testing.assert_array_equal(
        wf.greedy_give_waterfill(tprio, troom, tidle).numpy(), ref)
    bis = tp.give_asc_prefix(tprio, troom, tidle, -5, 5)
    np.testing.assert_array_equal(bis.numpy(), ref)
