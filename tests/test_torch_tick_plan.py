"""The tick kernel's launch plan and argument preparation, on the CPU.

``repro_torch.kernels.schedule_tick.plan`` is what ``csrc/schedule_tick.cu``
launches: these tests hold it to the card's limits on every window the
engine's ladder can reach, pin where each tier starts, and replay the
kernel's map of slots to threads.  ``kernel_args`` is the wrapper's
argument preparation, which must hand the caller's tensors to the kernel
without a copy.  The kernel itself is held to its plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.passes import PassParams  # noqa: E402
from repro_torch.kernels import schedule_tick as st  # noqa: E402
from repro_torch.sweep.batch import window_ladder  # noqa: E402

N_EAGLE = 143_829   # the largest trace: the ladder's top rung
EXTRA_WIDTHS = (1, 24, 129, 255, 257, 1023, 2047, 4095, 4097, 32_767,
                32_769, 65_536)


def owned_slots(p, W):
    """How many times the kernel's map (``first = rank * span + t * k``,
    slots ``first + j`` below the CTA's end) hands each of one lane's W
    slots to a thread."""
    span = -(-W // p.cluster)
    count = np.zeros(W, dtype=np.int64)
    for rank in range(p.cluster):
        lo, hi = rank * span, min((rank + 1) * span, W)
        slots = (lo + np.arange(p.threads)[:, None] * p.k
                 + np.arange(p.k)[None, :]).ravel()
        np.add.at(count, slots[slots < hi], 1)
    return count


@pytest.mark.parametrize("B", [1, 16, 31, 64])
def test_tick_plan_fits_the_card_on_every_rung(B):
    """Threads a multiple of 32 and at most 512 (1,024 is the card's
    limit), shared memory within 232,448 bytes, at most 8 CTAs a lane, the
    code the C entry point decodes, and every slot owned exactly once."""
    for W in window_ladder(128, N_EAGLE) + EXTRA_WIDTHS:
        p = st.plan(B, W)
        assert p.tier in st.TIERS
        assert p.threads % 32 == 0 and 32 <= p.threads <= st.MAX_THREADS
        assert p.smem <= st.MAX_SMEM_BYTES
        assert 1 <= p.cluster <= st.MAX_CLUSTER
        assert (p.tier == "cluster") == (p.cluster > 1) or p.tier == "global"
        assert p.tier != "warp" or (p.threads, p.cluster) == (32, 1)
        assert p.scratch == (B * p.cluster * p.threads * p.k * st.SLOT_BYTES
                             if p.tier == "global" else 0)
        assert np.array_equal(owned_slots(p, W), np.ones(W, np.int64)), W
        code = p.code
        assert (st.TIERS[code & 3], (code >> 2) & 15, ((code >> 6) & 63) * 32,
                (code >> 12) & 0xFFFF) == (p.tier, p.cluster, p.threads, p.k)
        # the bytes schedule_tick_smem() gives the launch
        per_slot = p.threads * p.k * st.SLOT_BYTES
        assert p.smem == {"warp": per_slot, "global": st.PART_BYTES}.get(
            p.tier, st.PART_BYTES + per_slot)


@pytest.mark.parametrize("B,W,tier,cluster,threads,k", [
    (31, 128, "warp", 1, 32, 4),            # theta's main-path call
    (1, 24, "warp", 1, 32, 4),
    (64, 129, "warp", 1, 32, 8),
    (64, 256, "warp", 1, 32, 8),
    (64, 257, "cta", 1, 64, 8),
    (64, 1000, "cta", 1, 128, 8),
    (1, 2048, "cta", 1, 256, 8),            # a row one CTA holds stays whole
    (16, 4096, "cta", 1, 512, 8),
    (1, 4097, "cluster", 2, 288, 8),        # past one CTA's 4,096 slots
    (64, 4097, "cluster", 2, 288, 8),
    (1, 8192, "cluster", 4, 256, 8),        # split while CTAs keep 2,048
    (16, 16_384, "cluster", 8, 256, 8),     # haswell's peak window
    (31, 16_384, "cluster", 4, 512, 8),     # 31 x 8 CTAs would pass 132
    (1, 16_384, "cluster", 8, 256, 8),
    (16, 32_768, "cluster", 8, 512, 8),
    (16, 32_769, "global", 8, 512, 9),      # past 8 CTAs' shared memory
    (2, 65_536, "global", 8, 512, 16),
    (64, N_EAGLE, "global", 2, 512, 141),
    (1, N_EAGLE, "global", 8, 512, 36),
])
def test_tick_plan_tier_boundaries(B, W, tier, cluster, threads, k):
    p = st.plan(B, W)
    assert (p.tier, p.cluster, p.threads, p.k) == (tier, cluster, threads, k)


def _tick_inputs(B=3, W=40, lanes=None):
    rng = np.random.default_rng(0)
    shape = (B, W) if lanes is None else tuple(lanes) + (W,)

    def i32(lo, hi, s=shape):
        return torch.from_numpy(rng.integers(lo, hi, s).astype(np.int32))

    def f32(s=shape):
        return torch.from_numpy(rng.uniform(0.5, 2.0, s).astype(np.float32))

    mn = i32(1, 4)
    p = PassParams(torch.from_numpy(rng.random(shape) < 0.5), mn, mn + 3,
                   mn + 1, mn, mn, i32(0, 3), f32(), f32())
    lane_shape = shape[:-1]
    return (p, i32(0, 4), i32(0, 5), f32(), f32(),
            torch.from_numpy(rng.random(lane_shape + (1,)) < 0.8),
            i32(5, 30, lane_shape), f32(lane_shape))


def test_tick_kernel_args_copy_nothing():
    """Rows that already have the kernel's dtype and layout reach it as
    they are: a bool row is read as its bytes in place, and ``act`` of
    shape ``(B, 1)`` (the engine's ``halted[:, None]``) as one flag a
    lane."""
    p, state, alloc, rem, start, act, cap, t_now = _tick_inputs()
    depth = torch.full((3,), 2, dtype=torch.int32)
    rows, act_lane, B = st.kernel_args(p, state, alloc, rem, start, act, cap,
                                       t_now, depth)
    given = [state, alloc, rem, start, act, p.malleable, p.want, p.floor,
             p.shrink_floor, p.prio_ref, p.max_nodes, p.pfrac, p.wall_work,
             cap, t_now, depth]
    assert [r.data_ptr() for r in rows] == [g.data_ptr() for g in given]
    assert rows[4].dtype == rows[5].dtype == torch.uint8
    assert (act_lane, B) == (1, 3)
    # a full act row is read in place too, and no depth gives None
    full = act.expand(3, 40).contiguous()
    rows, act_lane, _ = st.kernel_args(p, state, alloc, rem, start, full,
                                       cap, t_now)
    assert act_lane == 0 and rows[4].data_ptr() == full.data_ptr()
    assert rows[-1] is None


def test_tick_kernel_args_flatten_lanes_as_views():
    p, state, alloc, rem, start, act, cap, t_now = _tick_inputs(
        W=16, lanes=(2, 3))
    rows, act_lane, B = st.kernel_args(p, state, alloc, rem, start, act, cap,
                                       t_now)
    assert (act_lane, B) == (1, 6)
    assert rows[4].shape == (2, 3) and rows[4].data_ptr() == act.data_ptr()
    assert rows[13].data_ptr() == cap.data_ptr()


@pytest.mark.parametrize("bad", ["alloc_i64", "state_strided", "pfrac_f64",
                                 "act_wide", "act_lanes", "capacity_shape"])
def test_tick_kernel_args_refuse_other_dtypes_and_layouts(bad):
    """The kernel reads raw pointers, so any other dtype or layout raises
    instead of being converted behind the caller's back."""
    p, state, alloc, rem, start, act, cap, t_now = _tick_inputs()
    if bad == "alloc_i64":
        alloc = alloc.long()
    elif bad == "state_strided":
        state = torch.zeros((3, 80), dtype=torch.int32)[:, ::2]
    elif bad == "pfrac_f64":
        p = p._replace(pfrac=p.pfrac.double())
    elif bad == "act_wide":
        act = act.expand(3, 2)
    elif bad == "act_lanes":
        # (B,) would line up with the slots under broadcasting, not lanes
        act = act[:, 0]
    else:
        cap = cap[:2]
    with pytest.raises(ValueError):
        st.kernel_args(p, state, alloc, rem, start, act, cap, t_now)
