"""The CUDA tick kernel's own source, run on the CPU under a host emulation.

``tests/host_cuda/`` stands in for the CUDA runtime: every CUDA thread is
a ``std::thread``, and warp shuffles and reductions, CTA barriers and
cluster barriers go through ``std::barrier``.  ``csrc/schedule_tick.cu``
(its ``extern __shared__`` array pointed at the emulated CTA's memory) and
``csrc/bindings.cpp`` are compiled with the host's C++20 compiler against
it, and the library's ``repro_schedule_tick`` is called with the arguments
the wrapper passes, on CPU tensors, in every tier of the plan -- the
cluster and global tiers also through small hand-made plans -- and held
bit for bit to ``schedule_tick_ref``.  This checks the kernel's logic;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` check it on the card.
Skips where no C++ compiler is found.
"""
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.passes import PassParams  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import schedule_tick as st  # noqa: E402
from repro_torch.kernels.ref import schedule_tick_ref  # noqa: E402

HOST = pathlib.Path(__file__).resolve().with_name("host_cuda")
SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem[];"


@pytest.fixture(scope="module")
def tick_lib():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host emulation")
    src = (build.CSRC / "schedule_tick.cu").read_text()
    assert SMEM_DECL in src
    src = src.replace(SMEM_DECL,
                      "unsigned char* smem = emu::dynamic_smem();")
    h = hashlib.sha256(src.encode())
    for f in [build.CSRC / "bindings.cpp", build.CSRC / "kernels.h",
              *sorted(HOST.iterdir())]:
        h.update(f.read_bytes())
    out = build.build_dir().parent / "host_cuda"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libtick_host_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        cpp = out / f"schedule_tick.{os.getpid()}.cpp"
        cpp.write_text(src)
        tmp = out / f"{lib.name}.{os.getpid()}.tmp"
        try:
            done = subprocess.run(
                [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                 "-Wno-unknown-pragmas", "-I", str(HOST), "-I",
                 str(build.CSRC), str(cpp), str(build.CSRC / "bindings.cpp"),
                 str(HOST / "others.cpp"), str(HOST / "no_waterfill.cpp"),
                 str(HOST / "no_rmsnorm.cpp"),
                 str(HOST / "no_rmsnorm_bwd.cpp"),
                 "-o", str(tmp)],
                capture_output=True, text=True)
            if done.returncode != 0 and "barrier" in done.stderr:
                pytest.skip(f"{cxx} has no C++20 <barrier>")
            assert done.returncode == 0, done.stderr[-4000:]
            os.replace(tmp, lib)
        finally:
            cpp.unlink(missing_ok=True)
            tmp.unlink(missing_ok=True)
    so = ctypes.CDLL(str(lib))
    so.repro_abi.restype = ctypes.c_char_p
    assert so.repro_abi().decode() == build.expected_abi()
    fn = so.repro_schedule_tick
    fn.argtypes = build._SIGNATURES["repro_schedule_tick"]
    fn.restype = ctypes.c_int
    return fn


def tight_case(rng, B, W):
    """Lanes with few free nodes and a blocked head, end estimates that tie,
    short and long jobs on both sides of the shadow time: every branch of
    the pass acts (the shadow, all three fill classes, shrink, expand)."""
    state = rng.choice(4, size=(B, W), p=[0.05, 0.55, 0.35, 0.05])
    big = rng.random((B, W)) < rng.uniform(0.05, 0.5, (B, 1))
    mn = np.where(big, rng.integers(8, 40, (B, W)), rng.integers(1, 4, (B, W)))
    mx = mn + rng.integers(0, 3 * mn + 2)
    want = np.minimum(mn + rng.integers(0, 2 * mn + 1), mx)
    alloc = np.where(state == 2, np.maximum(want + rng.integers(-2, 3, (B, W)),
                                            1), 0)
    busy = np.where(state == 2, alloc, 0).sum(-1)
    cap = busy + rng.integers(0, 40, B) * rng.integers(0, 2, B)
    wall = np.where(rng.random((B, W)) < 0.5, rng.uniform(5, 50, (B, W)),
                    rng.uniform(100, 5000, (B, W)))

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    p = PassParams(torch.from_numpy(rng.random((B, W)) < 0.6), i32(mn),
                   i32(mx), i32(want), i32(mn),
                   i32(np.maximum(mn - rng.integers(0, 3, (B, W)), 1)),
                   i32(mn + rng.integers(0, 4, (B, W))),
                   f32(rng.choice([0.5, 0.9, 0.99], size=(B, W))), f32(wall))
    args = (p, i32(state), i32(alloc),
            f32(rng.choice([0.05, 0.2, 0.5, 0.9], size=(B, W))),
            f32(np.where(state == 2, rng.uniform(0.0, 40.0, (B, W)), np.nan)),
            torch.from_numpy((rng.random(B) < 0.9)[:, None]), i32(cap),
            f32(rng.uniform(30.0, 60.0, B)))
    prio_lo = -int(p.prio_ref.max())
    prio_hi = int((p.max_nodes - p.prio_ref).max())
    return args, prio_lo, prio_hi


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def run_host(fn, case, depth, pl=None, fill_rounds=2, full_act=False):
    """The emulated launch's error code, its outputs and the plain pass's."""
    (p, state, alloc, rem, start, act, cap, t_now), lo, hi = case
    B, W = state.shape
    if full_act:
        act = act.expand(B, W).contiguous()
    d = None if depth is None else torch.full((B,), depth, dtype=torch.int32)
    kw = dict(fill_rounds=fill_rounds, prio_lo=lo, prio_hi=hi,
              shadow_iters=26, backfill_depth=d)
    ref = schedule_tick_ref(p, state, alloc, rem, start, act, cap, t_now,
                            **kw)
    rows, act_lane, nb = st.kernel_args(p, state, alloc, rem, start, act,
                                        cap, t_now, d)
    pl = pl or st.plan(B, W)
    outs = [torch.empty_like(state), torch.empty_like(alloc),
            torch.empty_like(start)]
    scratch = (torch.empty(pl.scratch, dtype=torch.uint8) if pl.scratch
               else None)
    err = fn(*(None if t is None else t.data_ptr() for t in rows),
             *(o.data_ptr() for o in outs),
             None if scratch is None else scratch.data_ptr(), nb, W,
             act_lane, pl.code, fill_rounds, lo, hi, 26,
             *st.bisect_bounds(lo, hi), None)
    return err, outs, ref


def run_and_compare(fn, case, depth, pl=None, **kw):
    err, outs, ref = run_host(fn, case, depth, pl, **kw)
    assert err == 0
    for g, r, name in zip(outs, ref, ("state", "alloc", "start_t")):
        assert torch.equal(_bits(g), _bits(r)), (name, pl)


@pytest.mark.parametrize("B,W", [(5, 24), (6, 200), (3, 700), (1, 4097)])
@pytest.mark.parametrize("depth", [None, 2])
def test_tick_source_matches_plain_in_the_planned_tier(tick_lib, B, W,
                                                       depth):
    """Warp (W <= 256), CTA and cluster tiers as :func:`plan` picks them
    (1 x 4,097 is a cluster of two CTAs)."""
    rng = np.random.default_rng(100 * W + B)
    for _ in range(2):
        run_and_compare(tick_lib, tight_case(rng, B, W), depth)


@pytest.mark.parametrize("B,W,tier,cluster,threads,k", [
    (2, 500, "cluster", 4, 32, 8), (3, 300, "cluster", 2, 32, 8),
    (2, 700, "global", 4, 64, 3), (3, 200, "global", 1, 32, 7)])
def test_tick_source_matches_plain_in_small_plans(tick_lib, B, W, tier,
                                                  cluster, threads, k):
    """The cluster and global tiers at small widths: the code paths the
    card takes for haswell's and eagle's windows (partials read across
    the cluster, rows in a device-memory scratch, k from the plan)."""
    rng = np.random.default_rng(7 * W + cluster)
    pl = st.make_plan(B, tier, threads, k, cluster)
    for depth in (None, 1):
        run_and_compare(tick_lib, tight_case(rng, B, W), depth, pl)


@pytest.mark.parametrize("fill_rounds", [0, 1, 3])
def test_tick_source_matches_plain_for_other_fill_rounds(tick_lib,
                                                         fill_rounds):
    rng = np.random.default_rng(fill_rounds)
    run_and_compare(tick_lib, tight_case(rng, 6, 100), 2,
                    fill_rounds=fill_rounds)
    run_and_compare(tick_lib, tight_case(rng, 3, 300), None,
                    fill_rounds=fill_rounds)


def test_tick_source_reads_a_full_act_row(tick_lib):
    rng = np.random.default_rng(5)
    run_and_compare(tick_lib, tight_case(rng, 4, 130), None, full_act=True)
    run_and_compare(tick_lib, tight_case(rng, 2, 400), 2, full_act=True)


def test_tick_source_refuses_a_plan_that_misses_slots(tick_lib):
    """The C launch re-checks the plan: too few threads for the row is
    refused (cudaErrorInvalidValue), not run."""
    case = tight_case(np.random.default_rng(1), 2, 600)
    err, _, _ = run_host(tick_lib, case, None,
                         st.make_plan(2, "cluster", 32, 8, 2))
    assert err == 1
