"""The CUDA waterfill kernel's own source, run on the CPU under a host
emulation.

``tests/host_cuda/`` stands in for the CUDA runtime (a ``std::thread`` per
CUDA thread; shuffles, votes and barriers through ``std::barrier``; the
look-back's atomics through ``std::atomic_ref``).  ``csrc/waterfill.cu``
(its ``extern __shared__`` array pointed at the emulated CTA's memory) and
``csrc/bindings.cpp`` are compiled with the host's C++20 compiler against
it, and the library's ``repro_waterfill`` is called with the arguments the
wrapper passes (:func:`repro_torch.kernels.waterfill.kernel_args`), on CPU
tensors, in every tier of the plan -- the look-back tier also through small
hand-made plans of 2, 3 and 37 tiles, with the grid run one CTA at a time
and all at once -- and held bit for bit to ``waterfill_ref``.  Each launch
has a time limit: a look-back that waits on a tile which never publishes
returns an error instead of hanging the suite.  This checks the kernel's
logic; ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` check it on the
card.  Skips where no C++ compiler is found.
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

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import waterfill as wf  # noqa: E402
from repro_torch.kernels.ref import waterfill_ref  # noqa: E402

HOST = pathlib.Path(__file__).resolve().with_name("host_cuda")
SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem[];"
TIME_LIMIT_S = 30.0
# a stale descriptor: flag "inclusive prefix", value 5 (what a launch that
# skipped its reset would find from an earlier one)
STALE_WORD = (2 << 32) | 5


class HostLib:
    def __init__(self, so):
        self.fn = so.repro_waterfill
        self.fn.argtypes = build._SIGNATURES["repro_waterfill"]
        self.fn.restype = ctypes.c_int
        self.config = so.repro_emu_config
        self.config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
        self.config.restype = None


@pytest.fixture(scope="module")
def wf_lib():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host emulation")
    src = (build.CSRC / "waterfill.cu").read_text()
    assert SMEM_DECL in src
    src = src.replace(SMEM_DECL, "unsigned char* smem = emu::dynamic_smem();")
    h = hashlib.sha256(src.encode())
    for f in [build.CSRC / "bindings.cpp", build.CSRC / "kernels.h",
              build.CSRC / "block.cuh", *sorted(HOST.iterdir())]:
        h.update(f.read_bytes())
    out = build.build_dir().parent / "host_cuda"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libwaterfill_host_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        cpp = out / f"waterfill.{os.getpid()}.cpp"
        cpp.write_text(src)
        tmp = out / f"{lib.name}.{os.getpid()}.tmp"
        try:
            done = subprocess.run(
                [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                 "-Wno-unknown-pragmas", "-I", str(HOST), "-I",
                 str(build.CSRC), str(cpp), str(build.CSRC / "bindings.cpp"),
                 str(HOST / "others.cpp"), str(HOST / "no_schedule_tick.cpp"),
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
    host = HostLib(so)
    host.config(0, 0, TIME_LIMIT_S)
    return host


def run_host(lib, cap, target, order=None, pl=None, sms=132, scratch=None):
    """The emulated launch's error code and output (every slot of which
    the launch must write: it starts as -7)."""
    B, N, shared = wf.check_args(cap, target, order)
    pl = pl or wf.plan(B, N, sms)
    out = torch.full_like(cap, -7)
    if scratch is None and pl.scratch:
        scratch = torch.full((pl.scratch,), STALE_WORD, dtype=torch.int64)
    err = lib.fn(*wf.kernel_args(cap, target, order, out, scratch, pl,
                                 shared), None)
    return err, out


def check(lib, cap, target, order=None, pl=None, **kw):
    err, out = run_host(lib, cap, target, order, pl, **kw)
    assert err == 0, (err, pl)
    ref = waterfill_ref(cap, target, order)
    assert torch.equal(out, ref), (pl, int((out != ref).sum()))


def caps(rng, B, N):
    """Node counts with runs of zeros (rows that end early, slots that
    give nothing), as a (B, N) or, for B = 0, an (N,) int32 tensor."""
    shape = (N,) if B == 0 else (B, N)
    c = rng.integers(0, 9, size=shape) * (rng.random(shape) < 0.8)
    return torch.from_numpy(c.astype(np.int32))


def targets(rng, cap):
    """Every kind of target: Python ints (<= 0, mid-row, >= the total),
    per-row tensors (one that runs out in the row's last slots, where an
    error in any earlier tile's sum shows) and, for 2-D rows, one 0-d
    tensor for all."""
    total = cap.sum(dim=-1, dtype=torch.int32)
    mid = (torch.from_numpy(rng.random(total.shape)).float()
           * total.float()).to(torch.int32)
    t_all = int(total.min())
    out = [0, -3, t_all // 2, int(total.max()) + 17, mid, total - 3, total,
           total + 17, -1 - total]
    if cap.ndim == 2:
        out.append(torch.tensor(t_all // 3, dtype=torch.int32))
    return out


def orders(rng, cap):
    prio = torch.from_numpy(rng.integers(-4, 5, size=tuple(cap.shape)))
    return [None, torch.argsort(prio, dim=-1, stable=True)]


@pytest.mark.parametrize("B,N,sms,tier", [
    (5, 24, 132, "warp"), (6, 33, 132, "warp"), (31, 128, 132, "warp"),
    (9, 256, 2, "warp"), (0, 255, 132, "warp"),
    (3, 1000, 132, "cta"), (3, 1001, 132, "cta"), (0, 2999, 132, "cta"),
    (1, 4097, 132, "lookback"), (2, 4097, 1, "lookback"),
    (0, 5003, 132, "lookback")])
def test_waterfill_source_matches_plain_in_the_planned_tier(wf_lib, B, N,
                                                            sms, tier):
    """Every tier as :func:`plan` picks it (B = 0: one 1-D row), with every
    kind of target, with and without ``order``; rows of N % 4 != 0 and
    1-D rows take the scalar and the 16-byte paths."""
    wf_lib.config(0, 0, TIME_LIMIT_S)
    rng = np.random.default_rng(10 * N + B)
    cap = caps(rng, B, N)
    assert wf.plan(max(B, 1), N, sms).tier == tier
    for order in orders(rng, cap):
        for tgt in targets(rng, cap):
            check(wf_lib, cap, tgt, order, sms=sms)


@pytest.mark.parametrize("B,N,tiles", [(1, 200, 2), (1, 300, 3), (3, 300, 3),
                                       (1, 37 * 128 - 5, 37),
                                       (0, 37 * 128 - 4, 37)])
@pytest.mark.parametrize("all_at_once", [False, True])
def test_waterfill_source_looks_back_over_small_tiles(wf_lib, B, N, tiles,
                                                      all_at_once):
    """The look-back tier with tiles of 32 threads x 4 slots.  Run one CTA
    at a time, every tile finds its predecessor's prefix; run all at once
    with every release store delayed, tiles find aggregates only and look
    back further, past 32 tiles at 37."""
    wf_lib.config(int(all_at_once), 20_000 if all_at_once else 0,
                  TIME_LIMIT_S)
    try:
        rng = np.random.default_rng(N + B)
        cap = caps(rng, B, N)
        pl = wf.make_plan(max(B, 1), N, "lookback", 32, 4)
        assert pl.tiles == tiles
        for order in orders(rng, cap):
            for tgt in targets(rng, cap):
                check(wf_lib, cap, tgt, order, pl)
    finally:
        wf_lib.config(0, 0, TIME_LIMIT_S)


@pytest.mark.parametrize("B,N,tier,threads,k", [
    (7, 90, "warp", 96, 4),       # 3 rows a CTA, the last CTA part empty
    (2, 1000, "cta", 64, 16),     # two warps, 16-byte loads
    (3, 128, "cta", 32, 4),       # one warp scans a CTA of one warp
    (3, 130, "cta", 64, 4)])      # N % 4 != 0: scalar accesses
def test_waterfill_source_matches_plain_in_small_plans(wf_lib, B, N, tier,
                                                       threads, k):
    wf_lib.config(0, 0, TIME_LIMIT_S)
    rng = np.random.default_rng(B * N + k)
    cap = caps(rng, B, N)
    pl = wf.make_plan(B, N, tier, threads, k)
    for order in orders(rng, cap):
        for tgt in targets(rng, cap):
            check(wf_lib, cap, tgt, order, pl)


def test_waterfill_source_resets_its_scratch_in_every_launch(wf_lib):
    """Two launches in a row on one scratch (stale descriptors from the
    first, and a tile counter past the grid), then on a scratch filled
    with stale "inclusive" words: each result equals the plain version."""
    wf_lib.config(0, 0, TIME_LIMIT_S)
    rng = np.random.default_rng(3)
    pl = wf.make_plan(2, 700, "lookback", 32, 8)
    scratch = torch.full((pl.scratch,), STALE_WORD, dtype=torch.int64)
    for _ in range(3):
        cap = caps(rng, 2, 700)
        tgt = cap.sum(dim=-1, dtype=torch.int32) // 2
        check(wf_lib, cap, tgt, None, pl, scratch=scratch)
    assert int(scratch[0]) == pl.grid  # the last launch's tile counter


def test_waterfill_source_takes_a_misaligned_row(wf_lib):
    """A 1-D row that starts 4 bytes past a 16-byte boundary: the wrapper
    gives no 16-byte accesses, and the scalar path is exact."""
    wf_lib.config(0, 0, TIME_LIMIT_S)
    rng = np.random.default_rng(4)
    cap = caps(rng, 0, 3001)[1:]
    assert cap.data_ptr() % 16 == 4
    for tgt in (0, int(cap.sum()) // 2, int(cap.sum()) + 1):
        check(wf_lib, cap, tgt)


@pytest.mark.parametrize("tier,k,scratch,why", [
    ("warp", 2, False, "too few slots for the row"),
    ("warp", 12, False, "no warp kernel for k = 12"),
    ("cta", 8, False, "too few slots for the row"),
    ("lookback", 2, True, "no look-back kernel for k = 2"),
    ("lookback", 4, False, "no scratch")])
def test_waterfill_source_refuses_a_bad_plan(wf_lib, tier, k, scratch, why):
    """The C launch re-checks the plan and refuses (cudaErrorInvalidValue)
    what would miss slots or has no kernel, and runs nothing."""
    wf_lib.config(0, 0, TIME_LIMIT_S)
    cap = torch.ones((2, 300), dtype=torch.int32)
    pl = wf.make_plan(2, 300, tier, 32, k)
    buf = torch.zeros(pl.scratch or 1, dtype=torch.int64)
    out = torch.full_like(cap, -7)
    err = wf_lib.fn(*wf.kernel_args(cap, 5, None, out,
                                    buf if scratch else None, pl, False),
                    None)
    assert err == 1, why
    assert bool((out == -7).all())


@pytest.mark.parametrize("use_order", [False, True])
def test_waterfill_source_refuses_16_byte_access_it_cannot_make(wf_lib,
                                                                use_order):
    """The vector bit with ``order``, or on rows that do not start on 4
    ints, is refused by the C launch, not run."""
    wf_lib.config(0, 0, TIME_LIMIT_S)
    N = 304 if use_order else 302
    cap = torch.ones((2, N), dtype=torch.int32)
    order = torch.argsort(cap, dim=-1, stable=True) if use_order else None
    pl = wf.make_plan(2, N, "cta", 96, 4)
    args = list(wf.kernel_args(cap, 5, order, torch.empty_like(cap), None,
                               pl, False))
    assert not args[-1] & wf.VEC_BIT
    args[-1] |= wf.VEC_BIT
    assert wf_lib.fn(*args, None) == 1
