"""The SSD scan's backward kernels' own source run on the CPU under the
host emulation.

``csrc/ssd_scan_bwd.cu`` (its ``extern __shared__`` arrays pointed at the
emulated CTA's memory) and ``csrc/bindings.cpp`` are compiled with the
host's C++20 compiler against ``tests/host_cuda/`` (a ``std::thread`` per
CUDA thread, ``std::barrier`` for ``__syncthreads``, warp shuffles through
the warp's array, tensor-core products from the lanes' fragments), and the
library's ``repro_ssd_scan_bwd`` (all three kernels) is called with the arguments the wrapper passes on CPU tensors:
the saved states the forward's scratch would hold (computed here in
float64), the plans :func:`~repro_torch.kernels.ssd_scan.bwd_plan` picks
and hand-made head groupings, f32 and bf16, ragged last chunks, widths
that are not multiples of 4, with and without an initial state and a pull
on the final state.  Every output is held to ``ssd_bwd_ref`` within
``BWD_TOL`` of its largest |ref| and to the same bits on a second launch
with the grid run all at once.  Each launch runs under a time limit, so a
barrier that never opens fails the test instead of hanging the suite.
This checks the kernels' logic; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` check them on the card.  Skips where no C++ compiler is
found.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ref import ssd_bwd_ref  # noqa: E402

HOST = build.CSRC.parents[3] / "tests" / "host_cuda"
SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem[];"
TIME_LIMIT_S = 120.0
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
F32, BF16 = torch.float32, torch.bfloat16
NAMES = ("dx", "ddt", "da", "db", "dc", "dinit")


class HostLib:
    def __init__(self, so):
        self.fn = so.repro_ssd_scan_bwd
        self.fn.argtypes = build._SIGNATURES["repro_ssd_scan_bwd"]
        self.fn.restype = ctypes.c_int
        self.config = so.repro_emu_config
        self.config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
        self.config.restype = None


@pytest.fixture(scope="module")
def ssd_lib():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host emulation")
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    assert SMEM_DECL in src
    src = src.replace(SMEM_DECL, "unsigned char* smem = emu::dynamic_smem();")
    h = hashlib.sha256(src.encode())
    for f in [build.CSRC / "bindings.cpp", build.CSRC / "kernels.h",
              build.CSRC / "dtype.cuh", build.CSRC / "ssd_mma.cuh",
              *sorted(HOST.iterdir())]:
        h.update(f.read_bytes())
    out = build.build_dir().parent / "host_cuda"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libssd_bwd_host_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        cpp = out / f"ssd_scan_bwd.{os.getpid()}.cpp"
        cpp.write_text(src)
        tmp = out / f"{lib.name}.{os.getpid()}.tmp"
        try:
            done = subprocess.run(
                [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                 "-Wno-unknown-pragmas", "-DREPRO_EMU_SSD_SCAN_BWD", "-I",
                 str(HOST), "-I", str(build.CSRC), str(cpp),
                 str(build.CSRC / "bindings.cpp"), str(HOST / "others.cpp"),
                 str(HOST / "no_schedule_tick.cpp"),
                 str(HOST / "no_waterfill.cpp"),
                 str(HOST / "no_rmsnorm.cpp"),
                 str(HOST / "no_rmsnorm_bwd.cpp"), "-o", str(tmp)],
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


def launch(lib, args):
    """``lib.fn(*args, None)`` in a thread joined within TIME_LIMIT_S: a
    launch whose barriers never open fails instead of hanging."""
    out = []
    th = threading.Thread(target=lambda: out.append(lib.fn(*args, None)),
                          daemon=True)
    th.start()
    th.join(TIME_LIMIT_S)
    assert not th.is_alive(), "the emulated launch did not end"
    return out[0]


def case(seed, bsz, s, h, p, n, dtype, init):
    """Seeded inputs, the outputs' gradients and an initial state (or
    None), made with numpy."""
    rng = np.random.default_rng(seed)

    def f(*shape, lo=None, hi=None):
        v = (rng.standard_normal(shape) if lo is None
             else rng.uniform(lo, hi, shape))
        return torch.tensor(v, dtype=torch.float32)

    x, b, c = f(bsz, s, h, p), f(bsz, s, n), f(bsz, s, n)
    dt = f(bsz, s, h, lo=0.05, hi=0.6)
    a = f(h, lo=0.5, hi=3.0)
    dy, dstate = f(bsz, s, h, p), f(bsz, h, p, n)
    i0 = f(bsz, h, p, n) if init else None
    return ((x.to(dtype), dt.to(dtype), a, b.to(dtype), c.to(dtype)), dy,
            dstate, i0)


def saved_states(x, dt, a, b, c, L, init):
    """What the forward's scratch holds at chunk ``L``: the states before
    each chunk (B, NC, H, P, N) then the chunks' last cumsums (B, NC, H),
    f32, computed in float64."""
    x, dt, b, c = (t.double() for t in (x, dt, b, c))
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // L)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float64)
             if init is None else init.double())
    before, last = [], []
    for ci in range(nc):
        sl = slice(ci * L, min(s, ci * L + L))
        cum = torch.cumsum(-a.double() * dt[:, sl], dim=1)      # (B, l, H)
        tail = torch.exp(cum[:, -1:] - cum) * dt[:, sl]
        sc = torch.einsum("blh,blhp,bln->bhpn", tail, x[:, sl], b[:, sl])
        before.append(state)
        last.append(cum[:, -1])
        state = state * torch.exp(cum[:, -1])[..., None, None] + sc
    return torch.cat([torch.stack(before, 1).reshape(-1),
                      torch.stack(last, 1).reshape(-1)]).float()


def run_host(lib, ins, dy, dstate, init, L, groups, dtype_code=None):
    """The emulated launch's error code and (dx, ddt, da, db, dc, dinit),
    each starting as NaN, so an element the launch does not write fails
    the comparison; the scratch starts as NaN too.  ``dtype_code``: the
    C code passed, by default x's."""
    x, dt, a, b, c = ins
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    states = saved_states(x, dt, a, b, c, L, init)
    scratch = torch.full((ss.bwd_scratch_floats(bsz, s, h, p, n, L, groups),),
                         float("nan"))
    outs = [torch.full_like(t, float("nan")) for t in (x, dt)]
    outs.append(torch.full((h,), float("nan")))
    outs += [torch.full_like(t, float("nan")) for t in (b, c)]
    outs.append(None if init is None else torch.full((bsz, h, p, n),
                                                     float("nan")))
    # the C entry point's order: dx, ddt, db, dc, da, dinit
    ptr = [None if t is None else t.data_ptr()
           for t in (outs[0], outs[1], outs[3], outs[4], outs[2], outs[5])]
    err = launch(lib, (
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), states.data_ptr(),
        *ptr, scratch.data_ptr(), bsz, s, h, p, n, L, groups,
        build.dtype_code(x.dtype) if dtype_code is None else dtype_code))
    return err, outs


def check(lib, ins, dy, dstate, init, L, groups):
    err, outs = run_host(lib, ins, dy, dstate, init, L, groups)
    assert err == 0, err
    ref = ssd_bwd_ref(*ins, dy, dstate, chunk=L, initial_state=init)
    for name, got, r in zip(NAMES, outs, ref):
        if got is None:
            continue
        want = torch.float32 if name in ("da", "dinit") else ins[0].dtype
        assert got.dtype == want, name
        bad = float((got.double() - r.double()).abs().max())
        big = float(r.double().abs().max())
        assert bad <= BWD_TOL[ins[0].dtype] * big, (name, bad, big)
    return outs


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bsz,s,h,p,n,chunk,init,pull", [
    (2, 40, 3, 8, 16, 16, False, True),    # ragged last chunk of 8
    (1, 37, 2, 5, 6, 16, True, True),      # P, N not multiples of 4
    (1, 24, 4, 8, 8, 8, True, False),      # no pull on the final state
    (2, 9, 2, 4, 12, 128, False, False),   # one chunk shorter than 128
    (1, 70, 2, 64, 64, 64, True, True),    # zamba2's widths, 2 chunks
    (1, 40, 1, 64, 128, 64, False, True)])  # mamba2's dstate
def test_ssd_bwd_source_matches_plain_in_the_planned_launch(
        ssd_lib, dtype, bsz, s, h, p, n, chunk, init, pull):
    ins, dy, dstate, i0 = case(s * h + p, bsz, s, h, p, n, dtype, init)
    pl = ss.bwd_plan(bsz, s, h, p, n, chunk)
    dstate = dstate if pull else None
    outs = check(ssd_lib, ins, dy, dstate, i0, pl.chunk, pl.groups)
    ssd_lib.config(1, 0, TIME_LIMIT_S)
    try:
        err, again = run_host(ssd_lib, ins, dy, dstate, i0, pl.chunk,
                              pl.groups)
    finally:
        ssd_lib.config(0, 0, TIME_LIMIT_S)
    assert err == 0
    for got, g2 in zip(outs, again):
        assert got is None or torch.equal(got, g2)


@pytest.mark.parametrize("groups", [1, 2, 5])
def test_ssd_bwd_source_sums_head_groups_in_order(ssd_lib, groups):
    """A chunk's heads split into 1, 2 or 5 groups (5 heads): dB, dC and da
    the same within tolerance whatever the split."""
    ins, dy, dstate, i0 = case(groups, 1, 20, 5, 8, 8, F32, True)
    check(ssd_lib, ins, dy, dstate, i0, 8, groups)


def test_ssd_bwd_source_refuses_what_it_cannot_run(ssd_lib):
    """Head groups outside 1..H, a chunk outside 1..64, a dtype other than
    f32 / bf16, null states or scratch: the launch is refused before any
    kernel runs (the outputs stay NaN)."""
    ins, dy, dstate, _ = case(0, 1, 8, 2, 4, 4, F32, False)
    for L, groups, code in ((8, 0, None), (8, 3, None), (8, 1, 2)):
        err, outs = run_host(ssd_lib, ins, dy, dstate, None, L, groups,
                             code)
        assert err != 0 and torch.isnan(outs[0]).all(), (L, groups, code)
    for L in (0, 65, 8):
        assert launch(ssd_lib, (None,) * 15 + (1, 8, 2, 4, 4, L, 1, 0)) != 0
