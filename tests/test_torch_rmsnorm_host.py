"""The RMSNorm backward kernel's own source run on the CPU under a host
emulation, and its launch plan.

``tests/host_cuda/`` stands in for the CUDA runtime (a ``std::thread`` per
CUDA thread; shuffles and barriers through ``std::barrier``; a cluster's
CTAs read each other's shared memory; ``cuda_bf16.h`` rounds to the
nearest even, as torch does).  ``csrc/rmsnorm_bwd.cu`` (its ``extern
__shared__`` arrays pointed at the emulated CTA's memory) and
``csrc/bindings.cpp`` are compiled with the host's C++20 compiler against
it, and the library's ``repro_rmsnorm_bwd`` (both of its kernels) is
called with the arguments the wrapper passes
(:func:`repro_torch.kernels.rmsnorm.bwd_kernel_args`) on CPU tensors: the
plans :func:`~repro_torch.kernels.rmsnorm.bwd_plan` picks on a card of 2-4
SMs, and hand-made plans of several clusters, f32 and bf16, odd widths,
rows fewer than a cluster and one row, rows walked twice (the widest the
forward takes, and small hand-made plans), held to ``rmsnorm_bwd_ref`` within
``BWD_TOL`` and to the same bits on a second launch and with the grid run
all at once.  Each launch runs under a time limit, so a barrier that never
opens fails the test instead of hanging the suite.  This checks the
kernel's logic; ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` check it
on the card.  Skips where no C++ compiler is found.
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

from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_bwd_ref  # noqa: E402

HOST = build.CSRC.parents[3] / "tests" / "host_cuda"
SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem[];"
TIME_LIMIT_S = 60.0
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
F32, BF16 = torch.float32, torch.bfloat16


# ------------------------------------------------------------------ plans
def norm_widths():
    """Every RMSNorm width of the registered configs, published and
    reduced: the model width, MLA's two latent norms, Mamba-2's inner
    width."""
    out = set()
    for arch in list_archs():
        for cfg in (get_config(arch), get_config(arch).reduced()):
            out.add(cfg.d_model)
            out.update(w for w in (cfg.q_lora, cfg.kv_lora) if w)
            if cfg.ssm_state:
                out.add(cfg.ssm_expand * cfg.d_model)
    return sorted(out)


def walk(plan, rows, d):
    """(times each row is walked, times each column is read in a row,
    times each column is folded into a partial row, times each column of
    dscale is written) under the kernel's index arithmetic for ``plan``."""
    vec, tpr = plan.vec, plan.row_threads
    stride = plan.ctas * (plan.threads // tpr)
    walked = np.zeros(rows, dtype=np.int64)
    for g in range(stride):
        walked[g::stride] += 1
    i = (np.arange(tpr)[:, None]
         + np.arange(plan.per_thread)[None, :] * tpr).ravel()
    i = i[i < d // vec]
    read = np.zeros(d, dtype=np.int64)
    np.add.at(read, (i[:, None] * vec + np.arange(vec)).ravel(), 1)
    folded = np.zeros((plan.partials, d), dtype=np.int64)
    span = -(-d // plan.cluster)
    for b in range(plan.ctas):
        rank = b % plan.cluster
        folded[b // plan.cluster, rank * span:(rank + 1) * span] += 1
    written = np.zeros(d, dtype=np.int64)
    if plan.partials == 1 and plan.depth:   # the cluster's fold writes dscale
        written += folded[0]
    else:                    # the column-sum kernel: 32 columns a CTA
        for b in range(-(-d // 32)):
            written[32 * b:32 * b + 32] += 1
    return walked, read, folded, written


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d,sms", [
    (2048, 2048, 132), (996, 2560, 132), (7, 2561, 132), (3, 20, 132),
    (33, 512, 132), (1, 5120, 132), (5, 600, 4), (40, 96, 2), (64, 613, 3),
    (9, 8192, 132)])
def test_rmsnorm_bwd_plan_covers_every_row_and_column_once(dtype, rows, d,
                                                           sms):
    """Each (row, column) read by one thread once, each column folded into
    its cluster's partial row once and written to dscale once; whole
    clusters, a grid of at most two CTAs an SM (one of more than 256
    threads), the CTA's shared memory and the held registers within the
    card's."""
    p = rn.bwd_plan(rows, d, dtype, F32, sms)
    for count in walk(p, rows, d):
        assert (count == 1).all()
    check_plan(p, dtype, sms)
    assert p.held_registers <= rn.BWD_HELD_REGISTERS and p.depth >= 2
    assert p.per_thread in rn.BWD_VECTORS[p.vec]


def check_plan(p, dtype, sms):
    """Whole clusters, a grid of at most two CTAs an SM (one of more than
    256 threads), the CTA's shared memory within the card's."""
    assert p.ctas % p.cluster == 0 and p.cluster in (1, 2, 4, 8)
    assert p.partials == p.ctas // p.cluster
    # a grid of more than one cluster takes clusters of 2 (the card spreads
    # them 2 an SM), a streamed one clusters of 1, and the column-sum
    # kernel adds ~32 partials at most in a row
    assert p.partials == 1 or p.cluster == (rn.BWD_CLUSTER if p.depth else 1)
    assert -(-p.partials // rn.BWD_DW_GROUPS) <= 33
    assert p.threads % 32 == 0 and 32 <= p.threads <= rn.BWD_MAX_THREADS
    assert p.row_threads in (32, p.threads)
    # the CTAs an SM fit its threads and its 65,536 registers (the kernels'
    # registers a thread from ptxas, or the launch bound's 128)
    regs = rn.BWD_REGISTERS.get((dtype.itemsize, p.vec, p.per_thread), 128)
    per_sm = max(1, min(rn.BWD_CTAS_PER_SM, 2048 // p.threads,
                        65536 // (p.threads * regs)))
    assert p.ctas <= max(per_sm * sms, p.cluster)
    assert p.smem_bytes <= rn.MAX_SMEM_BYTES


@pytest.mark.parametrize("dtype,rows,d,sms", [
    (F32, 3, 16388, 132), (F32, 300, 32768, 132), (F32, 2, 65536, 132),
    (BF16, 3, 16392, 132), (BF16, 200, 65536, 132), (BF16, 1, 131072, 132),
    (F32, 9, 32768, 2)])
def test_rmsnorm_bwd_plan_walks_rows_past_the_registers_twice(dtype, rows,
                                                              d, sms):
    """Rows wider than BWD_MAX_THREADS threads hold: a CTA a row (512
    threads), one CTA an SM, clusters of 1 and a partial row a CTA, no
    column sums in shared memory; every row and column once."""
    p = rn.bwd_plan(rows, d, dtype, F32, sms)
    assert (p.depth, p.threads, p.cluster, p.ctas, p.held_registers) == (
        0, rn.BWD_MAX_THREADS, 1, min(rows, sms), 0)
    assert p.smem_bytes == rn.BWD_SMEM_HEAD
    assert p.per_thread <= rn.BWD_STREAM_VECTORS
    for count in walk(p, rows, d):
        assert (count == 1).all()
    check_plan(p, dtype, sms)


def test_rmsnorm_bwd_plan_at_the_training_calls():
    """internvl2's training rows take two 16-byte vectors a thread: bf16
    128 threads a row, 4 CTAs an SM, f32 256 threads a row, 3 CTAs an SM,
    in clusters of 2 on 132 SMs; qwen2-72b's take 512 threads, one CTA an
    SM; 7 rows one cluster of 8 CTAs (no partial row to add up); odd widths
    take scalar accesses."""
    p = rn.bwd_plan(2048, 2048, BF16, F32, 132)
    assert (p.vec, p.per_thread, p.threads, p.ctas, p.cluster,
            p.partials) == (8, 2, 128, 528, 2, 264)
    p = rn.bwd_plan(2048, 2048, F32, F32, 132)
    assert (p.vec, p.per_thread, p.threads, p.partials) == (4, 2, 256, 198)
    p = rn.bwd_plan(2048, 8192, BF16, F32, 132)
    assert (p.threads, p.ctas, p.partials) == (512, 132, 66)
    p = rn.bwd_plan(7, 2561, F32, F32, 132)
    assert (p.ctas, p.cluster, p.partials) == (8, 8, 1)
    assert p.vec == 1
    assert rn.bwd_plan(8, 20, BF16, BF16, 132).vec == 1
    assert rn.bwd_plan(8, 2048, F32, F32, 132, aligned=False).vec == 1


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_rmsnorm_bwd_plan_takes_every_registered_width(dtype):
    widths = norm_widths()
    assert {2048, 2560, 4096, 5120, 8192, 512, 1536} <= set(widths)
    # and every width the forward takes, to its widest rows (16 bytes of x
    # and scalar accesses)
    widest = {a: rn.MAX_THREADS * rn.WIDE_ROW_VECTORS[-1]
              * (16 // dtype.itemsize if a else 1) for a in (True, False)}
    for d in widths:
        for wdtype in (F32, BF16):
            for rows in (1, 7, 2048):
                p = rn.bwd_plan(rows, d, dtype, wdtype, 132)
                assert p.row_threads * p.per_thread * p.vec >= d
                assert p.code == rn.bwd_pack(
                    dtype == BF16, wdtype == BF16, p.vec, p.per_thread,
                    p.cluster, p.threads, p.row_threads == 32, p.depth)
    for aligned, d in widest.items():
        rn.plan(d, dtype, F32, aligned)
        with pytest.raises(ValueError, match="wider"):
            rn.plan(d + 16, dtype, F32, aligned)
        for rows in (1, 7, 2048):
            p = rn.bwd_plan(rows, d, dtype, F32, 132, aligned)
            assert p.row_threads * p.per_thread * p.vec >= d
    # the streamed walk's widest rows: twice the forward's with 16 bytes
    with pytest.raises(ValueError, match="wider"):
        rn.bwd_plan(8, 2 * widest[True] + 16 // dtype.itemsize, dtype, F32,
                    132)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rn.bwd_plan(8, 64, torch.float16, F32, 132)


# ---------------------------------------------------------- host emulation
class HostLib:
    def __init__(self, so):
        self.fn = so.repro_rmsnorm_bwd
        self.fn.argtypes = build._SIGNATURES["repro_rmsnorm_bwd"]
        self.fn.restype = ctypes.c_int
        self.config = so.repro_emu_config
        self.config.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
        self.config.restype = None


@pytest.fixture(scope="module")
def norm_lib():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host emulation")
    src = (build.CSRC / "rmsnorm_bwd.cu").read_text()
    assert SMEM_DECL in src
    src = src.replace(SMEM_DECL, "unsigned char* smem = emu::dynamic_smem();")
    h = hashlib.sha256(src.encode())
    for f in [build.CSRC / "bindings.cpp", build.CSRC / "kernels.h",
              build.CSRC / "dtype.cuh", *sorted(HOST.iterdir())]:
        h.update(f.read_bytes())
    out = build.build_dir().parent / "host_cuda"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"librmsnorm_bwd_host_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        cpp = out / f"rmsnorm_bwd.{os.getpid()}.cpp"
        cpp.write_text(src)
        tmp = out / f"{lib.name}.{os.getpid()}.tmp"
        try:
            done = subprocess.run(
                [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                 "-Wno-unknown-pragmas", "-I", str(HOST), "-I",
                 str(build.CSRC), str(cpp), str(build.CSRC / "bindings.cpp"),
                 str(HOST / "others.cpp"), str(HOST / "no_schedule_tick.cpp"),
                 str(HOST / "no_waterfill.cpp"),
                 str(HOST / "no_rmsnorm.cpp"), "-o", str(tmp)],
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


def case(seed, rows, d, dtype, wdtype):
    gen = torch.Generator().manual_seed(seed)
    x, dy = (torch.randn((rows, d), generator=gen).to(dtype) for _ in "xy")
    w = torch.randn((d,), generator=gen).to(wdtype)
    return x, w, dy


def run_host(lib, x, w, dy, plan, eps=1e-6, partial=None):
    """The emulated launch's error code, dx and dscale (both start as
    NaN, so an element the launch does not write fails the comparison)."""
    dx = torch.full_like(x, float("nan"))
    dw = torch.full_like(w, float("nan"))
    if partial is None:   # stale partial rows, which the launch overwrites
        partial = torch.full((plan.partials, x.shape[-1]), 7.0)
    err = launch(lib, rn.bwd_kernel_args(x, w, dy, dx, dw, partial, plan,
                                         eps))
    return err, dx, dw


def check(lib, x, w, dy, plan):
    err, dx, dw = run_host(lib, x, w, dy, plan)
    assert err == 0, (err, plan)
    rdx, rdw = rmsnorm_bwd_ref(x, w, dy)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    for name, got, ref in (("dx", dx, rdx), ("dscale", dw, rdw)):
        bad = float((got.double() - ref.double()).abs().max())
        big = float(ref.double().abs().max())
        assert bad <= BWD_TOL[x.dtype] * big, (name, bad, big, plan)
    return dx, dw


def same_bits_all_at_once(lib, x, w, dy, plan, dx, dw):
    """A second launch, with every CTA of the grid run together, gives the
    same bits."""
    lib.config(1, 0, TIME_LIMIT_S)
    try:
        err, dx2, dw2 = run_host(lib, x, w, dy, plan)
    finally:
        lib.config(0, 0, TIME_LIMIT_S)
    assert err == 0
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("dtype,wdtype", [(F32, F32), (BF16, F32),
                                          (F32, BF16), (BF16, BF16)],
                         ids=["f32", "bf16", "f32-bf16w", "bf16-bf16w"])
@pytest.mark.parametrize("rows,d,sms", [
    (40, 96, 2),      # a warp a row, 8 rows a CTA, 16-byte accesses
    (12, 600, 2),     # a CTA a row (5 warps), 4 CTAs: one cluster
    (64, 613, 3),     # odd width: scalar accesses, 6 CTAs in one cluster
    (5, 600, 4),      # rows fewer than a cluster: 3 CTAs idle
    (1, 1000, 4),     # one row
    (3, 37, 2)])      # three rows of an odd width, one warp each
def test_rmsnorm_bwd_source_matches_plain_in_the_planned_launch(
        norm_lib, dtype, wdtype, rows, d, sms):
    norm_lib.config(0, 0, TIME_LIMIT_S)
    x, w, dy = case(rows * d + sms, rows, d, dtype, wdtype)
    plan = rn.bwd_plan(rows, d, dtype, wdtype, sms)
    dx, dw = check(norm_lib, x, w, dy, plan)
    same_bits_all_at_once(norm_lib, x, w, dy, plan, dx, dw)


@pytest.mark.parametrize("dtype,wdtype,rows,d", [
    (F32, F32, 3, 32768), (BF16, F32, 2, 65536), (BF16, BF16, 2, 65536)],
    ids=["f32", "bf16", "bf16-bf16w"])
def test_rmsnorm_bwd_source_takes_the_forwards_widest_rows(norm_lib, dtype,
                                                           wdtype, rows, d):
    """The widest rows the forward takes (32,768 f32, 65,536 bf16), in the
    planned launch on 2 SMs: walked twice, 512 threads a row."""
    norm_lib.config(0, 0, TIME_LIMIT_S)
    x, w, dy = case(rows * d, rows, d, dtype, wdtype)
    plan = rn.bwd_plan(rows, d, dtype, wdtype, 2)
    assert plan.depth == 0 and plan.threads == 512
    dx, dw = check(norm_lib, x, w, dy, plan)
    same_bits_all_at_once(norm_lib, x, w, dy, plan, dx, dw)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d,vec,k,threads,warp_rows,ctas,cluster", [
    (37, 256, 0, 1, 64, False, 8, 2),     # 4 clusters of 2: 4 partial rows
    (50, 200, 0, 2, 64, True, 6, 1),      # 6 clusters of 1, warp rows
    (30, 127, 1, 4, 96, True, 8, 4),      # scalar accesses, 2 clusters
    (17, 520, 0, 8, 32, False, 4, 2),     # the most a thread holds (f32)
    (9, 300, 1, 32, 32, False, 2, 2),     # 32 scalars a thread: one row
    (97, 256, 0, 1, 64, False, 2, 2),     # ~48 rows a CTA, two at a time
    (60, 128, 0, 1, 32, True, 20, 1)])    # 20 partial rows: 8 warps' sums
def test_rmsnorm_bwd_source_folds_several_clusters_in_order(
        norm_lib, dtype, rows, d, vec, k, threads, warp_rows, ctas, cluster):
    """Hand-made plans of several clusters: the partial rows and the
    column-sum kernel's fixed order, run one cluster at a time and all at
    once; one row at a time and two."""
    vec = vec or 16 // dtype.itemsize
    k = min(k, rn.BWD_VECTORS[vec][-1])
    norm_lib.config(0, 0, TIME_LIMIT_S)
    x, w, dy = case(rows + d, rows, d, dtype, F32)
    plan = rn.make_bwd_plan(rows, d, dtype, F32, vec, k, threads, warp_rows,
                            ctas, cluster)
    assert plan.partials == ctas // cluster
    dx, dw = check(norm_lib, x, w, dy, plan)
    same_bits_all_at_once(norm_lib, x, w, dy, plan, dx, dw)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d,scalar,threads,ctas", [
    (37, 600, False, 64, 3),    # ~12 rows a CTA into its partial row
    (9, 613, True, 32, 4),      # scalar accesses, a warp a CTA (no barrier)
    (5, 1000, False, 96, 5),    # a row a CTA
    (1, 256, False, 128, 1)])   # one row
def test_rmsnorm_bwd_source_walks_rows_twice_in_order(norm_lib, dtype, rows,
                                                      d, scalar, threads,
                                                      ctas):
    """Hand-made plans of the twice-walked route at small widths: each
    CTA's partial row over its rows, then the column-sum kernel; run one
    CTA at a time and all at once."""
    vec = 1 if scalar else 16 // dtype.itemsize
    norm_lib.config(0, 0, TIME_LIMIT_S)
    x, w, dy = case(rows * 3 + d, rows, d, dtype, F32)
    plan = rn.make_bwd_plan(rows, d, dtype, F32, vec,
                            -(-(d // vec) // threads), threads, False, ctas,
                            1, depth=0)
    assert plan.partials == ctas and plan.smem_bytes == rn.BWD_SMEM_HEAD
    dx, dw = check(norm_lib, x, w, dy, plan)
    same_bits_all_at_once(norm_lib, x, w, dy, plan, dx, dw)


@pytest.mark.parametrize("vec,k,threads,warp_rows,ctas,cluster,why", [
    (4, 1, 32, True, 2, 1, "too few threads for the row"),
    (4, 3, 64, False, 2, 1, "no kernel for 3 vectors a thread"),
    (4, 4, 64, False, 6, 4, "the cluster does not divide the grid"),
    (4, 4, 64, False, 3, 3, "a cluster of 3"),
    (4, 4, 1024, False, 2, 1, "more than 512 threads"),
    (8, 2, 64, False, 2, 1, "8 f32 are 32 bytes, not 16"),
    (4, 8, 32, False, 2, 1, "8 vectors two rows deep: no such kernel"),
    (4, 2, 64, False, 2, 2, "a twice-walked row in a cluster of 2"),
    (4, 2, 64, True, 2, 1, "a twice-walked row a warp"),
    (4, 1, 64, False, 6, 1, "more CTAs than rows: a partial row unwritten")])
def test_rmsnorm_bwd_source_refuses_a_bad_plan(norm_lib, vec, k, threads,
                                               warp_rows, ctas, cluster,
                                               why):
    """The C launch re-checks the plan and refuses
    (cudaErrorInvalidValue) what would miss columns or has no kernel, and
    writes nothing."""
    norm_lib.config(0, 0, TIME_LIMIT_S)
    x, w, dy = case(1, 4, 256, F32, F32)
    depth = 0 if "twice" in why or "unwritten" in why else (
        2 if "two rows deep" in why else None)
    plan = rn.make_bwd_plan(4, 256, F32, F32, vec, k, threads, warp_rows,
                            ctas, cluster, depth)
    err, dx, dw = run_host(norm_lib, x, w, dy, plan)
    assert err == 1, why
    assert bool(dx.isnan().all()) and bool(dw.isnan().all())


def test_rmsnorm_bwd_source_refuses_16_byte_access_it_cannot_make(norm_lib):
    """A row that starts 4 bytes past a 16-byte boundary: the wrapper's
    plan takes scalar accesses and is exact; the 16-byte plan is refused."""
    norm_lib.config(0, 0, TIME_LIMIT_S)
    x0, w0, dy0 = case(2, 3, 257, F32, F32)
    x = x0.flatten()[1:3 * 256 + 1].view(3, 256)
    dy = dy0.flatten()[1:3 * 256 + 1].view(3, 256)
    w = w0[1:]
    assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    aligned = (x.data_ptr() | dy.data_ptr() | w.data_ptr()) % 16 == 0
    check(norm_lib, x, w, dy, rn.bwd_plan(3, 256, F32, F32, 2, aligned))
    bad = rn.bwd_plan(3, 256, F32, F32, 2)
    assert bad.vec == 4
    assert run_host(norm_lib, x, w, dy, bad)[0] == 1


def test_rmsnorm_bwd_source_reuses_partial_rows(norm_lib):
    """Three launches on one partial-row buffer: each overwrites the rows
    the one before left."""
    norm_lib.config(0, 0, TIME_LIMIT_S)
    plan = rn.make_bwd_plan(21, 160, F32, F32, 4, 2, 32, True, 4, 2)
    partial = torch.full((plan.partials, 160), -3.0)
    for seed in range(3):
        x, w, dy = case(seed, 21, 160, F32, F32)
        err, dx, dw = run_host(norm_lib, x, w, dy, plan, partial=partial)
        assert err == 0
        rdx, rdw = rmsnorm_bwd_ref(x, w, dy)
        torch.testing.assert_close(dw, rdw, atol=2e-4 * float(
            rdw.abs().max()), rtol=0)
