#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card, drives the port's two
main paths (the paper grid on the batched engine through
``repro_torch.experiments.backend_torch.run_cells``, and LLM serving
through ``repro_torch.serve.engine.ServeEngine``) and prints what it saw.
Phases:

1. environment: versions, the card's name and power limit, the build;
2. kernel parity: the CUDA ``schedule_tick`` kernel against its plain
   version, bit-equal, on two seeded random slot states (a plausible
   mid-simulation one and a tight one that drives every branch) in every
   tier of its plan (B = 64 at W = 128, 200, 1,000, 4,097 and 8,192;
   16 x 16,384, 1 x 16,384 and 2 x 65,536), with and without a backfill
   depth; single-call, device (CUDA graph) and plain times; ``waterfill``
   bit-equal in every tier of its plan (31 x 128, 64 x 1,000, 64 x 4,097,
   132 x 2,048, 16 x 16,384, 1 x 16,384, a 143,829-slot 1-D row) for
   targets of 0, mid-row and above the row total, with and without
   ``order``, and after the replays of a CUDA graph; then
   ``rmsnorm``, ``flash_attention`` and ``ssd_scan`` in f32 and bf16 at
   the serving path's zamba2-2.7b shapes, a ragged and a GQA shape
   (Hkv = 4, 8 groups), gemma3-4b's and glm4-9b's attention shapes (head
   dims 256 and 128), a 4,096-token scan (32 chunks) and rmsnorm rows that
   take scalar accesses (d = 2561; bf16 d = 20), within the tolerances of
   ``tests/test_kernels.py``
   (f32 2e-5 / 2e-5 / 2e-4, bf16 2e-2 / 2e-2 / 5e-2); median times (CUDA
   events, 20 runs) of kernel and plain version;
3. main path: theta at scale 1.0 (2,550 jobs on 4,392 nodes), 2 seeds,
   the paper's five strategies (41 cells), under ``expand_backend`` =
   fused, waterfill and bisect; per-cell metrics must be identical across
   the three and every lane must finish.  Kernel launches are counted per
   run, from 0 just before it.  A small theta grid on the card must also
   equal the plain path on the CPU bit for bit.  The tick and waterfill
   kernels are then held to their plain versions on a captured call of
   the run and timed there: single calls (CUDA events) and device time
   (a CUDA graph of 20 calls); waterfill also at the six shapes of
   ``WATERFILL_TIMED_SHAPES`` (``--phases env,waterfill`` times those
   alone, with calls an earlier tree's waterfill also takes: an A/B of
   two trees runs this file from a copy of each);
4. serve: reduced zamba2 with the same seeded weights on the card and on
   the CPU (2 slots, 4 requests) must give identical tokens and last
   logits within 1e-3; then zamba2-2.7b at full width and depth, f32
   (TF32 off), random weights from seed 0: 8 slots, 24 requests with
   prompts of 64..1024 tokens (no multiple of 128) from seed 0, 32 new
   tokens each, max_len 1280.  Every request must finish, every logit be
   finite and each LLM kernel launch, counted from 0 just before the run;
   prints parameters, weight GB, prefill tokens/s, decode ms per engine
   step, decode tokens/s and launches.  Then gemma3-4b at full width
   (head dim 256), f32: one 1,100-token prompt, past its 1,024-token
   window, and 8 decode steps; logits finite, attention launched.  Each
   LLM kernel is then timed and checked on the zamba2 run's largest calls,
   beside its plain version, its bound (the f32 attention prefill and the
   SSD scan at the split TF32 rate, 495 / 3 TFLOP/s, the SSD scan's work
   counting C B^T once per chunk; decode and rmsnorm at the f32 CUDA-core
   rate, 67 TFLOP/s) and one PyTorch call of the same function where there
   is one, single calls with CUDA events and device times alone (a CUDA
   graph of 20 calls) of the kernel and of that PyTorch call;
5. scale: the greedy batch on haswell at scale 1.0 (the whole trace,
   28,259 jobs on 2,388 nodes) with ``fused``, tick launches counted from
   0 just before it; the tick kernel is then timed on the run's call at
   its peak window (B = 16, W = 16,384): single-call and device (CUDA
   graph) times beside its plain version and bound.  Should the time
   left in the smoke's 1,200 s limit not hold it at the rate this card
   ran the theta greedy batch, the scale is cut to
   the largest of 0.5 and 0.25 that fits, and the cut is printed.

Prints the kernels' JSON line, the ``nvidia-smi`` name / power-limit line
and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when CUDA is missing, the port's sources are missing, or any phase
fails.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
# the f32 prefill attention runs each product as 3 TF32 products (split TF32)
SPLIT_TF32_PASSES = 3
PAPER_STRATEGIES = ("easy", "min", "pref", "avg", "keeppref")
TIME_LIMIT_S = 1200.0
# haswell at scale 1.0: scan steps of the greedy batch, and its wall per
# step over the theta fused greedy batch's (PERF.md section 5)
HASWELL_STEPS = 52_160
HASWELL_STEP_RATIO = 1.25


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, check=None) -> float:
    """Device ms per call: ``calls`` calls captured in one CUDA graph and
    replayed (median of 5 replays), so no host work sits between launches
    as it does in :func:`cuda_median_ms`.  ``check``, when given, is called
    on each captured call's output after the last replay (a kernel whose
    scratch outlived a launch shows there)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # warm-up off the default stream, as capture needs
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    if check is not None:
        for out in outs:
            check(out)
    return statistics.median(times)


# --------------------------------------------------------------- inputs
def random_tick_case(gen, B: int, W: int, device):
    """A plausible mid-simulation slot state (paper-like node counts)."""
    import torch
    from repro_torch.core.passes import PassParams

    def ri(lo, hi, shape=(B, W)):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    def rf(lo, hi, shape=(B, W)):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    mn = ri(1, 33)
    mx = mn + ri(0, 97)
    want = torch.minimum(torch.maximum(ri(1, 65), mn), mx)
    u = torch.rand((B, W), generator=gen)
    state = torch.where(u < 0.2, 0, torch.where(
        u < 0.6, 1, torch.where(u < 0.9, 2, 3))).to(torch.int32)
    alloc = torch.where(state == 2, want, 0)
    busy = alloc.sum(dim=-1, dtype=torch.int32)
    capacity = busy + ri(0, 256, (B,))
    p = PassParams(
        malleable=torch.rand((B, W), generator=gen) < 0.7,
        min_nodes=mn, max_nodes=mx, want=want, floor=mn, shrink_floor=mn,
        prio_ref=mn + ri(0, 3), pfrac=rf(0.3, 0.999),
        wall_work=rf(60.0, 2.0e5))
    args = (p, state, alloc, rf(0.01, 1.0),
            torch.where(state == 2, rf(0.0, 1.0e5), 0.0),
            (torch.rand((B,), generator=gen) < 0.8)[:, None],
            capacity, rf(1.0e5, 2.0e5, (B,)))
    return _tick_case_on(device, args)


def _tick_case_on(device, args):
    from repro_torch.core.passes import PassParams
    p = args[0]
    moved = [PassParams(*(t.to(device) for t in p[:9]))]
    moved += [t.to(device) for t in args[1:]]
    prio_lo = -int(p.prio_ref.max())
    prio_hi = int((p.max_nodes - p.prio_ref).max())
    return moved, prio_lo, prio_hi


def tight_tick_case(gen, B: int, W: int, device):
    """A slot state that drives every branch of the pass: a blocked head
    on lanes with few free nodes, end estimates that tie (four remaining
    fractions), short and long jobs on both sides of the shadow time, so
    all three fill classes, the shrink and the expand act."""
    import torch
    from repro_torch.core.passes import PassParams

    def ri(lo, hi, shape=(B, W)):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    def rand(shape=(B, W)):
        return torch.rand(shape, generator=gen)

    def pick(values):
        v = torch.tensor(values, dtype=torch.float32)
        return v[torch.randint(0, len(values), (B, W), generator=gen)]

    u = rand()
    state = torch.where(u < 0.05, 0, torch.where(
        u < 0.6, 1, torch.where(u < 0.95, 2, 3))).to(torch.int32)
    big = rand() < 0.05 + 0.45 * rand((B, 1))
    mn = torch.where(big, ri(8, 40), ri(1, 4))
    mx = mn + (rand() * (3 * mn + 2)).to(torch.int32)
    want = torch.minimum(mn + (rand() * (2 * mn + 1)).to(torch.int32), mx)
    alloc = torch.where(state == 2, torch.clamp(want + ri(-2, 3), min=1), 0)
    busy = alloc.sum(dim=-1, dtype=torch.int32)
    capacity = busy + ri(0, 40, (B,)) * ri(0, 2, (B,))
    wall = torch.where(rand() < 0.5, 5.0 + 45.0 * rand(),
                       100.0 + 4900.0 * rand())
    p = PassParams(
        malleable=rand() < 0.6, min_nodes=mn, max_nodes=mx, want=want,
        floor=mn, shrink_floor=torch.clamp(mn - ri(0, 3), min=1),
        prio_ref=mn + ri(0, 4), pfrac=pick([0.5, 0.9, 0.99]),
        wall_work=wall)
    return _tick_case_on(device, (
        p, state, alloc, pick([0.05, 0.2, 0.5, 0.9]),
        torch.where(state == 2, 40.0 * rand(), float("nan")),
        (rand((B,)) < 0.9)[:, None], capacity, 30.0 + 30.0 * rand((B,))))


def tick_bytes(args, kw) -> int:
    """Bytes one call moves: every tensor the kernel reads, as the launch
    takes it (``act`` one byte a lane or a full row, ``depth`` only when
    given), and the three output rows."""
    from repro_torch.kernels.schedule_tick import kernel_args
    rows, _, _ = kernel_args(*args, kw.get("backfill_depth"))
    read = sum(t.numel() * t.element_size() for t in rows if t is not None)
    return read + 3 * args[1].numel() * 4


def tick_ops(B: int, W: int, fill_rounds: int) -> int:
    # the row passes every lane runs (copy-in, step 1, queue snapshot,
    # 3 * fill_rounds fills, surplus, expand flag), ~1 op per slot each;
    # data-dependent shadow / bisection passes are left out -- the bytes
    # bound is the larger by >10x either way
    return B * W * (5 + 3 * fill_rounds)


# --------------------------------------------------------------- phases
def device_events(prof):
    """The device-side entries (kernels, copies) of a profiler trace's
    ``key_averages()``, largest first.  The host-side op entries also
    carry ``self_device_time_total`` (their kernels' time), so summing
    every entry would count each kernel twice."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU),
                  key=lambda e: e.self_device_time_total, reverse=True)


def phase_env(report):
    import torch
    from repro_torch.kernels import build
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    report["gpu"] = gpu_line()
    log(f"[env] nvidia-smi: {report['gpu']}")
    build.load_library()
    log(f"[env] kernel library built in {build.BUILD_INFO['seconds']:.1f}s "
        f"-> {build.BUILD_INFO['path']}")
    for line in build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[env]   {line.strip()}")


def identical(a, b) -> bool:
    """Bit-for-bit equality (NaN start times of unstarted jobs included)."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def max_abs_err(a, b) -> float:
    import torch
    d = (a.double() - b.double()).abs()
    d = d[torch.isfinite(d)]
    return float(d.max()) if d.numel() else 0.0


def tick_parity(case, depth, fill_rounds=2, shadow_iters=26):
    """Kernel vs plain on one case; returns (max_abs_err, kernel, plain)."""
    import torch
    from repro_torch.kernels.ref import schedule_tick_ref
    from repro_torch.kernels.schedule_tick import fused_schedule_tick
    (p, state, alloc, rem, start, act, cap, t_now), lo, hi = case
    kw = dict(fill_rounds=fill_rounds, prio_lo=lo, prio_hi=hi,
              shadow_iters=shadow_iters, backfill_depth=depth)

    def kern():
        return fused_schedule_tick(p, state, alloc, rem, start, act, cap,
                                   t_now, **kw)

    def plain():
        return schedule_tick_ref(p, state, alloc, rem, start, act, cap,
                                 t_now, **kw)

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for g, r, name in zip(got, ref, ("state", "alloc", "start_t")):
        if not identical(g, r):
            bad = int((g != r).sum())
            raise AssertionError(f"schedule_tick kernel differs from plain "
                                 f"on {name} in {bad} slots")
        err = max(err, max_abs_err(g, r))
    return err, kern, plain


def waterfill_case(gen, shape, device):
    """Node counts 0..63 (a fifth of them 0) and priorities -4..4 of one
    shape, made on the host from ``gen``."""
    import torch
    cap = (torch.randint(0, 64, shape, generator=gen, dtype=torch.int32)
           * (torch.rand(shape, generator=gen) < 0.8)).to(torch.int32)
    prio = torch.randint(-4, 5, shape, generator=gen, dtype=torch.int32)
    total = cap.sum(dim=-1, dtype=torch.int32)
    frac = torch.rand(total.shape, generator=gen)
    mid = (frac * total.float()).to(torch.int32)
    return cap.to(device), prio.to(device), mid.to(device)


def waterfill_args(cap, tgt, order):
    """The call's arguments, ``order`` only when given (so the timing runs
    unchanged against a tree whose waterfill takes no order, for A/B)."""
    return (cap, tgt) if order is None else (cap, tgt, order)


def waterfill_check(cap, tgt, order=None, label=""):
    """A function that raises unless its argument equals the plain
    version's take on these inputs, bit for bit, and else returns the
    max |difference| (0.0)."""
    from repro_torch.kernels.ref import waterfill_ref
    ref = waterfill_ref(*waterfill_args(cap, tgt, order))

    def check(got):
        if not identical(got, ref):
            raise AssertionError(f"waterfill kernel differs from plain in "
                                 f"{int((got != ref).sum())} slots {label}")
        return max_abs_err(got, ref)
    return check


def time_waterfill(cap, tgt, order=None):
    """The waterfill kernel beside its plain version on one call's inputs:
    single-call ms (CUDA events), device ms (a CUDA graph of 20 calls,
    each output held to the plain version after the replays), the plain
    version's ms and the bound (each input read once, the take written
    once; 3 operations a slot at the f32 CUDA-core rate)."""
    import torch
    from repro_torch.kernels.ref import waterfill_ref
    from repro_torch.kernels.waterfill import waterfill
    args = waterfill_args(cap, tgt, order)
    check = waterfill_check(cap, tgt, order, f"at {tuple(cap.shape)}")
    err = check(waterfill(*args))

    nbytes = 2 * cap.numel() * 4 + (
        tgt.numel() * 4 if torch.is_tensor(tgt) else 0)
    if order is not None:
        nbytes += order.numel() * order.element_size()
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = 3 * cap.numel() / FP32_OPS_PER_S * 1e3
    return {"shape": list(cap.shape), "order": order is not None,
            "max_abs_err": err, "ms": cuda_median_ms(lambda: waterfill(*args)),
            "device_ms": graph_ms(lambda: waterfill(*args), check=check),
            "plain_ms": cuda_median_ms(lambda: waterfill_ref(*args)),
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


# one or more shapes in every tier of the tick kernel's plan: warp (W <=
# 256), CTA, cluster (haswell's peak window, one lane of it and the tier's
# widest: 8 CTAs of 512 threads) and global
TICK_PARITY_SHAPES = ((64, 128), (64, 200), (64, 1000), (64, 4097),
                      (64, 8192), (16, 16_384), (1, 16_384), (16, 32_768),
                      (2, 65_536))


def phase_parity(report):
    import torch
    from repro_torch.kernels.schedule_tick import plan
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(11)
    errs = report.setdefault("max_abs_err", {"schedule_tick": 0.0})
    for B, W in TICK_PARITY_SHAPES:
        pl = plan(B, W)
        for depth in (None, 2):
            d = None if depth is None else torch.full(
                (B,), depth, dtype=torch.int32, device=dev)
            err, kern, plain = tick_parity(tight_tick_case(gen, B, W, dev),
                                           d)
            errs["schedule_tick"] = max(errs["schedule_tick"], err)
            err, kern, plain = tick_parity(random_tick_case(gen, B, W, dev),
                                           d)
            errs["schedule_tick"] = max(errs["schedule_tick"], err)
            log(f"[parity] schedule_tick B={B} W={W} depth={depth} "
                f"({pl.tier}, cluster {pl.cluster}, {pl.threads} threads x "
                f"{pl.k} slots): bit-equal on both cases; kernel "
                f"{cuda_median_ms(kern):.4f} ms, device "
                f"{graph_ms(kern):.4f} ms, plain {cuda_median_ms(plain):.3f} "
                "ms")
    waterfill_parity(gen, dev)


# every tier of the waterfill kernel's plan: warp (theta's 31 x 128), CTA
# (64 x 1,000, 132 x 2,048) and look-back (64 x 4,097, haswell's peak
# window 16 x 16,384, one lane of it, Eagle's 143,829 jobs as one row)
WATERFILL_PARITY_SHAPES = ((31, 128), (64, 1000), (64, 4097), (132, 2048),
                           (16, 16_384), (1, 16_384), (143_829,))
# timed in the kernels line (and alone by ``--phases env,waterfill``)
WATERFILL_TIMED_SHAPES = ((31, 128), (16, 16_384), (1, 16_384), (64, 1000),
                          (132, 2048), (143_829,))


def waterfill_parity(gen, dev):
    """The waterfill kernel bit-equal to its plain version at every parity
    shape, for targets of 0, mid-row and above each row's total, with and
    without ``order`` (argsort of random priorities), and after the
    replays of a CUDA graph of 20 calls (mid-row targets)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.waterfill import plan, waterfill
    sms = build.sm_count(dev.index or 0)
    for shape in WATERFILL_PARITY_SHAPES:
        cap, prio, mid = waterfill_case(gen, shape, dev)
        total = cap.sum(dim=-1, dtype=torch.int32)
        order = torch.argsort(prio, dim=-1, stable=True)
        for o in (None, order):
            for tgt in (0, mid, total + 17):
                waterfill_check(cap, tgt, o, f"at {shape}")(
                    waterfill(cap, tgt, o))
        B, N = (1, shape[0]) if len(shape) == 1 else shape
        pl = plan(B, N, sms)
        dev_ms = [graph_ms(lambda o=o: waterfill(cap, mid, o),
                           check=waterfill_check(cap, mid, o, "after replay"))
                  for o in (None, order)]
        log(f"[parity] waterfill {shape} ({pl.tier}, {pl.threads} threads x "
            f"{pl.k} slots, {pl.grid} CTAs): bit-equal for 3 targets with "
            f"and without order and after a CUDA-graph replay; device "
            f"{dev_ms[0]:.4f} ms, with order {dev_ms[1]:.4f} ms")


def time_waterfill_shapes(report):
    """The waterfill kernel timed at :data:`WATERFILL_TIMED_SHAPES` on
    seeded counts with mid-row targets (no order: the same call on this
    tree and on earlier ones, for A/B runs)."""
    import torch
    gen = torch.Generator().manual_seed(17)
    rows = []
    for shape in WATERFILL_TIMED_SHAPES:
        cap, _prio, mid = waterfill_case(gen, shape, torch.device("cuda"))
        t = time_waterfill(cap, mid)
        rows.append(t)
        log(f"[waterfill] {shape}: {t['ms']:.4f} ms, device "
            f"{t['device_ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.6f} ms by {t['bound_by']}); bit-equal after "
            f"a CUDA-graph replay; {report['gpu']}")
    return rows


# the shapes at which kernels/waterfill.py::plan's cuts were chosen, and
# the hand-made plans (tier, threads, slots a thread) timed at each: warp
# or CTA, rows a warp-tier CTA, CTA or look-back, look-back tile sizes
WATERFILL_PLAN_CHOICES = {
    (31, 128): (("warp", 32, 4), ("warp", 128, 4), ("cta", 32, 4)),
    (31, 256): (("warp", 32, 8), ("cta", 64, 4)),
    (31, 512): (("warp", 32, 16), ("cta", 128, 4)),
    (1000, 128): (("warp", 32, 4), ("warp", 128, 4)),
    (64, 1000): (("warp", 32, 32), ("cta", 256, 4), ("cta", 128, 8)),
    (8, 2000): (("cta", 512, 4), ("lookback", 256, 4)),
    (16, 4096): (("cta", 1024, 4), ("cta", 512, 8), ("lookback", 256, 4)),
    (16, 8192): (("cta", 1024, 8), ("lookback", 256, 4),
                 ("lookback", 256, 8)),
    (64, 4097): (("cta", 544, 8), ("lookback", 256, 4)),
    (16, 16_384): (("cta", 1024, 16), ("lookback", 128, 4),
                   ("lookback", 256, 4), ("lookback", 256, 8)),
    (143_829,): (("lookback", 256, 4), ("lookback", 256, 8),
                 ("lookback", 512, 4)),
}


def time_waterfill_plans(report):
    """Device ms (CUDA graph of 20 calls, held to the plain version after
    the replays) of hand-made waterfill plans, without and with ``order``
    (``--phases env,waterfill-plans``: how the plan's cuts were set)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import waterfill as wf
    gen = torch.Generator().manual_seed(3)
    sms = build.sm_count(0)
    for shape, plans in WATERFILL_PLAN_CHOICES.items():
        cap, prio, mid = waterfill_case(gen, shape, torch.device("cuda"))
        order = torch.argsort(prio, dim=-1, stable=True)
        B, N = (1, shape[0]) if len(shape) == 1 else shape
        log(f"[plans] {shape}: plan() picks {wf.plan(B, N, sms)[:3]}")
        for tier, threads, k in plans:
            pl = wf.make_plan(B, N, tier, threads, k)
            ms = []
            for o in (None, order):
                def call(o=o):
                    out = torch.empty_like(cap)
                    scratch = (torch.empty(pl.scratch, dtype=torch.int64,
                                           device=cap.device)
                               if pl.scratch else None)
                    build.launch("waterfill", cap, "repro_waterfill",
                                 *wf.kernel_args(cap, mid, o, out, scratch,
                                                 pl, False))
                    return out
                ms.append(graph_ms(call, check=waterfill_check(cap, mid, o)))
            log(f"[plans]   {tier} {threads} threads x {k} slots, {pl.grid} "
                f"CTAs: device {ms[0]:.4f} ms, with order {ms[1]:.4f} ms")
    log(f"[plans] {report['gpu']}")


class Patch:
    """Puts ``self`` in place of ``module.name`` inside a ``with`` block;
    ``self.inner`` is what it replaced."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.inner = getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


class Capture(Patch):
    """Wraps a kernel wrapper to keep one real main-path call's inputs.

    It keeps references, not copies: the engine builds every tensor out of
    place and never writes into one it has passed on, so a kept call's
    inputs stay as they were, and the timed run pays no device work for
    the capture.
    """

    def __init__(self, module, name, every=97):
        super().__init__(module, name)
        self.every = every
        self.calls, self.kept = 0, None

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.kept is None or self.calls % self.every == 0:
            self.kept = (args, kwargs)
        return self.inner(*args, **kwargs)


def run_grid(workloads, scale, seeds, backend, device, strategies=None):
    from repro_torch.experiments.backend_torch import run_cells
    from repro_torch.experiments.spec import ExperimentSpec
    kw = {} if strategies is None else {"strategies": strategies}
    spec = ExperimentSpec(workloads=workloads, scale=scale, seeds=seeds,
                          **kw)
    todo = [(w, c) for w in spec.workloads for c in spec.cells()]
    t0 = time.monotonic()
    metrics, info = run_cells(
        spec, todo, None, {}, options={"device": device,
                                       "expand_backend": backend},
        verbose=False)
    info["wall_s"] = time.monotonic() - t0
    return todo, metrics, info


def same_metrics(a, b) -> bool:
    if a.keys() != b.keys():
        return False
    for k in a:
        for key in a[k]:
            x, y = a[k][key], b[k][key]
            if not (x == y or (math.isnan(x) and math.isnan(y))):
                return False
    return True


def check_cells(todo, metrics, info, label):
    if info["incomplete"]:
        raise AssertionError(f"{label}: {len(info['incomplete'])} lanes "
                             "did not finish")
    for key in todo:
        u = metrics[key]["utilization"]
        if not 0.0 <= u <= 1.0:
            raise AssertionError(f"{label}: utilization {u} of {key} "
                                 "outside [0, 1]")


def small_theta_on_both_devices():
    """The engine on the card (fused) equals the plain path on the CPU,
    bit for bit, on a small theta grid (scale 0.05, 1 seed)."""
    import numpy as np
    from repro_torch.core import CLUSTERS, get_strategy
    from repro_torch.experiments.spec import ExperimentSpec, prepare_workload
    from repro_torch.sweep.batch import (EngineConfig, build_lanes,
                                         simulate_lanes)
    spec = ExperimentSpec(workloads=("theta",), scale=0.05, seeds=1)
    cl, w, _ = prepare_workload(spec, "theta")
    for structure in ("greedy", "balanced"):
        lanes = [(get_strategy(s), p, sd) for s, p, sd in spec.cells()
                 if get_strategy(s).structure == structure]
        res = {}
        for dev, backend in (("cpu", "bisect"), ("cuda", "fused")):
            batch, _ = build_lanes(w, CLUSTERS["theta"].nodes, lanes,
                                   tick=cl.tick, device=dev)
            res[dev] = simulate_lanes(batch, EngineConfig(
                structure=structure, expand_backend=backend))
        for key in ("state", "alloc", "start_t", "end_t", "expand_ops",
                    "shrink_ops", "bf_starts", "sched_steps"):
            if not np.array_equal(res["cpu"][key], res["cuda"][key],
                                  equal_nan=True):
                raise AssertionError(f"theta scale 0.05 {structure}: {key} "
                                     "on the card differs from the CPU")
        log(f"[main] theta scale 0.05 {structure} ({len(lanes)} lanes): "
            "the card (fused) == the plain path on the CPU, bit for bit")


def phase_main(report):
    import torch
    from repro_torch.kernels import build, schedule_tick, waterfill
    small_theta_on_both_devices()

    runs = {}
    tick_cap = Capture(schedule_tick, "fused_schedule_tick")
    wf_cap = Capture(waterfill, "waterfill")
    with tick_cap, wf_cap:
        for backend in ("fused", "waterfill", "bisect"):
            torch.cuda.synchronize()
            build.LAUNCH_COUNTS.clear()  # this path's launches start here
            todo, metrics, info = run_grid(("theta",), 1.0, 2, backend,
                                           "cuda")
            torch.cuda.synchronize()
            delta = {k: build.LAUNCH_COUNTS[k]
                     for k in ("schedule_tick", "waterfill")}
            check_cells(todo, metrics, info, f"theta/{backend}")
            runs[backend] = (metrics, info, delta)
            walls = {c["structure"]: c["wall_s"] for c in info["chunks"]}
            log(f"[main] theta scale 1.0 {backend}: {len(todo)} cells in "
                f"{info['wall_s']:.2f}s ({len(todo) / info['wall_s']:.3f} "
                f"cells/s); greedy {info['greedy_lanes']} lanes "
                f"{info['greedy_steps']} steps window "
                f"{info['greedy_window']} {walls['greedy']:.2f}s; balanced "
                f"{info['balanced_lanes']} lanes {info['balanced_steps']} "
                f"steps window {info['balanced_window']} "
                f"{walls['balanced']:.2f}s; launches {delta}")
    report["launches"] = {b: runs[b][2] for b in runs}
    greedy = runs["fused"][1]
    report["greedy_s_per_step"] = (
        next(c["wall_s"] for c in greedy["chunks"]
             if c["structure"] == "greedy") / greedy["greedy_steps"])
    if len(todo) != 41:
        raise AssertionError(f"expected 41 theta cells, got {len(todo)}")
    fused, wfill, bisect = (runs[b][0] for b in ("fused", "waterfill",
                                                 "bisect"))
    if not (same_metrics(fused, wfill) and same_metrics(fused, bisect)):
        raise AssertionError("per-cell metrics differ across backends")
    if runs["fused"][2]["schedule_tick"] == 0 or \
            runs["fused"][2]["waterfill"] != 0:
        raise AssertionError(f"fused run launches {runs['fused'][2]}")
    if runs["waterfill"][2]["waterfill"] == 0 or \
            runs["waterfill"][2]["schedule_tick"] != 0:
        raise AssertionError(f"waterfill run launches {runs['waterfill'][2]}")
    if any(runs["bisect"][2].values()):
        raise AssertionError(f"bisect run launches {runs['bisect'][2]}")
    log("[main] per-cell metrics identical under fused / waterfill / bisect")
    by = {}
    for (_w, (s, prop, _sd)), m in fused.items():
        if prop in (0.0, 1.0):
            by.setdefault(s, []).append(m["turnaround_mean"])
    base = sum(by["easy"]) / len(by["easy"])
    for s in PAPER_STRATEGIES:
        t = sum(by[s]) / len(by[s])
        log(f"[main] turnaround {s:>8s} @ proportion "
            f"{0.0 if s == 'easy' else 1.0}: {t:.1f} s "
            f"({100.0 * (base - t) / base:+.1f}% vs easy)")
    report["captured"] = {"schedule_tick": tick_cap.kept,
                          "waterfill": wf_cap.kept}


def time_tick(args, kw):
    """The tick kernel against its plain version on one real call's
    inputs (bit-equal required): max |err|, single-call ms of both and the
    bound (bytes or operations, whichever is larger)."""
    from repro_torch.kernels.ref import schedule_tick_ref
    from repro_torch.kernels.schedule_tick import fused_schedule_tick
    B, W = args[1].shape
    got = fused_schedule_tick(*args, **kw)
    ref = schedule_tick_ref(*args, **kw)
    err = 0.0
    for g, r in zip(got, ref):
        if not identical(g, r):
            raise AssertionError(f"schedule_tick differs from plain on the "
                                 f"captured main-path call B={B} W={W}")
        err = max(err, max_abs_err(g, r))
    b_bytes = tick_bytes(args, kw) / HBM_BYTES_PER_S * 1e3
    b_ops = tick_ops(B, W, kw["fill_rounds"]) / FP32_OPS_PER_S * 1e3
    return {"max_abs_err": err,
            "ms": cuda_median_ms(lambda: fused_schedule_tick(*args, **kw)),
            "device_ms": graph_ms(lambda: fused_schedule_tick(*args, **kw)),
            "plain_ms": cuda_median_ms(
                lambda: schedule_tick_ref(*args, **kw)),
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"}


def phase_kernels_at_main_shape(report):
    """Time each kernel on a real main-path call's inputs and hold it
    against its plain version there."""
    from repro_torch.kernels import build
    from repro_torch.kernels.waterfill import plan
    out = []
    args, kw = report["captured"]["schedule_tick"]
    B, W = args[1].shape
    t = time_tick(args, kw)
    out.append({
        "name": "schedule_tick", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/schedule_tick.cu",
        "replaces": "src/repro/kernels/schedule_tick.py:105",
        "launches": report["launches"]["fused"]["schedule_tick"],
        "launches_by_backend": {b: c["schedule_tick"]
                                for b, c in report["launches"].items()},
        "max_abs_err": max(t["max_abs_err"],
                           report.get("max_abs_err", {}).get(
                               "schedule_tick", 0.0)),
        **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                             "bound_by")},
        "library_ms": None, "shape": [B, W]})
    log(f"[kernel] schedule_tick at the main-path shape B={B} W={W}: "
        f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} ms (plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms); "
        f"{report['gpu']}")

    (cap, tgt), kw = report["captured"]["waterfill"]
    t = time_waterfill(cap, tgt, kw.get("order"))
    B, N = (1, cap.shape[0]) if cap.ndim == 1 else tuple(cap.shape)
    tier = plan(B, N, build.sm_count(cap.get_device())).tier
    out.append({
        "name": "waterfill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/waterfill.cu",
        "replaces": "src/repro/kernels/waterfill.py:29",
        "launches": report["launches"]["waterfill"]["waterfill"],
        "launches_by_backend": {b: c["waterfill"]
                                for b, c in report["launches"].items()},
        **{k: t[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                             "bound_ms", "bound_by", "shape", "order")},
        "tier": tier, "library_ms": None,
        "shapes": time_waterfill_shapes(report)})
    log(f"[kernel] waterfill at the main-path shape {tuple(cap.shape)} "
        f"({tier} tier, order {t['order']}): {t['ms']:.4f} ms, device "
        f"{t['device_ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.6f} ms by {t['bound_by']}); bit-equal after a "
        f"CUDA-graph replay; {report['gpu']}")
    report["kernels"] = out


# ------------------------------------------------------- LLM serving path
# (atol = rtol) of the kernel-vs-plain checks, by kernel and dtype: those
# of tests/test_kernels.py
LLM_TOL = {"float32": {"rmsnorm": 2e-5, "flash_attention": 2e-5,
                       "ssd_scan": 2e-4},
           "bfloat16": {"rmsnorm": 2e-2, "flash_attention": 2e-2,
                        "ssd_scan": 5e-2}}
LLM_KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:19"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:36"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:37"),
}
# the card the LLM phases run on
DEVICE = "cuda"
# the full-width serve run: zamba2-2.7b, f32, prompts of 64..1024 tokens
SERVE = dict(slots=8, requests=24, new=32, max_len=1280, prompt=(64, 1024))


def close_err(got, ref, tol: float, label: str) -> float:
    """max |got - ref|; raises unless |got - ref| <= tol + tol * |ref|
    everywhere (a NaN fails)."""
    g, r = got.double(), ref.double()
    d = (g - r).abs()
    bad = ~(d <= tol + tol * r.abs())
    if bool(bad.any()):
        raise AssertionError(f"{label}: kernel differs from plain in "
                             f"{int(bad.sum())} of {d.numel()} values "
                             f"(max |err| {float(d.max()):.3g}, tol {tol})")
    return float(d.max()) if d.numel() else 0.0


def llm_calls(kernel: str, args, kw):
    """(kernel call, plain call) of one LLM kernel on the same inputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    fns = {"rmsnorm": (rmsnorm, ref.rmsnorm_ref),
           "flash_attention": (flash_attention, ref.attention_ref),
           "ssd_scan": (ssd_scan, ref.ssd_ref)}[kernel]
    return (lambda: fns[0](*args, **kw)), (lambda: fns[1](*args, **kw))


def llm_case(gen, kernel: str, shape: dict, dtype):
    """Seeded inputs of one kernel at ``shape`` (on the card)."""
    import torch

    def rn(*s, lo=None, hi=None, dt=dtype):
        t = (torch.randn(s, generator=gen) if lo is None else
             lo + (hi - lo) * torch.rand(s, generator=gen))
        return t.to(DEVICE, dt)

    if kernel == "rmsnorm":
        return (rn(shape["rows"], shape["d"]),
                rn(shape["d"], dt=torch.float32)), {}
    if kernel == "flash_attention":
        b, sq, sk = shape["B"], shape["Sq"], shape["Sk"]
        h, hkv, d = shape["H"], shape["Hkv"], shape["D"]
        kw = {k: shape[k] for k in ("q_offset", "kv_valid_len", "window")
              if k in shape}
        return (rn(b, sq, h, d), rn(b, sk, hkv, d), rn(b, sk, hkv, d)), kw
    b, s, h, p, n = (shape[k] for k in ("B", "S", "H", "P", "N"))
    kw = {}
    if shape.get("init"):
        kw["initial_state"] = rn(b, h, p, n, dt=torch.float32)
    return (rn(b, s, h, p), rn(b, s, h, lo=0.01, hi=0.5),
            rn(h, lo=0.5, hi=2.0, dt=torch.float32), rn(b, s, n),
            rn(b, s, n)), kw


# the serving path's shapes at full zamba2 width, a ragged and a GQA one
LLM_PARITY_SHAPES = [
    ("rmsnorm", "prefill d=2560", dict(rows=1000, d=2560)),
    ("rmsnorm", "prefill d=5120", dict(rows=1000, d=5120)),
    ("rmsnorm", "decode d=2560", dict(rows=8, d=2560)),
    ("rmsnorm", "decode d=5120", dict(rows=8, d=5120)),
    ("flash_attention", "prefill", dict(B=1, Sq=1000, Sk=1000, H=32,
                                        Hkv=32, D=80)),
    ("flash_attention", "decode", dict(B=8, Sq=1, Sk=1280, H=32, Hkv=32,
                                       D=80, q_offset=1000,
                                       kv_valid_len=1001)),
    ("flash_attention", "GQA ragged", dict(B=2, Sq=333, Sk=333, H=32,
                                           Hkv=4, D=80)),
    ("flash_attention", "GQA decode window", dict(
        B=3, Sq=1, Sk=700, H=32, Hkv=4, D=80, q_offset=650,
        kv_valid_len=651, window=256)),
    # gemma3-4b (8:4 heads of 256, window 1,024) and glm4-9b (32:2 of 128)
    ("flash_attention", "gemma3 prefill window", dict(
        B=1, Sq=1100, Sk=1100, H=8, Hkv=4, D=256, window=1024)),
    ("flash_attention", "gemma3 decode window", dict(
        B=1, Sq=1, Sk=1280, H=8, Hkv=4, D=256, q_offset=1107,
        kv_valid_len=1108, window=1024)),
    ("flash_attention", "glm4 prefill", dict(B=1, Sq=1000, Sk=1000, H=32,
                                             Hkv=2, D=128)),
    ("flash_attention", "glm4 decode", dict(B=8, Sq=1, Sk=1280, H=32, Hkv=2,
                                            D=128, q_offset=1000,
                                            kv_valid_len=1001)),
    ("ssd_scan", "prefill ragged", dict(B=1, S=1000, H=80, P=64, N=64)),
    ("ssd_scan", "initial state", dict(B=1, S=1024, H=80, P=64, N=64,
                                       init=True)),
    ("ssd_scan", "batch 2", dict(B=2, S=300, H=80, P=64, N=64)),
    ("ssd_scan", "32 chunks", dict(B=1, S=4096, H=80, P=64, N=64)),
    # the rmsnorm kernel's scalar accesses (odd width; bf16 rows of 40 B)
    ("rmsnorm", "odd width", dict(rows=7, d=2561)),
    ("rmsnorm", "narrow", dict(rows=5, d=20)),
]


def phase_llm_parity(report):
    """Each LLM kernel against its plain version on the card, f32 and
    bf16, at the serving path's shapes."""
    import torch
    gen = torch.Generator().manual_seed(12)
    errs = report.setdefault("max_abs_err", {})
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for kernel, label, shape in LLM_PARITY_SHAPES:
            args, kw = llm_case(gen, kernel, shape, dtype)
            kern, plain = llm_calls(kernel, args, kw)
            tol = LLM_TOL[dname][kernel]
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            pairs = zip(got, ref) if kernel == "ssd_scan" else [(got, ref)]
            err = max(close_err(g, r, tol, f"{kernel} {label} {dname}")
                      for g, r in pairs)
            if dtype == torch.float32:
                errs[kernel] = max(errs.get(kernel, 0.0), err)
            log(f"[parity] {kernel} {label} {dname} {shape}: max |err| "
                f"{err:.3g} <= tol {tol}; kernel {cuda_median_ms(kern):.4f}"
                f" ms, plain {cuda_median_ms(plain):.4f} ms")


def attention_rate(q, k, kw):
    """(operations per second, its name) of the route the kernel takes for
    this call: the decode variant computes on CUDA cores; the prefill
    variant on the tensor cores, in f32 as split TF32 (3 TF32 products per
    product, so a third of the TF32 rate)."""
    import torch
    from repro_torch.kernels.flash_attention import plan
    b, sq, h, d = q.shape
    p = plan(b, sq, k.shape[1], h, k.shape[2], d, q.element_size(),
             causal=kw.get("causal", True), window=kw.get("window", 0),
             q_offset=kw.get("q_offset", 0),
             kv_valid=kw.get("kv_valid_len") or k.shape[1])
    if p.variant == "decode":
        return FP32_OPS_PER_S, "f32 CUDA cores, 67 TFLOP/s"
    if q.dtype == torch.bfloat16:
        return BF16_OPS_PER_S, "bf16 tensor cores, 989 TFLOP/s"
    return (TF32_OPS_PER_S / SPLIT_TF32_PASSES,
            "split TF32, 495 / 3 TFLOP/s")


def attention_work(q, k, kw):
    """(flops, bytes) an attention call needs: 4 * D flops per visible
    (query, key) pair; q and the output once, and each K / V row up to
    the last visible key once."""
    import numpy as np
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    lim = min(sk, kw.get("kv_valid_len") or sk)
    pos = kw.get("q_offset", 0) + np.arange(sq)
    hi = np.minimum(lim, pos + 1) if kw.get("causal", True) else \
        np.full(sq, lim)
    window = kw.get("window", 0)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq)
    seen = np.maximum(hi - lo, 0)
    es = q.element_size()
    rows = int(hi.max() - lo.min()) if seen.any() else 0
    return (4.0 * d * b * h * float(seen.sum()),
            es * (2 * q.numel() + 2 * b * hkv * d * rows))


def ssd_work(x, b, kw):
    """(flops, bytes) the chunked SSD scan needs on these inputs: C B^T once
    per (batch, chunk) over the lower triangle, the intra-chunk product and
    the chunk state and output products per head; x, dt, B, C read once,
    y and the state written once."""
    from repro_torch.kernels.ssd_scan import plan
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = plan(bsz, s, h, p, n, kw.get("chunk", 128)).chunk
    tri = sum(lc * (lc + 1) // 2 for lc in
              (min(chunk, s - t0) for t0 in range(0, s, chunk)))
    macs = bsz * (tri * n + h * (tri * p + 2 * s * p * n))
    es = x.element_size()
    nbytes = (es * (x.numel() + bsz * s * h + 2 * bsz * s * n)
              + 4 * (x.numel() + bsz * h * p * n + h))
    if kw.get("initial_state") is not None:
        nbytes += 4 * bsz * h * p * n
    return 2.0 * macs, nbytes


def ssd_rate(x):
    """(operations per second, its name) of the SSD kernels' route: every
    product on the tensor cores in split TF32 (3 TF32 products each) for
    f32 inputs; for bf16 inputs one operand is exact, so 2."""
    import torch
    if x.dtype == torch.bfloat16:
        return (TF32_OPS_PER_S / 2,
                "TF32 with one exact operand, 495 / 2 TFLOP/s")
    return (TF32_OPS_PER_S / SPLIT_TF32_PASSES,
            "split TF32, 495 / 3 TFLOP/s")


def library_call(kernel: str, args, kw):
    """One PyTorch call computing the same function, or None."""
    import torch
    import torch.nn.functional as F
    if kernel == "rmsnorm":
        x, w = args[:2]
        eps = args[2] if len(args) > 2 else kw.get("eps", 1e-6)
        return lambda: F.rms_norm(x, (x.shape[-1],), w, eps=eps)
    if kernel != "flash_attention" or kw.get("window", 0) > 0:
        return None
    q, k, v = args
    valid = kw.get("kv_valid_len") or k.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :valid], v[:, :valid]))
    gqa = q.shape[2] != k.shape[2]
    causal = q.shape[1] > 1   # decode: the one query sees every valid key
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=gqa)


class Keep(Patch):
    """Wraps a kernel wrapper where the model calls it and keeps the
    largest call's inputs per label (references, not copies: the model
    does not write into a tensor it has passed to a kernel, except the
    decode caches, which keep their shape)."""

    def __init__(self, module, name, label):
        super().__init__(module, name)
        self.label = label
        self.kept = {}

    def __call__(self, *args, **kwargs):
        label, size = self.label(args, kwargs)
        if size > self.kept.get(label, (-1,))[0]:
            self.kept[label] = (size, args, kwargs)
        return self.inner(*args, **kwargs)


class Timed(Patch):
    """Wraps ``decode.prefill`` / ``decode.decode_step``: synchronises after
    each call, sums the wall time and counts calls with non-finite logits."""

    def __init__(self, module, name):
        super().__init__(module, name)
        self.seconds, self.calls, self.nonfinite = 0.0, 0, 0

    def __call__(self, *args, **kwargs):
        import torch
        t0 = time.monotonic()
        logits, cache = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds += time.monotonic() - t0
        self.calls += 1
        self.nonfinite += int(not bool(torch.isfinite(logits).all()))
        return logits, cache


def serve_prompts(vocab: int, n: int, lo: int, hi: int, seed: int):
    """``n`` prompts of lo..hi tokens from ``seed``; no length is a
    multiple of 128, so every prefill scans a ragged last chunk."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    lens = np.where(lens % 128 == 0, lens - 1, lens)
    return [rng.integers(2, vocab, size=int(m)).astype(np.int32)
            for m in lens]


def serve(model, cfg, prompts, *, slots, max_len, new, device):
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(model, cfg, n_slots=slots, max_len=max_len,
                      dtype=model.embed.table.dtype, device=device)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    if not all(r.done for r in reqs):
        raise AssertionError("a request did not finish")
    return reqs, eng


def serve_reduced_card_vs_cpu():
    """Reduced zamba2 with the same seeded weights on the card (kernels)
    and on the CPU (plain versions): identical greedy tokens, and the last
    position's logits of every finished sequence within 1e-3."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode as D
    from repro_torch.models.transformer import init_params
    cfg = get_config("zamba2-2.7b").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(DEVICE)
    prompts = serve_prompts(cfg.vocab, 4, 5, 40, 1)
    kw = dict(slots=2, max_len=64, new=8)
    r_cpu, _ = serve(cpu, cfg, prompts, device="cpu", **kw)
    r_card, eng = serve(card, cfg, prompts, device=DEVICE, **kw)
    if [r.out_tokens for r in r_cpu] != [r.out_tokens for r in r_card]:
        raise AssertionError("reduced zamba2: tokens on the card differ "
                             "from the CPU")
    err = 0.0
    for r in r_card:
        seq = torch.as_tensor(list(r.prompt) + r.out_tokens[:-1])[None]
        lc, _ = D.prefill(cpu, cfg, {"tokens": seq}, dtype=torch.float32)
        lg, _ = D.prefill(card, cfg, {"tokens": seq.to(DEVICE)},
                          dtype=torch.float32)
        err = max(err, float((lg.cpu() - lc).abs().max()))
    if not err <= 1e-3:
        raise AssertionError(f"reduced zamba2: last logits differ by {err}")
    log(f"[serve] reduced zamba2 (2 slots, 4 requests, {eng.steps} steps):"
        f" tokens on the card == the CPU; last logits within {err:.3g} "
        "(limit 1e-3)")


def serve_device_busy(model, cfg):
    """The card's busy share in one full-width prefill (996 tokens) and one
    decode step (8 slots at cache length 1,000): device time from a
    torch.profiler trace over the wall time of the same calls unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode as D
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(2, cfg.vocab, (1, 996), generator=gen).to(DEVICE)
    last = torch.randint(2, cfg.vocab, (SERVE["slots"], 1),
                         generator=gen).to(DEVICE)
    cache = D.init_decode_cache(cfg, SERVE["slots"], SERVE["max_len"],
                                torch.float32, DEVICE)
    calls = {
        "prefill": (lambda: D.prefill(model, cfg, {"tokens": toks},
                                      cache_size=SERVE["max_len"],
                                      dtype=torch.float32), 2),
        "decode step": (lambda: D.decode_step(model, cfg, last, cache, 1000,
                                              dtype=torch.float32), 5)}
    out = {}
    for name, (fn, reps) in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        dev = sum(e.self_device_time_total for e in events) / 1e6 / reps
        n_dev = sum(e.count for e in events) / reps
        top = events[:6]
        out[name] = dict(wall_ms=1e3 * wall, device_ms=1e3 * dev,
                         busy=dev / wall, device_ops=n_dev)
        log(f"[serve] {name}: {1e3 * wall:.2f} ms wall, device busy "
            f"{1e3 * dev:.2f} ms ({100.0 * dev / wall:.1f}%), "
            f"{n_dev:.0f} device ops; top: " +
            "; ".join(f"{e.key[:40]} "
                      f"{e.self_device_time_total / 1e3 / reps:.2f} ms"
                      for e in top))
    return out


def phase_serve(report):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import decode as D
    from repro_torch.models import layers, ssm
    from repro_torch.models.transformer import init_params, param_count
    serve_reduced_card_vs_cpu()

    cfg = get_config("zamba2-2.7b")
    t0 = time.monotonic()
    model = init_params(cfg, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    n_params = param_count(model)
    log(f"[serve] {cfg.name} f32 on the card: {n_params:,} parameters, "
        f"{4 * n_params / 1e9:.2f} GB of weights, built in "
        f"{time.monotonic() - t0:.1f}s")
    prompts = serve_prompts(cfg.vocab, SERVE["requests"], *SERVE["prompt"],
                            0)
    keeps = [
        Keep(layers, "rmsnorm_kernel", lambda a, k: (
            f"{'prefill' if a[0].shape[1] > 1 else 'decode'} "
            f"d={a[0].shape[-1]}", a[0].numel())),
        Keep(layers, "flash_attention", lambda a, k: (
            "prefill" if a[0].shape[1] > 1 else "decode",
            a[0].shape[0] * a[0].shape[1]
            * (k.get("kv_valid_len") or a[1].shape[1]))),
        Keep(ssm, "ssd_scan", lambda a, k: ("prefill", a[0].numel()))]
    pre, dec = Timed(D, "prefill"), Timed(D, "decode_step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCH_COUNTS.clear()  # this path's launches start here
    t0 = time.monotonic()
    with keeps[0], keeps[1], keeps[2], pre, dec:
        reqs, eng = serve(model, cfg, prompts, slots=SERVE["slots"],
                          max_len=SERVE["max_len"], new=SERVE["new"],
                          device=DEVICE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: build.LAUNCH_COUNTS[k] for k in LLM_KERNELS}
    if pre.nonfinite or dec.nonfinite:
        raise AssertionError(f"non-finite logits in {pre.nonfinite} "
                             f"prefills and {dec.nonfinite} decode steps")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the serving path never "
                             f"launched: {launches}")
    n_prompt = sum(len(p) for p in prompts)
    n_decoded = sum(len(r.out_tokens) - 1 for r in reqs)
    report["serve"] = dict(
        params=n_params, weight_gb=4 * n_params / 1e9, wall_s=wall,
        prefill_s=pre.seconds, prefill_tok_per_s=n_prompt / pre.seconds,
        decode_ms_per_step=1e3 * dec.seconds / dec.calls,
        decode_tok_per_s=n_decoded / dec.seconds, steps=eng.steps,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    s = report["serve"]
    log(f"[serve] {cfg.name}: {len(reqs)}/{len(reqs)} requests done, "
        f"{SERVE['slots']} slots, prompts {min(map(len, prompts))}.."
        f"{max(map(len, prompts))} tokens ({n_prompt} in all), "
        f"{SERVE['new']} new each, max_len {SERVE['max_len']}; wall "
        f"{wall:.2f}s; prefill {pre.seconds:.2f}s = "
        f"{s['prefill_tok_per_s']:.0f} tokens/s; decode {dec.calls} steps "
        f"{s['decode_ms_per_step']:.2f} ms/step = "
        f"{s['decode_tok_per_s']:.1f} tokens/s; peak memory "
        f"{s['peak_gb']:.2f} GB; launches {launches}")
    report["serve"]["busy"] = serve_device_busy(model, cfg)
    report["serve_kept"] = {"rmsnorm": keeps[0].kept,
                            "flash_attention": keeps[1].kept,
                            "ssd_scan": keeps[2].kept}
    del model
    serve_gemma3(report)


# gemma3-4b at full width: one prompt past the 1,024-token window of its
# local layers, then 8 decode steps (head dim 256: ROADMAP C5)
GEMMA3 = dict(prompt=1100, new=9, max_len=1152)


def serve_gemma3(report):
    """gemma3-4b (34 layers, d = 2560, 8:4 heads of 256), f32, random
    weights from seed 0, one request: every logit finite and attention
    launched through the kernel, counted from 0 just before the run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import decode as D
    from repro_torch.models.transformer import init_params, param_count
    cfg = get_config("gemma3-4b")
    model = init_params(cfg, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    prompts = serve_prompts(cfg.vocab, 1, GEMMA3["prompt"], GEMMA3["prompt"],
                            5)
    pre, dec = Timed(D, "prefill"), Timed(D, "decode_step")
    torch.cuda.synchronize()
    build.LAUNCH_COUNTS.clear()  # this path's launches start here
    with pre, dec:
        reqs, _ = serve(model, cfg, prompts, slots=1,
                        max_len=GEMMA3["max_len"], new=GEMMA3["new"],
                        device=DEVICE)
    torch.cuda.synchronize()
    launches = build.LAUNCH_COUNTS["flash_attention"]
    if pre.nonfinite or dec.nonfinite:
        raise AssertionError(f"gemma3-4b: non-finite logits in "
                             f"{pre.nonfinite} prefills and {dec.nonfinite} "
                             "decode steps")
    if not launches or dec.calls < GEMMA3["new"] - 1:
        raise AssertionError(f"gemma3-4b: {launches} attention launches, "
                             f"{dec.calls} decode steps")
    report["gemma3"] = dict(
        params=param_count(model), prompt=len(prompts[0]),
        tokens=len(reqs[0].out_tokens), prefill_s=pre.seconds,
        decode_ms_per_step=1e3 * dec.seconds / dec.calls,
        flash_attention_launches=launches)
    g = report["gemma3"]
    log(f"[serve] gemma3-4b f32 on the card: {g['params']:,} parameters; "
        f"a {g['prompt']}-token prompt (window 1,024) prefilled in "
        f"{g['prefill_s']:.2f}s, {dec.calls} decode steps at "
        f"{g['decode_ms_per_step']:.2f} ms; logits finite; flash_attention "
        f"launches {launches}")


def phase_llm_kernels_at_serve_shape(report):
    """Time each LLM kernel on the serve run's largest calls and hold it
    against its plain version there (f32)."""
    import torch
    out = report.setdefault("kernels", [])
    for kernel, (source, replaces) in LLM_KERNELS.items():
        rows = []
        for label, (_size, args, kw) in sorted(
                report["serve_kept"][kernel].items()):
            kern, plain = llm_calls(kernel, args, kw)
            got, ref = kern(), plain()
            pairs = zip(got, ref) if kernel == "ssd_scan" else [(got, ref)]
            err = max(close_err(g, r, LLM_TOL["float32"][kernel],
                                f"{kernel} at the serve shape {label}")
                      for g, r in pairs)
            lib = library_call(kernel, args, kw)
            if kernel == "rmsnorm":
                x = args[0]
                flops, nbytes = 4.0 * x.numel(), \
                    2 * x.numel() * x.element_size() + 4 * x.shape[-1]
            rate, rate_name = FP32_OPS_PER_S, "f32 CUDA cores, 67 TFLOP/s"
            if kernel == "flash_attention":
                flops, nbytes = attention_work(args[0], args[1], kw)
                rate, rate_name = attention_rate(args[0], args[1], kw)
            elif kernel == "ssd_scan":
                flops, nbytes = ssd_work(args[0], args[3], kw)
                rate, rate_name = ssd_rate(args[0])
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = flops / rate * 1e3
            rows.append({
                "label": label, "shape": list(args[0].shape),
                "kwargs": {k: v for k, v in kw.items()
                           if not torch.is_tensor(v)},
                "max_abs_err": err, "ms": cuda_median_ms(kern),
                "plain_ms": cuda_median_ms(plain),
                "bound_ms": max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                "bound_rate": rate_name,
                "bound_ms_f32_cuda_cores": max(
                    b_bytes, flops / FP32_OPS_PER_S * 1e3),
                "library_ms": None if lib is None else cuda_median_ms(lib)})
            r = rows[-1]
            # device time alone: the single-call times above include the
            # wrapper's host work (PERF.md section 7)
            r["device_ms"] = graph_ms(kern)
            r["library_device_ms"] = None if lib is None else graph_ms(lib)
            lib_dev = ("none" if lib is None
                       else f"{r['library_device_ms']:.4f} ms")
            log(f"[kernel] {kernel} {label} device time "
                f"{r['device_ms']:.4f} ms, library {lib_dev} (CUDA graph "
                f"of 20 calls; {report['gpu']})")
            lib_txt = ("none" if r["library_ms"] is None
                       else f"{r['library_ms']:.4f} ms")
            log(f"[kernel] {kernel} at the serve shape {label} "
                f"{r['shape']} {r['kwargs']}: {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f} ms, library {lib_txt}, bound "
                f"{r['bound_ms']:.6f} ms by {r['bound_by']}, "
                f"{r['bound_rate']}); max |err| {err:.3g}")
        main = max(rows, key=lambda r: r["bound_ms"])
        out.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": report["serve"]["launches"][kernel],
            "max_abs_err": max([r["max_abs_err"] for r in rows]
                               + [report.get("max_abs_err", {}).get(kernel,
                                                                    0.0)]),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms",
                                    "library_device_ms", "shape")},
            "shapes": rows})


def haswell_scale(report, elapsed_s):
    """1.0, or the largest of 0.5 and 0.25 whose predicted wall (at this
    card's theta greedy rate) still ends inside the time limit."""
    rate = report.get("greedy_s_per_step")
    if rate is None:
        return 1.0
    left = 0.95 * TIME_LIMIT_S - elapsed_s
    for scale in (1.0, 0.5, 0.25):
        if scale * HASWELL_STEPS * HASWELL_STEP_RATIO * rate <= left:
            return scale
    return 0.25


def phase_scale(report, elapsed_s):
    """haswell's greedy batch with ``fused``: tick launches counted from 0
    just before the run, and the tick kernel timed on the run's call at
    its peak window beside its plain version and bound."""
    import torch
    from repro_torch.kernels import build, schedule_tick
    scale = haswell_scale(report, elapsed_s)
    if scale != 1.0:
        ms = report["greedy_s_per_step"] * 1e3
        log(f"[scale] {elapsed_s:.0f}s spent; at {ms:.2f} ms per theta "
            f"greedy step haswell at scale 1.0 would not end inside "
            f"{TIME_LIMIT_S:.0f}s")
    peak = Keep(schedule_tick, "fused_schedule_tick",
                lambda a, k: ("peak", a[1].numel()))
    torch.cuda.synchronize()
    build.LAUNCH_COUNTS.clear()  # this run's launches start here
    t0 = time.monotonic()
    with peak:
        todo, metrics, info = run_grid(("haswell",), scale, 1, "fused",
                                       "cuda",
                                       strategies=("min", "pref", "keeppref"))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = build.LAUNCH_COUNTS["schedule_tick"]
    check_cells(todo, metrics, info, "haswell")
    if not launches:
        raise AssertionError("haswell: the tick kernel never launched")
    cut = "" if scale == 1.0 else f" (CUT from scale 1.0 to {scale})"
    log(f"[scale] haswell scale {scale}{cut}: {len(todo)} greedy cells in "
        f"{wall:.2f}s; {info['greedy_steps']} steps, peak window "
        f"{info['greedy_window']}; schedule_tick launches {launches}")
    _size, args, kw = peak.kept["peak"]
    B, W = args[1].shape
    t = time_tick(args, kw)
    t.update(shape=[B, W], launches=launches, scale=scale)
    log(f"[kernel] schedule_tick at haswell's peak window B={B} W={W}: "
        f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} ms (plain "
        f"{t['plain_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.6f} ms by {t['bound_by']}); bit-equal; "
        f"{report['gpu']}")
    for row in report.get("kernels", []):
        if row["name"] == "schedule_tick":
            row["haswell"] = t
            row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])


def phase_profile(report):
    """Opt-in (``--phases env,profile``): a torch.profiler trace of a small
    theta grid (scale 0.1, 1 seed, fused) -- the device's busy share of the
    wall time and the kernel time by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run_grid(("theta",), 0.1, 1, "fused", "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        todo, _, info = run_grid(("theta",), 0.1, 1, "fused", "cuda")
        torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    events = device_events(prof)
    dev_us = sum(e.self_device_time_total for e in events)
    steps = info["greedy_steps"] + info["balanced_steps"]
    log(f"[profile] theta scale 0.1 fused, {len(todo)} cells, {steps} "
        f"steps: wall {wall_us / 1e6:.2f}s under the profiler, device busy "
        f"{dev_us / 1e6:.3f}s ({100.0 * dev_us / wall_us:.1f}% of wall), "
        f"{sum(e.count for e in events if e.self_device_time_total > 0)} "
        "device ops")
    for e in events[:8]:
        log(f"[profile]   {e.key[:60]:60s} {e.count:8d} calls "
            f"{e.self_device_time_total / 1e3:10.2f} ms device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="env,parity,main,serve,scale",
                    help="comma-separated subset of env,parity,main,serve,"
                         "scale (the default) and the opt-in waterfill, "
                         "waterfill-plans and profile")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = args.phases.split(",")
    report = {}
    t_start = time.monotonic()
    try:
        phase_env(report)
        if "parity" in phases:
            phase_parity(report)
            phase_llm_parity(report)
        if "main" in phases:
            phase_main(report)
            phase_kernels_at_main_shape(report)
        if "serve" in phases:
            phase_serve(report)
            phase_llm_kernels_at_serve_shape(report)
        if "scale" in phases:
            phase_scale(report, time.monotonic() - t_start)
        if "waterfill" in phases:
            time_waterfill_shapes(report)
        if "waterfill-plans" in phases:
            time_waterfill_plans(report)
        if "profile" in phases:
            phase_profile(report)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(f"[done] {time.monotonic() - t_start:.1f}s")
    if "kernels" in report:
        print(json.dumps({"kernels": report["kernels"]}))
    print(report["gpu"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
