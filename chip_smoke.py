#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card, drives the main path
(the paper grid on the batched engine through
``repro_torch.experiments.backend_torch.run_cells``) and prints what it saw.
Phases:

1. environment: versions, the card's name and power limit, the build;
2. kernel parity: the CUDA ``schedule_tick`` and ``waterfill`` kernels
   against their plain versions on seeded random inputs (B = 64 lanes,
   W up to 8192; a 143,829-slot 1-D waterfill), bit-equal, with median
   times (CUDA events, 20 runs);
3. main path: theta at scale 1.0 (2,550 jobs on 4,392 nodes), 2 seeds,
   the paper's five strategies (41 cells), under ``expand_backend`` =
   fused, waterfill and bisect; per-cell metrics must be identical across
   the three and every lane must finish.  Kernel launches are counted per
   run, from 0 just before it.  A small theta grid on the card must also
   equal the plain path on the CPU bit for bit;
4. scale: the greedy batch on haswell at scale 1.0 (the whole trace,
   28,259 jobs on 2,388 nodes) with ``fused``.  Should the time left in
   the smoke's 1,200 s limit not hold it at the rate this card ran the
   theta greedy batch, the scale is cut to the largest of 0.5 and 0.25
   that fits, and the cut is printed.

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
    moved = [PassParams(*(t.to(device) for t in args[0][:9]))]
    moved += [t.to(device) for t in args[1:]]
    prio_lo = -int(p.prio_ref.max())
    prio_hi = int((p.max_nodes - p.prio_ref).max())
    return moved, prio_lo, prio_hi


def tick_bytes(B: int, W: int) -> int:
    # 11 int32/float32 rows + 2 uint8 rows in, 3 rows out, 3 lane scalars
    return B * W * (11 * 4 + 2 + 3 * 4) + B * 12


def tick_ops(B: int, W: int, fill_rounds: int) -> int:
    # the row passes every lane runs (copy-in, step 1, queue snapshot,
    # 3 * fill_rounds fills, surplus, expand flag), ~1 op per slot each;
    # data-dependent shadow / bisection passes are left out -- the bytes
    # bound is the larger by >10x either way
    return B * W * (5 + 3 * fill_rounds)


# --------------------------------------------------------------- phases
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


def waterfill_parity(cap, tgt):
    import torch
    from repro_torch.kernels.ref import waterfill_ref
    from repro_torch.kernels.waterfill import waterfill
    got, ref = waterfill(cap, tgt), waterfill_ref(cap, tgt)
    torch.cuda.synchronize()
    if not identical(got, ref):
        raise AssertionError(f"waterfill kernel differs from plain in "
                             f"{int((got != ref).sum())} slots")
    return (max_abs_err(got, ref), lambda: waterfill(cap, tgt),
            lambda: waterfill_ref(cap, tgt))


def phase_parity(report):
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(11)
    errs = report.setdefault("max_abs_err", {"schedule_tick": 0.0,
                                             "waterfill": 0.0})
    for W in (128, 1000, 2048, 8192):
        case = random_tick_case(gen, 64, W, dev)
        for depth in (None, 2):
            d = None if depth is None else torch.full(
                (64,), depth, dtype=torch.int32, device=dev)
            err, kern, plain = tick_parity(case, d)
            errs["schedule_tick"] = max(errs["schedule_tick"], err)
            log(f"[parity] schedule_tick B=64 W={W} depth={depth}: "
                f"bit-equal; kernel {cuda_median_ms(kern):.3f} ms, plain "
                f"{cuda_median_ms(plain):.3f} ms")
    for shape in ((64, 128), (64, 1000), (64, 2048), (64, 8192), (143_829,)):
        cap = torch.randint(0, 64, shape, generator=gen,
                            dtype=torch.int32).to(dev)
        total = cap.sum(dim=-1, dtype=torch.int32)
        frac = torch.rand(total.shape, generator=gen).to(dev)
        tgt = (frac * 1.2 * total.float()).to(torch.int32)
        err, kern, plain = waterfill_parity(cap, tgt)
        errs["waterfill"] = max(errs["waterfill"], err)
        log(f"[parity] waterfill shape={shape}: bit-equal; kernel "
            f"{cuda_median_ms(kern):.3f} ms, plain "
            f"{cuda_median_ms(plain):.3f} ms")


class Capture:
    """Wraps a kernel wrapper to keep one real main-path call's inputs.

    It keeps references, not copies: the engine builds every tensor out of
    place and never writes into one it has passed on, so a kept call's
    inputs stay as they were, and the timed run pays no device work for
    the capture.
    """

    def __init__(self, module, name, every=97):
        self.module, self.name, self.every = module, name, every
        self.inner = getattr(module, name)
        self.calls, self.kept = 0, None

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.kept is None or self.calls % self.every == 0:
            self.kept = (args, kwargs)
        return self.inner(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


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


def phase_kernels_at_main_shape(report):
    """Time each kernel on a real main-path call's inputs and hold it
    against its plain version there."""
    import torch
    from repro_torch.kernels.ref import waterfill_ref
    from repro_torch.kernels.schedule_tick import fused_schedule_tick
    from repro_torch.kernels.waterfill import waterfill
    from repro_torch.kernels.ref import schedule_tick_ref
    out = []
    args, kw = report["captured"]["schedule_tick"]
    B, W = args[1].shape
    got = fused_schedule_tick(*args, **kw)
    ref = schedule_tick_ref(*args, **kw)
    err = 0.0
    for g, r in zip(got, ref):
        if not identical(g, r):
            raise AssertionError("schedule_tick differs from plain on the "
                                 "captured main-path call")
        err = max(err, max_abs_err(g, r))
    ms = cuda_median_ms(lambda: fused_schedule_tick(*args, **kw))
    plain_ms = cuda_median_ms(lambda: schedule_tick_ref(*args, **kw))
    nbytes = tick_bytes(B, W)
    nops = tick_ops(B, W, kw["fill_rounds"])
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
    out.append({
        "name": "schedule_tick", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/schedule_tick.cu",
        "replaces": "src/repro/kernels/schedule_tick.py:105",
        "launches": report["launches"]["fused"]["schedule_tick"],
        "launches_by_backend": {b: c["schedule_tick"]
                                for b, c in report["launches"].items()},
        "max_abs_err": max(err, report["max_abs_err"]["schedule_tick"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None, "shape": [B, W]})
    log(f"[kernel] schedule_tick at the main-path shape B={B} W={W}: "
        f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_bytes:.6f} ms)")

    (cap, tgt), _ = report["captured"]["waterfill"]
    got, ref = waterfill(cap, tgt), waterfill_ref(cap, tgt)
    if not identical(got, ref):
        raise AssertionError("waterfill differs from plain on the captured "
                             "main-path call")
    rows = cap.reshape(-1, cap.shape[-1])
    ms = cuda_median_ms(lambda: waterfill(cap, tgt))
    plain_ms = cuda_median_ms(lambda: waterfill_ref(cap, tgt))
    nbytes = 2 * 4 * rows.numel() + 4 * rows.shape[0]
    nops = 3 * rows.numel()
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
    out.append({
        "name": "waterfill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/waterfill.cu",
        "replaces": "src/repro/kernels/waterfill.py:29",
        "launches": report["launches"]["waterfill"]["waterfill"],
        "launches_by_backend": {b: c["waterfill"]
                                for b, c in report["launches"].items()},
        "max_abs_err": max(max_abs_err(got, ref),
                           report["max_abs_err"]["waterfill"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None, "shape": list(rows.shape)})
    log(f"[kernel] waterfill at the main-path shape {tuple(rows.shape)}: "
        f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_bytes:.6f} ms)")
    report["kernels"] = out


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
    import torch
    scale = haswell_scale(report, elapsed_s)
    if scale != 1.0:
        ms = report["greedy_s_per_step"] * 1e3
        log(f"[scale] {elapsed_s:.0f}s spent; at {ms:.2f} ms per theta "
            f"greedy step haswell at scale 1.0 would not end inside "
            f"{TIME_LIMIT_S:.0f}s")
    t0 = time.monotonic()
    todo, metrics, info = run_grid(("haswell",), scale, 1, "fused", "cuda",
                                   strategies=("min", "pref", "keeppref"))
    torch.cuda.synchronize()
    check_cells(todo, metrics, info, "haswell")
    cut = "" if scale == 1.0 else f" (CUT from scale 1.0 to {scale})"
    log(f"[scale] haswell scale {scale}{cut}: {len(todo)} greedy cells in "
        f"{time.monotonic() - t0:.2f}s; {info['greedy_steps']} steps, peak "
        f"window {info['greedy_window']}")


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
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events)
    steps = info["greedy_steps"] + info["balanced_steps"]
    log(f"[profile] theta scale 0.1 fused, {len(todo)} cells, {steps} "
        f"steps: wall {wall_us / 1e6:.2f}s under the profiler, device busy "
        f"{dev_us / 1e6:.3f}s ({100.0 * dev_us / wall_us:.1f}% of wall), "
        f"{sum(e.count for e in events if e.self_device_time_total > 0)} "
        "device ops")
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    for e in top:
        log(f"[profile]   {e.key[:60]:60s} {e.count:8d} calls "
            f"{e.self_device_time_total / 1e3:10.2f} ms device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="env,parity,main,scale",
                    help="comma-separated subset of env,parity,main,scale "
                         "(the default) and the opt-in profile")
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
        if "main" in phases:
            phase_main(report)
            phase_kernels_at_main_shape(report)
        if "scale" in phases:
            phase_scale(report, time.monotonic() - t_start)
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
