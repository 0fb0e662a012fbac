#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card, drives the port's two
main paths (the paper grid on the batched engine through
``repro_torch.experiments.backend_torch.run_cells`` and the experiment
layer around it, ``python -m repro_torch.experiments``; the what-if query
service, ``python -m repro_torch.serve``; LLM serving through
``repro_torch.serve.engine.ServeEngine``; the encoder-decoder and the
vision prefix through ``repro_torch.models.decode.prefill`` /
``decode_step``; and LLM training through ``repro_torch.launch.train``)
and prints what it saw.
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
   ``order``, and after the replays of a CUDA graph; the 1-D
   ``greedy_shrink_waterfill`` / ``greedy_expand_waterfill`` wrappers
   bit-equal to the numpy redistribution (777 slots, 4 needs and 3
   idles; a 143,829-slot row), one waterfill launch a call; then
   ``rmsnorm``, ``flash_attention`` and ``ssd_scan`` in f32 and bf16 at
   the serving path's zamba2-2.7b shapes, a ragged and a GQA shape
   (Hkv = 4, 8 groups), gemma3-4b's and glm4-9b's attention shapes (head
   dims 256 and 128), a 4,096-token scan (32 chunks) and rmsnorm rows that
   take scalar accesses (d = 2561; bf16 d = 20), within the tolerances of
   ``tests/test_kernels.py``
   (f32 2e-5 / 2e-5 / 2e-4, bf16 2e-2 / 2e-2 / 5e-2); median times (CUDA
   events, 20 runs) of kernel and plain version;
3. main path: theta at scale 1.0 (2,550 jobs on 4,392 nodes), 2 seeds,
   the paper's five strategies (41 cells) under ``expand_backend`` =
   fused, and its greedy-structured strategies (EASY, MIN, PREF,
   KEEPPREF: 31 cells) under waterfill and bisect (AVG's balanced lanes
   run the same plain pass under every backend and launch nothing); the
   31 cells' metrics must be identical across the three and every lane
   must finish.  The fused run takes the greedy lanes first; then the
   card runs waterfill while two worker processes run the fused run's
   balanced lanes on the card and bisect on the CPU.  Where the time left
   would not hold a waterfill run of all 31 lanes that ends after the
   balanced lanes, and the phases after it at their least scales
   (predicted at the fused run's greedy rate), waterfill and bisect take
   seed 0's 16 lanes (EASY, MIN, PREF and KEEPPREF; KEEPPREF at 0.4
   reaches the 256-slot window: both warp tiers), with the whole batch's
   lane statics; the rule's choice is printed, a cut as CUT.  Kernel launches are counted per run and process, from 0
   just before the run.  A small theta grid on the card must also
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
5. moe: the MoE family through the port's LLM layer, f32, random weights
   from seed 0, launches counted from 0 just before each run: (a) reduced
   olmoe-1b-7b and reduced deepseek-v2-236b, the same seeded weights on
   the card and on the CPU, identical tokens and last logits within 1e-3;
   (b) olmoe-1b-7b at full width and depth (16 MoE layers of 64 experts,
   top-8): 6 requests of 64..512 prompt tokens, 16 new tokens each, 4
   slots; (c) deepseek-v2-236b at full width cut to 2 layers (its dense
   MLA layer and one MoE layer of 160 routed experts, top-6, and 2 shared
   ones): one 512-token prompt and 5 decode steps.  Each run: every logit
   finite, rmsnorm and flash_attention launched; prints parameters,
   prefill s, decode ms per step, tokens and launches.  (d)
   flash_attention at DeepSeek's prefill call (1 x 512 x 128 heads, keys
   192, values 128) held to its plain version in f32 (the run's own call)
   and bf16, and timed beside SDPA; rmsnorm at MLA's q_norm / kv_norm
   calls (widths 1,536 and 512);
6. encdec: the encoder-decoder and the modality frontends through the
   port's LLM layer, f32, random weights from seed 0, launches counted
   from 0 just before each run: (a) reduced whisper-large-v3 and reduced
   internvl2-2b (with patches), the same seeded weights and inputs on the
   card and on the CPU, through ``prefill`` and 8 greedy ``decode_step``s:
   identical tokens and last logits within 1e-3; (b) whisper-large-v3 at
   full width and depth (32 + 32 layers): 4 utterances of 1,500 frame
   embeddings from the seed (the audio frontend is a stub), a 4-token
   prompt, 60 greedy tokens, a 448-row cache; (c) internvl2-2b at full
   width and depth: 4 sequences of 256 patch embeddings and 128 tokens,
   32 greedy tokens, then 4 text-only requests of 64..256 tokens through
   the engine (2 slots, 16 new each).  Each run: logits finite,
   flash_attention launched in every call form (whisper: the encoder's
   non-causal prefill, the cross-attention prefill and decode, the
   decoder's own prefill and decode), rmsnorm for internvl2; prints
   encoder s, prefill s, decode ms per step, peak memory, launches per
   prefill and per decode step and the busy share of one prefill and one
   decode step.  (d) flash_attention in each call form, the run's own
   call (f32) and its bf16 copy, held to its plain version and timed
   beside SDPA with the call's own ``causal``; rmsnorm at internvl2's
   calls (1,536 x 2,048 and 4 x 2,048) beside ``F.rms_norm``;
7. train: training through the port's LLM layer on the hand-written
   backward kernels of RMSNorm, flash attention and the SSD scan: (a) each
   backward kernel against its plain version (``rmsnorm_bwd_ref``,
   ``attention_bwd_ref``, ``ssd_bwd_ref``) in f32 and bf16 -- rmsnorm at
   2,048 x 2,048 (internvl2's training rows), 996 x 2,560, d = 2,561,
   2,048 x 8,192 (qwen2-72b's width) and 256 x 32,768 (past the
   registers: each row walked twice), with its launch plan printed;
   attention at internvl2's training call (4 x 512, 16 / 8 heads of 128,
   causal), gemma3's (head 256, window 1,024), DeepSeek-V2's widths
   (192 / 128), whisper's encoder (4 x 1,500 x 20 x 64, non-causal) and
   its cross attention (448 queries over 1,500 keys); the SSD scan at
   zamba2-2.7b's training call (4 x 512, 80 heads, P = N = 64), zamba2's
   serve prefill (1 x 996, ragged against the chunk), mamba2-1.3b's width
   (4 x 512, 64 heads, N = 128) and a small call from an initial state,
   on the forward's saved states, with its plan printed -- within 2e-4
   (f32) / 5e-2 (bf16) of the largest |ref|, the same bits on a second
   call; median times (CUDA events, 20 runs), device times (a CUDA graph
   of 20 calls), the plain backward's time, and the kernel's forward +
   backward beside ``F.rms_norm``'s / SDPA's through autograd (the SSD
   scan has no library call); (b) one f32 ``make_train_step`` step of
   each reduced architecture (stablelm, gemma3, glm4, qwen2, olmoe,
   DeepSeek, internvl2 with patches, whisper, mamba2, zamba2), the same
   seeded weights and batch on the card and the CPU: loss within 1e-4,
   every gradient within 1e-3 of its largest |value|, every updated
   parameter within 1e-5; ``accum_steps`` 2 the same; a
   ``compress_grads`` step's loss; remat none / dots / full the same loss
   and gradient norm on the card for olmoe and zamba2, reduced; (c)
   internvl2-2b at full width and depth through
   ``repro_torch.launch.train.train`` (the code of ``python -m
   repro_torch.launch.train``): 8 steps of 4 x (256 patches + 256 tokens),
   bf16 compute, f32 params, AdamW with the reference's defaults, remat
   ``dots``: every loss and gradient norm finite, every parameter finite
   and changed, launches a step of rmsnorm, rmsnorm_bwd, flash_attention,
   flash_attention_bwd, ssd_scan and ssd_scan_bwd (counted from 0 just
   before the run) equal to what the model's plan gives, and no call to a
   plain version (each wrapped with a counter); s / step, positions / s,
   peak memory, and a torch.profiler trace of one step (busy share,
   device time by kind: GEMMs, the kernels' forward and backward, the
   optimizer); (c') zamba2-2.7b at full width and depth the same way, 4 x
   512 tokens, 6 steps (4 where the time left would not hold the phases
   after it at their least scales; printed as CUT): all six LLM kernels,
   forward and backward.  Each backward kernel is then timed on (c)'s or
   (c')'s own call (bf16 and f32);
8. registry: the rest of the strategy registry through ``run_cells``, on
   theta at scale 0.1 (255 jobs on 4,392 nodes, 1 seed, proportions 0.2 /
   0.6 / 1.0): SJF with MIN, KEEPPREF, PREF_COMMON_POOL and
   STEAL_AGREEMENT (greedy, pooled and stealing batches; 13 cells) under
   fused, waterfill and bisect, and on-demand job classes (10% rigid, 10%
   on-demand) with PREF, RIGID_SJF and PREF_COMMON_POOL (a greedy batch of
   FCFS and SJF lanes, a pooled batch; 8 cells) under fused and bisect.
   Per-cell metrics identical across backends, every lane finished, the
   tick launched only by the SJF fused run, waterfill by every fused and
   waterfill run, nothing by bisect; both runs on the card equal the CPU
   bit for bit at scale 0.02; a captured SJF-permuted tick call and a
   captured pooled / stealing give held to their plain versions and timed
   as in phase 3; each batch's wall, steps, window and ms per step, and the
   SJF greedy step beside the main phase's FCFS one.  Cut to scale 0.05,
   printed, if the time left would not hold it;
9. experiment: ``python -m repro_torch.experiments``'s ``main(argv)`` as
   a user runs it, each group of runs in a fresh temporary directory
   outside the repository, kernel launches counted from 0 before each
   run: (a) haswell at scale 0.02, 2 seeds, ``--crosscheck 2
   --require-crosscheck`` with a cell store, an artifact, a Chrome trace,
   a JSONL log and the heartbeat (rc 0, the tick launched, the artifact
   reloads for its spec, the trace holds the pipeline's spans); (b) the
   same with ``--expect-cached`` (rc 0, no kernel launched, the two DES
   cells read from the store); (c) ``--engine des --workers 2`` on that
   store (rc 0, the crosschecked cells read from it); (d) knl and eagle
   at scale 0.01 in one run, ``--crosscheck 2`` (each crosschecked cell's
   worst relative error); (e) knl at 0.01, MIN and KEEPPREF, swept over
   ``backfill_depth`` 1 / 4 / 256 (the table); (f) the DES crosscheck of
   4 of the main phase's fused theta scale-1.0 cells (seed 0), its deltas
   and DES seconds printed and not gated: a breach there is the batched
   engine's methodology gap, which the port shares with the JAX engine.
   Each run prints its wall, cells computed, store hits, launches and
   DES seconds;
10. whatif: the what-if query service (``repro_torch.serve``) in a fresh
   temporary cell store outside the repository: (a) 16 seeded queries at
   theta scale 1.0 (MIN, PREF, KEEPPREF, EASY; proportions 0.2 / 0.4 /
   0.6 / 1.0; 2 seeds; 10 distinct cells) submitted from 4 client threads
   into a paused engine (``fused``, ``max_batch`` 16): one coalesced
   greedy batch, every query answered, the tick launched (counted from 0
   just before), at least 2 queries deduplicated, and every answer equal
   to ``run_cells``' cell (the main phase's, else one direct call); (b)
   the same queries through ``python -m repro_torch.serve``'s
   ``main(argv)`` with ``--expect-hits``: rc 0, every query a store hit,
   no kernel launched; (c) ``serve_http`` on a free local port: a stored
   cell's ``POST /whatif`` returns the storm's metrics, ``GET /stats`` and
   ``/healthz`` answer 200, a bad strategy 400; (d) theta at scale 0.1, 1
   seed (cut to 0.05, printed, if the time left would not hold it and the
   dense and scale phases), a greedy batch of FCFS and SJF lanes (the tick)
   and one of
   on-demand class lanes (the waterfill give), each run monolithic, in
   chunks of 2 lanes and split in 2 pieces on ``cuda:0`` (two threads):
   per-cell metrics identical; and a storm at theta 0.02 (greedy and
   balanced lanes) on the card equal to the same storm on the CPU bit for
   bit.  Prints wall, batches, coalesce widths, steps and launches;
11. dense: the dense per-tick engine (``repro_torch.core.sim_dense``,
   one scheduling pass a tick over whole job tensors), launches counted
   from 0 before each run: (a) the 20-job workload of
   ``tests/test_sim_jax.py`` on 10 nodes for 800 ticks under the 8
   registry strategies, a class workload (10% rigid, 10% on-demand) and
   an SJF run, under ``fused`` (and MIN under ``waterfill``), each equal
   bit for bit in every field of ``SimState`` / ``SimTrace`` to
   ``bisect`` on the CPU (run in worker processes meanwhile), one launch
   a tick of the kernel the backend routes the pass to; (b) knl at scale
   0.01 (415 jobs on 9,688 nodes, tick 10 s, 5,000 ticks): MIN at
   proportions 0.2 / 0.6 / 1.0 as one ``simulate_scan_batch`` and EASY as
   one ``simulate_dense`` lane under ``fused``: every job DONE, busy <=
   9,688 nodes at every tick, 5,000 tick launches a run, the first 1,000
   ticks equal to ``bisect``; wall, ms a tick and each lane's mean
   turnaround beside the port's DES (not gated); the tick kernel timed on
   the batch's 450th call (3 x 415 slots, priority bounds +-4 x 9,688);
12. scale: the greedy batch on haswell at scale 1.0 (the whole trace,
   28,259 jobs on 2,388 nodes) with ``fused``, tick launches counted from
   0 just before it; the tick kernel is then timed on the run's call at
   its peak window (B = 16, W = 16,384): single-call and device (CUDA
   graph) times beside its plain version and bound.  Should the time
   left in the smoke's 1,200 s limit not hold it at the rate this card
   ran the theta greedy batch, the scale is cut to
   the largest of 0.5 and 0.25 that fits, and the cut is printed.

Opt-in, ``--phases env,bwd-ab`` (``--ab-csrc`` another tree's kernel
sources): the backward kernels of this tree against another's in one
process, device time in turns other / this / this / other and each
kernel's time a launch; ``--phases
env,rmsnorm-plans``: device times of hand-made plans of the RMSNorm
backward at ``RMS_BWD_SHAPES``.

Opt-in, ``--phases env,paper-scale`` (give the call ``--timeout`` a few
minutes above ``--paper-scale-budget``, 2,700 s by default): knl at scale
1.0 (41,524 jobs on 9,688 nodes), 1 seed, EASY, MIN, PREF and KEEPPREF
(16 cells) under fused and bisect, metrics identical; then eagle at scale
1.0 (143,829 jobs on 2,568 nodes) through ``python -m
repro_torch.experiments`` with ``--chunk-lanes 4`` and a cell store, and
its ``--expect-cached`` rerun (every cell a hit, no launch).  The strategies
are cut, and the cut printed, where the run predicted from knl's fused
wall would not end inside the budget.

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
import re
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
# step over the theta fused greedy batch's: 1.18-1.73 on H100 runs
# (PERF.md section 5), so the largest, that a slow haswell run still ends
# inside the time limit
HASWELL_STEPS = 52_160
HASWELL_STEP_RATIO = 1.75
# the registry phase at theta scale 0.1: scan steps of its batches that run
# the plain pass, and the plain pass's wall per step over the theta fused
# greedy batch's (PERF.md section 5; 4.4 on an H100 run at 6.53 ms a greedy
# step, whose phase at 0.1 took ~230 s and ended the smoke at 1,183.7 s;
# 4.72 on one at 5.72 ms, ~216 s, the smoke ended at 1,161.2 s)
REGISTRY_STEPS = 8_000
REGISTRY_STEP_RATIO = 4.8
# what-if (d) at theta scale 0.1: scan steps of its six runs, and their
# wall per step over the theta fused greedy batch's (4.2 on H100 runs at
# 3.84 and 5.34 ms a greedy step, 4.65 on one at 5.72 ms); the dense
# phase's wall in theta fused greedy steps (13,570-15,000 on the same
# runs, 17,552 on the 5.72 ms one; PERF.md section 5)
WHATIF_D_STEPS = 4_320
WHATIF_D_STEP_RATIO = 4.8
DENSE_GREEDY_STEPS = 17_600
# the main phase's waterfill run (D8), beside which run the fused run's
# balanced lanes (a worker process on the card) and bisect (a worker
# process on the CPU): the waterfill run's wall per step over the fused
# greedy step (2.80-3.06 on H100 runs at 4.16-6.57 ms a greedy step, alone
# or beside the workers: the largest); the balanced lanes' steps and their
# wall per step over the same (4.01-4.85, alone or in the worker: the
# least, so that the rule does not count on a longer shadow than it gets);
# and what the phases after the main one take at their least scales, in
# fused greedy steps (smokes took ~600 s after the main phase on a host at
# 5.15 ms a step, ~690 s on one at 4.16 ms, both with the registry at
# scale 0.1: the wall of those phases follows the host only in part)
MAIN_WATERFILL_RATIO = 3.1
MAIN_BALANCED_STEPS = 5_280
MAIN_BALANCED_RATIO = 4.0
MAIN_AFTER_STEPS = 120_000
# the experiment phase's wall and what-if (a)-(c)'s, in theta fused greedy
# steps (two H100 runs at 6.80-6.88 ms a greedy step took 125-130 s and
# 56-61 s: ~19,000 and ~8,300 steps)
EXPERIMENT_STEPS = 19_000
WHATIF_ABC_STEPS = 8_300


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
    wrapper_parity(report)


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


def wrapper_parity(report):
    """``greedy_shrink_waterfill`` / ``greedy_expand_waterfill`` (the
    reference's ``greedy_*_pallas``) on the card equal the numpy
    redistribution bit for bit, one waterfill launch a call:
    ``tests/test_kernels.py``'s 777-slot case (4 needs, 3 idles) and one
    143,829-slot row (the look-back tier; mid-row need and idle).  Keeps
    the long row's shrink call for the kernels line."""
    import numpy as np
    import torch
    from repro_torch.core.passes import greedy_expand, greedy_shrink
    from repro_torch.kernels import build, waterfill
    calls = 0
    for n, seed in ((777, 17), (143_829, 18)):
        rng = np.random.default_rng(seed)
        alloc = rng.integers(1, 64, size=n).astype(np.int64)
        floor = np.maximum(alloc - rng.integers(0, 32, size=n), 1)
        cap = alloc + rng.integers(0, 32, size=n)
        prio = rng.normal(size=n)
        surplus, room = int((alloc - floor).sum()), int((cap - alloc).sum())
        a, f, c, pr = (torch.from_numpy(x).cuda()
                       for x in (alloc, floor, cap, prio))
        cases = (("shrink", waterfill.greedy_shrink_waterfill, greedy_shrink,
                  f, floor, (0, 100, 10_000, surplus) if n == 777
                  else (surplus // 2,)),
                 ("expand", waterfill.greedy_expand_waterfill, greedy_expand,
                  c, cap, (0, 100, 10_000) if n == 777 else (room // 2,)))
        for kind, fn, plain, bound_d, bound, amounts in cases:
            for amount in amounts:
                with Capture(waterfill, "waterfill") as kept:
                    before = build.LAUNCH_COUNTS["waterfill"]
                    got = fn(a, bound_d, pr, amount)
                    torch.cuda.synchronize()
                calls += 1
                if build.LAUNCH_COUNTS["waterfill"] != before + 1:
                    raise AssertionError(f"greedy {kind} over {n} slots "
                                         "made other than one launch")
                exp = plain(alloc, bound, prio, amount, xp=np)
                if got.cpu().numpy().tobytes() != \
                        exp.astype(np.int32).tobytes():
                    raise AssertionError(f"greedy {kind} over {n} slots "
                                         f"({amount}) differs from numpy")
                if n > 777 and kind == "shrink":
                    report["wrapper_call"] = kept.kept
        log(f"[parity] greedy shrink / expand wrappers over {n} slots: "
            f"bit-equal to the numpy redistribution for "
            f"{len(cases[0][-1])} needs and {len(cases[1][-1])} idles, one "
            f"waterfill launch a call")
    report["wrapper_launches"] = calls


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
    """Wraps a kernel wrapper to keep one real main-path call's inputs
    (the first and every ``every``-th, or only call number ``at``).

    It keeps references, not copies: the engine builds every tensor out of
    place and never writes into one it has passed on, so a kept call's
    inputs stay as they were, and the timed run pays no device work for
    the capture.
    """

    def __init__(self, module, name, every=97, at=None):
        super().__init__(module, name)
        self.every, self.at = every, at
        self.calls, self.kept = 0, None

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if (self.calls == self.at if self.at else
                self.kept is None or self.calls % self.every == 0):
            self.kept = (args, kwargs)
        return self.inner(*args, **kwargs)


def run_grid(workloads, scale, seeds, backend, device, keep=None,
             **spec_kw):
    """``run_cells`` over a spec of ``workloads`` at ``scale`` (``spec_kw``:
    strategies, proportions, scenario; ``keep``: only these cells, or
    "seed 0" for seed 0's); returns (todo, metrics, info)."""
    from repro_torch.experiments.backend_torch import run_cells
    from repro_torch.experiments.spec import ExperimentSpec
    spec = ExperimentSpec(workloads=workloads, scale=scale, seeds=seeds,
                          **spec_kw)
    todo = [(w, c) for w in spec.workloads for c in spec.cells()
            if keep is None or (c[2] == 0 if keep == "seed 0" else
                                c in keep)]
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


def metric_diffs(a, b, limit=4):
    """The first ``limit`` (cell, metric, a, b) where ``a`` and ``b`` differ
    (for failure messages)."""
    out = []
    for k in a:
        for key in sorted(set(a[k]) | set(b.get(k, {}))):
            x, y = a[k].get(key), b.get(k, {}).get(key)
            if x is None or y is None or not (
                    x == y or (math.isnan(x) and math.isnan(y))):
                out.append((k, key, x, y))
    return out[:limit]


def check_cells(todo, metrics, info, label):
    if info["incomplete"]:
        raise AssertionError(f"{label}: {len(info['incomplete'])} lanes "
                             "did not finish")
    for key in todo:
        u = metrics[key]["utilization"]
        if not 0.0 <= u <= 1.0:
            raise AssertionError(f"{label}: utilization {u} of {key} "
                                 "outside [0, 1]")


def theta_on_both_devices(tag, scale, **spec_kw):
    """The engine on the card (fused) equals the plain path on the CPU,
    bit for bit, on a small theta grid (1 seed; ``spec_kw`` as in
    :func:`run_grid`), one batch per structure."""
    import numpy as np
    from repro_torch.core import get_strategy
    from repro_torch.experiments.spec import ExperimentSpec, prepare_workload
    from repro_torch.sweep.batch import (EngineConfig, build_lanes,
                                         simulate_lanes)
    spec = ExperimentSpec(workloads=("theta",), scale=scale, seeds=1,
                          **spec_kw)
    cl, w, _ = prepare_workload(spec, "theta")
    groups = {}
    for s, p, sd in spec.cells():
        groups.setdefault(get_strategy(s).structure, []).append(
            (get_strategy(s), p, sd))
    for structure, lanes in groups.items():
        res = {}
        for dev, backend in (("cpu", "bisect"), ("cuda", "fused")):
            batch, _ = build_lanes(
                w, cl.nodes, lanes, config=spec.transform, tick=cl.tick,
                backfill_depth=spec.scenario.backfill_depth,
                queue_order=spec.scenario.queue_order, device=dev)
            res[dev] = simulate_lanes(batch, EngineConfig(
                structure=structure, expand_backend=backend))
        for key in ("state", "alloc", "start_t", "end_t", "expand_ops",
                    "shrink_ops", "bf_starts", "sched_steps"):
            if not np.array_equal(res["cpu"][key], res["cuda"][key],
                                  equal_nan=True):
                raise AssertionError(f"theta scale {scale} {structure}: "
                                     f"{key} on the card differs from the "
                                     "CPU")
        if not (res["cpu"]["finished"] and res["cuda"]["finished"]):
            raise AssertionError(f"theta scale {scale} {structure}: lanes "
                                 "did not finish")
        log(f"[{tag}] theta scale {scale} {structure} ({len(lanes)} lanes): "
            "the card (fused) == the plain path on the CPU, bit for bit")


# the strategies of the main phase's waterfill and bisect runs: the
# greedy-structured ones (31 lanes), whose pass each backend routes
# differently; AVG's balanced lanes run the same plain pass under every
# backend and launch nothing, so the fused run alone takes them
GREEDY_STRATEGIES = ("min", "pref", "keeppref")
# the lane sets of those runs, largest first: (name, the cells kept or None
# for all 31, the batch's steps).  Each keeps EASY, MIN, PREF and KEEPPREF
# and both warp tiers of the two kernels (windows of 128 and 256 slots:
# KEEPPREF at proportion 0.4 grows to 256).  Seed 0's run ends before the
# balanced lanes beside it (6,720 steps x MAIN_WATERFILL_RATIO against
# MAIN_BALANCED_STEPS x MAIN_BALANCED_RATIO), so no smaller set would end
# the phase sooner
MAIN_LANE_SETS = (
    ("every greedy lane", None, 7_200),
    ("seed 0's lanes", "seed 0", 6_720))


def main_lanes(report, elapsed_s):
    """The largest of ``MAIN_LANE_SETS`` whose waterfill run (its steps at
    this card's theta greedy rate times ``MAIN_WATERFILL_RATIO``) ends no
    later than the fused run's balanced lanes beside it or, where it would,
    still leaves the phases after the main one at their least scales
    (``MAIN_AFTER_STEPS``) inside the time limit; the smallest when none
    does (it ends before the balanced lanes)."""
    rate = report.get("greedy_s_per_step")
    if rate is None:
        return MAIN_LANE_SETS[0]
    left = 0.95 * TIME_LIMIT_S - elapsed_s - MAIN_AFTER_STEPS * rate
    room = max(left, MAIN_BALANCED_STEPS * MAIN_BALANCED_RATIO * rate)
    for lanes in MAIN_LANE_SETS:
        if lanes[2] * MAIN_WATERFILL_RATIO * rate <= room:
            return lanes
    return MAIN_LANE_SETS[-1]


class FullStatics(Patch):
    """Hands every batch the statics of the main phase's whole greedy batch
    (``lane_statics``): a cut lane set runs its lanes as the whole batch
    runs them (the bisection bounds, the starting window; C7)."""

    def __init__(self, statics):
        from repro_torch.sweep import shard
        super().__init__(shard, "lane_statics")
        self.statics = statics

    def __call__(self, batch):
        return self.statics


def greedy_statics(device="cuda"):
    """``lane_statics`` of the main phase's theta greedy batch (31 lanes)
    on ``device``."""
    from repro_torch.core import get_strategy
    from repro_torch.experiments.spec import ExperimentSpec, prepare_workload
    from repro_torch.sweep.batch import build_lanes, lane_statics
    spec = ExperimentSpec(workloads=("theta",), scale=1.0, seeds=2,
                          strategies=GREEDY_STRATEGIES)
    cl, w, _ = prepare_workload(spec, "theta")
    lanes = [(get_strategy(st), p, sd) for st, p, sd in spec.cells()]
    batch, _ = build_lanes(w, cl.nodes, lanes, config=spec.transform,
                           tick=cl.tick,
                           backfill_depth=spec.scenario.backfill_depth,
                           queue_order=spec.scenario.queue_order,
                           device=device)
    return lane_statics(batch)


def balanced_cells():
    """The main grid's cells outside the greedy runs: AVG's balanced
    lanes."""
    from repro_torch.experiments.spec import ExperimentSpec
    greedy = set(ExperimentSpec(workloads=("theta",), scale=1.0, seeds=2,
                                strategies=GREEDY_STRATEGIES).cells())
    return tuple(c for c in ExperimentSpec(workloads=("theta",), scale=1.0,
                                           seeds=2).cells()
                 if c not in greedy)


def main_worker(backend, device, keep, cut):
    """One of the main phase's runs in a worker process, beside the card's
    waterfill run: the fused run's balanced lanes on the card, or the
    bisect run on the CPU.  ``keep``: the cells (None: the 31 greedy
    ones); ``cut``: run them with the whole greedy batch's lane statics.
    Returns ``(todo, metrics, info, launches)``, the launches this
    process's wrappers counted from 0 just before the run."""
    import contextlib
    import torch
    from repro_torch.kernels import build
    torch.set_num_threads(2)
    statics = (FullStatics(greedy_statics(device)) if cut
               else contextlib.nullcontext())
    spec_kw = {} if backend == "fused" else {"strategies": GREEDY_STRATEGIES}
    with statics:
        if device == "cuda":
            torch.cuda.synchronize()
        build.LAUNCH_COUNTS.clear()  # this run's launches start here
        todo, metrics, info = run_grid(("theta",), 1.0, 2, backend, device,
                                       keep=keep, **spec_kw)
        if device == "cuda":
            torch.cuda.synchronize()
    launches = {k: build.LAUNCH_COUNTS[k]
                for k in ("schedule_tick", "waterfill")}
    check_cells(todo, metrics, info, f"theta/{backend} on the {device}")
    return todo, metrics, {k: info[k] for k in ("wall_s", "chunks")}, \
        launches


def phase_main(report, elapsed_s=0.0):
    import concurrent.futures
    import contextlib
    import multiprocessing
    import torch
    from repro_torch.kernels import build, schedule_tick, waterfill
    t_phase = time.monotonic()
    theta_on_both_devices("main", 0.05)

    def log_run(backend, todo, info, delta, where=""):
        batches = "; ".join(
            f"{c['structure']} {c['lanes']} lanes {c['steps']} steps "
            f"window {c['window']} {c['wall_s']:.2f}s"
            for c in info["chunks"])
        log(f"[main] theta scale 1.0 {backend}{where}: {len(todo)} cells in "
            f"{info['wall_s']:.2f}s ({len(todo) / info['wall_s']:.3f} "
            f"cells/s); {batches}; launches {delta}")

    def card_run(backend, **spec_kw):
        torch.cuda.synchronize()
        build.LAUNCH_COUNTS.clear()  # this path's launches start here
        todo, metrics, info = run_grid(("theta",), 1.0, 2, backend, "cuda",
                                       strategies=GREEDY_STRATEGIES,
                                       **spec_kw)
        torch.cuda.synchronize()
        delta = {k: build.LAUNCH_COUNTS[k]
                 for k in ("schedule_tick", "waterfill")}
        check_cells(todo, metrics, info, f"theta/{backend}")
        log_run(backend, todo, info, delta,
                " (greedy lanes)" if backend == "fused" else "")
        return todo, metrics, info, delta

    runs = {}
    tick_cap = Capture(schedule_tick, "fused_schedule_tick")
    wf_cap = Capture(waterfill, "waterfill")
    with tick_cap, wf_cap, concurrent.futures.ProcessPoolExecutor(
            max_workers=2,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        _todo, metrics, info, delta = card_run("fused")
        runs["fused"] = (metrics, info, delta)
        rate = report["greedy_s_per_step"] = (
            next(c["wall_s"] for c in info["chunks"]
                 if c["structure"] == "greedy") / info["greedy_steps"])
        at = elapsed_s + time.monotonic() - t_phase
        name, keep, steps = main_lanes(report, at)
        end = at + (max(steps * MAIN_WATERFILL_RATIO,
                        MAIN_BALANCED_STEPS * MAIN_BALANCED_RATIO)
                    + MAIN_AFTER_STEPS) * rate
        log(f"[main] time left: {at:.0f}s spent, {rate * 1e3:.2f} ms a "
            "theta greedy step; the fused run's balanced lanes (a worker "
            "process on the card) and bisect (a worker process on the CPU) "
            f"run beside waterfill, which takes {name} with bisect (~{steps} "
            "steps; with the later phases at their least scales the smoke "
            f"would end at {end:.0f}s)" + (
                "" if keep is None else
                " (CUT from every greedy lane: those runs and the phases "
                f"after them would not end inside "
                f"{0.95 * TIME_LIMIT_S:.0f}s; the whole batch's lane "
                "statics)"))
        balanced = pool.submit(main_worker, "fused", "cuda",
                               balanced_cells(), False)
        bisect = pool.submit(main_worker, "bisect", "cpu", keep,
                             keep is not None)
        with (contextlib.nullcontext() if keep is None
              else FullStatics(greedy_statics())):
            _todo, metrics, info, delta = card_run(
                "waterfill", **({} if keep is None else {"keep": keep}))
        runs["waterfill"] = (metrics, info, delta)
        todo, metrics, info, delta = balanced.result()
        log_run("fused", todo, info, delta,
                " (balanced lanes, a worker process on the card beside the "
                "waterfill run)")
        fused, finfo, fdelta = runs["fused"]
        runs["fused"] = ({**fused, **metrics},
                         {**finfo, "chunks": finfo["chunks"] + info["chunks"]},
                         {k: fdelta[k] + delta[k] for k in fdelta})
        if any(delta.values()):
            raise AssertionError(f"fused run's balanced lanes launch {delta}")
        todo, metrics, info, delta = bisect.result()
        runs["bisect on the CPU"] = (metrics, info, delta)
        log_run("bisect", todo, info, delta,
                " on the CPU (a worker process, beside the waterfill run)")
    report["launches"] = {b: runs[b][2] for b in runs}
    fused, wfill, bisect = (runs[b][0] for b in ("fused", "waterfill",
                                                 "bisect on the CPU"))
    n_kept = 31 if keep is None else len(wfill)
    if len(fused) != 41 or len(wfill) != n_kept or len(bisect) != n_kept \
            or n_kept < 4:
        raise AssertionError(f"expected 41 / 31 / 31 theta cells (or the "
                             f"cut's), got {len(fused)} / {len(wfill)} / "
                             f"{len(bisect)}")
    greedy_cells = {k: fused[k] for k in wfill}
    if not (same_metrics(greedy_cells, wfill)
            and same_metrics(greedy_cells, bisect)):
        raise AssertionError("per-cell metrics differ across backends")
    if runs["fused"][2]["schedule_tick"] == 0 or \
            runs["fused"][2]["waterfill"] != 0:
        raise AssertionError(f"fused run launches {runs['fused'][2]}")
    if runs["waterfill"][2]["waterfill"] == 0 or \
            runs["waterfill"][2]["schedule_tick"] != 0:
        raise AssertionError(f"waterfill run launches {runs['waterfill'][2]}")
    if any(runs["bisect on the CPU"][2].values()):
        raise AssertionError(f"bisect run launches "
                             f"{runs['bisect on the CPU'][2]}")
    log(f"[main] per-cell metrics of the {n_kept} greedy cells identical "
        "under fused / waterfill on the card and bisect on the CPU; main "
        f"phase {time.monotonic() - t_phase:.1f}s")
    report["main_lanes"] = n_kept
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
    report["theta_fused"] = {cell: m for (_w, cell), m in fused.items()}


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
    if "wrapper_call" in report:
        (cap, tgt), kw = report["wrapper_call"]
        t = time_waterfill(cap, tgt, kw.get("order"))
        t.update(replaces="src/repro/kernels/waterfill.py:74",
                 launches=report["wrapper_launches"])
        out[-1]["wrapper"] = t
        log(f"[kernel] waterfill under greedy_shrink_waterfill, "
            f"{cap.shape[0]} slots: {t['ms']:.4f} ms, device "
            f"{t['device_ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.6f} ms by {t['bound_by']}); "
            f"{report['gpu']}")
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


def attention_rate(q, k, v, kw):
    """(operations per second, its name) of the route the kernel takes for
    this call: the decode variant computes on CUDA cores; the prefill
    variant on the tensor cores, in f32 as split TF32 (3 TF32 products per
    product, so a third of the TF32 rate)."""
    import torch
    from repro_torch.kernels.flash_attention import plan
    b, sq, h, d = q.shape
    p = plan(b, sq, k.shape[1], h, k.shape[2], d, q.element_size(),
             dv=v.shape[-1], causal=kw.get("causal", True),
             window=kw.get("window", 0), q_offset=kw.get("q_offset", 0),
             kv_valid=kw.get("kv_valid_len") or k.shape[1])
    if p.variant == "decode":
        return FP32_OPS_PER_S, "f32 CUDA cores, 67 TFLOP/s"
    if q.dtype == torch.bfloat16:
        return BF16_OPS_PER_S, "bf16 tensor cores, 989 TFLOP/s"
    return (TF32_OPS_PER_S / SPLIT_TF32_PASSES,
            "split TF32, 495 / 3 TFLOP/s")


def attention_work(q, k, v, kw):
    """(flops, bytes) an attention call needs: 2 * (D + Dv) flops per
    visible (query, key) pair; q and the output once, and each K / V row
    up to the last visible key once."""
    import numpy as np
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    lim = min(sk, kw.get("kv_valid_len") or sk)
    pos = kw.get("q_offset", 0) + np.arange(sq)
    hi = np.minimum(lim, pos + 1) if kw.get("causal", True) else \
        np.full(sq, lim)
    window = kw.get("window", 0)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq)
    seen = np.maximum(hi - lo, 0)
    es = q.element_size()
    rows = int(hi.max() - lo.min()) if seen.any() else 0
    return (2.0 * (d + dv) * b * h * float(seen.sum()),
            es * (b * sq * h * (d + dv) + b * hkv * (d + dv) * rows))


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
    """One PyTorch call computing the same function, or None.  For
    attention, SDPA with the call's own ``causal`` over its valid keys,
    output (B, H, Sq, Dv); None for a sliding window and for a causal
    call of several queries at an offset (SDPA's causal mask is aligned
    top-left)."""
    import torch
    import torch.nn.functional as F
    if kernel == "rmsnorm":
        x, w = args[:2]
        eps = args[2] if len(args) > 2 else kw.get("eps", 1e-6)
        return lambda: F.rms_norm(x, (x.shape[-1],), w, eps=eps)
    if kernel != "flash_attention" or kw.get("window", 0) > 0:
        return None
    q, k, v = args
    sq, off = q.shape[1], kw.get("q_offset", 0)
    causal = kw.get("causal", True)
    if causal and sq > 1 and off > 0:
        return None   # SDPA's causal mask is top-left: it takes no offset
    hi = min(k.shape[1], kw.get("kv_valid_len") or k.shape[1])
    if causal and sq == 1:   # the one query sees keys 0..q_offset
        hi, causal = min(hi, off + 1), False
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :hi], v[:, :hi]))
    gqa = q.shape[2] != k.shape[2]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=kw.get("softmax_scale"),
        enable_gqa=gqa)


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


class Clock(Patch):
    """Wraps a function: synchronises after each call and sums the wall
    time."""

    def __init__(self, module, name):
        super().__init__(module, name)
        self.seconds, self.calls = 0.0, 0

    def __call__(self, *args, **kwargs):
        import torch
        t0 = time.monotonic()
        out = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds += time.monotonic() - t0
        self.calls += 1
        return out


class Timed(Clock):
    """Wraps ``decode.prefill`` / ``decode.decode_step``: a :class:`Clock`
    that also counts calls with non-finite logits."""

    def __init__(self, module, name):
        super().__init__(module, name)
        self.nonfinite = 0

    def __call__(self, *args, **kwargs):
        import torch
        logits, cache = super().__call__(*args, **kwargs)
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


def serve_reduced_card_vs_cpu(arch: str = "zamba2-2.7b", tag="serve"):
    """``arch`` reduced, with the same seeded weights on the card (kernels)
    and on the CPU (plain versions): identical greedy tokens, and the last
    position's logits of every finished sequence within 1e-3."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode as D
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch).reduced()
    name = arch.split("-")[0]
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(DEVICE)
    prompts = serve_prompts(cfg.vocab, 4, 5, 40, 1)
    kw = dict(slots=2, max_len=64, new=8)
    r_cpu, _ = serve(cpu, cfg, prompts, device="cpu", **kw)
    r_card, eng = serve(card, cfg, prompts, device=DEVICE, **kw)
    if [r.out_tokens for r in r_cpu] != [r.out_tokens for r in r_card]:
        raise AssertionError(f"reduced {name}: tokens on the card differ "
                             "from the CPU")
    err = 0.0
    for r in r_card:
        seq = torch.as_tensor(list(r.prompt) + r.out_tokens[:-1])[None]
        lc, _ = D.prefill(cpu, cfg, {"tokens": seq}, dtype=torch.float32)
        lg, _ = D.prefill(card, cfg, {"tokens": seq.to(DEVICE)},
                          dtype=torch.float32)
        err = max(err, float((lg.cpu() - lc).abs().max()))
    if not err <= 1e-3:
        raise AssertionError(f"reduced {name}: last logits differ by {err}")
    log(f"[{tag}] reduced {name} (2 slots, 4 requests, {eng.steps} steps):"
        f" tokens on the card == the CPU; last logits within {err:.3g} "
        "(limit 1e-3)")
    return err


def serve_device_busy(model, cfg, *, prompt=996, slots=SERVE["slots"],
                      max_len=SERVE["max_len"], cache_len=1000, tag="serve"):
    """The card's busy share in one full-width prefill (``prompt`` tokens)
    and one decode step (``slots`` slots at ``cache_len``): device time
    from a torch.profiler trace over the wall time of the same calls
    unprofiled."""
    import torch
    from repro_torch.models import decode as D
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(2, cfg.vocab, (1, prompt), generator=gen).to(DEVICE)
    last = torch.randint(2, cfg.vocab, (slots, 1),
                         generator=gen).to(DEVICE)
    cache = D.init_decode_cache(cfg, slots, max_len, torch.float32, DEVICE)
    return busy_share(cfg, {
        "prefill": (lambda: D.prefill(model, cfg, {"tokens": toks},
                                      cache_size=max_len,
                                      dtype=torch.float32), 2),
        "decode step": (lambda: D.decode_step(model, cfg, last, cache,
                                              cache_len,
                                              dtype=torch.float32), 5)}, tag)


def busy_share(cfg, calls, tag):
    """Per named call ``(fn, reps)``: wall ms, device ms from a
    torch.profiler trace of ``reps`` calls, their share and the device
    ops a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
        log(f"[{tag}] {cfg.name} {name}: {1e3 * wall:.2f} ms wall, device "
            f"busy {1e3 * dev:.2f} ms ({100.0 * dev / wall:.1f}%), "
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


def llm_kernel_row(kernel: str, label: str, args, kw, report, where: str,
                   dtype: str = "float32"):
    """One LLM kernel on one call's inputs: held to its plain version, then
    single-call (CUDA events) and device (CUDA graph) times beside the
    plain version, its bound and the library call."""
    import torch
    kern, plain = llm_calls(kernel, args, kw)
    got, ref = kern(), plain()
    pairs = zip(got, ref) if kernel == "ssd_scan" else [(got, ref)]
    err = max(close_err(g, r, LLM_TOL[dtype][kernel],
                        f"{kernel} at the {where} shape {label} {dtype}")
              for g, r in pairs)
    lib = library_call(kernel, args, kw)
    if kernel == "rmsnorm":
        x = args[0]
        flops, nbytes = 4.0 * x.numel(), \
            2 * x.numel() * x.element_size() + 4 * x.shape[-1]
    rate, rate_name = FP32_OPS_PER_S, "f32 CUDA cores, 67 TFLOP/s"
    if kernel == "flash_attention":
        flops, nbytes = attention_work(*args, kw)
        rate, rate_name = attention_rate(*args, kw)
    elif kernel == "ssd_scan":
        flops, nbytes = ssd_work(args[0], args[3], kw)
        rate, rate_name = ssd_rate(args[0])
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / rate * 1e3
    r = {
        "label": label, "shape": list(args[0].shape),
        "kwargs": {k: v for k, v in kw.items() if not torch.is_tensor(v)},
        "max_abs_err": err, "ms": cuda_median_ms(kern),
        "plain_ms": cuda_median_ms(plain),
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "bound_rate": rate_name,
        "bound_ms_f32_cuda_cores": max(
            b_bytes, flops / FP32_OPS_PER_S * 1e3),
        "library_ms": None if lib is None else cuda_median_ms(lib)}
    if kernel == "flash_attention" and args[2].shape[-1] != args[0].shape[-1]:
        r["value_dim"] = args[2].shape[-1]
    if dtype != "float32":
        r["dtype"] = dtype
    # device time alone: the single-call times above include the
    # wrapper's host work (PERF.md section 7)
    r["device_ms"] = graph_ms(kern)
    r["library_device_ms"] = None if lib is None else graph_ms(lib)
    lib_dev = ("none" if lib is None
               else f"{r['library_device_ms']:.4f} ms")
    log(f"[kernel] {kernel} {label} {dtype} device time "
        f"{r['device_ms']:.4f} ms, library {lib_dev} (CUDA graph "
        f"of 20 calls; {report['gpu']})")
    lib_txt = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
    log(f"[kernel] {kernel} at the {where} shape {label} {dtype} "
        f"{r['shape']} {r['kwargs']}: {r['ms']:.4f} ms (plain "
        f"{r['plain_ms']:.4f} ms, library {lib_txt}, bound "
        f"{r['bound_ms']:.6f} ms by {r['bound_by']}, "
        f"{r['bound_rate']}); max |err| {err:.3g}")
    return r


def llm_kernel_entry(kernel, rows, launches, err=0.0):
    """The kernels line's entry of an LLM kernel from its timed ``rows``:
    the numbers of its f32 row of the largest bound, ``launches`` from the
    main path's run, and the largest f32 error of ``rows`` and ``err``."""
    source, replaces = LLM_KERNELS[kernel]
    f32 = [r for r in rows if "dtype" not in r]
    main = max(f32, key=lambda r: r["bound_ms"])
    return {"name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max([err] + [r["max_abs_err"] for r in f32]),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms",
                                    "library_device_ms", "shape")},
            "shapes": list(rows)}


def phase_llm_kernels_at_serve_shape(report):
    """Time each LLM kernel on the serve run's largest calls and hold it
    against its plain version there (f32)."""
    out = report.setdefault("kernels", [])
    for kernel in LLM_KERNELS:
        rows = [llm_kernel_row(kernel, label, args, kw, report, "serve")
                for label, (_size, args, kw) in sorted(
                    report["serve_kept"][kernel].items())]
        out.append(llm_kernel_entry(
            kernel, rows, report["serve"]["launches"][kernel],
            report.get("max_abs_err", {}).get(kernel, 0.0)))


# ------------------------------------------------------------ the MoE family
# olmoe-1b-7b at full width and depth, f32: 6 requests of 64..512 prompt
# tokens from seed 6, 16 new tokens each, 4 slots
OLMOE = dict(slots=4, requests=6, new=16, max_len=640, prompt=(64, 512))
# deepseek-v2-236b at full width, cut to its dense MLA layer and one MoE
# layer (160 routed experts, 2 shared), f32: one 512-token prompt and 5
# decode steps
DEEPSEEK = dict(layers=2, prompt=512, new=6, max_len=576)


def moe_serve(cfg, prompts, *, slots, max_len, new, label):
    """Serve ``prompts`` on the card with random weights from seed 0 (the
    model freed after), kernel launches counted from 0 just before the
    run; logits finite and rmsnorm and flash_attention launched.  Returns
    the run's numbers and the largest call's inputs of each of the two
    kernels by label: flash_attention's "prefill", rmsnorm's by width
    ("d=512", ...)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import decode as D
    from repro_torch.models import layers
    from repro_torch.models.transformer import init_params, param_count
    t0 = time.monotonic()
    model = init_params(cfg, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    n_params, built = param_count(model), time.monotonic() - t0
    keep = Keep(layers, "flash_attention", lambda a, k: (
        "prefill", a[0].shape[0] * a[0].shape[1] * a[1].shape[1]))
    keep_norm = Keep(layers, "rmsnorm_kernel", lambda a, k: (
        f"d={a[0].shape[-1]}", a[0].numel()))
    pre, dec = Timed(D, "prefill"), Timed(D, "decode_step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCH_COUNTS.clear()  # this path's launches start here
    t0 = time.monotonic()
    with keep, keep_norm, pre, dec:
        reqs, eng = serve(model, cfg, prompts, slots=slots, max_len=max_len,
                          new=new, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: build.LAUNCH_COUNTS[k] for k in LLM_KERNELS}
    if pre.nonfinite or dec.nonfinite:
        raise AssertionError(f"{label}: non-finite logits in "
                             f"{pre.nonfinite} prefills and "
                             f"{dec.nonfinite} decode steps")
    if not (launches["rmsnorm"] and launches["flash_attention"]):
        raise AssertionError(f"{label}: a kernel of the path never "
                             f"launched: {launches}")
    if dec.calls < new - 1:
        raise AssertionError(f"{label}: {dec.calls} decode steps")
    out = dict(params=n_params, weight_gb=4 * n_params / 1e9,
               init_s=built, wall_s=wall, requests=len(reqs),
               prompt_tokens=sum(len(p) for p in prompts),
               tokens=sum(len(r.out_tokens) for r in reqs),
               prefill_s=pre.seconds,
               prefill_tok_per_s=sum(len(p) for p in prompts) / pre.seconds,
               decode_steps=dec.calls,
               decode_ms_per_step=1e3 * dec.seconds / dec.calls,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches)
    out["busy"] = serve_device_busy(
        model, cfg, prompt=max(map(len, prompts)), slots=slots,
        max_len=max_len, cache_len=max(map(len, prompts)), tag="moe")
    log(f"[moe] {label} f32 on the card: {n_params:,} parameters "
        f"({out['weight_gb']:.2f} GB, built in {built:.1f}s); "
        f"{len(reqs)}/{len(reqs)} requests done, {slots} slots, prompts "
        f"{min(map(len, prompts))}..{max(map(len, prompts))} tokens "
        f"({out['prompt_tokens']} in all), {out['tokens']} tokens out; "
        f"wall {wall:.2f}s; prefill {pre.seconds:.3f}s = "
        f"{out['prefill_tok_per_s']:.0f} tokens/s; decode {dec.calls} "
        f"steps {out['decode_ms_per_step']:.2f} ms/step; peak memory "
        f"{out['peak_gb']:.2f} GB; logits finite; launches {launches}")
    del model, reqs, eng
    torch.cuda.empty_cache()
    return out, {"flash_attention": keep.kept, "rmsnorm": keep_norm.kept}


def phase_moe(report):
    """The MoE family through the port's LLM layer: (a) reduced olmoe and
    reduced DeepSeek-V2 card == CPU; (b) olmoe-1b-7b at full width and
    depth; (c) deepseek-v2-236b at full width, 2 layers; (d)
    flash_attention at DeepSeek's prefill shape (keys 192, values 128)
    held to its plain version in f32 (the main path's call) and bf16 and
    timed beside SDPA, and rmsnorm at MLA's q_norm / kv_norm widths (1,536
    and 512) on the run's own calls."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    out = report.setdefault("moe", {})
    t_phase = time.monotonic()
    out["reduced_err"] = {arch: serve_reduced_card_vs_cpu(arch, "moe")
                          for arch in ("olmoe-1b-7b", "deepseek-v2-236b")}

    cfg = get_config("olmoe-1b-7b")
    prompts = serve_prompts(cfg.vocab, OLMOE["requests"], *OLMOE["prompt"],
                            6)
    out["olmoe"], _ = moe_serve(cfg, prompts, slots=OLMOE["slots"],
                                max_len=OLMOE["max_len"], new=OLMOE["new"],
                                label=cfg.name)

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              n_layers=DEEPSEEK["layers"])
    prompt = np.random.default_rng(7).integers(
        2, cfg.vocab, size=DEEPSEEK["prompt"]).astype(np.int32)
    out["deepseek"], kept = moe_serve(
        cfg, [prompt], slots=1, max_len=DEEPSEEK["max_len"],
        new=DEEPSEEK["new"], label=f"{cfg.name} ({cfg.n_layers} layers)")
    _size, args, kw = kept["flash_attention"]["prefill"]

    q, k, v = args
    if (tuple(q.shape), k.shape[-1], v.shape[-1]) != (
            (1, DEEPSEEK["prompt"], cfg.n_heads, cfg.qk_nope + cfg.qk_rope),
            cfg.qk_nope + cfg.qk_rope, cfg.v_head):
        raise AssertionError(f"DeepSeek's prefill attention took q "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                             f"{tuple(v.shape)}")
    rows = [llm_kernel_row("flash_attention", "deepseek prefill", args, kw,
                           report, "moe")]
    half = tuple(t.to(torch.bfloat16) for t in args)
    rows.append(llm_kernel_row("flash_attention", "deepseek prefill", half,
                               kw, report, "moe", "bfloat16"))
    norms = [llm_kernel_row("rmsnorm", f"deepseek {name} d={d}",
                            *kept["rmsnorm"][f"d={d}"][1:], report, "moe")
             for name, d in (("q_norm", cfg.q_lora),
                             ("kv_norm", cfg.kv_lora))]
    out["kernel_rows"] = {"flash_attention": rows, "rmsnorm": norms}
    out["phase_s"] = time.monotonic() - t_phase
    log(f"[moe] phase {out['phase_s']:.1f}s")
    add_phase_kernel_rows(report, "moe", ("olmoe", "deepseek"))


def add_phase_kernel_rows(report, phase, runs):
    """A phase's launches (``<phase>_launches``, per run) and timed shapes
    on the rmsnorm and flash_attention entries of the kernels line: merged
    into the serve phase's entries, or those entries themselves when the
    serve phase did not run."""
    data = report[phase]
    rows = report.setdefault("kernels", [])
    for kernel, timed in data["kernel_rows"].items():
        entry = llm_kernel_entry(
            kernel, timed, sum(data[r]["launches"][kernel] for r in runs))
        row = next((r for r in rows if r["name"] == kernel), None)
        if row is None:
            row = entry
            rows.append(row)
        else:
            row["shapes"].extend(timed)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     entry["max_abs_err"])
        row[f"{phase}_launches"] = {r: data[r]["launches"][kernel]
                                    for r in runs}


# ------------------------------------ the encoder-decoder and the frontends
# whisper-large-v3 (arXiv:2212.04356) at its published width and depth, f32:
# 4 utterances of 1,500 frame embeddings (its 30 s window; the audio
# frontend is a stub, so the frames come from the seed), a 4-token prompt,
# 60 greedy tokens, a 448-row decoder cache (its text context)
WHISPER = dict(batch=4, front=1500, prompt=4, new=60, max_len=448)
# internvl2-2b (arXiv:2404.16821), f32: 4 requests of 256 patch embeddings
# and 128 tokens, 32 greedy tokens, cache 448; then 4 text-only requests of
# 64..256 tokens through the engine (2 slots, 16 new tokens each), as the
# reference's engine serves this arch
INTERNVL2 = dict(batch=4, front=256, prompt=128, new=32, max_len=448,
                 requests=4, slots=2, engine_new=16, engine_prompt=(64, 256))
# the flash_attention call forms each run must take
ENCDEC_FORMS = {"whisper": {"encoder", "cross prefill", "cross decode",
                            "self prefill", "self decode"},
                "internvl2": {"self prefill", "self decode"}}


def attention_form(args, kw):
    """(call form, size) of one flash_attention call on the encoder-decoder
    / vision path: the encoder's non-causal self-attention, the
    cross-attention's prefill (queries over every encoder row) and decode,
    and the decoder's own causal prefill and decode."""
    q, k = args[0], args[1]
    causal = kw.get("causal", True)
    if q.shape[1] == 1:
        form = "self decode" if causal else "cross decode"
    elif causal:
        form = "self prefill"
    else:
        form = "encoder" if q.shape[1] == k.shape[1] else "cross prefill"
    return form, q.shape[0] * q.shape[1] * (kw.get("kv_valid_len")
                                            or k.shape[1])


def frontend_batch(cfg, b, s, n_front, device, seed):
    """Seeded tokens (b, s) and ``n_front`` rows of width d a sequence:
    audio frames for an encoder-decoder, vision patches otherwise."""
    import torch
    gen = torch.Generator(device).manual_seed(seed)
    return {"tokens": torch.randint(2, cfg.vocab, (b, s), generator=gen,
                                    device=device),
            "frames" if cfg.is_encdec else "patches": torch.randn(
                (b, n_front, cfg.d_model), generator=gen, device=device)}


def generate(model, cfg, batch, *, new, max_len, on_prefill=None):
    """Greedy decoding through ``prefill`` and ``new - 1`` ``decode_step``s
    (step i at position P + S + i: a vision prompt's patches count).
    Returns (tokens (B, new), the last logits, the cache)."""
    import torch
    from repro_torch.models import decode as D
    logits, cache = D.prefill(model, cfg, batch, cache_size=max_len,
                              dtype=torch.float32)
    if on_prefill is not None:
        on_prefill()
    pos = batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                      if "patches" in batch else 0)
    toks = [logits.argmax(-1)]
    for i in range(new - 1):
        logits, cache = D.decode_step(model, cfg, toks[-1][:, None], cache,
                                      pos + i, dtype=torch.float32)
        toks.append(logits.argmax(-1))
    return torch.stack(toks, 1), logits, cache


def generate_reduced_card_vs_cpu(arch: str, new: int = 9):
    """``arch`` reduced, the same seeded weights and inputs (frames or
    patches) on the card (kernels) and on the CPU (plain versions), through
    ``prefill`` and ``new - 1`` greedy ``decode_step``s: identical tokens,
    the last logits within 1e-3."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch).reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(DEVICE)
    batch = frontend_batch(cfg, 2, 11, cfg.n_frontend_tokens, "cpu", 1)
    t_cpu, l_cpu, _ = generate(cpu, cfg, batch, new=new, max_len=64)
    t_card, l_card, _ = generate(
        card, cfg, {k: v.to(DEVICE) for k, v in batch.items()}, new=new,
        max_len=64)
    name = arch.split("-")[0]
    if not torch.equal(t_cpu, t_card.cpu()):
        raise AssertionError(f"reduced {name}: tokens on the card differ "
                             "from the CPU")
    err = float((l_card.cpu() - l_cpu).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"reduced {name}: last logits differ by {err}")
    log(f"[encdec] reduced {name} (2 sequences, prefill + {new - 1} decode "
        f"steps): tokens on the card == the CPU; last logits within "
        f"{err:.3g} (limit 1e-3)")
    return err


def encdec_run(cfg, spec, seed, label):
    """``cfg`` at full width on the card, random weights from seed 0:
    ``spec["batch"]`` sequences of ``spec["front"]`` frames or patches and
    ``spec["prompt"]`` tokens through ``generate`` (kernel launches counted
    from 0 just before it); logits finite, flash_attention launched in its
    forms, rmsnorm for an RMSNorm config.  Then the busy shares of one
    prefill and one decode step.  Returns (numbers, the model, the largest
    call's inputs of each kernel by label)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import decode as D
    from repro_torch.models import layers
    from repro_torch.models.transformer import init_params, param_count
    t0 = time.monotonic()
    model = init_params(cfg, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    n_params, built = param_count(model), time.monotonic() - t0
    b, s, n_front = spec["batch"], spec["prompt"], spec["front"]
    batch = frontend_batch(cfg, b, s, n_front, DEVICE, seed)
    keep = Keep(layers, "flash_attention", attention_form)
    keep_norm = Keep(layers, "rmsnorm_kernel", lambda a, k: (
        f"{'prefill' if a[0].shape[1] > 1 else 'decode'} "
        f"d={a[0].shape[-1]}", a[0].numel()))
    enc = Clock(D, "run_encoder")
    pre, dec = Timed(D, "prefill"), Timed(D, "decode_step")
    at_prefill = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCH_COUNTS.clear()  # this path's launches start here
    t0 = time.monotonic()
    with keep, keep_norm, enc, pre, dec:
        toks, logits, cache = generate(
            model, cfg, batch, new=spec["new"], max_len=spec["max_len"],
            on_prefill=lambda: at_prefill.update(build.LAUNCH_COUNTS))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: build.LAUNCH_COUNTS[k] for k in LLM_KERNELS}
    per_prefill = {k: at_prefill.get(k, 0) for k in LLM_KERNELS}
    per_step = {k: (launches[k] - per_prefill[k]) / dec.calls
                for k in LLM_KERNELS}
    if pre.nonfinite or dec.nonfinite or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite logits")
    if tuple(toks.shape) != (b, spec["new"]) or dec.calls != spec["new"] - 1:
        raise AssertionError(f"{label}: tokens {tuple(toks.shape)}, "
                             f"{dec.calls} decode steps")
    want = {"flash_attention"} | ({"rmsnorm"} if cfg.norm == "rmsnorm"
                                  else set())
    if {k for k, n in launches.items() if n} != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    run = "whisper" if cfg.is_encdec else "internvl2"
    if set(keep.kept) != ENCDEC_FORMS[run]:
        raise AssertionError(f"{label}: attention took the forms "
                             f"{sorted(keep.kept)}, want "
                             f"{sorted(ENCDEC_FORMS[run])}")
    rows = b * (n_front + s)
    out = dict(params=n_params, weight_gb=4 * n_params / 1e9, init_s=built,
               wall_s=wall, encoder_s=enc.seconds, prefill_s=pre.seconds,
               prefill_rows=rows, prefill_rows_per_s=rows / pre.seconds,
               decode_steps=dec.calls,
               decode_ms_per_step=1e3 * dec.seconds / dec.calls,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, launches_per_prefill=per_prefill,
               launches_per_decode_step=per_step)
    enc_txt = (f"encoder {enc.seconds:.3f}s of " if cfg.is_encdec else "")
    log(f"[encdec] {label} f32 on the card: {n_params:,} parameters "
        f"({out['weight_gb']:.2f} GB, built in {built:.1f}s); {b} sequences"
        f" of {n_front} {'frames' if cfg.is_encdec else 'patches'} + {s} "
        f"tokens, {spec['new']} greedy tokens, cache {spec['max_len']}; "
        f"wall {wall:.2f}s; {enc_txt}prefill {pre.seconds:.3f}s "
        f"({rows / pre.seconds:.0f} rows/s); decode {dec.calls} steps "
        f"{out['decode_ms_per_step']:.2f} ms/step; peak memory "
        f"{out['peak_gb']:.2f} GB; logits finite; launches {launches}: a "
        f"prefill {per_prefill}, a decode step {per_step}; attention forms "
        f"{sorted(keep.kept)}")
    pos = s + (0 if cfg.is_encdec else n_front) + spec["new"] - 1
    last = toks[:, -1:]
    out["busy"] = busy_share(cfg, {
        "prefill": (lambda: D.prefill(model, cfg, batch,
                                      cache_size=spec["max_len"],
                                      dtype=torch.float32), 2),
        "decode step": (lambda: D.decode_step(model, cfg, last, cache, pos,
                                              dtype=torch.float32), 5)},
        "encdec")
    return out, model, {"flash_attention": keep.kept,
                        "rmsnorm": keep_norm.kept}


def phase_encdec(report):
    """The encoder-decoder and the modality frontends through the port's
    LLM layer: (a) reduced whisper and reduced internvl2 (with patches)
    card == CPU; (b) whisper-large-v3 at full width and depth; (c)
    internvl2-2b at full width and depth, with patches, then text-only
    through the engine; (d) flash_attention in each call form of (b) and
    (c), the run's own call (f32) and its bf16 copy, held to its plain
    version and timed beside SDPA, and rmsnorm at internvl2's calls."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import plan
    from repro_torch.models import decode as D
    out = report.setdefault("encdec", {})
    t_phase = time.monotonic()
    out["reduced_err"] = {arch: generate_reduced_card_vs_cpu(arch)
                          for arch in ("whisper-large-v3", "internvl2-2b")}

    out["whisper"], model, kept_w = encdec_run(
        get_config("whisper-large-v3"), WHISPER, 8, "whisper-large-v3")
    del model
    torch.cuda.empty_cache()

    cfg = get_config("internvl2-2b")
    out["internvl2"], model, kept_i = encdec_run(cfg, INTERNVL2, 9,
                                                 "internvl2-2b")
    prompts = serve_prompts(cfg.vocab, INTERNVL2["requests"],
                            *INTERNVL2["engine_prompt"], 10)
    pre, dec = Timed(D, "prefill"), Timed(D, "decode_step")
    torch.cuda.synchronize()
    build.LAUNCH_COUNTS.clear()  # this path's launches start here
    t0 = time.monotonic()
    with pre, dec:
        reqs, eng = serve(model, cfg, prompts, slots=INTERNVL2["slots"],
                          max_len=INTERNVL2["max_len"],
                          new=INTERNVL2["engine_new"], device=DEVICE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: build.LAUNCH_COUNTS[k] for k in LLM_KERNELS}
    if pre.nonfinite or dec.nonfinite:
        raise AssertionError("internvl2-2b engine: non-finite logits")
    if not (launches["rmsnorm"] and launches["flash_attention"]):
        raise AssertionError(f"internvl2-2b engine: launches {launches}")
    n_prompt = sum(map(len, prompts))
    out["internvl2_engine"] = dict(
        wall_s=wall, requests=len(reqs), prompt_tokens=n_prompt,
        tokens=sum(len(r.out_tokens) for r in reqs), prefill_s=pre.seconds,
        prefill_tok_per_s=n_prompt / pre.seconds, decode_steps=dec.calls,
        decode_ms_per_step=1e3 * dec.seconds / dec.calls, steps=eng.steps,
        launches=launches)
    e = out["internvl2_engine"]
    log(f"[encdec] internvl2-2b text-only through the engine: "
        f"{len(reqs)}/{len(reqs)} requests done, {INTERNVL2['slots']} "
        f"slots, prompts {min(map(len, prompts))}..{max(map(len, prompts))}"
        f" tokens ({n_prompt} in all), {INTERNVL2['engine_new']} new each; "
        f"wall {wall:.2f}s; prefill {pre.seconds:.3f}s = "
        f"{e['prefill_tok_per_s']:.0f} tokens/s; decode {dec.calls} steps "
        f"{e['decode_ms_per_step']:.2f} ms/step; logits finite; launches "
        f"{launches}")
    del model, reqs, eng
    torch.cuda.empty_cache()

    rows = []
    for run, kept in (("whisper", kept_w), ("internvl2", kept_i)):
        for form, (_size, args, kw) in sorted(
                kept["flash_attention"].items()):
            q, k, v = args
            variant = plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                           k.shape[2], q.shape[3], q.element_size(),
                           dv=v.shape[-1], causal=kw.get("causal", True),
                           window=kw.get("window", 0),
                           q_offset=kw.get("q_offset", 0),
                           kv_valid=kw.get("kv_valid_len") or k.shape[1]
                           ).variant
            label = f"{run} {form} ({variant} variant)"
            rows.append(llm_kernel_row("flash_attention", label, args, kw,
                                       report, "encdec"))
            half = tuple(t.to(torch.bfloat16) for t in args)
            rows.append(llm_kernel_row("flash_attention", label, half, kw,
                                       report, "encdec", "bfloat16"))
    norms = [llm_kernel_row("rmsnorm", f"internvl2 {label}", args, kw,
                            report, "encdec")
             for label, (_size, args, kw) in sorted(
                 kept_i["rmsnorm"].items())]
    out["kernel_rows"] = {"flash_attention": rows, "rmsnorm": norms}
    out["phase_s"] = time.monotonic() - t_phase
    log(f"[encdec] phase {out['phase_s']:.1f}s; {report['gpu']}")
    add_phase_kernel_rows(report, "encdec",
                          ("whisper", "internvl2", "internvl2_engine"))


# ------------------------------------------------------------- training
# the backward kernels; "replaces" names the TPU kernel whose function
# they differentiate (the Pallas kernels have no backward: JAX trains
# through XLA autodiff of plain ops)
BWD_KERNELS = {
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                    "src/repro/kernels/rmsnorm.py:19"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:36"),
    "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_scan.py:37"),
}
# the names of each backward kernel's outputs, in its wrapper's order
BWD_OUTPUTS = {"rmsnorm_bwd": ("dx", "dscale"),
               "flash_attention_bwd": ("dq", "dk", "dv"),
               "ssd_scan_bwd": ("dx", "ddt", "da", "db", "dc", "dinit")}
# a backward output against its plain version: max |err| <= tol x the
# largest |ref| of that output (its sums run over rows, keys or queries,
# so the error grows with that length as |ref| does)
BWD_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
# (a): internvl2's training rows and call, zamba2's prefill rows, the
# forward's scalar-access width, qwen2-72b's width (2,048 rows of 8,192),
# rows too wide for the registers (the forward's widest f32 rows, walked
# twice);
# gemma3's head dim with its window, DeepSeek-V2's key / value widths,
# whisper's encoder and cross attention;
# zamba2-2.7b's training call, its serve prefill (ragged against the
# chunk), mamba2-1.3b's width (N = 128), a small call from a state
RMS_BWD_SHAPES = [("internvl2 train rows", dict(rows=2048, d=2048)),
                  ("zamba2 prefill rows", dict(rows=996, d=2560)),
                  ("odd width", dict(rows=7, d=2561)),
                  ("qwen2-72b rows", dict(rows=2048, d=8192)),
                  ("past the registers", dict(rows=256, d=32768))]
ATTN_BWD_SHAPES = [
    ("internvl2 train", dict(B=4, Sq=512, Sk=512, H=16, Hkv=8, D=128,
                             Dv=128)),
    ("gemma3 window", dict(B=1, Sq=1100, Sk=1100, H=8, Hkv=4, D=256,
                           Dv=256, window=1024)),
    ("DeepSeek widths", dict(B=1, Sq=512, Sk=512, H=128, Hkv=128, D=192,
                             Dv=128)),
    ("whisper encoder", dict(B=4, Sq=1500, Sk=1500, H=20, Hkv=20, D=64,
                             Dv=64, causal=False)),
    ("whisper cross", dict(B=4, Sq=448, Sk=1500, H=20, Hkv=20, D=64, Dv=64,
                           causal=False)),
]
SSD_BWD_SHAPES = [
    ("zamba2 train call", dict(B=4, S=512, H=80, P=64, N=64)),
    ("zamba2 serve prefill", dict(B=1, S=996, H=80, P=64, N=64)),
    ("mamba2 train call", dict(B=4, S=512, H=64, P=64, N=128)),
    ("initial state", dict(B=2, S=300, H=6, P=64, N=64, init=True)),
]
# (b): every registered architecture, reduced; the remat modes on olmoe
# (MoE blocks) and zamba2 (Mamba-2 blocks and the shared attention block)
TRAIN_ARCHS = ("stablelm-1.6b", "gemma3-4b", "glm4-9b", "qwen2-72b",
               "olmoe-1b-7b", "deepseek-v2-236b", "internvl2-2b",
               "whisper-large-v3", "mamba2-1.3b", "zamba2-2.7b")
TRAIN_REMAT = ("olmoe-1b-7b", "zamba2-2.7b")
# (c) and (c'): internvl2-2b and zamba2-2.7b at full width and depth,
# bf16 compute, f32 params, AdamW with the reference's defaults, remat
# "dots" (TrainConfig's defaults): 8 steps of 4 x (256 patches + 256
# tokens), 6 of 4 x 512 tokens (4, ``least_steps``, where the time left
# would not hold the phases after the train phase at their least scales
# with 6 at ``s_per_step``: 1.09-1.44 s a step on H100 runs, PERF.md
# section 5); the last step is profiled
TRAIN_FULL = dict(tag="c", arch="internvl2-2b", steps=8, batch=4, seq=512)
TRAIN_ZAMBA2 = dict(tag="c'", arch="zamba2-2.7b", steps=6, least_steps=4,
                    batch=4, seq=512, s_per_step=1.5)
TRAIN_PLAIN = ("rmsnorm_ref", "attention_ref", "ssd_ref", "rmsnorm_bwd_ref",
               "attention_bwd_ref", "ssd_bwd_ref")


def max_rel_err(got, ref, tol, label):
    """(max |got - ref|, that / max |ref|); raises when the second is above
    ``tol`` (a NaN fails)."""
    got, ref = got.detach().double(), ref.detach().double()
    err = float((got - ref).abs().max())
    big = float(ref.abs().max())
    rel = err / max(big, 1e-30)
    if not rel <= tol:
        raise AssertionError(f"{label}: max |err| {err:.3g} is {rel:.3g} "
                             f"of max |ref| {big:.3g} (tol {tol})")
    return err, rel


def bwd_case(gen, kernel, shape, dtype):
    """Seeded inputs of a backward kernel on the card, the forward's
    output and row log-sum-exp (attention) or its saved states (the SSD
    scan: the forward kernels' scratch at the backward's chunk) from the
    kernel."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_with_lse
    from repro_torch.kernels.ssd_scan import ssd_scan_with_states

    def rn(*s, dt=dtype):
        return torch.randn(s, generator=gen).to(DEVICE, dt)

    if kernel == "ssd_scan_bwd":   # made on the card: ~10 M values a row
        dgen = torch.Generator(DEVICE).manual_seed(
            int(torch.randint(2 ** 31, (1,), generator=gen)))

        def rd(*s, lo=None, hi=None, dt=dtype):
            t = (torch.randn(s, generator=dgen, device=DEVICE) if lo is None
                 else lo + (hi - lo) * torch.rand(s, generator=dgen,
                                                  device=DEVICE))
            return t.to(dt)

        b, s, h, p, n = (shape[k] for k in ("B", "S", "H", "P", "N"))
        f32 = torch.float32
        ins = (rd(b, s, h, p), rd(b, s, h, lo=0.01, hi=0.5),
               rd(h, lo=0.5, hi=2.0, dt=f32), rd(b, s, n), rd(b, s, n))
        kw = {"initial_state": rd(b, h, p, n, dt=f32)} if shape.get(
            "init") else {}
        states = ssd_scan_with_states(*ins, **kw)[2]
        return ins + (rd(b, s, h, p, dt=f32), rd(b, h, p, n, dt=f32),
                      states), kw
    if kernel == "rmsnorm_bwd":
        r, d = shape["rows"], shape["d"]
        return (rn(r, d), rn(d, dt=torch.float32), rn(r, d)), {}
    b, sq, sk, h, hkv = (shape[k] for k in ("B", "Sq", "Sk", "H", "Hkv"))
    kw = {k: shape[k] for k in ("causal", "window") if k in shape}
    q, k, v = rn(b, sq, h, shape["D"]), rn(b, sk, hkv, shape["D"]), \
        rn(b, sk, hkv, shape["Dv"])
    o, lse = flash_attention_with_lse(q, k, v, **kw)
    return (q, k, v, o, lse, rn(b, sq, h, shape["Dv"])), kw


def bwd_work(kernel, args, kw):
    """(flops, bytes, rate, rate name) the least the card could take for a
    backward call: RMSNorm reads x, dy and the scale, writes dx and dscale
    (~8 flops an element, f32 CUDA cores); attention computes, per visible
    (query, key) pair, S again (2 D), dP (2 Dv), dV (2 Dv), dQ (2 D) and
    dK (2 D) flops, reads q, k, v, o, dO and lse once and writes dq, dk,
    dv once, at the route's rate (bf16 tensor cores, or split TF32); the
    SSD scan as :func:`ssd_bwd_work` computes it."""
    import torch
    if kernel == "ssd_scan_bwd":
        flops, nbytes = ssd_bwd_work(args, kw)
        return (flops, nbytes) + ssd_rate(args[0])
    if kernel == "rmsnorm_bwd":
        x, w = args[:2]
        return (8.0 * x.numel(),
                3 * x.numel() * x.element_size() + 2 * w.numel() *
                w.element_size(), FP32_OPS_PER_S,
                "f32 CUDA cores, 67 TFLOP/s")
    q, k, v, o, lse, do = args
    b, sq, h, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    fwd_flops, _ = attention_work(q, k, v, kw)
    pairs = fwd_flops / (2.0 * (d + dv))
    es = q.element_size()
    nbytes = es * (2 * (q.numel() + k.numel() + v.numel())
                   + 2 * o.numel()) + 4 * lse.numel()
    if q.dtype == torch.bfloat16:
        rate, name = BF16_OPS_PER_S, "bf16 tensor cores, 989 TFLOP/s"
    else:
        rate = TF32_OPS_PER_S / SPLIT_TF32_PASSES
        name = "split TF32, 495 / 3 TFLOP/s"
    return 2.0 * (3 * d + 2 * dv) * pairs, nbytes, rate, name


def ssd_bwd_work(args, kw):
    """(flops, bytes) the SSD scan's gradient needs on one call's inputs (x,
    dt, a, b, c, dy, dstate, the saved states): per (batch, chunk) C B^T
    again and the head-summed D's products with B and C over the lower
    triangle; per head dy x^T and W^T dy over it, and G, dS B, x^T dS and
    before^T dy over the chunk's steps; the inputs, the saved states and
    dy read once, the gradients written once (at the backward's chunk)."""
    from repro_torch.kernels.ssd_scan import bwd_plan
    x, dt, a, b, c, dy, dstate, states = args
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = bwd_plan(bsz, s, h, p, n, kw.get("chunk", 128)).chunk
    tri = sum(lc * (lc + 1) // 2 for lc in
              (min(chunk, s - t0) for t0 in range(0, s, chunk)))
    macs = bsz * (3 * tri * n + h * (2 * tri * p + 4 * s * p * n))
    es = x.element_size()
    init = kw.get("initial_state")
    nbytes = (2 * es * (x.numel() + dt.numel() + b.numel() + c.numel())
              + 4 * (dy.numel() + states.numel() + 2 * a.numel()))
    if dstate is not None:
        nbytes += 4 * dstate.numel()
    if init is not None:
        nbytes += 2 * 4 * init.numel()
    return 2.0 * macs, nbytes


def bwd_fns(kernel, args, kw):
    """(kernel backward, plain backward, kernel forward + backward through
    autograd, library forward + backward through autograd, the library's
    forward alone, on inputs that need a gradient as in the fourth) on one
    call's inputs; the third and fourth return the inputs' gradients.  The
    library's attention is SDPA with the call's own mask (``is_causal``, or
    with a window a boolean ``attn_mask`` built here, outside the timed
    call) and value width.  The SSD scan has no library call to set its
    forward + backward beside: the last three are None."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.ssd_scan import bwd_plan, ssd_scan_bwd
    if kernel == "ssd_scan_bwd":
        x, b = args[0], args[3]
        chunk = bwd_plan(*x.shape, b.shape[-1]).chunk
        init = kw.get("initial_state")
        return ((lambda: ssd_scan_bwd(*args, **kw)),
                (lambda: ref.ssd_bwd_ref(*args[:7], chunk=chunk,
                                         initial_state=init)),
                None, None, None)
    if kernel == "rmsnorm_bwd":
        x, w, dy = args[:3]
        ins = x.detach().requires_grad_(), w.detach().requires_grad_()

        def both(fn):
            return lambda: torch.autograd.grad(fn(*ins), ins, dy)
        def lib_fwd(a, b):
            return F.rms_norm(a, (a.shape[-1],), b, eps=1e-6)
        return ((lambda: rmsnorm_bwd(*args)),
                (lambda: ref.rmsnorm_bwd_ref(*args)), both(rmsnorm),
                both(lib_fwd), lambda: lib_fwd(*ins))
    q, k, v, o, lse, do = args
    ins = tuple(t.detach().requires_grad_() for t in (q, k, v))
    causal, window = kw.get("causal", True), kw.get("window", 0)
    mask = None
    if window > 0:   # the kernel's band: query - window < key (<= query)
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = kpos > qpos - window
        if causal:
            mask = mask & (kpos <= qpos)
    gqa = q.shape[2] != k.shape[2]

    def kern_both():
        return torch.autograd.grad(flash_attention(*ins, **kw), ins, do)

    def lib_fwd():
        return F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in ins), attn_mask=mask,
            is_causal=causal and mask is None,
            scale=kw.get("softmax_scale"), enable_gqa=gqa)

    def lib():
        return torch.autograd.grad(lib_fwd(), ins, do.transpose(1, 2))
    return ((lambda: flash_attention_bwd(*args, **kw)),
            (lambda: ref.attention_bwd_ref(*args, **kw)), kern_both, lib,
            lib_fwd)


def bwd_plan_text(args):
    """The attention backward's launch plan for one call's inputs
    (``flash_attention.bwd_plan``), as the [train:a] line prints it."""
    from repro_torch.kernels.flash_attention import bwd_plan
    q, k, v = args[:3]
    b, sq, h, d = q.shape
    p = bwd_plan(b, sq, k.shape[1], h, k.shape[2], d, q.element_size(),
                 dv=v.shape[-1])
    return (f"plan {p.route}, {p.stages} stage(s); dK / dV: "
            f"{p.kv_warpgroups} group(s) x {p.kv_keys} keys"
            f"{' split dK | dV' if p.kv_split else ''}, {p.kv_query_tile}-"
            f"query tiles, {p.kv_ctas} CTAs, {p.kv_smem_bytes} B; dQ: "
            f"{p.dq_queries} queries x {p.dq_key_tile}-key tiles, "
            f"{p.dq_ctas} CTAs, {p.dq_smem_bytes} B; {p.kernels} kernels, "
            f"{p.kv_launches} dK / dV launch"), p


def rms_bwd_plan_text(args):
    """The RMSNorm backward's launch plan for one call's inputs
    (``rmsnorm.bwd_plan``), as the [train:a] line prints it."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import bwd_plan
    x, w, dy = args[:3]
    d = x.shape[-1]
    aligned = (x.data_ptr() | dy.data_ptr() | w.data_ptr()) % 16 == 0
    p = bwd_plan(x.numel() // d, d, x.dtype, w.dtype,
                 build.sm_count(x.get_device()), aligned)
    rows = (f"a warp a row, {p.threads // 32} a CTA" if p.row_threads == 32
            else f"{p.threads} threads a row")
    return (f"plan {p.vec}-element loads x {p.per_thread} a thread, {rows}, "
            f"{p.ctas} CTAs in clusters of {p.cluster}, {p.partials} partial "
            f"rows, {p.smem_bytes} B shared, "
            + (f"{p.depth} rows deep ({p.held_registers} held registers)"
               if p.depth else "each row walked twice")), p


def ssd_bwd_plan_text(args):
    """The SSD backward's launch plan for one call's inputs
    (``ssd_scan.bwd_plan``), as the [train:a] line prints it."""
    from repro_torch.kernels.ssd_scan import bwd_plan
    x, b, states = args[0], args[3], args[7]
    p = bwd_plan(*x.shape, b.shape[-1])
    return (f"plan chunk {p.chunk} ({p.n_chunks} chunks), {p.groups} head "
            f"groups a chunk (<= {p.heads_per_cta} heads a CTA), "
            f"{p.scan_ctas} chunk-scan CTAs of {p.smem_bytes} B shared "
            f"({p.tile_sets} set(s) of head tiles), {p.state_ctas} state "
            f"CTAs of {p.state_threads} threads and {p.state_smem_bytes} B, "
            f"scratch {4 * p.scratch_floats} B, saved states "
            f"{4 * states.numel()} B"), p


def ssd_forward_check(args, kw, label, dname):
    """The training forward on an SSD backward call's inputs: y and the
    final state of :func:`ssd_scan_with_states` (the forward kernels at
    the backward's chunk, which serving never runs) held to ``ssd_ref`` at
    that chunk within ``LLM_TOL``, and its scratch equal, bit for bit, to
    the saved states the backward was given.  Returns (chunk, max |err|)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import bwd_plan, ssd_scan_with_states
    x, b, init = args[0], args[3], kw.get("initial_state")
    chunk = bwd_plan(*x.shape, b.shape[-1], kw.get("chunk", 128)).chunk
    tol = LLM_TOL[dname]["ssd_scan"]
    y, state, states = ssd_scan_with_states(*args[:5], **kw)
    want = ref.ssd_ref(*args[:5], chunk=chunk, initial_state=init)
    err = max(close_err(g, w, tol, f"ssd_scan at chunk {chunk} {label} "
                        f"{dname} {n}")
              for n, g, w in zip(("y", "state"), (y, state), want))
    if not identical(states, args[7]):
        raise AssertionError(f"ssd_scan at chunk {chunk} {label} {dname}: "
                             "its scratch differs from the saved states")
    return chunk, err


def bwd_row(kernel, label, args, kw, report, dname):
    """One backward kernel on one call's inputs: held to its plain
    version, then single-call (CUDA events, median of 20) and device (a
    CUDA graph of 20 calls) times beside the plain backward, its bound,
    and the kernel's forward + backward against the library's through
    autograd, both as single-call and as device times; the library's
    backward alone as its forward + backward less its forward (device
    times).  The SSD scan has no library call: those times are None."""
    kern, plain, both, lib, lib_fwd = bwd_fns(kernel, args, kw)
    got, ref = kern(), plain()
    errs = [max_rel_err(g, r, BWD_TOL[dname], f"{kernel} {label} {dname} "
                        f"{n}") for n, g, r in zip(BWD_OUTPUTS[kernel], got,
                                                   ref) if g is not None]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    again = kern()
    if not all(a is b or identical(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{kernel} {label} {dname}: a second call "
                             "gave other bits")
    flops, nbytes, rate, rate_name = bwd_work(kernel, args, kw)
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    r = {"label": label, "dtype": dname, "shape": list(args[0].shape),
         "kwargs": {k: v for k, v in kw.items() if not hasattr(v, "shape")},
         "max_abs_err": err, "max_rel_err": rel,
         "ms": cuda_median_ms(kern), "device_ms": graph_ms(kern),
         "plain_ms": cuda_median_ms(plain),
         "bound_ms": max(b_bytes, b_ops),
         "bound_by": "bytes" if b_bytes >= b_ops else "operations",
         "bound_rate": rate_name, "fwd_bwd_ms": None,
         "fwd_bwd_device_ms": None, "library_ms": None,
         "library_device_ms": None, "library_fwd_device_ms": None,
         "library_bwd_device_ms": None}
    if lib is None:
        lib_text = "no library call"
    else:
        r.update(fwd_bwd_ms=cuda_median_ms(both),
                 fwd_bwd_device_ms=graph_ms(both),
                 library_ms=cuda_median_ms(lib),
                 library_device_ms=graph_ms(lib),
                 library_fwd_device_ms=graph_ms(lib_fwd))
        r["library_bwd_device_ms"] = (r["library_device_ms"]
                                      - r["library_fwd_device_ms"])
        lib_text = (
            f"forward + backward {r['fwd_bwd_ms']:.4f} ms, device "
            f"{r['fwd_bwd_device_ms']:.4f} ms; "
            f"library {r['library_ms']:.4f} ms, device "
            f"{r['library_device_ms']:.4f} ms (library / kernels "
            f"{r['library_device_ms'] / r['fwd_bwd_device_ms']:.3f} in "
            f"device time); backward alone, device: kernels "
            f"{r['device_ms']:.4f} ms, library "
            f"{r['library_bwd_device_ms']:.4f} ms (its forward "
            f"{r['library_fwd_device_ms']:.4f} ms; library / kernels "
            f"{r['library_bwd_device_ms'] / r['device_ms']:.3f})")
    if kernel == "flash_attention_bwd":
        if args[2].shape[-1] != args[0].shape[-1]:
            r["value_dim"] = args[2].shape[-1]
        plan, p = bwd_plan_text(args)
        r["plan"] = dict(vars(p))
    elif kernel == "ssd_scan_bwd":
        plan, p = ssd_bwd_plan_text(args)
        r["plan"] = dict(vars(p))
        chunk, r["forward_max_abs_err"] = ssd_forward_check(args, kw, label,
                                                            dname)
        plan += (f"; the forward at chunk {chunk} == ssd_ref at it, max "
                 f"|err| {r['forward_max_abs_err']:.3g} <= tol "
                 f"{LLM_TOL[dname]['ssd_scan']}, its scratch == the saved "
                 "states")
    else:
        plan, p = rms_bwd_plan_text(args)
        r["plan"] = p._asdict()
    log(f"[train:a] {kernel} {label} {dname} {r['shape']} {r['kwargs']}: "
        f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms (plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms by "
        f"{r['bound_by']}, {rate_name}); {lib_text}; max |err| {err:.3g}, "
        f"{rel:.3g} of max |ref| <= {BWD_TOL[dname]}; the same bits twice; "
        f"{plan}; {report['gpu']}")
    return r


def train_state_to(state, dev):
    """A train state built on the CPU, moved to ``dev`` (the model in
    place, the optimizer trees copied)."""
    state["params"].to(dev)
    state["opt"] = {k: ({n: t.to(dev) for n, t in v.items()}
                        if isinstance(v, dict) else v)
                    for k, v in state["opt"].items()}
    if "ef" in state:
        state["ef"] = {n: t.to(dev) for n, t in state["ef"].items()}
    return state


class KeepGrads(Patch):
    """Wraps ``train_step.adamw_update``: keeps a copy of the gradients a
    step hands the optimizer (which scales them in place)."""

    def __call__(self, params, grads, *args, **kwargs):
        self.grads = {n: g.detach().float().cpu().clone()
                      for n, g in grads.items()}
        return self.inner(params, grads, *args, **kwargs)


class KeepCompression(Patch):
    """Wraps ``train_step.compress_decompress``: keeps copies of the
    gradients it is given and of the dequantized gradients and residuals
    it returns."""

    def __call__(self, grads, residuals):
        deq, res = self.inner(grads, residuals)
        self.kept = tuple({n: t.detach().float().cpu().clone()
                           for n, t in tree.items()}
                          for tree in (grads, deq, res))
        return deq, res


def train_reduced_card_vs_cpu(arch, tc=None, seed=0):
    """One ``make_train_step`` step of ``arch`` reduced, f32, the same
    weights (seed ``seed``, built on the CPU) and ``batch_for`` batch on
    the CPU and on the card.  Returns {device: (loss, grad_norm, grads,
    params, (grads, dequantized grads, residuals) of the compression or
    None)}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import to_tensors
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import batch_for
    cfg = get_config(arch).reduced()
    tc = tc or TS.TrainConfig(compute_dtype=torch.float32)
    batch = batch_for(cfg, 32, 4, step=1, seed=seed)
    out = {}
    for dev in ("cpu", DEVICE):
        state = train_state_to(TS.init_train_state(
            cfg, tc, torch.Generator().manual_seed(seed), "cpu"), dev)
        with KeepGrads(TS, "adamw_update") as keep, \
                KeepCompression(TS, "compress_decompress") as comp:
            comp.kept = None
            state, stats = TS.make_train_step(cfg, tc)(
                state, to_tensors(batch, dev))
        out[dev] = (float(stats["loss"]), float(stats["grad_norm"]),
                    keep.grads, {n: p.detach().float().cpu() for n, p in
                                 state["params"].named_parameters()},
                    comp.kept)
    return out


def check_card_vs_cpu(arch, out, tol_grad=1e-3, tol_param=1e-5):
    """Loss within 1e-4 (relative), each gradient within ``tol_grad`` of
    its largest |value| on the CPU, each updated parameter within
    ``tol_param``; returns the worst (loss, grad, param) differences, the
    first two relative (the gradient's to its largest |value|), the last
    absolute."""
    cpu, card = out["cpu"], out[DEVICE]
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    if not loss_err <= 1e-4:
        raise AssertionError(f"train (b) {arch}: loss {card[0]} on the card,"
                             f" {cpu[0]} on the CPU")
    grad_err = max(max_rel_err(card[2][n], g, tol_grad,
                               f"train (b) {arch} grad {n}")[1]
                   for n, g in cpu[2].items())
    param_err = 0.0
    for n, p in cpu[3].items():
        d = float((card[3][n] - p).abs().max())
        if not d <= tol_param:
            raise AssertionError(f"train (b) {arch}: param {n} differs by "
                                 f"{d:.3g} after the step")
        param_err = max(param_err, d)
    return loss_err, grad_err, param_err


# how far, in int8 steps, the f32 roundings of a scale and of a quotient
# (|gradient| / scale <= 127) can move a gradient / scale
F32_STEP_SLACK = 4 * 127.0 * 2.0 ** -24


def check_compression(out, tol_grad=1e-3):
    """A first ``compress_grads`` step (zero residuals) on the card against
    the CPU, per JAX leaf (one int8 scale, its largest |gradient| / 127):
    the gradients handed to the compression within ``tol_grad`` of the
    leaf's largest |value|; the int8 steps equal, except where the CPU's
    gradient / scale lies within twice the two sides' drift (their
    gradients' difference and their scales' difference, in steps) plus
    :data:`F32_STEP_SLACK` of a rounding boundary: there it may round one
    step apart; elsewhere the dequantized gradients equal up to the
    scales' difference; and on each side residual = gradient - dequantized
    gradient, so the residuals differ by the gradients' difference less
    the dequantized ones' (within f32 rounding, 1e-6 of the leaf's largest
    |value|).  Returns (flipped
    elements, elements, worst dequantized gradient difference over the
    leaf's largest |value|)."""
    import torch
    from repro_torch.convert import jax_key
    (g_c, q_c, r_c), (g_d, q_d, r_d) = out["cpu"][4], out[DEVICE][4]
    leaves = {}
    for n in g_c:
        leaves.setdefault(jax_key(n)[0], []).append(n)
    flips = total = 0
    worst = 0.0
    for leaf, names in leaves.items():
        amax_c = max(float(g_c[n].double().abs().max()) for n in names)
        amax_d = max(float(g_d[n].double().abs().max()) for n in names)
        s_c, s_d = (amax_c + 1e-12) / 127.0, (amax_d + 1e-12) / 127.0
        e = max(float((g_d[n].double() - g_c[n].double()).abs().max())
                for n in names)
        if not e <= tol_grad * amax_c:
            raise AssertionError(f"train (b) compress_grads {leaf}: "
                                 f"gradients differ by {e:.3g}, max |grad| "
                                 f"{amax_c:.3g}")
        drift = e / s_c + 127.0 * abs(s_d - s_c) / s_c
        for n in names:
            gc, gd = g_c[n].double(), g_d[n].double()
            qc, qd = q_c[n].double(), q_d[n].double()
            kc, kd = torch.round(qc / s_c), torch.round(qd / s_d)
            flip = kc != kd
            frac = gc / s_c - torch.floor(gc / s_c)
            edge = (frac - 0.5).abs() <= 2.0 * drift + F32_STEP_SLACK
            if not bool(((kc - kd).abs() <= 1).all() and
                         (edge | ~flip).all()):
                raise AssertionError(
                    f"train (b) compress_grads {n}: int8 steps differ "
                    f"away from a rounding boundary (drift {drift:.3g} "
                    f"steps)")
            dq = (qd - qc).abs()
            if not float(torch.where(flip, 0.0, dq).max()) <= \
                    127.0 * abs(s_d - s_c) + 1e-6 * amax_c:
                raise AssertionError(f"train (b) compress_grads {n}: "
                                     "dequantized gradients differ")
            rerr = ((r_d[n].double() - r_c[n].double())
                    - ((gd - gc) - (qd - qc))).abs().max()
            if not float(rerr) <= 1e-6 * amax_c:
                raise AssertionError(f"train (b) compress_grads {n}: "
                                     f"residuals differ by {float(rerr):.3g}"
                                     " beyond gradient - dequantized")
            flips += int(flip.sum())
            total += flip.numel()
            worst = max(worst, float(dq.max()) / amax_c)
    return flips, total, worst


# the kernels a block of each kind launches forward: (RMSNorms, attention
# calls, SSD scans); zamba2's "shared" block and a "moe" block are
# attention blocks
BLOCK_LAUNCHES = {"attn": (2, 1, 0), "moe": (2, 1, 0), "shared": (2, 1, 0),
                  "mamba": (2, 0, 1)}
TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")


def expected_train_launches(cfg, remat):
    """The launches of one train step that the model's plan gives: each
    block's RMSNorms (an attention block's two; a Mamba-2 block's norm and
    its gated output norm), attention and SSD scan run forward once, and
    again under remat's recompute, and backward once; the final norm runs
    forward and backward once."""
    norms = attn = ssd = 0
    for seg in cfg_plan(cfg):
        kn, ka, ks = BLOCK_LAUNCHES[seg.kind]
        norms, attn, ssd = (norms + kn * seg.count, attn + ka * seg.count,
                            ssd + ks * seg.count)
    fwd = 1 if remat == "none" else 2
    return {"rmsnorm": norms * fwd + 1, "rmsnorm_bwd": norms + 1,
            "flash_attention": attn * fwd, "flash_attention_bwd": attn,
            "ssd_scan": ssd * fwd, "ssd_scan_bwd": ssd}


def cfg_plan(cfg):
    from repro_torch.models.transformer import decoder_plan
    plan = decoder_plan(cfg)
    if (any(seg.kind not in BLOCK_LAUNCHES for seg in plan)
            or cfg.norm != "rmsnorm"):
        raise ValueError(f"{cfg.name}: the launch plan counts attn, moe, "
                         "shared and mamba blocks with RMSNorm only")
    return plan


def by_kernel_ms(fn, calls: int = 10):
    """Device ms a launch of each kernel ``fn`` runs, from ``calls`` eager
    calls under torch.profiler (largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in device_events(prof):
        name = re.search(r"\b(\w+_kernel)\b", e.key)
        out[name.group(1) if name else e.key] = (
            e.self_device_time_total / 1e3 / max(e.count, 1))
    return out


def device_split(prof):
    """Device ms of a profiled step by kind: the GEMMs, the LLM kernels'
    forward and backward, the optimizer's foreach kernels, the rest (the
    first kind whose pattern a kernel's name holds: the SSD backward's
    names hold the forward's)."""
    groups = {"gemm": ("gemm", "xmma", "cutlass", "nvjet", "cublas"),
              "rmsnorm forward": ("rmsnorm_kernel",),
              "rmsnorm backward": ("rmsnorm_bwd_kernel",
                                   "rmsnorm_dw_kernel"),
              "attention forward": ("prefill_kernel", "decode_kernel",
                                    "combine_kernel"),
              "attention backward": ("dkdv_", "dq_kernel", "dq_wg_kernel",
                                     "delta_kernel"),
              "ssd backward": ("ssd_bwd_state_kernel", "ssd_scan_bwd_kernel",
                               "ssd_bwd_sum_kernel"),
              "ssd forward": ("state_kernel", "pass_kernel", "scan_kernel"),
              "optimizer": ("multi_tensor_apply", "foreach")}
    out = dict.fromkeys(list(groups) + ["other"], 0.0)
    for e in device_events(prof):
        key = e.key.lower()
        kind = next((g for g, pats in groups.items()
                     if any(p.lower() in key for p in pats)), "other")
        out[kind] += e.self_device_time_total / 1e3
    return out


class Counted(Patch):
    """Wraps a function and counts its calls."""

    def __init__(self, module, name):
        super().__init__(module, name)
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.inner(*args, **kwargs)


def train_steps(report, elapsed_s, spec):
    """``spec``'s steps, or its ``least_steps`` where the phases after the
    train phase at their least scales (registry and what-if (d) at 0.05,
    experiment, what-if (a)-(c), dense, haswell at 0.25), predicted at this
    card's theta greedy rate, would not end inside the time limit after
    ``steps`` steps at ``s_per_step``."""
    rate = report.get("greedy_s_per_step")
    least = spec.get("least_steps", spec["steps"])
    if rate is None:
        return spec["steps"], False
    after = (0.5 * REGISTRY_STEPS * REGISTRY_STEP_RATIO + EXPERIMENT_STEPS
             + WHATIF_ABC_STEPS + 0.5 * WHATIF_D_STEPS * WHATIF_D_STEP_RATIO
             + DENSE_GREEDY_STEPS + 0.25 * HASWELL_STEPS * HASWELL_STEP_RATIO)
    left = 0.95 * TIME_LIMIT_S - elapsed_s - after * rate
    if spec["steps"] * spec.get("s_per_step", 0.0) <= left:
        return spec["steps"], False
    return least, least < spec["steps"]


def train_full(report, spec, steps):
    """(c) / (c'): ``spec["arch"]`` at full width and depth through
    ``launch.train.train`` (the code path of ``python -m
    repro_torch.launch.train``) for ``steps`` steps, the last profiled,
    launches counted from 0 just before it and the plain versions wrapped
    with counters that must stay at 0.  Returns (the run's numbers, each
    backward kernel's largest call's inputs by label)."""
    import contextlib
    import io
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch import train as LT
    from repro_torch.train.train_step import TrainConfig
    tag = spec["tag"]
    cfg = get_config(spec["arch"])
    tc = TrainConfig()
    profile_step = steps
    plain = [Counted(m, n) for n in TRAIN_PLAIN
             for m in (ref, RN, FA, SS) if hasattr(m, n)]
    call = f"{cfg.name.split('-')[0]} train call"
    keeps = [Keep(FA, "flash_attention_bwd", lambda a, k: (call, 1)),
             Keep(RN, "rmsnorm_bwd", lambda a, k: (call, a[0].numel())),
             Keep(SS, "ssd_scan_bwd", lambda a, k: (call, 1))]
    sums = {}
    done = {}

    def snapshot(state):
        return {n: float(p.detach().double().sum())
                for n, p in state["params"].named_parameters()}

    # device activity only: the split reads the device's events, and the
    # host's (~10^5 ops a zamba2 step) took seconds to reduce
    prof = profile(activities=[ProfilerActivity.CUDA])
    t_prof = [0.0]

    def on_step(i, state, stats):
        # step i's time ends here; what this call adds before the next
        # step starts is left out of it
        loss, gnorm = float(stats["loss"]), float(stats["grad_norm"])
        torch.cuda.synchronize()
        t_end = time.monotonic()
        if i == profile_step:
            prof.__exit__(None, None, None)
            t_prof[0] = t_end - t_prof[0]
        done[i] = dict(loss=loss, grad_norm=gnorm, t_end=t_end)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train ({tag}) step {i}: loss {loss}, "
                                 f"grad norm {gnorm}")
        if i == 1:
            sums["first"] = snapshot(state)
            sums["n_params"] = sum(p.numel() for p in
                                   state["params"].parameters())
        if i == steps:
            sums["last"] = snapshot(state)
            sums["finite"] = all(bool(torch.isfinite(p).all()) for p in
                                 state["params"].parameters())
        torch.cuda.synchronize()
        done[i]["t_next"] = time.monotonic()
        if i == profile_step - 1:
            prof.__enter__()
            t_prof[0] = time.monotonic()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCH_COUNTS.clear()  # this path's launches start here
    t0 = time.monotonic()
    with contextlib.ExitStack() as stack:
        for p in plain + keeps:
            stack.enter_context(p)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            LT.train(cfg, tc, steps=steps, batch=spec["batch"],
                     seq=spec["seq"], seed=0, device=DEVICE, log_every=1,
                     on_step=on_step)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for line in buf.getvalue().splitlines():
        log(f"[train:{tag}] {line}")
    launches = {k: build.LAUNCH_COUNTS[k] for k in TRAIN_KERNELS}
    per_step = {k: v / steps for k, v in launches.items()}
    want = expected_train_launches(cfg, tc.remat)
    if per_step != want:
        raise AssertionError(f"train ({tag}): launches a step {per_step}, "
                             f"the plan gives {want}")
    calls = {f"{p.module.__name__.rsplit('.', 1)[-1]}.{p.name}": p.calls
             for p in plain}
    if any(calls.values()):
        raise AssertionError(f"train ({tag}): plain versions called {calls}")
    unchanged = [n for n, v in sums["first"].items()
                 if v == sums["last"][n]]
    if not sums["finite"] or unchanged:
        raise AssertionError(f"train ({tag}): params finite "
                             f"{sums['finite']}, unchanged {unchanged[:5]}")
    times = [done[i + 1]["t_end"] - done[i]["t_next"]
             for i in range(1, steps) if i + 1 != profile_step]
    s_step = statistics.median(times)
    positions = spec["batch"] * spec["seq"]
    text = spec["batch"] * (spec["seq"] - cfg.n_frontend_tokens)
    split = device_split(prof)
    dev_ms = sum(split.values())
    out = dict(arch=cfg.name, steps=steps, params=sums["n_params"],
               wall_s=wall, s_per_step=s_step,
               positions_per_s=positions / s_step,
               text_tokens_per_s=text / s_step,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=[done[i]["loss"] for i in sorted(done)],
               grad_norms=[done[i]["grad_norm"] for i in sorted(done)],
               launches=launches, launches_per_step=per_step,
               plain_calls=calls, profiled_step_s=t_prof[0],
               device_ms=dev_ms, busy=dev_ms / 1e3 / t_prof[0],
               device_split_ms=split)
    tokens = (f"{cfg.n_frontend_tokens} patches + "
              f"{spec['seq'] - cfg.n_frontend_tokens} tokens"
              if cfg.n_frontend_tokens else f"{spec['seq']} tokens")
    log(f"[train:{tag}] {cfg.name} at full width and depth "
        f"({sums['n_params']:,} parameters): {steps} steps of "
        f"{spec['batch']} x ({tokens}), bf16 compute, f32 params, AdamW, "
        f"remat {tc.remat}: wall {wall:.2f}s, {s_step:.4f} s/step (median "
        f"of the unprofiled steps), {out['positions_per_s']:.0f} positions/s"
        f" ({out['text_tokens_per_s']:.0f} text tokens/s), peak memory "
        f"{out['peak_gb']:.2f} GB; losses "
        f"{[round(x, 4) for x in out['losses']]}, every loss and grad norm "
        f"finite, every parameter finite and changed; launches a step "
        f"{per_step} == the plan's; plain versions called {calls}")
    log(f"[train:{tag}] profiled step {profile_step}: "
        f"{t_prof[0] * 1e3:.1f} ms wall under the profiler, device busy "
        f"{dev_ms:.1f} ms ({100.0 * out['busy']:.1f}%); device ms by kind "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"; {report['gpu']}")
    kept = {k.name: k.kept for k in keeps if k.kept}
    return out, kept


def phase_train(report, elapsed_s=0.0):
    """Training through the port's LLM layer on hand-written backward
    kernels: (a) the backward kernels against their plain versions at the
    training path's shapes, f32 and bf16, timed beside the plain backward
    and the library's forward + backward; (b) one train step of every
    reduced architecture, card == CPU, the remat modes (launches as the
    plan gives), an accumulated and a compressed step; (c) internvl2-2b
    and (c') zamba2-2.7b at full width and depth through
    ``launch.train``; then each backward kernel timed on (c)'s or (c')'s
    own calls.  ``elapsed_s``: the smoke's time at the phase's start."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import to_tensors
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import batch_for
    out = report.setdefault("train", {})
    t_phase = time.monotonic()
    gen = torch.Generator().manual_seed(24)
    rows = {kernel: [] for kernel in BWD_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for kernel, shapes in (("rmsnorm_bwd", RMS_BWD_SHAPES),
                               ("flash_attention_bwd", ATTN_BWD_SHAPES),
                               ("ssd_scan_bwd", SSD_BWD_SHAPES)):
            for label, shape in shapes:
                args, kw = bwd_case(gen, kernel, shape, dtype)
                rows[kernel].append(bwd_row(kernel, label, args, kw, report,
                                            dname))
                del args
                torch.cuda.empty_cache()
    out["a_s"] = time.monotonic() - t_phase

    errs = {}
    for arch in TRAIN_ARCHS:
        errs[arch] = check_card_vs_cpu(arch,
                                       train_reduced_card_vs_cpu(arch))
        log(f"[train:b] {arch} reduced, one f32 step: card == CPU, loss "
            f"{errs[arch][0]:.2g} (relative), worst gradient "
            f"{errs[arch][1]:.3g} of its largest |value|, worst updated "
            f"parameter {errs[arch][2]:.3g} (absolute)")
    accum = TS.TrainConfig(compute_dtype=torch.float32, accum_steps=2)
    errs["accum 2"] = check_card_vs_cpu("accum 2", train_reduced_card_vs_cpu(
        "stablelm-1.6b", accum))
    comp = train_reduced_card_vs_cpu("glm4-9b", TS.TrainConfig(
        compute_dtype=torch.float32, compress_grads=True))
    if not (abs(comp[DEVICE][0] - comp["cpu"][0]) <= 1e-4 * abs(
            comp["cpu"][0]) and math.isfinite(comp[DEVICE][1])):
        raise AssertionError(f"train (b) compress_grads: {comp[DEVICE][:2]}"
                             f" on the card, {comp['cpu'][:2]} on the CPU")
    flips, n_elem, comp_err = check_compression(comp)
    errs["compress_grads"] = dict(flips=flips, elements=n_elem,
                                  worst_rel=comp_err)
    log(f"[train:b] accum_steps 2 (stablelm): card == CPU, worst gradient "
        f"{errs['accum 2'][1]:.3g} of its largest |value|; compress_grads (glm4): loss "
        f"{comp[DEVICE][0]:.6f} (CPU {comp['cpu'][0]:.6f}), grad norm "
        f"{comp[DEVICE][1]:.6f} (CPU {comp['cpu'][1]:.6f}); compressed "
        f"gradients and residuals card == CPU but {flips} of {n_elem} "
        f"elements one int8 step apart at a rounding boundary (worst "
        f"{comp_err:.3g} of the leaf's max |grad|)")
    remat = {}
    for arch in TRAIN_REMAT:
        cfg = get_config(arch).reduced()
        model = T.init_params(cfg, torch.Generator(DEVICE).manual_seed(0),
                              DEVICE)
        model.requires_grad_(True)
        batch = to_tensors(batch_for(cfg, 32, 4, step=2, seed=0), DEVICE)
        modes = {}
        for mode in T.REMAT_MODES:
            model.zero_grad(set_to_none=True)
            build.LAUNCH_COUNTS.clear()
            loss, _ = T.forward_train(model, cfg, batch, dtype=torch.float32,
                                      remat=mode)
            loss.backward()
            launches = {k: build.LAUNCH_COUNTS[k] for k in TRAIN_KERNELS}
            want = expected_train_launches(cfg, mode)
            if launches != want:
                raise AssertionError(f"train (b) {arch} remat {mode}: "
                                     f"launches {launches}, the plan gives "
                                     f"{want}")
            modes[mode] = (float(loss.detach()), float(
                torch.linalg.vector_norm(torch.stack(
                    [p.grad.norm() for p in model.parameters()]))))
        base = modes["none"]
        if any(abs(v[0] - base[0]) > 1e-6 * abs(base[0]) or
               abs(v[1] - base[1]) > 1e-5 * base[1] for v in modes.values()):
            raise AssertionError(f"train (b) {arch}: remat modes disagree "
                                 f"{modes}")
        remat[arch] = modes
        log(f"[train:b] {arch} reduced on the card, remat none / dots / "
            f"full: loss and gradient norm {modes}; launches as the plan "
            f"gives in each")
        del model
    out["b"] = {"errors": errs, "remat": remat}
    out["b_s"] = time.monotonic() - t_phase - out["a_s"]

    out["full"], kept = train_full(report, TRAIN_FULL, TRAIN_FULL["steps"])
    t_c = time.monotonic()
    steps, cut = train_steps(report, elapsed_s + t_c - t_phase,
                             TRAIN_ZAMBA2)
    log(f"[train:c'] {TRAIN_ZAMBA2['arch']}: {steps} steps"
        + (" (CUT: the time left would not hold "
           f"{TRAIN_ZAMBA2['steps']} and the phases after this one)"
           if cut else ""))
    out["zamba2"], kept_z = train_full(report, TRAIN_ZAMBA2, steps)
    out["zamba2"]["cut"] = cut
    out["c_prime_s"] = time.monotonic() - t_c
    runs = {"rmsnorm_bwd": ("full", kept), "flash_attention_bwd": (
        "full", kept), "ssd_scan_bwd": ("zamba2", kept_z)}
    entries = report.setdefault("kernels", [])
    for kernel, (source, replaces) in BWD_KERNELS.items():
        run, kept_run = runs[kernel]
        (label, (_size, args, kw)), = kept_run[kernel].items()
        main = bwd_row(kernel, label, args, kw, report,
                       str(args[0].dtype).split(".")[-1])
        if kernel == "ssd_scan_bwd":
            main["by_kernel_ms"] = by_kernel_ms(
                lambda: bwd_fns(kernel, args, kw)[0]())
            log(f"[train:c'] ssd_scan_bwd at {label}, device ms a launch by "
                "kernel (10 eager calls): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in main["by_kernel_ms"].items())
                + f"; {report['gpu']}")
        entries.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": out[run]["launches"][kernel],
            **{k: main[k] for k in (
                "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "device_ms", "fwd_bwd_ms",
                "fwd_bwd_device_ms", "library_device_ms",
                "library_fwd_device_ms", "library_bwd_device_ms", "shape",
                "dtype")},
            **{k: main[k] for k in ("by_kernel_ms", "forward_max_abs_err")
               if k in main},
            "shapes": rows[kernel]})
        del args, kw
    del kept, kept_z
    torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    log(f"[train] phase {out['phase_s']:.1f}s ((a) {out['a_s']:.1f}s, (b) "
        f"{out['b_s']:.1f}s, (c') {out['c_prime_s']:.1f}s); "
        f"{report['gpu']}")


# ------------------------------------------------- the dense per-tick engine
# (a): tests/test_sim_jax.py's 20-job workload on 10 nodes and its horizon
DENSE_TICKS = 800
# (b): knl at scale 0.01 (415 jobs on 9,688 nodes, tick 10 s).  The first
# multiple of 500 ticks at which every job is DONE under the JAX package's
# repro.core.sim_jax.simulate_jax on the CPU, for MIN at proportions 0.2 /
# 0.6 / 1.0 (simulate_scan_batch) and EASY (the last job ends at tick
# 4,804 in both), measured once on the CPU; the smoke imports no JAX
KNL_DENSE_TICKS = 5_000
KNL_DENSE_PROPS = (0.2, 0.6, 1.0)
KNL_BISECT_TICKS = 1_000
DENSE_KEPT_CALL = 450
# the registry's strategies, a class workload (10% rigid, 10% on-demand)
# and an SJF run: (label, strategy, job classes, queue order)
DENSE_RUNS = tuple((s, s, False, "fcfs") for s in (
    "easy", "min", "pref", "avg", "keeppref", "steal_agreement",
    "pref_common_pool", "rigid_sjf")) + (("classes", "pref", True, "fcfs"),
                                         ("sjf", "min", False, "sjf"))
# the runs whose pass takes the tick kernel under fused (greedy, no
# classes); under waterfill they run the plain pass with the waterfill give
# instead -- the route fused already gives the pooled, stealing and class
# runs -- so waterfill reruns one of them, which holds the phase near 60 s
# (a plain-pass tick costs ~10 ms of host dispatch on the card)
DENSE_TICK_RUNS = ("easy", "min", "pref", "keeppref", "rigid_sjf", "sjf")
DENSE_WATERFILL_RUNS = ("min",)


def dense_small_workload(classes: bool):
    """tests/test_sim_jax.py's workload (seed 0, 20 jobs, 60% malleable),
    with 10% rigid and 10% on-demand jobs when ``classes``."""
    import numpy as np
    from repro_torch.core import (JobClasses, ScenarioConfig, Workload,
                                  apply_scenario,
                                  transform_rigid_to_malleable)
    rng = np.random.default_rng(0)
    w = Workload.rigid(submit=np.sort(rng.uniform(0, 150, 20)),
                       runtime=rng.uniform(20, 120, 20),
                       nodes_req=rng.choice([1, 2, 4, 8], 20))
    if classes:
        w = apply_scenario(w, ScenarioConfig(job_classes=JobClasses(
            rigid=0.1, on_demand=0.1, malleable=0.8)))
    return transform_rigid_to_malleable(w, 0.6, seed=0, cluster_nodes=10)


def knl_dense_workloads():
    """knl at scale 0.01 as the experiment layer realizes it, and its MIN
    variants at :data:`KNL_DENSE_PROPS` (seed 0)."""
    from repro_torch.core import transform_rigid_to_malleable
    from repro_torch.experiments.spec import ExperimentSpec, prepare_workload
    cl, w, _ = prepare_workload(ExperimentSpec(
        workloads=("knl",), scale=0.01, seeds=1), "knl")
    return cl, w, [transform_rigid_to_malleable(w, p, 0, cl.nodes)
                   for p in KNL_DENSE_PROPS]


def dense_run(job, device, backend, n_ticks=None):
    """One run of the dense phase: ``("small", label)`` of
    :data:`DENSE_RUNS`, or ``("knl", "min" | "easy")``; returns (state,
    trace) on ``device``."""
    from repro_torch.core import STRATEGIES
    from repro_torch.core.sim_dense import (JobArrays, simulate_dense,
                                            simulate_scan_batch)
    kind, label = job
    if kind == "small":
        _, name, classes, order = next(r for r in DENSE_RUNS
                                       if r[0] == label)
        return simulate_dense(dense_small_workload(classes), 10, 1.0,
                              n_ticks or DENSE_TICKS, STRATEGIES[name],
                              queue_order=order, device=device,
                              expand_backend=backend)
    cl, w, variants = knl_dense_workloads()
    n_ticks = n_ticks or KNL_DENSE_TICKS
    if label == "easy":
        return simulate_dense(w, cl.nodes, cl.tick, n_ticks,
                              STRATEGIES["easy"], device=device,
                              expand_backend=backend)
    jobs = JobArrays.stack([JobArrays.from_workload(v, device)
                            for v in variants])
    return simulate_scan_batch(jobs, STRATEGIES["min"], cl.nodes, cl.tick,
                               n_ticks, expand_backend=backend)


def dense_reference(job, n_ticks=None):
    """``bisect`` on the CPU of one dense run, as numpy arrays (run in a
    worker process while the card runs)."""
    import torch
    torch.set_num_threads(1)
    st, tr = dense_run(job, "cpu", "bisect", n_ticks)
    return [t.numpy() for t in (*st, *tr)]


def dense_equal(ref, st, tr, label):
    """Every field of the card's ``(SimState, SimTrace)`` equal to the CPU
    reference's, byte for byte (NaN times of unstarted jobs included)."""
    fields = st._fields + tr._fields
    for name, r, g in zip(fields, ref, (*st, *tr)):
        g = g.cpu().numpy()
        if r.dtype != g.dtype or r.tobytes() != g.tobytes():
            raise AssertionError(f"dense {label}: {name} on the card differs "
                                 f"from bisect on the CPU")


def dense_launches(build):
    return {k: build.LAUNCH_COUNTS[k] for k in ("schedule_tick",
                                                "waterfill")}


def phase_dense(report):
    """The dense per-tick engine (``repro_torch.core.sim_dense``): (a)
    card == CPU on the registry's runs, (b) knl at scale 0.01 under
    ``fused``, its first 1,000 ticks equal to ``bisect``; launches counted
    from 0 before each run."""
    import concurrent.futures
    import contextlib
    import multiprocessing
    import numpy as np
    import torch
    from repro_torch.core import DONE, STRATEGIES, simulate
    from repro_torch.kernels import build, schedule_tick
    t_phase = time.monotonic()
    small = [("small", r[0]) for r in DENSE_RUNS]
    knl = [("knl", "min"), ("knl", "easy")]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=4,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = {job: pool.submit(dense_reference, job) for job in small}
        refs.update({job: pool.submit(dense_reference, job, KNL_BISECT_TICKS)
                     for job in knl})

        # (a) every run under fused, the tick runs' route under waterfill;
        # each is held to its CPU reference after the card runs, so no
        # card run waits for a worker
        held = []
        for backend, labels in (("fused", [r[0] for r in DENSE_RUNS]),
                                ("waterfill", DENSE_WATERFILL_RUNS)):
            for label in labels:
                torch.cuda.synchronize()
                build.LAUNCH_COUNTS.clear()  # this run's launches start here
                t0 = time.monotonic()
                st, tr = dense_run(("small", label), "cuda", backend)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                got = dense_launches(build)
                # one launch a tick: the tick kernel, or the plain pass's
                # waterfill give; AVG's balanced pass launches nothing
                kernel = (None if label == "avg" else "schedule_tick"
                          if backend == "fused" and label in DENSE_TICK_RUNS
                          else "waterfill")
                want = {k: DENSE_TICKS if k == kernel else 0
                        for k in ("schedule_tick", "waterfill")}
                if got != want:
                    raise AssertionError(f"dense {label} {backend}: "
                                         f"launches {got}, expected {want}")
                if not bool((st.state == DONE).all()):
                    raise AssertionError(f"dense {label} {backend}: jobs "
                                         "left undone")
                held.append((("small", label), st, tr, f"{label} {backend}"))
                log(f"[dense] (a) {label} {backend}: {DENSE_TICKS} ticks in "
                    f"{wall:.2f}s ({1e3 * wall / DENSE_TICKS:.2f} ms a tick);"
                    f" launches {got}")
        skipped = [r[0] for r in DENSE_RUNS if r[0] in DENSE_TICK_RUNS
                   and r[0] not in DENSE_WATERFILL_RUNS]
        log(f"[dense] (a) CUT: waterfill reruns {list(DENSE_WATERFILL_RUNS)}"
            f" and not {skipped} (the same plain pass with the waterfill "
            "give); the other runs take fused's route under waterfill")

        # (b) knl 0.01: MIN at three proportions as one batch, EASY alone
        cl, w, variants = knl_dense_workloads()
        # a call just after the last arrival (tick 431), the queue full
        kept = Capture(schedule_tick, "fused_schedule_tick",
                       at=DENSE_KEPT_CALL)
        dense = {}
        for label in ("min", "easy"):
            torch.cuda.synchronize()
            build.LAUNCH_COUNTS.clear()  # this run's launches start here
            t0 = time.monotonic()
            with kept if label == "min" else contextlib.nullcontext():
                st, tr = dense_run(("knl", label), "cuda", "fused")
                torch.cuda.synchronize()
            wall = time.monotonic() - t0
            got = dense_launches(build)
            busy = tr.busy.cpu().numpy()
            if got != {"schedule_tick": KNL_DENSE_TICKS, "waterfill": 0}:
                raise AssertionError(f"dense knl {label}: launches {got}")
            if not bool((st.state == DONE).all()):
                raise AssertionError(f"dense knl {label}: jobs left undone "
                                     f"after {KNL_DENSE_TICKS} ticks")
            if int(busy.max()) > cl.nodes:
                raise AssertionError(f"dense knl {label}: {busy.max()} busy "
                                     f"nodes of {cl.nodes}")
            # the first 1,000 ticks under fused equal bisect's
            st1, tr1 = dense_run(("knl", label), "cuda", "fused",
                                 KNL_BISECT_TICKS)
            held.append((("knl", label), st1, tr1,
                         f"knl {label} first {KNL_BISECT_TICKS} ticks"))
            for a, b in zip(tr, tr1):
                if not torch.equal(a[..., :KNL_BISECT_TICKS], b):
                    raise AssertionError(f"dense knl {label}: the trace's "
                                         "first ticks differ between runs")
            ends = st.end_t.cpu().numpy().reshape(-1, w.n_jobs)
            lanes = [(label, p) for p in (KNL_DENSE_PROPS if label == "min"
                                          else (0.0,))]
            turn = []
            for (s, p), end, v in zip(lanes, ends,
                                      variants if label == "min" else [w]):
                des = simulate(v, cl, STRATEGIES[s])
                turn.append(f"{s}@{p}: {np.mean(end - w.submit):.1f} s "
                            f"(DES {np.mean(des.end - w.submit):.1f} s)")
            dense[label] = {"lanes": len(lanes), "wall_s": wall,
                            "ms_per_tick": 1e3 * wall / KNL_DENSE_TICKS,
                            "launches": got["schedule_tick"]}
            log(f"[dense] (b) knl 0.01 {label} ({len(lanes)} x {w.n_jobs} "
                f"jobs, {cl.nodes} nodes) fused: {KNL_DENSE_TICKS} ticks in "
                f"{wall:.2f}s ({dense[label]['ms_per_tick']:.3f} ms a tick), "
                f"every job DONE, busy <= {int(busy.max())}; launches {got}; "
                "mean turnaround " + "; ".join(turn))
        for job, st, tr, label in held:
            dense_equal(refs[job].result(), st, tr, label)
        log(f"[dense] (a) every run == bisect on the CPU bit for bit in "
            f"every field; (b) knl's first {KNL_BISECT_TICKS} ticks under "
            "fused == bisect on the CPU")
    args, kw = kept.kept
    t = time_tick(args, kw)
    B, W = args[1].shape
    t.update(shape=[B, W], launches=dense["min"]["launches"],
             prio_bounds=[kw["prio_lo"], kw["prio_hi"]])
    log(f"[kernel] schedule_tick at the dense knl call B={B} W={W} (priority"
        f" bounds {kw['prio_lo']}..{kw['prio_hi']}): {t['ms']:.4f} ms, "
        f"device {t['device_ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.6f} ms by {t['bound_by']}); bit-equal; "
        f"{report['gpu']}")
    for row in report.get("kernels", []):
        if row["name"] == "schedule_tick":
            row["dense"] = t
            row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
    report["dense"] = dense
    log(f"[dense] phase {time.monotonic() - t_phase:.1f}s; {report['gpu']}")


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


def registry_runs():
    """The registry phase's two theta runs: ``(name, spec keywords,
    backends)`` (1 seed, proportions 0.2 / 0.6 / 1.0)."""
    from repro_torch.core.scenario import JobClasses, ScenarioConfig
    props = (0.2, 0.6, 1.0)
    return (
        ("sjf", dict(proportions=props, scenario=ScenarioConfig(
            queue_order="sjf"), strategies=(
                "min", "keeppref", "pref_common_pool", "steal_agreement")),
         ("fused", "waterfill", "bisect")),
        ("classes", dict(proportions=props, scenario=ScenarioConfig(
            job_classes=JobClasses(rigid=0.1, on_demand=0.1,
                                   malleable=0.8)), strategies=(
                "pref", "rigid_sjf", "pref_common_pool")),
         ("fused", "bisect")),
    )


def registry_scale(report, elapsed_s):
    """0.1, or 0.05 when the phase's predicted wall (its plain-pass steps
    at this card's theta greedy rate times the plain / fused step ratio)
    and that of the phases after it at their least scales (experiment,
    what-if with (d) at 0.05, dense, and scale at haswell's 0.25) would
    not end inside the time limit."""
    rate = report.get("greedy_s_per_step")
    if rate is None:
        return 0.1
    left = 0.95 * TIME_LIMIT_S - elapsed_s
    after = (EXPERIMENT_STEPS + WHATIF_ABC_STEPS
             + 0.5 * WHATIF_D_STEPS * WHATIF_D_STEP_RATIO
             + DENSE_GREEDY_STEPS + 0.25 * HASWELL_STEPS * HASWELL_STEP_RATIO)
    if (REGISTRY_STEPS * REGISTRY_STEP_RATIO + after) * rate <= left:
        return 0.1
    return 0.05


def check_registry_launches(name, runs):
    """The kernels each backend must (and must not) launch in one run."""
    fused = runs["fused"][2]
    want_tick = name == "sjf"   # run 1's greedy lanes are class-free
    if (fused["schedule_tick"] > 0) != want_tick or not fused["waterfill"]:
        raise AssertionError(f"registry {name}: fused run launches {fused}")
    if "waterfill" in runs:
        wf = runs["waterfill"][2]
        if wf["schedule_tick"] or not wf["waterfill"]:
            raise AssertionError(f"registry {name}: waterfill run launches "
                                 f"{wf}")
    if any(runs["bisect"][2].values()):
        raise AssertionError(f"registry {name}: bisect run launches "
                             f"{runs['bisect'][2]}")


def phase_registry(report, elapsed_s):
    """The strategy registry through the port's entry point: theta with
    SJF (greedy, pooled and stealing batches) and with on-demand job
    classes (a greedy batch of FCFS and SJF lanes, a pooled batch), under
    each backend; metrics identical across backends, launches as each
    backend routes them, the card equal to the CPU on small runs, and the
    tick (an SJF-permuted call) and waterfill (a pooled / stealing give)
    held to their plain versions on captured calls and timed there."""
    import torch
    from repro_torch.kernels import build, schedule_tick, waterfill
    from repro_torch.core import CLUSTERS, traces
    scale = registry_scale(report, elapsed_s)
    cut = "" if scale == 0.1 else " (CUT from scale 0.1 to 0.05)"
    log(f"[registry] theta at scale {scale}{cut}: "
        f"{traces.generate('theta', seed=0, scale=scale).n_jobs} jobs on "
        f"{CLUSTERS['theta'].nodes:,} nodes (scale 1.0: 2,550; the cut is the "
        "job count), 1 seed, proportions 0.2 / 0.6 / 1.0")
    out = {"scale": scale, "runs": {}}
    tick_cap = Capture(schedule_tick, "fused_schedule_tick")
    wf_cap = Capture(waterfill, "waterfill")
    for name, spec_kw, backends in registry_runs():
        theta_on_both_devices("registry", 0.02, **spec_kw)
        runs = {}
        for backend in backends:
            capture = backend == "fused" and name == "sjf"
            torch.cuda.synchronize()
            build.LAUNCH_COUNTS.clear()  # this run's launches start here
            if capture:
                with tick_cap, wf_cap:
                    todo, metrics, info = run_grid(
                        ("theta",), scale, 1, backend, "cuda", **spec_kw)
            else:
                todo, metrics, info = run_grid(("theta",), scale, 1, backend,
                                               "cuda", **spec_kw)
            torch.cuda.synchronize()
            delta = {k: build.LAUNCH_COUNTS[k]
                     for k in ("schedule_tick", "waterfill")}
            check_cells(todo, metrics, info, f"registry {name}/{backend}")
            runs[backend] = (metrics, info, delta)
            log(f"[registry] {name} {backend}: {len(todo)} cells in "
                f"{info['wall_s']:.2f}s; launches {delta}")
            for c in info["chunks"]:
                log(f"[registry]   {c['structure']}: {c['lanes']} lanes "
                    f"{c['wall_s']:.2f}s {c['steps']} steps window "
                    f"{c['window']} "
                    f"{1e3 * c['wall_s'] / c['steps']:.2f} ms/step")
        base = runs["fused"][0]
        for backend in backends[1:]:
            if not same_metrics(base, runs[backend][0]):
                raise AssertionError(f"registry {name}: per-cell metrics "
                                     f"differ between fused and {backend}")
        check_registry_launches(name, runs)
        log(f"[registry] {name}: per-cell metrics identical under "
            f"{' / '.join(backends)}; launches as routed")
        out["runs"][name] = {
            "cells": len(todo),
            "launches": {b: runs[b][2] for b in backends},
            "batches": {b: {c["structure"]: {
                k: c[k] for k in ("lanes", "wall_s", "steps", "window")}
                for c in runs[b][1]["chunks"]} for b in backends}}
    sjf = out["runs"]["sjf"]["batches"]["fused"]["greedy"]
    s_step = sjf["wall_s"] / sjf["steps"]
    fcfs = report.get("greedy_s_per_step")
    log(f"[registry] fused greedy s/step: SJF {s_step:.6f} (theta scale "
        f"{scale}) beside FCFS "
        + (f"{fcfs:.6f} (main phase, theta scale 1.0)" if fcfs else
           "not measured (main phase not run)") + f"; {report['gpu']}")

    args, kw = tick_cap.kept
    if args[0].sort_key is None:
        raise AssertionError("registry: the captured tick call is not SJF")
    t = time_tick(args, kw)
    B, W = args[1].shape
    t.update(shape=[B, W], launches=out["runs"]["sjf"]["launches"][
        "fused"]["schedule_tick"])
    out["schedule_tick"] = t
    log(f"[kernel] schedule_tick on a captured SJF-permuted call B={B} "
        f"W={W}: {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms (plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms by "
        f"{t['bound_by']}); bit-equal; {report['gpu']}")
    (cap, tgt), kw = wf_cap.kept
    t = time_waterfill(cap, tgt, kw.get("order"))
    t.update(launches={n: r["launches"]["fused"]["waterfill"]
                       for n, r in out["runs"].items()})
    out["waterfill"] = t
    log(f"[kernel] waterfill on a captured pooled / stealing give "
        f"{tuple(cap.shape)} (order {t['order']}): {t['ms']:.4f} ms, device "
        f"{t['device_ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.6f} ms by {t['bound_by']}); bit-equal after a "
        f"CUDA-graph replay; {report['gpu']}")
    report["registry"] = out
    for row in report.get("kernels", []):
        if row["name"] in ("schedule_tick", "waterfill"):
            row["registry"] = out[row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     out[row["name"]]["max_abs_err"])


# ------------------------------------------------ the experiment layer
KERNEL_NAMES = ("schedule_tick", "waterfill", "rmsnorm", "flash_attention",
                "ssd_scan", "rmsnorm_bwd", "flash_attention_bwd",
                "ssd_scan_bwd")
# the configuration the reference's CI gates: haswell at scale 0.02, 2
# seeds, the paper grid, 2 cells crosschecked against the DES
GATED_ARGV = ["--workload", "haswell", "--scale", "0.02", "--seeds", "2"]


def run_entry(tag, argv):
    """``python -m repro_torch.experiments`` as a user runs it:
    ``main(argv)`` with kernel launches counted from 0 just before it and
    the flight recorder off again after it.  Prints the run's summary,
    crosscheck and heartbeat lines; returns (rc, wall s, launches, the
    run's whole output)."""
    import contextlib
    import io
    import torch
    from repro_torch import obs
    from repro_torch.experiments.__main__ import main
    from repro_torch.kernels import build
    argv = argv + ["--device", "cuda"]
    torch.cuda.synchronize()
    build.LAUNCH_COUNTS.clear()  # this run's launches start here
    buf = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        torch.cuda.synchronize()
    finally:
        obs.configure(enabled=False)
        obs.get_tracer().reset()
    wall = time.monotonic() - t0
    launches = {k: build.LAUNCH_COUNTS[k] for k in KERNEL_NAMES}
    text = buf.getvalue()
    for ln in text.splitlines():
        if ln.startswith(("[crosscheck", "[progress")) or any(
                w in ln for w in (" engine=", "FAIL", "WARNING",
                                  "EXCEEDED")):
            log(f"[experiment:{tag}]   {ln}")
    log(f"[experiment:{tag}] rc {rc}, wall {wall:.2f}s, launches "
        f"{ {k: v for k, v in launches.items() if v} or 'none'}")
    return rc, wall, launches, text


def artifact(path):
    return json.loads(pathlib.Path(path).read_text())["results"]


def worst_rel_err(cell):
    return max(d["abs_err"] / max(abs(d["des"]), 1e-9)
               for d in cell["deltas"].values())


def log_engine(tag, results):
    e = results["_engine"]
    cc = results.get("_crosscheck")
    log(f"[experiment:{tag}] {results['_meta']['workload']}: cells "
        f"computed {e['computed_cells']}, store hits {e['cache_hits']}, "
        f"incomplete {e['incomplete_cells_total']}, engine seconds "
        f"{e['sim_seconds']:.2f}"
        + ("" if cc is None else
           f"; crosscheck {len(cc['cells'])} cells, store hits "
           f"{cc['store_hits']}, DES seconds {cc['seconds']:.2f}, within "
           f"tolerance {cc['all_within_tolerance']}"))


def phase_experiment(report):
    """The port's experiment layer through ``python -m
    repro_torch.experiments``, each run group in a fresh temporary
    directory outside the repository: (a) the gated run (haswell 0.02,
    ``--require-crosscheck``, store, artifact, trace); (b) its resume
    (``--expect-cached``: no kernel launches, the DES cells read from the
    store); (c) the DES engine with two workers on the same store; (d) knl
    and eagle in one run, crosschecked; (e) a scenario sweep; (f) the
    DES crosscheck of the main phase's theta scale-1.0 cells (reported,
    not gated: a breach is the batched engine's methodology gap)."""
    import shutil
    import tempfile
    from repro_torch.experiments import (ExperimentSpec,
                                         load_artifact_results)
    from repro_torch.experiments.crosscheck import crosscheck_cells
    out = {}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="repro_torch_experiment_"))
    try:
        d = tmp / "gated"
        a_argv = GATED_ARGV + [
            "--crosscheck", "2", "--require-crosscheck", "--cache-dir",
            str(d / "store"), "--out", str(d / "haswell.json")]
        rc, wall, launches, _ = run_entry("a", a_argv + [
            "--trace", str(d / "t.json"), "--trace-jsonl",
            str(d / "t.jsonl"), "--progress"])
        if rc != 0:
            raise AssertionError(f"experiment (a): rc {rc}")
        if not launches["schedule_tick"]:
            raise AssertionError("experiment (a): the tick never launched")
        spec = ExperimentSpec(workloads=("haswell",), scale=0.02, seeds=2)
        res = load_artifact_results(d / "haswell.json", spec, "haswell")
        if res is None:
            raise AssertionError("experiment (a): the artifact does not "
                                 "reload for its spec")
        log_engine("a", res)
        names = {e["name"] for e in json.loads((d / "t.json").read_text())}
        want = {"experiment.fingerprint", "trace.generate", "sweep.execute"}
        if not want <= names:
            raise AssertionError(f"experiment (a): trace lacks "
                                 f"{sorted(want - names)}")
        jsonl = (d / "t.jsonl").read_text().splitlines()
        counters = json.loads(jsonl[-1])["counters"]
        log(f"[experiment:a] trace: {len(jsonl) - 1} spans "
            f"({', '.join(sorted(names))}); counters {counters}")
        out["a"] = {"wall_s": wall, "launches": launches,
                    "computed": res["_engine"]["computed_cells"],
                    "crosscheck": res["_crosscheck"]}

        rc, wall, launches, _ = run_entry("b", a_argv + ["--expect-cached"])
        res = artifact(d / "haswell.json")
        log_engine("b", res)
        if rc != 0 or any(launches.values()) or \
                res["_crosscheck"]["store_hits"] != 2:
            raise AssertionError(f"experiment (b): rc {rc}, launches "
                                 f"{launches}, crosscheck store hits "
                                 f"{res['_crosscheck']['store_hits']}")
        out["b"] = {"wall_s": wall, "launches": launches}

        rc, wall, launches, _ = run_entry("c", GATED_ARGV + [
            "--engine", "des", "--workers", "2", "--cache-dir",
            str(d / "store"), "--out", str(d / "haswell-des.json")])
        res = artifact(d / "haswell-des.json")
        log_engine("c", res)
        if rc != 0 or any(launches.values()) or \
                res["_engine"]["cache_hits"] < 2:
            raise AssertionError(f"experiment (c): rc {rc}, launches "
                                 f"{launches}, store hits "
                                 f"{res['_engine']['cache_hits']}")
        out["c"] = {"wall_s": wall, "des_s": res["_engine"]["sim_seconds"],
                    "cache_hits": res["_engine"]["cache_hits"]}

        d = tmp / "clusters"
        rc, wall, launches, _ = run_entry("d", [
            "--workload", "knl", "eagle", "--scale", "0.01", "--seeds", "1",
            "--crosscheck", "2", "--out", str(d / "knl-eagle.json")])
        res = artifact(d / "knl-eagle.json")
        if rc != 0 or set(res) != {"knl", "eagle"}:
            raise AssertionError(f"experiment (d): rc {rc}, workloads "
                                 f"{sorted(res)}")
        out["d"] = {"wall_s": wall, "launches": launches}
        for name, r in res.items():
            log_engine("d", r)
            if r["_engine"]["incomplete_cells"]:
                raise AssertionError(f"experiment (d): {name} incomplete")
            out["d"][name] = {c["cell"]: worst_rel_err(c)
                              for c in r["_crosscheck"]["cells"]}
            for c in r["_crosscheck"]["cells"]:
                log(f"[experiment:d] {name} {c['cell']}: worst relative "
                    f"error {worst_rel_err(c):.4f}, within tolerance "
                    f"{c['within_tolerance']}")

        d = tmp / "scenarios"
        rc, wall, launches, text = run_entry("e", [
            "--workload", "knl", "--scale", "0.01", "--seeds", "1",
            "--strategies", "min", "keeppref", "--compare-scenarios",
            "backfill_depth", "--scenario-values", "1", "4", "256", "--out",
            str(d / "cmp.json")])
        table = json.loads((d / "cmp.json").read_text())["tables"]["knl"]
        if rc != 0 or table not in text:
            raise AssertionError(f"experiment (e): rc {rc}, table printed "
                                 f"{table in text}")
        for ln in table.splitlines():
            log(f"[experiment:e]   {ln}")
        out["e"] = {"wall_s": wall, "launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    fused = report.get("theta_fused")
    if fused is None:
        log("[experiment:f] theta scale 1.0 crosscheck: not run (main "
            "phase not run)")
    else:
        spec = ExperimentSpec(workloads=("theta",), scale=1.0, seeds=2)
        cc = crosscheck_cells(spec, "theta", fused, n_cells=4, rng_seed=0,
                              verbose=False)
        for c in cc["cells"]:
            log(f"[experiment:f] theta scale 1.0 {c['cell']}: within "
                f"tolerance {c['within_tolerance']}; " + "; ".join(
                    f"{k} des {v['des']:.4f} torch {v['torch']:.4f} rel "
                    f"{v['abs_err'] / max(abs(v['des']), 1e-9):.4f}"
                    for k, v in c["deltas"].items()))
        log(f"[experiment:f] theta scale 1.0: 4 cells, DES seconds "
            f"{cc['seconds']:.2f}, all within tolerance "
            f"{cc['all_within_tolerance']} (reported, not gated)")
        out["f"] = cc
    report["experiment"] = out


# ---------------------------------------------- the what-if query service
# (a)'s storm: 16 queries drawn by ``sample_queries`` (seed 0) over the
# greedy-structured strategies; seed 0 draws 10 distinct cells, so 6
# queries attach to a pending duplicate
WHATIF_SAMPLE = dict(workloads=("theta",),
                     strategies=("min", "pref", "keeppref", "easy"),
                     proportions=(0.2, 0.4, 0.6, 1.0), seeds=2)
WHATIF_QUERY_SEED = 0


def whatif_argv(store, queries):
    """``python -m repro_torch.serve`` argv asking ``queries`` of theta at
    scale 1.0 against ``store`` on the card."""
    argv = ["--workload", "theta", "--scale", "1.0", "--seeds", "2",
            "--device", "cuda", "--cache-dir", str(store)]
    for q in queries:
        argv += ["--query", ",".join(f"{k}={v}"
                                     for k, v in q.to_dict().items())]
    return argv


def whatif_storm(engine, queries, clients=4):
    """Submit ``queries`` from ``clients`` threads into the paused
    ``engine``, then start it: every miss lands in one admitted batch."""
    import threading
    futs = [None] * len(queries)

    def client(idxs):
        for i in idxs:
            futs[i] = engine.submit(queries[i])

    threads = [threading.Thread(target=client,
                                args=(range(c, len(queries), clients),))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    engine.start()
    return [f.result(timeout=900) for f in futs]


def whatif_http(store, query, want):
    """(c): ``serve_http`` on a free local port in a thread; a stored
    cell's POST returns its metrics, /stats and /healthz answer, a bad
    strategy is a 400."""
    import threading
    import urllib.error
    import urllib.request
    from repro_torch.serve import __main__ as smain
    args = smain.build_parser().parse_args(whatif_argv(store, [])
                                           + ["--max-wait-ms", "0"])
    engine = smain.engine_from_args(args)
    bound, ready = [], threading.Event()

    def started(httpd):
        bound.append(httpd)
        ready.set()

    thread = threading.Thread(target=smain.serve_http,
                              args=(engine, "127.0.0.1", 0, started),
                              daemon=True)
    thread.start()
    if not ready.wait(60):
        raise AssertionError("whatif (c): the HTTP service did not start")
    httpd = bound[0]
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    local = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        try:
            with local.open(url + path, data=data, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    try:
        code, body = call("/whatif", query.to_dict())
        if code != 200 or body["metrics"] != want:
            raise AssertionError(f"whatif (c): POST /whatif gave {code}, "
                                 "metrics differ from the storm's")
        stats = call("/stats")
        health = call("/healthz")
        bad = call("/whatif", {"strategy": "nope"})
        if stats[0] != 200 or health != (200, {"ok": True}) or \
                bad[0] != 400:
            raise AssertionError(f"whatif (c): /stats {stats[0]}, /healthz "
                                 f"{health}, bad strategy {bad[0]}")
    finally:
        httpd.shutdown()
        thread.join(60)
    return stats[1]


# (d): theta at scale 0.1, 1 seed: a greedy batch of FCFS and SJF lanes
# (the tick) and one of on-demand class lanes (the waterfill give), each
# run monolithic, in chunks of 2 lanes and split in 2 pieces on one card
WHATIF_PLANS = (("monolithic", {}), ("chunk_lanes=2", {"chunk_lanes": 2}),
                ("devices=2 on cuda:0", {"devices": 2,
                                         "device": "cuda:0"}))


def whatif_plan_specs():
    from repro_torch.core.scenario import JobClasses, ScenarioConfig
    return (
        ("fcfs+sjf", dict(proportions=(1.0,),
                          strategies=("min", "keeppref", "rigid_sjf"))),
        ("classes", dict(proportions=(1.0,),
                         strategies=("pref", "rigid_sjf"),
                         scenario=ScenarioConfig(job_classes=JobClasses(
                             rigid=0.1, on_demand=0.1, malleable=0.8)))),
    )


def whatif_scale(report, elapsed_s):
    """0.1, or 0.05 when (d)'s predicted wall at 0.1 and that of the phases
    after it (dense, and scale at haswell's least scale), at this card's
    theta greedy rate, would not end inside the time limit."""
    rate = report.get("greedy_s_per_step")
    if rate is None:
        return 0.1
    steps = (WHATIF_D_STEPS * WHATIF_D_STEP_RATIO + DENSE_GREEDY_STEPS
             + 0.25 * HASWELL_STEPS * HASWELL_STEP_RATIO)
    if steps * rate <= 0.95 * TIME_LIMIT_S - elapsed_s:
        return 0.1
    return 0.05


def whatif_plans(scale):
    """(d): per-cell metrics identical under the three plans."""
    import torch
    from repro_torch.experiments.backend_torch import run_cells
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.kernels import build
    log(f"[whatif:d] theta at scale {scale}, 1 seed")
    out = {}
    for name, spec_kw in whatif_plan_specs():
        spec = ExperimentSpec(workloads=("theta",), scale=scale, seeds=1,
                              **spec_kw)
        todo = [("theta", c) for c in spec.cells()]
        runs = {}
        for label, plan in WHATIF_PLANS:
            torch.cuda.synchronize()
            build.LAUNCH_COUNTS.clear()  # this run's launches start here
            t0 = time.monotonic()
            metrics, info = run_cells(
                spec, todo, None, {}, verbose=False,
                options={"device": "cuda", "expand_backend": "fused",
                         **plan})
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = {k: build.LAUNCH_COUNTS[k]
                        for k in ("schedule_tick", "waterfill")}
            check_cells(todo, metrics, info, f"whatif (d) {name} {label}")
            chunks = [(c["lo"], c["hi"], c["lane_width"], c["devices"])
                      for c in info["chunks"]]
            log(f"[whatif:d] {name} {label}: {len(todo)} cells in "
                f"{wall:.2f}s, chunks (lo, hi, width, devices) {chunks}, "
                f"steps {sum(c['steps'] for c in info['chunks'])}, "
                f"launches {launches}")
            runs[label] = metrics
            out[f"{name} {label}"] = {"wall_s": wall, "launches": launches,
                                      "chunks": len(chunks)}
            if not any(launches.values()):
                raise AssertionError(f"whatif (d) {name} {label}: no "
                                     "kernel launched")
        base = runs["monolithic"]
        for label, _plan in WHATIF_PLANS[1:]:
            if not same_metrics(base, runs[label]):
                raise AssertionError(
                    f"whatif (d) {name}: {label} differs from the "
                    f"monolithic run: {metric_diffs(base, runs[label])}")
        log(f"[whatif:d] {name}: per-cell metrics identical under "
            f"{' / '.join(label for label, _ in WHATIF_PLANS)}")
    return out


def whatif_card_vs_cpu():
    """(d): a storm at theta 0.02 (greedy and balanced lanes) answered on
    the card (fused) equals the same storm on the CPU bit for bit."""
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.serve.whatif import WhatIfEngine, sample_queries
    spec = ExperimentSpec(workloads=("theta",), scale=0.02, seeds=2)
    queries = sample_queries(1, 12, workloads=("theta",), seeds=2)
    answers = {}
    for device in ("cpu", "cuda"):
        engine = WhatIfEngine(spec, max_batch=16, max_wait_s=0.0,
                              start=False,
                              backend_options={"device": device})
        answers[device] = whatif_storm(engine, queries)
        engine.close()
    cpu, card = (dict(enumerate(answers[d])) for d in ("cpu", "cuda"))
    if not same_metrics(cpu, card):
        raise AssertionError("whatif (d): the theta 0.02 storm on the card "
                             f"differs from the CPU's: "
                             f"{metric_diffs(cpu, card)}")
    log(f"[whatif:d] theta scale 0.02 storm, {len(queries)} queries "
        f"({len({q.cell() for q in queries})} cells, greedy and balanced): "
        "the card (fused) == the CPU (bisect), bit for bit")


def phase_whatif(report, elapsed_s):
    """The what-if query service through its entry points: (a) a storm of
    16 queries at theta scale 1.0 from 4 client threads, one coalesced
    batch on the card, every answer equal to ``run_cells``' cell; (b) its
    ``--expect-hits`` rerun through ``python -m repro_torch.serve``'s
    ``main(argv)`` (100% store hits, no launch); (c) the HTTP service; (d)
    chunked and split runs bit-identical to the monolithic one on the
    card, and a small storm on the card equal to the CPU's."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch
    from repro_torch import obs
    from repro_torch.experiments.backend_torch import run_cells
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.kernels import build
    from repro_torch.serve import __main__ as smain
    from repro_torch.serve.whatif import WhatIfEngine, sample_queries
    t_phase = time.monotonic()
    out = {}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="repro_torch_whatif_"))
    try:
        store = tmp / "store"
        spec = ExperimentSpec(workloads=("theta",), scale=1.0, seeds=2)
        queries = sample_queries(WHATIF_QUERY_SEED, 16, **WHATIF_SAMPLE)
        engine = WhatIfEngine(spec, cache_dir=str(store), max_batch=16,
                              max_wait_s=0.0, start=False,
                              backend_options={"device": "cuda",
                                               "expand_backend": "fused"})
        obs.configure(enabled=True)
        try:
            torch.cuda.synchronize()
            build.LAUNCH_COUNTS.clear()  # this path's launches start here
            t0 = time.monotonic()
            answers = whatif_storm(engine, queries)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = {k: build.LAUNCH_COUNTS[k] for k in KERNEL_NAMES}
            stats = engine.stats()
            steps = int(obs.get_tracer().counters.get("serve.steps"))
        finally:
            engine.close()
            obs.configure(enabled=False)
            obs.get_tracer().reset()
        log(f"[whatif:a] theta scale 1.0, {len(queries)} queries from 4 "
            f"clients: wall {wall:.2f}s, {stats['batches']} batch(es) "
            f"(width max {stats['max_batch_width']}, mean "
            f"{stats['mean_batch_width']:.1f}), {stats['computed']} cells "
            f"computed, {stats['dedup']} deduplicated, {steps} steps "
            f"({1e3 * wall / max(steps, 1):.2f} ms/step), launches "
            f"{ {k: v for k, v in launches.items() if v} or 'none'}")
        if len(answers) != len(queries) or stats["failed"] or \
                stats["batches"] != 1:
            raise AssertionError(f"whatif (a): stats {stats}")
        if not launches["schedule_tick"] or stats["dedup"] < 2:
            raise AssertionError(f"whatif (a): launches {launches}, dedup "
                                 f"{stats['dedup']}")
        cells = {q.cell(): m for q, m in zip(queries, answers)}
        want = dict(report.get("theta_fused") or {})
        missing = [c for c in cells if c not in want]
        if missing:
            metrics, _ = run_cells(spec, [("theta", c) for c in missing],
                                   None, {}, verbose=False,
                                   options={"device": "cuda",
                                            "expand_backend": "fused"})
            want.update({c: metrics[("theta", c)] for c in missing})
        if not same_metrics(cells, {c: want[c] for c in cells}):
            raise AssertionError(
                "whatif (a): answers differ from run_cells' cells: "
                f"{metric_diffs(cells, {c: want[c] for c in cells})}")
        log(f"[whatif:a] every answer equals run_cells' cell "
            f"({len(cells) - len(missing)} from the main phase's grid, "
            f"{len(missing)} from a direct run_cells call)")
        out["a"] = {"wall_s": wall, "stats": stats, "steps": steps,
                    "launches": launches}

        torch.cuda.synchronize()
        build.LAUNCH_COUNTS.clear()  # (b)'s launches start here
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = smain.main(whatif_argv(store, queries)
                            + ["--clients", "4", "--expect-hits"])
        wall_b = time.monotonic() - t0
        launches_b = {k: build.LAUNCH_COUNTS[k] for k in KERNEL_NAMES}
        summary = buf.getvalue().strip().splitlines()[-1]
        log(f"[whatif:b] --expect-hits rerun: rc {rc}, wall {wall_b:.2f}s, "
            f"{summary}; launches "
            f"{ {k: v for k, v in launches_b.items() if v} or 'none'}")
        if rc != 0 or any(launches_b.values()) or \
                f"{len(queries)} queries: {len(queries)} hits" not in summary:
            raise AssertionError(f"whatif (b): rc {rc}, launches "
                                 f"{launches_b}")
        out["b"] = {"wall_s": wall_b, "launches": launches_b}

        build.LAUNCH_COUNTS.clear()
        stats_c = whatif_http(store, queries[0], answers[0])
        if any(build.LAUNCH_COUNTS.values()):
            raise AssertionError("whatif (c): a stored cell launched "
                                 f"{dict(build.LAUNCH_COUNTS)}")
        log(f"[whatif:c] HTTP on a free local port: POST /whatif == the "
            f"storm's answer (store hits {stats_c['store_hits']}), /stats "
            "and /healthz 200, a bad strategy 400")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    spent = elapsed_s + time.monotonic() - t_phase
    scale = whatif_scale(report, spent)
    if scale != 0.1:
        log(f"[whatif:d] {spent:.0f}s spent; at this card's theta greedy "
            "rate (d) at scale 0.1 and "
            "the dense and scale phases would not end inside "
            f"{TIME_LIMIT_S:.0f}s (CUT from scale 0.1 to 0.05)")
    out["d_scale"] = scale
    out["d"] = whatif_plans(scale)
    whatif_card_vs_cpu()
    report["whatif"] = out
    for row in report.get("kernels", []):
        if row["name"] == "schedule_tick":
            row["whatif"] = {"launches": out["a"]["launches"][
                "schedule_tick"], "steps": out["a"]["steps"]}


# ------------------------------------ the paper's clusters at full scale
PAPER_SCALE_BUDGET_S = 2700.0
# knl at scale 1.0 on one H100 (700 W): the plain pass's wall per step
# over the tick's (12.83 / 4.62 ms), and one 4-lane eagle chunk's wall over
# knl's fused run (411-463 s / 185.7 s), with some margin; the predictions
# that decide the cuts (PERF.md section 5)
BISECT_STEP_RATIO = 3.0
EAGLE_CHUNK_RATIO = 2.7
PAPER_GREEDY = ("min", "pref", "keeppref")


def paper_strategies(predict, left, label):
    """The most greedy-structured strategies (all three, two, one) whose
    predicted wall ``predict(strategies)`` fits in ``left`` seconds; the
    cut is printed."""
    for k in (3, 2, 1):
        cut = PAPER_GREEDY[:k]
        if predict(cut) <= left:
            break
    if cut != PAPER_GREEDY:
        log(f"[paper-scale] {label}: CUT to strategies {cut} (predicted "
            f"{predict(cut):.0f}s, {left:.0f}s left of the budget)")
    return cut


def phase_paper_scale(report, elapsed_s, budget_s):
    """Opt-in (``--phases env,paper-scale``): knl at scale 1.0 (41,524
    jobs on 9,688 nodes) under fused and bisect, metrics identical; eagle
    at scale 1.0 (143,829 jobs on 2,568 nodes) through ``python -m
    repro_torch.experiments`` with ``--chunk-lanes 4`` and a cell store,
    then its ``--expect-cached`` rerun (all hits, no launch).  1 seed,
    EASY and the greedy strategies; cut to fewer strategies, printed, when
    the predicted wall would not end inside ``budget_s``."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import build
    t_phase = time.monotonic()

    def left():
        return budget_s - elapsed_s - (time.monotonic() - t_phase)

    out = {}
    runs = {}
    for backend in ("fused", "bisect"):
        strategies = PAPER_GREEDY if backend == "fused" else \
            paper_strategies(lambda s: runs["fused"]["wall_s"]
                             * BISECT_STEP_RATIO, left(), "knl bisect")
        torch.cuda.synchronize()
        build.LAUNCH_COUNTS.clear()  # this run's launches start here
        todo, metrics, info = run_grid(("knl",), 1.0, 1, backend, "cuda",
                                       strategies=strategies)
        torch.cuda.synchronize()
        launches = {k: build.LAUNCH_COUNTS[k]
                    for k in ("schedule_tick", "waterfill")}
        check_cells(todo, metrics, info, f"knl/{backend}")
        runs[backend] = {"wall_s": info["wall_s"], "cells": len(todo),
                         "steps": info["greedy_steps"],
                         "window": info["greedy_window"],
                         "launches": launches, "metrics": metrics}
        log(f"[paper-scale] knl scale 1.0 {backend}: {len(todo)} cells in "
            f"{info['wall_s']:.2f}s; {info['greedy_steps']} steps "
            f"({1e3 * info['wall_s'] / info['greedy_steps']:.2f} ms/step), "
            f"peak window {info['greedy_window']}; launches {launches}")
    fused, bisect = runs["fused"], runs["bisect"]
    if not same_metrics({k: fused["metrics"][k] for k in bisect["metrics"]},
                        bisect["metrics"]):
        raise AssertionError("paper-scale: knl metrics differ between fused "
                             "and bisect")
    if not fused["launches"]["schedule_tick"] or \
            any(bisect["launches"].values()):
        raise AssertionError(f"paper-scale: knl launches fused "
                             f"{fused['launches']} bisect "
                             f"{bisect['launches']}")
    log(f"[paper-scale] knl: the {bisect['cells']} cells of the bisect run "
        "identical under fused and bisect")
    out["knl"] = {b: {k: v for k, v in r.items() if k != "metrics"}
                  for b, r in runs.items()}

    def predict(strategies):
        lanes = 1 + len(strategies) * 5  # EASY + 5 proportions a strategy
        return fused["wall_s"] * EAGLE_CHUNK_RATIO * -(-lanes // 4)

    strategies = paper_strategies(predict, left(), "eagle")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="repro_torch_paper_"))
    try:
        argv = ["--workload", "eagle", "--scale", "1.0", "--seeds", "1",
                "--strategies", *strategies, "--expand-backend", "fused",
                "--chunk-lanes", "4", "--cache-dir", str(tmp / "store"),
                "--out", str(tmp / "eagle.json")]
        rc, wall, launches, _ = run_entry("eagle", argv)
        res = artifact(tmp / "eagle.json")
        eng = res["_engine"]
        if rc != 0 or not launches["schedule_tick"] or \
                eng["incomplete_cells"] or len(eng["chunks"]) < 2:
            raise AssertionError(f"paper-scale: eagle rc {rc}, launches "
                                 f"{launches}, incomplete "
                                 f"{eng['incomplete_cells']}, chunks "
                                 f"{len(eng['chunks'])}")
        for c in eng["chunks"]:
            log(f"[paper-scale] eagle chunk [{c['lo']}, {c['hi']}) width "
                f"{c['lane_width']}: {c['wall_s']:.2f}s, {c['steps']} "
                f"steps, window {c['window']}")
        log(f"[paper-scale] eagle scale 1.0: {eng['computed_cells']} cells "
            f"in {wall:.2f}s as {len(eng['chunks'])} chunks of 4 lanes; "
            f"{eng['greedy_steps']} steps, peak window "
            f"{eng['greedy_window']}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        out["eagle"] = {"wall_s": wall, "launches": launches,
                        "cells": eng["computed_cells"],
                        "steps": eng["greedy_steps"],
                        "window": eng["greedy_window"],
                        "chunks": [{k: c[k] for k in (
                            "lo", "hi", "lane_width", "wall_s", "steps",
                            "window")} for c in eng["chunks"]]}
        rc, wall, launches, _ = run_entry("eagle-cached",
                                          argv + ["--expect-cached"])
        if rc != 0 or any(launches.values()):
            raise AssertionError(f"paper-scale: eagle --expect-cached rc "
                                 f"{rc}, launches {launches}")
        log(f"[paper-scale] eagle --expect-cached: rc 0, {wall:.2f}s, no "
            "launch")
        out["eagle"]["cached_wall_s"] = wall
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["paper_scale"] = out


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


def time_rmsnorm_bwd_plans(report):
    """Device ms (CUDA graph of 20 calls) of hand-made RMSNorm backward
    plans at ``RMS_BWD_SHAPES`` in bf16 and f32, each held to the plain
    backward (``--phases env,rmsnorm-plans``: how ``rmsnorm.bwd_plan``'s
    choices were set): every vectors-a-thread the kernel has that holds
    the row in at most 512 threads, 1-4 CTAs an SM, clusters of 2, 4 and
    8, each shaped by ``bwd_plan``'s own helpers (``bwd_row_shape``,
    ``bwd_grid``)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_bwd_ref
    gen = torch.Generator().manual_seed(26)
    sms = build.sm_count(0)
    out = report.setdefault("rmsnorm_bwd_plans", [])
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for label, shape in RMS_BWD_SHAPES:
            args, _kw = bwd_case(gen, "rmsnorm_bwd", shape, dtype)
            x, w, dy = args
            rows, d = shape["rows"], shape["d"]
            want = rmsnorm_bwd_ref(x, w, dy)
            picked = rn.bwd_plan(rows, d, dtype, w.dtype, sms)
            vec = picked.vec
            nv = d // vec
            times = []
            for k in rn.BWD_VECTORS[vec]:
                threads, warp_rows, groups = rn.bwd_row_shape(rows, nv, k)
                if threads > rn.BWD_MAX_THREADS:
                    continue
                for per_sm in (1, 2, 3, 4):
                    if per_sm * threads > 2048:
                        continue
                    for cl in (2, 4, 8):
                        ctas, cluster = rn.bwd_grid(rows, groups, per_sm, sms,
                                                    cl)
                        pl = rn.make_bwd_plan(rows, d, dtype, w.dtype, vec, k,
                                              threads, warp_rows, ctas,
                                              cluster)

                        def call(pl=pl):
                            dx, dw = torch.empty_like(x), torch.empty_like(w)
                            part = torch.empty((pl.partials, d),
                                               dtype=torch.float32,
                                               device=x.device)
                            build.launch("rmsnorm_bwd", x,
                                         "repro_rmsnorm_bwd",
                                         *rn.bwd_kernel_args(
                                             x, w, dy, dx, dw, part, pl,
                                             1e-6))
                            return dx, dw
                        for n, g, r in zip(("dx", "dscale"), call(), want):
                            max_rel_err(g, r, BWD_TOL[dname],
                                        f"plans {label} {dname} {n}")
                        times.append((graph_ms(call), k, threads, per_sm,
                                      cluster, ctas, pl == picked))
            times.sort()
            out.append({"label": label, "dtype": dname, "times": times})
            log(f"[rms-plans] {label} {dname} {rows} x {d}: bwd_plan picks "
                f"{picked.per_thread} x {vec} a thread, {picked.threads} "
                f"threads, {picked.ctas} CTAs, cluster {picked.cluster}; "
                "device ms (vectors a thread, threads, CTAs an SM, cluster, "
                "CTAs): " + "; ".join(
                    f"{t:.4f} ({k}, {th}, {ps}, {c}, {n}{' *' if mine else ''})"
                    for t, k, th, ps, c, n, mine in times[:12])
                + f"; {report['gpu']}")
            del args, want
            torch.cuda.empty_cache()


def rmsnorm_bwd_per_cta(x, scale, dy, eps=1e-6):
    """``repro_rmsnorm_bwd`` called as the per-CTA backward's wrapper
    called it, for an ``--ab-csrc`` tree whose ``rmsnorm.cu`` holds the
    backward: 2 CTAs an SM each sum their rows' dscale terms into an f32
    partial row, which a second kernel adds up (the same C parameter
    kinds, other meanings)."""
    import torch
    from repro_torch.kernels.build import dtype_code, launch, sm_count
    d = x.shape[-1]
    rows = x.numel() // d
    dx, dw = torch.empty_like(x), torch.empty_like(scale)
    parts = min(rows, 2 * sm_count(x.get_device()))
    partial = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    launch("rmsnorm_bwd", x, "repro_rmsnorm_bwd", x.data_ptr(),
           scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
           partial.data_ptr(), rows, d, parts, eps,
           dtype_code(x.dtype) | dtype_code(scale.dtype) << 1)
    return dx, dw


def ssd_scan_bwd_cuda_core(x, dt, a, b, c, dy, dstate, states, *,
                           initial_state=None):
    """``repro_ssd_scan_bwd`` called as the CUDA-core backward's wrapper
    called it, for an ``--ab-csrc`` tree whose ``ssd_scan_bwd.cu`` runs four
    kernels (the pulls on the states, the reverse pass, the chunk scan on
    CUDA-core tiles, the sums): the same C parameters, a scratch that also
    holds the pulls G and the pass's per-CTA dot partials.  Its plan picked
    the chunk and head groups this tree's does at ``SSD_BWD_SHAPES`` (64, a
    wave of the SMs)."""
    import torch
    from repro_torch.kernels.build import dtype_code, launch
    from repro_torch.kernels.ssd_scan import SMS, bwd_plan
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    L = bwd_plan(bsz, s, h, p, n).chunk
    if L != 64:
        raise ValueError(f"the CUDA-core backward's plan runs chunk 64 "
                         f"here, not {L}")
    nc = -(-s // L)
    q = bsz * nc
    groups = max(1, min(h, SMS // q))
    x_ctas = -(-p * n // 256)
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = torch.empty(bsz * nc * h * (p * n + x_ctas + 1)
                          + 2 * q * groups * L * n, **f32)
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b, c))
    da = torch.empty((h,), **f32)
    dinit = (None if initial_state is None
             else torch.empty((bsz, h, p, n), **f32))
    launch("ssd_scan_bwd", x, "repro_ssd_scan_bwd", x.data_ptr(),
           dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
           dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
           states.data_ptr(), dx.data_ptr(), ddt.data_ptr(), db.data_ptr(),
           dc.data_ptr(), da.data_ptr(),
           None if dinit is None else dinit.data_ptr(), scratch.data_ptr(),
           bsz, s, h, p, n, L, groups, dtype_code(x.dtype))
    return dx, ddt, da, db, dc, dinit


def phase_bwd_ab(report, csrc, kernels=None):
    """Opt-in (``--phases env,bwd-ab``): the backward kernels of this tree
    against another tree's (``--ab-csrc``: that tree's
    ``src/repro_torch/kernels/csrc``, say the parent commit's, unpacked
    with ``git archive`` into a directory that .gitignore lists; its
    library is built beside it), in one process on one card: the backward
    kernels the other tree has (of ``kernels``, by default all three),
    the RMSNorm backward at ``RMS_BWD_SHAPES``, the attention backward at
    ``ATTN_BWD_SHAPES`` and the SSD scan's at ``SSD_BWD_SHAPES``, in bf16
    and f32: device time (a CUDA graph of 20 calls) in turns other / this
    / this / other, both held to the plain backward, then each kernel's
    device time a launch under torch.profiler (10 eager calls, memsets
    included).
    A tree whose RMSNorm backward lives in ``rmsnorm.cu`` is called as its
    wrapper called it (:func:`rmsnorm_bwd_per_cta`), and one whose SSD
    backward runs a reverse pass kernel as its wrapper called it
    (:func:`ssd_scan_bwd_cuda_core`)."""
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    from repro_torch.kernels.ssd_scan import bwd_plan, ssd_scan_bwd
    other_dir = pathlib.Path(csrc).resolve()
    wanted = kernels or ("rmsnorm_bwd", "flash_attention_bwd",
                         "ssd_scan_bwd")
    has = {"rmsnorm_bwd": (other_dir / "rmsnorm.cu").is_file(),
           "flash_attention_bwd": (other_dir /
                                   "flash_attention_bwd.cu").is_file(),
           "ssd_scan_bwd": (other_dir / "ssd_scan_bwd.cu").is_file()}
    has = {k: v and k in wanted for k, v in has.items()}
    if not any(has.values()):
        raise FileNotFoundError(f"--ab-csrc {csrc}: none of {wanted}'s "
                                "sources")
    mine = build.load_library()
    saved = build.CSRC, build.SOURCES, build.HEADERS, build._SIGNATURES
    build.CSRC = other_dir
    build.SOURCES, build.HEADERS = (
        tuple(f for f in names if (other_dir / f).is_file())
        for names in saved[1:3])
    # the entry points the other tree's bindings.cpp has (an older tree
    # lacks the later ones)
    entries = set(re.findall(r"^int (repro_\w+)\(",
                             (other_dir / "bindings.cpp").read_text(),
                             re.M))
    build._SIGNATURES = {k: v for k, v in saved[3].items() if k in entries}
    build._LIB = None
    try:
        t0 = time.monotonic()
        other = build.load_library()
        log(f"[bwd-ab] built {other_dir} in {time.monotonic() - t0:.1f}s")
    finally:
        build.CSRC, build.SOURCES, build.HEADERS, build._SIGNATURES = saved
        build._LIB = mine
    libs = {"other": other, "this": mine}
    per_cta = not (other_dir / "rmsnorm_bwd.cu").is_file()
    ssd_cuda_core = has["ssd_scan_bwd"] and "ssd_bwd_pass_kernel" in (
        other_dir / "ssd_scan_bwd.cu").read_text()

    def ssd_this(a, kw):
        return ssd_scan_bwd(*a, **kw)

    def ssd_plain(a, kw):
        x, b = a[0], a[3]
        return ref.ssd_bwd_ref(*a[:7], chunk=bwd_plan(*x.shape,
                                                      b.shape[-1]).chunk,
                               initial_state=kw.get("initial_state"))
    calls = {
        "rmsnorm_bwd": {"this": lambda a, kw: rmsnorm_bwd(*a),
                        "other": (lambda a, kw: rmsnorm_bwd_per_cta(*a))
                        if per_cta else (lambda a, kw: rmsnorm_bwd(*a))},
        "flash_attention_bwd": dict.fromkeys(
            libs, lambda a, kw: flash_attention_bwd(*a, **kw)),
        "ssd_scan_bwd": {"this": ssd_this,
                         "other": (lambda a, kw: ssd_scan_bwd_cuda_core(
                             *a, **kw)) if ssd_cuda_core else ssd_this}}
    plains = {"rmsnorm_bwd": lambda a, kw: ref.rmsnorm_bwd_ref(*a),
              "flash_attention_bwd": lambda a, kw: ref.attention_bwd_ref(
                  *a, **kw),
              "ssd_scan_bwd": ssd_plain}
    rows = []
    gen = torch.Generator().manual_seed(25)
    for kernel, shapes in (("rmsnorm_bwd", RMS_BWD_SHAPES),
                           ("flash_attention_bwd", ATTN_BWD_SHAPES),
                           ("ssd_scan_bwd", SSD_BWD_SHAPES)):
        if not has[kernel]:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            for label, shape in shapes:
                args, kw = bwd_case(gen, kernel, shape, dtype)
                want = plains[kernel](args, kw)
                row = {"kernel": kernel, "label": label, "dtype": dname,
                       "device_ms": {}, "by_kernel_ms": {}}
                for name in ("other", "this", "this", "other"):
                    build._LIB = libs[name]
                    fn = calls[kernel][name]
                    row["device_ms"].setdefault(name, []).append(graph_ms(
                        lambda: fn(args, kw)))
                for name, lib in libs.items():
                    build._LIB = lib
                    fn = calls[kernel][name]
                    for n, g, r in zip(BWD_OUTPUTS[kernel], fn(args, kw),
                                       want):
                        if g is not None:
                            max_rel_err(g, r, BWD_TOL[dname],
                                        f"bwd-ab {name} {label} {dname} {n}")
                    row["by_kernel_ms"][name] = by_kernel_ms(
                        lambda: fn(args, kw))
                build._LIB = mine
                t = row["device_ms"]
                log(f"[bwd-ab] {kernel} {label} {dname}: device ms other "
                    f"{t['other'][0]:.4f} / this {t['this'][0]:.4f} / this "
                    f"{t['this'][1]:.4f} / other {t['other'][1]:.4f} (this "
                    f"/ other {sum(t['this']) / sum(t['other']):.3f}); by "
                    "kernel (10 eager calls), ms a launch: "
                    + "; ".join(f"{n}: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in ks.items())
                        for n, ks in row["by_kernel_ms"].items())
                    + f"; {report['gpu']}")
                rows.append(row)
                del args, want
                torch.cuda.empty_cache()
    report["bwd_ab"] = {"other_csrc": str(other_dir), "rows": rows}


# (old, new) edits of csrc/ssd_scan_bwd.cu, each matching it once
_SSD_SCAN_LOOP = ("for (int k0 = 0; k0 < pp; k0 += 8) {\n"
                  "      const float2 v0 = ")
SSD_VARIANTS = {
    "base": [],
    "no_head_copies": [("  const auto stage_head = [&](int h, int set) {\n",
                        "  const auto stage_head = [&](int h, int set) {\n"
                        "    return;\n")],
    "no_scalar_steps": [
        ("  const auto cum_step = [&](int h, float* vec, float d0, float d1) "
         "{\n", "  const auto cum_step = [&](int h, float* vec, float d0, "
         "float d1) {\n    return;\n"),
        ("  const auto tail_step = [&](int h, const float* pt, "
         "const float* vec) {\n",
         "  const auto tail_step = [&](int h, const float* pt, "
         "const float* vec) {\n    return;\n")],
    "no_q_z": [(_SSD_SCAN_LOOP + "ld2(dys",
                _SSD_SCAN_LOOP.replace("k0 < pp", "k0 < 0") + "ld2(dys")],
    "no_xds": [("for (int k0 = 0; k0 < pp; k0 += 8) {\n        const float2 "
                "v0 = ld2(xs",
                "for (int k0 = 0; k0 < 0; k0 += 8) {\n        const float2 "
                "v0 = ld2(xs")],
    "no_dsb": [("for (int k0 = 0; k0 < np; k0 += 8) {\n      const float2 "
                "v0 = ld2(bs",
                "for (int k0 = 0; k0 < 0; k0 += 8) {\n      const float2 "
                "v0 = ld2(bs")],
    "no_wt_dy": [("for (int k0 = r0; k0 < lt; k0 += 8) {\n      const int ta",
                  "for (int k0 = r0; k0 < r0; k0 += 8) {\n      const int ta")],
    "no_decays": [("for (int tt = warp; tt < lt; tt += kMmaWarps) {",
                   "for (int tt = warp; tt < 0; tt += kMmaWarps) {")],
    "no_dot": [("for (int p = warp; p < pp; p += kMmaWarps) {",
                "for (int p = warp; p < 0; p += kMmaWarps) {")],
    "sync_head_copies": [
        ("    if (sets == 2 && h + 1 < h_hi) stage_head(h + 1, nxt);\n",
         "    if (sets == 2 && h + 1 < h_hi) stage_head(h + 1, nxt);\n"
         "    cp_async_wait<0>();\n")],
    "no_state_mma": [("mma_tiles<false, kBf16, 8>(carry, ah, al, b0, b1, "
                      "valid);", "")],
    "no_state_copies": [("  const auto stage_chunk = [&](int c, int buf) {\n",
                         "  const auto stage_chunk = [&](int c, int buf) {\n"
                         "    return;\n")],
    "no_state_ds_stores": [("        if (p < P && n < N) out[p * N + n] = "
                            "carry[i][e];", "")],
}

# The other route for the state work: each chunk's pull G_c on the state
# before it by its own CTA (a (batch, chunk, head)) into the dS slots, then
# a reverse pass that carries 4 elements a thread and loads 8 chunks' pulls
# ahead of its chain (ssd_scan.cu's pass_kernel<4> pattern) and writes dS
# over G.  <dS, before> stays in the chunk-scan kernel.  Timed beside the
# fused ssd_bwd_state_kernel; it computes the same function, so its outputs
# are held to the plain backward too.
_SSD_PASS_KERNELS = r"""
template <typename T>
__global__ void __launch_bounds__(kStateMaxThreads)
    variant_pull_kernel(SsdBwdArgs a, int NC, int flags) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int L = a.L, P = a.P, N = a.N, H = a.H;
  const int lt = pad16(L), pp = pad16(P), np = pad16(N);
  const int sdy = pp + 4, sc = np + static_cast<int>(16 / sizeof(T));
  float* dyt = sm;
  T* ct = reinterpret_cast<T*>(sm + lt * sdy);
  float* dts = sm + lt * (pp + 4 + np + 4);
  float* ec = dts + lt;
  const int bch = blockIdx.x, h = bch % H, c = (bch / H) % NC;
  const int b = bch / (H * NC);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mts = pp / 16, p0 = 16 * (warp % mts), n0 = 8 * (warp / mts);
  const int rows = min(L, a.S - c * L);
  const long long tok0 = static_cast<long long>(b) * a.S + c * L;
  stage_tile<float>(dyt, sdy, a.dy + (tok0 * H + h) * P,
                    static_cast<long long>(H) * P, rows, lt, P, pp,
                    flags & kVecDy);
  stage_tile<T>(ct, sc, static_cast<const T*>(a.c) + tok0 * N, N, rows, lt,
                N, np, flags & kVecBC);
  cp_async_commit();
  const T* dt = static_cast<const T*>(a.dt);
  for (int u = threadIdx.x; u < lt; u += blockDim.x) {
    dts[u] = u < rows ? to_f32(dt[(tok0 + u) * H + h]) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x == 0) chunk_cumsum(dts, ec, lt, -a.a[h]);
  __syncthreads();
  for (int u = threadIdx.x; u < lt; u += blockDim.x) ec[u] = expf(ec[u]);
  __syncthreads();
  const unsigned valid = (1u << min(8, max(0, np / 8 - n0))) - 1;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < lt; k0 += 8) {
    const int ta = k0 + 2 * t, tb = ta + 1;
    const float ea = ec[ta], eb = ec[tb];
    const float* ya = dyt + ta * sdy + p0 + g;
    const float* yb = dyt + tb * sdy + p0 + g;
    uint32_t ah[4], al[4];
    split_frag<false>(ea * ya[0], ea * ya[8], eb * yb[0], eb * yb[8], ah,
                      al);
    float b0[8], b1[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = min((n0 + i) * 8, np - 8) + g;
      b0[i] = to_f32(ct[ta * sc + col]);
      b1[i] = to_f32(ct[tb * sc + col]);
    }
    mma_tiles<false, kBf16, 8>(acc, ah, al, b0, b1, valid);
  }
  float* out = scratch_of(a, NC).ds + static_cast<long long>(bch) * P * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + (e >> 1) * 8;
      const int n = (n0 + i) * 8 + 2 * t + (e & 1);
      if (p < P && n < N) out[p * N + n] = acc[i][e];
    }
  }
}

__global__ void __launch_bounds__(256) variant_pass_kernel(SsdBwdArgs a,
                                                           int NC, int X) {
  const int PN = a.P * a.N;
  const int e = (blockIdx.x % X * 256 + threadIdx.x) * 4;
  const long long hb = blockIdx.x / X;
  const int b = static_cast<int>(hb / a.H), h = static_cast<int>(hb % a.H);
  if (e >= PN) return;
  float4 carry = a.dstate
      ? *reinterpret_cast<const float4*>(a.dstate + hb * PN + e)
      : make_float4(0.f, 0.f, 0.f, 0.f);
  float* ds = scratch_of(a, NC).ds;
  const float* cum_last =
      a.states + static_cast<long long>(a.B) * NC * a.H * PN;
  for (int c0 = NC - 1; c0 >= 0; c0 -= 8) {
    float4 gv[8];
    float d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long bc = (static_cast<long long>(b) * NC + c0 - j) * a.H + h;
      if (c0 - j >= 0) {
        gv[j] = *reinterpret_cast<const float4*>(ds + bc * PN + e);
        d[j] = expf(cum_last[bc]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long bc = (static_cast<long long>(b) * NC + c0 - j) * a.H + h;
      if (c0 - j >= 0) {
        *reinterpret_cast<float4*>(ds + bc * PN + e) = carry;
        carry.x = carry.x * d[j] + gv[j].x;
        carry.y = carry.y * d[j] + gv[j].y;
        carry.z = carry.z * d[j] + gv[j].z;
        carry.w = carry.w * d[j] + gv[j].w;
      }
    }
  }
  if (a.dinit) *reinterpret_cast<float4*>(a.dinit + hb * PN + e) = carry;
}

"""
_SSD_STATE_LAUNCH = """  size_t smem = state_smem_bytes(a.L, a.P, a.N);
  cudaError_t err =
      allow_smem<ssd_bwd_state_kernel<T, kLT, kPP, kNP>>(smem);
  if (err != cudaSuccess) return err;
  err = launch(ssd_bwd_state_kernel<T, kLT, kPP, kNP>,
               static_cast<long long>(a.B) * a.H, state_threads(a.P, a.N),
               smem, stream, a, NC, flags);
  if (err != cudaSuccess) return err;
"""
_SSD_PASS_LAUNCH = """  const int lt_ = pad16(a.L);
  size_t smem = sizeof(float) *
                (lt_ * (pad16(a.P) + 4 + pad16(a.N) + 4) + 2 * lt_);
  cudaError_t err = allow_smem<variant_pull_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  err = launch(variant_pull_kernel<T>, static_cast<long long>(a.B) * NC * a.H,
               state_threads(a.P, a.N), smem, stream, a, NC, flags);
  if (err != cudaSuccess) return err;
  const int X = (a.P * a.N / 4 + 255) / 256;
  err = launch(variant_pass_kernel, static_cast<long long>(a.B) * a.H * X,
               256, 0, stream, a, NC, X);
  if (err != cudaSuccess) return err;
"""
SSD_VARIANTS["load_ahead_pass"] = [
    ("// --------------------------------------------------------------- "
     "launch\n", _SSD_PASS_KERNELS + "// ------------------------------------"
     "--------------------------- launch\n"),
    (_SSD_STATE_LAUNCH, _SSD_PASS_LAUNCH)]
# the variants that compute the backward: their outputs are checked
SSD_VARIANTS_CORRECT = ("base", "load_ahead_pass")

_SSD_VARIANT_SHIM = r"""
#include "kernels.h"
extern "C" int variant_ssd_scan_bwd(
    const void* x, const void* dt, const void* a_rate, const void* b,
    const void* c, const void* dy, const void* dstate, const void* states,
    void* dx, void* ddt, void* db, void* dc, void* da, void* dinit,
    void* scratch, int B, int S, int H, int P, int N, int L, int groups,
    int dtype, void* stream) {
  repro::SsdBwdArgs a;
  a.x = x; a.dt = dt; a.a = static_cast<const float*>(a_rate); a.b = b;
  a.c = c; a.dy = static_cast<const float*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.states = static_cast<const float*>(states); a.dx = dx; a.ddt = ddt;
  a.db = db; a.dc = dc; a.da = static_cast<float*>(da);
  a.dinit = static_cast<float*>(dinit);
  a.scratch = static_cast<float*>(scratch);
  a.B = B; a.S = S; a.H = H; a.P = P; a.N = N; a.L = L; a.groups = groups;
  return static_cast<int>(repro::launch_ssd_scan_bwd(
      a, dtype, static_cast<cudaStream_t>(stream)));
}
"""


def ssd_variant_libs(names, out: pathlib.Path) -> dict:
    """{name: ctypes library} for each variant of ``SSD_VARIANTS``, built
    in parallel (its ``ssd_scan_bwd.cu`` and a C entry point of its own,
    one nvcc each)."""
    import ctypes
    import shutil
    from repro_torch.kernels import build
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    nvcc = build._nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        text = src
        for old, new in SSD_VARIANTS[name]:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} matches "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
        (d / "ssd_scan_bwd.cu").write_text(text)
        (d / "shim.cu").write_text(_SSD_VARIANT_SHIM)
        flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
        cmd = (f"{nvcc} {' '.join(flags)} -I {d} -c {d / 'ssd_scan_bwd.cu'} "
               f"-o {d / 'k.o'} && {nvcc} {' '.join(flags)} -I {d} -c "
               f"{d / 'shim.cu'} -o {d / 's.o'} && {nvcc} -shared "
               f"-gencode=arch=compute_90a,code=sm_90a {d / 'k.o'} "
               f"{d / 's.o'} -o {d / 'lib.so'}")
        procs[name] = subprocess.Popen(cmd, shell=True, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{text}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.variant_ssd_scan_bwd.argtypes = (
            build._SIGNATURES["repro_ssd_scan_bwd"])
        lib.variant_ssd_scan_bwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def ssd_variant_call(lib, args, kw):
    """One backward call through a variant, as ``ssd_scan_bwd`` makes it
    (no initial state)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import bwd_plan
    x, dt, a, b, c, dy, dstate, states = args
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pl = bwd_plan(bsz, s, h, p, n)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b, c))
    da = torch.empty((h,), **f32)
    scratch = torch.empty(pl.scratch_floats, **f32)
    err = lib.variant_ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(), dstate.data_ptr(), states.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da.data_ptr(), None, scratch.data_ptr(), bsz, s, h, p, n, pl.chunk,
        pl.groups, build.dtype_code(x.dtype),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: {err}")
    return dx, ddt, da, db, dc


def phase_ssd_variants(report):
    """Opt-in (``--phases env,ssd-variants``): where the SSD backward's time
    goes, at zamba2-2.7b's training call (``SSD_BWD_SHAPES``' first row),
    f32 and bf16.  Each variant of ``SSD_VARIANTS`` is the kernel's source
    with textual edits, one phase cut out (what it computes is wrong by
    design, only its device time is read) or, for ``load_ahead_pass``, the
    chunks' pulls and the state pass as two kernels (held to the plain
    backward, as ``base`` is).  Device time: a CUDA graph of 20 calls, the
    variants in turns, then again in reverse; by kernel: torch.profiler
    over 10 eager calls.  Each variant builds alone into
    ``build/ssd_variants``."""
    import torch
    from repro_torch.kernels.ref import ssd_bwd_ref
    names = list(SSD_VARIANTS)
    t0 = time.monotonic()
    libs = ssd_variant_libs(names, ROOT / "build" / "ssd_variants")
    log(f"[ssd-variants] built {len(names)} variants in "
        f"{time.monotonic() - t0:.1f}s")
    label, shape = SSD_BWD_SHAPES[0]
    gen = torch.Generator().manual_seed(28)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        args, kw = bwd_case(gen, "ssd_scan_bwd", shape, dtype)
        want = ssd_bwd_ref(*args[:7], chunk=64)
        for name in SSD_VARIANTS_CORRECT:
            got = ssd_variant_call(libs[name], args, kw)
            rel = max(max_rel_err(g, r, BWD_TOL[dname], f"{name} {o}")[1]
                      for o, g, r in zip(BWD_OUTPUTS["ssd_scan_bwd"], got,
                                         want))
            log(f"[ssd-variants] {label} {dname} {name}: outputs within "
                f"{rel:.3g} of max |ref| (tol {BWD_TOL[dname]})")
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(graph_ms(
                    lambda lib=libs[name]: ssd_variant_call(lib, args, kw)))
        for name in names:
            split = by_kernel_ms(
                lambda lib=libs[name]: ssd_variant_call(lib, args, kw))
            rows.append({"variant": name, "dtype": dname,
                         "device_ms": times[name], "by_kernel_ms": split})
            log(f"[ssd-variants] {label} {dname} {name}: device ms "
                f"{times[name][0]:.4f} / {times[name][1]:.4f}; by kernel "
                + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                + f"; {report['gpu']}")
        del args, want
        torch.cuda.empty_cache()
    report["ssd_variants"] = rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="env,parity,main,serve,moe,encdec,train,"
                            "registry,experiment,whatif,dense,scale",
                    help="comma-separated subset of env,parity,main,serve,"
                         "moe,encdec,train,registry,experiment,whatif,dense,"
                         "scale (the default) "
                         "and the opt-in waterfill, waterfill-plans, "
                         "rmsnorm-plans, profile, paper-scale, bwd-ab and "
                         "ssd-variants")
    ap.add_argument("--ab-csrc", default=str(
        ROOT / "build" / "parent" / "src" / "repro_torch" / "kernels" /
        "csrc"), metavar="DIR",
                    help="bwd-ab: the other tree's kernel sources")
    ap.add_argument("--ab-kernels", default="rmsnorm_bwd,flash_attention_bwd,"
                    "ssd_scan_bwd", metavar="NAMES",
                    help="bwd-ab: the backward kernels to compare")
    ap.add_argument("--paper-scale-budget", type=float,
                    default=PAPER_SCALE_BUDGET_S, metavar="SECONDS",
                    help="the paper-scale phase cuts its strategies so "
                         "that the whole run is predicted to end inside "
                         "this many seconds")
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
            phase_main(report, time.monotonic() - t_start)
            phase_kernels_at_main_shape(report)
        if "serve" in phases:
            phase_serve(report)
            phase_llm_kernels_at_serve_shape(report)
        if "moe" in phases:
            phase_moe(report)
        if "encdec" in phases:
            phase_encdec(report)
        if "train" in phases:
            phase_train(report, time.monotonic() - t_start)
        if "registry" in phases:
            phase_registry(report, time.monotonic() - t_start)
        if "experiment" in phases:
            phase_experiment(report)
        if "whatif" in phases:
            phase_whatif(report, time.monotonic() - t_start)
        if "dense" in phases:
            phase_dense(report)
        if "scale" in phases:
            phase_scale(report, time.monotonic() - t_start)
        if "waterfill" in phases:
            time_waterfill_shapes(report)
        if "waterfill-plans" in phases:
            time_waterfill_plans(report)
        if "rmsnorm-plans" in phases:
            time_rmsnorm_bwd_plans(report)
        if "profile" in phases:
            phase_profile(report)
        if "bwd-ab" in phases:
            phase_bwd_ab(report, args.ab_csrc,
                         tuple(args.ab_kernels.split(",")))
        if "ssd-variants" in phases:
            phase_ssd_variants(report)
        if "paper-scale" in phases:
            phase_paper_scale(report, time.monotonic() - t_start,
                              args.paper_scale_budget)
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
