"""End-to-end training driver of the port: ``python -m
repro_torch.launch.train``.

Trains any registered architecture (full or ``--reduced``) with the train
step (AdamW, remat, gradient accumulation, int8 gradient compression) on
the synthetic data pipeline, on the card unless ``--device cpu`` is given.
Prints the reference's ``[train] step i: loss=... lr=...`` lines and its
``done: loss a -> b`` line.  Every block kind trains on the card through
the backward kernels, Mamba-2's (mamba2-1.3b, zamba2-2.7b) included.

``--malleable`` runs the job under the elastic manager
(:class:`repro_torch.elastic.manager.ElasticTrainer`), which lets a
scheduler resize its data-parallel width at run time: ``--resize-every N``
resizes it every N steps through the widths (1, 2, 4) up to the world's
size, ``--fail-at N`` injects one node failure at step N (a restart from
the last checkpoint), ``--ckpt-dir`` / ``--ckpt-every`` checkpoint and
``--resume`` restarts from the directory's latest checkpoint; the lines
are the reference's.  With no process group open the job runs in a world
of one rank (widths 1); every rank of a wider world (opened before
``main`` is called) runs ``main`` with the same arguments, and rank 0
prints.  Without ``--malleable`` the elastic flags are ignored, as in the
reference (a note on stderr says so).

Examples:
  python -m repro_torch.launch.train --arch stablelm-1.6b --reduced \\
      --steps 50 --device cpu
  python -m repro_torch.launch.train --arch internvl2-2b --steps 8 \\
      --batch 4 --seq 512 --remat dots
  python -m repro_torch.launch.train --arch zamba2-2.7b --steps 4 \\
      --batch 4 --seq 512
  python -m repro_torch.launch.train --arch stablelm-1.6b --reduced \\
      --device cpu --steps 6 --malleable --resize-every 2 --fail-at 4 \\
      --ckpt-dir /tmp/ck --ckpt-every 2
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import to_tensors
from repro_torch.train.data import batch_for
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

ELASTIC_FLAGS = ("resize_every", "fail_at", "ckpt_dir", "resume")


def train(cfg, tc: TrainConfig, *, steps: int, batch: int, seq: int,
          seed: int = 0, device=None, log_every: int = 10, on_step=None):
    """``steps`` train steps of ``cfg`` on ``batch_for`` batches of
    ``batch`` x ``seq`` (step i's batch from step i and ``seed``), weights
    from ``seed``.  Prints the log lines; ``on_step(i, state, stats)`` runs
    after each step.  Returns the per-step losses."""
    dev = resolve_device(device)
    state = init_train_state(cfg, tc, torch.Generator(dev).manual_seed(seed),
                             dev)
    step_fn = make_train_step(cfg, tc)
    losses = []
    t0 = time.monotonic()
    for i in range(1, steps + 1):
        data = to_tensors(batch_for(cfg, seq, batch, step=i, seed=seed), dev)
        state, stats = step_fn(state, data)
        losses.append(float(stats["loss"]))
        if on_step is not None:
            on_step(i, state, stats)
        if i % log_every == 0 or i == steps:
            print(f"[train] step {i}: loss={losses[-1]:.4f} "
                  f"lr={float(stats['lr']):.2e} "
                  f"({(time.monotonic() - t0) / i:.3f}s/step)", flush=True)
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})",
              flush=True)
    return losses


def malleable(cfg, tc: TrainConfig, args) -> int:
    """The elastic run of :func:`main` (the reference's ``--malleable``
    branch).  The failure is injected once; with nothing left to run after
    ``--resume`` the done line says so (the reference's reads a loss no
    step gave)."""
    from repro_torch.elastic.manager import ElasticTrainer, close_world
    from repro_torch.launch.mesh import world_size
    trainer = ElasticTrainer(
        cfg, tc, global_batch=args.batch, seq_len=args.seq, width=1,
        ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
        seed=args.seed, device=args.device)
    import torch.distributed as dist
    lead = dist.get_rank() == 0

    def say(msg):
        if lead:
            print(f"[train] {msg}", flush=True)

    try:
        if args.resume and args.ckpt_dir:
            restored = trainer.try_resume()
            say(f"resume: restored step {restored}")
        widths = [w for w in (1, 2, 4) if w <= world_size()]
        t0 = time.monotonic()
        stats, failed = None, False
        while trainer.step_num < args.steps:
            stats = trainer.step()
            i = trainer.step_num
            if args.resize_every and i % args.resize_every == 0:
                new_w = widths[(i // args.resize_every) % len(widths)]
                plan = trainer.resize(new_w)
                say(f"step {i}: scheduler resized DP width -> {new_w} "
                    f"({plan.bytes_moved:.2e} bytes moved, est "
                    f"{plan.est_seconds:.3f}s on NVLink)")
            if args.fail_at and i == args.fail_at and not failed:
                failed = True
                lost = trainer.fail_and_restore(surviving_width=1)
                say(f"step {i}: node failure injected; lost {lost} steps, "
                    f"restarted at {trainer.step_num}")
            if lead and i % args.log_every == 0:
                say(f"step {i}: loss={stats['loss']:.4f} "
                    f"({(time.monotonic() - t0) / max(i, 1):.3f}s/step)")
        if lead:
            final = ("no step run (nothing left to run)" if stats is None
                     else f"final loss {stats['loss']:.4f}")
            say(f"done: {trainer.step_num} steps, {final}, resizes="
                f"{trainer.stats.resizes} restores={trainer.stats.restores}")
    finally:
        close_world()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(list_archs()))
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    # elasticity / fault tolerance
    ap.add_argument("--malleable", action="store_true",
                    help="run under the elastic manager (resizable DP)")
    ap.add_argument("--resize-every", type=int, default=0,
                    help="demo: scheduler resizes DP width every N steps")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="demo: inject a node failure at step N")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(remat=args.remat, accum_steps=args.accum,
                     compress_grads=args.compress_grads)
    if args.malleable:
        return malleable(cfg, tc, args)
    ignored = [f"--{f.replace('_', '-')}" for f in ELASTIC_FLAGS
               if getattr(args, f)]
    if ignored:
        print(f"[train] {' '.join(ignored)} apply only with --malleable; "
              "training without the elastic manager", file=sys.stderr)
    train(cfg, tc, steps=args.steps, batch=args.batch, seq=args.seq,
          seed=args.seed, device=args.device, log_every=args.log_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
