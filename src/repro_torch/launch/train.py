"""End-to-end training driver of the port: ``python -m
repro_torch.launch.train``.

Trains any registered architecture (full or ``--reduced``) with the train
step (AdamW, remat, gradient accumulation, int8 gradient compression) on
the synthetic data pipeline, on the card unless ``--device cpu`` is given.
Prints the reference's ``[train] step i: loss=... lr=...`` lines and its
``done: loss a -> b`` line.  Every block kind trains on the card through
the backward kernels, Mamba-2's (mamba2-1.3b, zamba2-2.7b) included.  The
elastic flags (``--malleable``, ``--resize-every``, ``--fail-at``,
``--ckpt-dir``, ``--resume``) need the elastic manager, which is ROADMAP
§A10g: they exit 1.

Examples:
  python -m repro_torch.launch.train --arch stablelm-1.6b --reduced \\
      --steps 50 --device cpu
  python -m repro_torch.launch.train --arch internvl2-2b --steps 8 \\
      --batch 4 --seq 512 --remat dots
  python -m repro_torch.launch.train --arch zamba2-2.7b --steps 4 \\
      --batch 4 --seq 512
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

ELASTIC_FLAGS = ("malleable", "resize_every", "fail_at", "ckpt_dir",
                 "resume")


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
    # elasticity / fault tolerance: the elastic manager (ROADMAP §A10g)
    ap.add_argument("--malleable", action="store_true")
    ap.add_argument("--resize-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    elastic = [f"--{f.replace('_', '-')}" for f in ELASTIC_FLAGS
               if getattr(args, f)]
    if elastic:
        print(f"[train] {' '.join(elastic)} need the elastic manager "
              "(ElasticTrainer), which is not ported yet: ROADMAP §A10g",
              file=sys.stderr)
        return 1
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(remat=args.remat, accum_steps=args.accum,
                     compress_grads=args.compress_grads)
    train(cfg, tc, steps=args.steps, batch=args.batch, seq=args.seq,
          seed=args.seed, device=args.device, log_every=args.log_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
