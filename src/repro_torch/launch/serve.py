"""Batched LLM serving from the command line: prefill + continuous batching.

Serves the published config on the card; ``--reduced`` serves the family-
preserving smoke config (what the JAX command always serves), which is what
runs on the CPU.  Weights are random, drawn from ``--seed``.  Requests are
tokens only: a vision config is served text-only, and an encoder-decoder
(whisper) exits non-zero (ROADMAP §C9).

Example::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --requests 8 --slots 4 [--reduced --device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.models.transformer import init_params, param_count
from repro_torch.serve.engine import Request, ServeEngine, check_servable


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=list(list_archs()))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample", action="store_true",
                    help="seeded categorical sampling instead of greedy "
                         "argmax decoding")
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's reduced smoke config")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encdec or cfg.frontend != "none":
        print(f"[serve] note: {args.arch} frontend is stubbed; serving the "
              "text decoder only")
    try:
        check_servable(cfg)
    except ValueError as err:
        print(f"[serve] {err}", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = init_params(cfg, gen, dev)
    print(f"[serve] {cfg.name} on {dev}: {param_count(model):,} params, "
          f"{args.slots} slots, max_len {args.max_len}")

    engine = ServeEngine(model, cfg, n_slots=args.slots,
                         max_len=args.max_len, greedy=not args.sample,
                         sample_seed=args.sample_seed, device=dev)
    reqs = []
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        prompt = rng.integers(2, cfg.vocab, size=plen).astype(np.int32)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new)
        engine.submit(req)
        reqs.append(req)

    t0 = time.monotonic()
    engine.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out_tokens) for r in reqs)
    print(f"[serve] {done}/{len(reqs)} requests done, {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s, {engine.steps} engine steps)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> "
              f"{r.out_tokens[:8]}...")
    return 0 if done == len(reqs) else 1


if __name__ == "__main__":
    sys.exit(main())
