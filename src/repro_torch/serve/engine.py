"""Batched serving engine: prefill + continuous-batching decode.

Counterpart of the JAX package's ``serve/engine.py``: fixed slots,
requests admitted in submission order whenever a slot is free (one
single-row prefill each), every active slot decoded together, a request
retired after ``max_new_tokens`` or when its slot nears ``max_len``.

Kept as the reference does it, for parity: each step decodes every slot at
one shared ``cache_len``, the longest active slot's length, so a shorter
request batched beside a longer one writes its KV row and takes its RoPE
position at the longer one's length and attends over zero rows (ROADMAP
§C4).

Requests carry tokens only, as the reference's do: a vision config is
served text-only, and an encoder-decoder is refused at construction
(:func:`check_servable`), where the reference's engine fails at its first
prefill, which reads ``batch["frames"]`` (ROADMAP §C9).  Whisper runs
through :func:`repro_torch.models.decode.prefill` / ``decode_step``.

Prefill caches are written into their slot by the cache's known layout
(layers on the leading axis of ``mamba``, ``attn`` and ``moe`` segments,
the batch first in ``shared`` markers).  Greedy decoding takes the first
maximal logit, as ``jnp.argmax``.  Sampling (``greedy=False``) draws from the
softmax with a ``torch.Generator`` seeded by ``sample_seed``: deterministic
per seed and submission order, but not JAX's random stream.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as D
from repro_torch.models.transformer import LM


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a config the engine cannot serve: an
    encoder-decoder, whose requests would need audio frames."""
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name}: the serving engine cannot serve an encoder-decoder "
            "(requests carry no frames; the reference's engine fails the "
            "same way, ROADMAP §C9); use repro_torch.models.decode.prefill "
            "/ decode_step")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Single-sequence-slot continuous batching (batch = n_slots)."""

    def __init__(self, model: LM, cfg: ModelConfig, *, n_slots: int,
                 max_len: int, dtype=torch.float32, greedy: bool = True,
                 sample_seed: int = 0, device=None):
        check_servable(cfg)
        self.device = resolve_device(device)
        on = {p.device.type for p in model.parameters()}
        if on != {self.device.type}:
            raise ValueError(f"the model lives on {sorted(on)}, the engine "
                             f"runs on {self.device}")
        self.model = model
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.dtype = dtype
        self.greedy = greedy
        self._gen = torch.Generator().manual_seed(sample_seed)
        self.cache = D.init_decode_cache(cfg, n_slots, max_len, dtype,
                                         self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_len = np.zeros(n_slots, dtype=np.int32)
        self.queue: List[Request] = []
        self.steps = 0

    # ------------------------------------------------------------ admit
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _sample(self, logits: torch.Tensor) -> List[int]:
        """Next token of each row of ``logits`` (greedy or seeded)."""
        if self.greedy:
            return logits.argmax(dim=-1).tolist()
        probs = torch.softmax(logits.float(), dim=-1).cpu()
        return [int(torch.multinomial(row, 1, generator=self._gen))
                for row in probs]

    def _write_slot(self, cache1, slot: int) -> None:
        for seg, big, small in zip(self.model.plan, self.cache["segments"],
                                   cache1["segments"]):
            if seg.kind == "shared":
                for name in ("k", "v"):
                    big[name][slot] = small[name][0]
            else:
                pairs = (zip(big, small) if seg.kind == "mamba" else
                         ((big[n], small[n]) for n in big))
                for dst, src in pairs:
                    dst[:, slot] = src[:, 0]

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            tokens = torch.as_tensor(req.prompt, dtype=torch.long,
                                     device=self.device)[None]
            logits, cache1 = D.prefill(self.model, self.cfg,
                                       {"tokens": tokens},
                                       cache_size=self.max_len,
                                       dtype=self.dtype)
            self._write_slot(cache1, slot)
            req.out_tokens.append(self._sample(logits)[0])
            self.slot_req[slot] = req
            self.slot_len[slot] = len(req.prompt)

    # ------------------------------------------------------------ decode
    def step(self) -> None:
        """One engine tick: admit, decode all active slots, retire."""
        self._admit()
        active = [s for s in range(self.n_slots)
                  if self.slot_req[s] is not None]
        if not active:
            return
        last = np.zeros((self.n_slots, 1), dtype=np.int64)
        for s in active:
            last[s, 0] = self.slot_req[s].out_tokens[-1]
        # one shared cache_len for every slot, as the reference (C4)
        cache_len = int(self.slot_len[active].max())
        logits, self.cache = D.decode_step(
            self.model, self.cfg, torch.from_numpy(last).to(self.device),
            self.cache, cache_len, dtype=self.dtype)
        self.steps += 1
        toks = self._sample(logits[active])
        for s, tok in zip(active, toks):
            req = self.slot_req[s]
            req.out_tokens.append(tok)
            self.slot_len[s] += 1
            if (len(req.out_tokens) >= req.max_new_tokens
                    or self.slot_len[s] >= self.max_len - 1):
                req.done = True
                self.slot_req[s] = None
                self.slot_len[s] = 0

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
            if self.steps > max_steps:
                raise RuntimeError("serve engine did not drain")
