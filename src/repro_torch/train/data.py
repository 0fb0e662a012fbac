"""Synthetic token pipeline with per-host sharding.

Training data is a deterministic synthetic stream (seeded zipf-ish token
draws with document structure), so runs are reproducible offline and each
data-parallel host can generate exactly its shard without any exchange —
the same contract a production loader (per-host file shards) satisfies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticTokens:
    """Deterministic, shardable synthetic LM batches.

    ``host_index / host_count`` select this host's rows of the global batch
    (contiguous block layout, matching the dp-axis device order)."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        if cfg.global_batch % host_count:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_index))
        # zipf-distributed tokens clipped to vocab, plus BOS resets
        toks = rng.zipf(cfg.zipf_a,
                        size=(self.local_batch, cfg.seq_len + 1))
        toks = np.minimum(toks, cfg.vocab - 1).astype(np.int32)
        doc_starts = rng.uniform(size=toks.shape) < (1.0 / 512)
        toks = np.where(doc_starts, 1, toks)  # token 1 = BOS
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batch_for(cfg: ModelConfig, seq_len: int, global_batch: int,
              step: int = 0, seed: int = 0,
              host_index: int = 0, host_count: int = 1,
              frontend_dtype=np.float32) -> Dict[str, np.ndarray]:
    """One batch including frontend stubs where the family needs them."""
    text_len = seq_len
    if cfg.frontend == "vision":
        text_len = max(seq_len - cfg.n_frontend_tokens, 8)
    data = SyntheticTokens(
        DataConfig(cfg.vocab, text_len, global_batch, seed),
        host_index, host_count).batch(step)
    lb = data["tokens"].shape[0]
    rng = np.random.default_rng((seed, step, 7))
    if cfg.frontend == "vision":
        data["patches"] = rng.standard_normal(
            (lb, cfg.n_frontend_tokens, cfg.d_model)).astype(frontend_dtype)
    if cfg.is_encdec:
        data["frames"] = rng.standard_normal(
            (lb, cfg.n_frontend_tokens, cfg.d_model)).astype(frontend_dtype)
    return data
