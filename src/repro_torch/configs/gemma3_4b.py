"""Gemma3-4B [hf:google/gemma-3-*-pt]: 34L d=2560 8H GQA kv=4 ff=10240
vocab=262144; 5:1 local:global attention (window 1024, global theta 1M),
128k context."""
from .base import ModelConfig, register


@register("gemma3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
        d_ff=10240, vocab=262144, head_dim=256,
        sliding_window=1024, global_every=6,          # LLLLLG pattern
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        act="geglu", tie_embeddings=True,
    )
