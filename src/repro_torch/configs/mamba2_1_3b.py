"""Mamba2-1.3B [arXiv:2405.21060]: 48L d=2048 attention-free SSD,
ssm_state=128, vocab=50280 (expand=2, headdim=64 per the reference)."""
from .base import ModelConfig, register


@register("mamba2-1.3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280,
        attn="none", ssm_state=128, ssm_expand=2, ssm_headdim=64,
        tie_embeddings=True,
    )
