"""Zamba2-2.7B [arXiv:2411.15242; hf]: 54 Mamba2 layers (d=2560,
ssm_state=64) with a *shared* attention(32H, kv=32)+MLP(ff=10240) block
applied every 6 layers (hybrid)."""
from .base import ModelConfig, register


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000,
        attn="gqa", ssm_state=64, ssm_expand=2, ssm_headdim=64,
        shared_attn_every=6,
        rope_theta=10_000.0,
    )
