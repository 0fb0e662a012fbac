"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d=2048 16H (kv=16) ff=1024
vocab=50304, MoE 64 experts top-8 (every layer MoE, no shared experts)."""
from .base import ModelConfig, register


@register("olmoe-1b-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304,
        n_experts=64, top_k=8, moe_d_ff=1024, n_shared_experts=0,
        rope_theta=10_000.0,
    )
