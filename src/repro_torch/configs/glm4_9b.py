"""GLM4-9B [hf:THUDM/glm-4-9b]: 40L d=4096 32H GQA kv=2 ff=13696
vocab=151552, RoPE."""
from .base import ModelConfig, register


@register("glm4-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552,
        rope_theta=10_000.0, qkv_bias=True,
    )
