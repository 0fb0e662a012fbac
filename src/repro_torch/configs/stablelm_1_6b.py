"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]: 24L d=2048 32H
(kv=32) ff=5632 vocab=100352; LayerNorm, partial-rotary ignored (full RoPE),
qkv bias."""
from .base import ModelConfig, register


@register("stablelm-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab=100352,
        norm="layernorm", qkv_bias=True,
        rope_theta=10_000.0,
    )
