"""InternVL2-2B [arXiv:2404.16821; hf]: InternLM2-backbone 24L d=2048 16H
GQA kv=8 ff=8192 vocab=92553.  The InternViT frontend is a STUB per the
assignment: input_specs() provides precomputed patch embeddings (256
patches) prepended to the token stream."""
from .base import ModelConfig, register


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92553,
        frontend="vision", n_frontend_tokens=256,
        rope_theta=1_000_000.0,
    )
