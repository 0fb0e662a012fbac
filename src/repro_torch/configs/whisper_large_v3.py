"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder, 32+32L d=1280
20H ff=5120 vocab=51866.  The conv audio frontend is a STUB per the
assignment: input_specs() provides precomputed frame embeddings (1500
frames) for the encoder; sinusoidal positions, LayerNorm, GELU MLPs."""
from .base import ModelConfig, register


@register("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866,
        enc_layers=32, norm="layernorm", act="gelu",
        rope_theta=0.0,  # sinusoidal absolute positions
        frontend="audio", n_frontend_tokens=1500,
    )
