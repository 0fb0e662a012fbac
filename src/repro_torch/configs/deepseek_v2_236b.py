"""DeepSeek-V2-236B [arXiv:2405.04434; hf]: 60L d=5120 128H MLA
(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64, v_head=128),
2 shared + 160 routed experts top-6, expert ff=1536, first layer dense
(dense ffn = 8 * 1536 = 12288, per the released model)."""
from .base import ModelConfig, register


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288,  # dense first-layer FFN (8x expert width)
        vocab=102400,
        attn="mla", q_lora=1536, kv_lora=512,
        qk_nope=128, qk_rope=64, v_head=128, head_dim=192,
        n_experts=160, top_k=6, moe_d_ff=1536, n_shared_experts=2,
        first_dense_layers=1,
        rope_theta=10_000.0,
    )
