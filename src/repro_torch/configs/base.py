"""Model/shape configuration dataclasses and the architecture registry.

Every assigned architecture registers a :class:`ModelConfig` built from the
exact published numbers.  ``reduced()`` derives the family-preserving smoke
configuration (small widths/depths, tiny vocab) used by CPU tests; the full
config is exercised only through the dry-run (abstract shapes, no
allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    act: str = "swiglu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0

    # attention structure
    attn: str = "gqa"             # gqa|mla|none
    sliding_window: int = 0       # >0: local window size for "local" layers
    global_every: int = 0         # gemma3: every Nth layer is global
    rope_theta_global: float = 0.0  # theta override for global layers

    # MLA (DeepSeek-V2)
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    moe_capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    shared_attn_every: int = 0    # zamba2: shared attn+mlp block cadence

    # encoder-decoder (whisper)
    enc_layers: int = 0

    # modality frontend stubs
    frontend: str = "none"        # none|vision|audio
    n_frontend_tokens: int = 0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    # ------------------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (see DESIGN.md §5)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # dominated by sliding-window layers (gemma3's 5:1 local:global)
        return self.sliding_window > 0 and self.global_every > 1

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    def reduced(self) -> "ModelConfig":
        """Family-preserving smoke config (runs a step on 1 CPU core)."""
        def shrink_layers(n):
            if self.shared_attn_every:
                return 2 * self.shared_attn_every  # keep hybrid cadence
            if self.global_every:
                return 2 * self.global_every       # keep local:global ratio
            return max(2, min(self.first_dense_layers + 1, 4))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=shrink_layers(self.n_layers),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            q_lora=64 if self.q_lora else 0,
            kv_lora=32 if self.kv_lora else 0,
            qk_nope=32 if self.attn == "mla" else self.qk_nope,
            qk_rope=16 if self.attn == "mla" else self.qk_rope,
            v_head=32 if self.attn == "mla" else self.v_head,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            sliding_window=64 if self.sliding_window else 0,
            enc_layers=2 if self.enc_layers else 0,
            n_frontend_tokens=(16 if self.n_frontend_tokens else 0),
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, batch) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train|prefill|decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401  (side-effect: load config modules)
    try:
        return _REGISTRY[arch_id]()
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}"
                       ) from None


def list_archs() -> Tuple[str, ...]:
    from . import ALL_ARCHS  # noqa: F401
    return tuple(sorted(_REGISTRY))


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: long_500k requires "
                       "sub-quadratic attention (assignment rule)")
    return True, ""
