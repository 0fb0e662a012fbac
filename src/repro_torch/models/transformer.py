"""The port's LM: blocks of kind ``mamba``, ``shared``, ``attn``, ``moe``,
``enc`` and ``dec``, with GQA or MLA attention, whisper's encoder and the
modality frontends' stubs (precomputed audio frames, vision patches).

Counterpart of the JAX package's ``models/transformer.py``: serving
(:func:`run_stack`, used by ``decode.prefill``) and training
(:func:`forward_train`).  The JAX package stacks each segment's parameters
and scans over them; here every layer is its own ``nn.Module`` in an
``nn.ModuleList`` per segment, run by a Python loop.  Parameter names
follow the JAX pytree: ``segments.<i>.<layer>.mixer.in_z`` is layer
``<layer>`` of the JAX ``segments/<i>/mixer/in_z`` stack,
``enc_segments.0.<layer>.attn.wq`` of ``enc_segments/0/attn/wq`` (see
``repro_torch.convert``).

Training differentiates through the kernels' autograd functions (the
backward kernels of RMSNorm, attention and the Mamba-2 SSD scan).
``remat`` checkpoints each
layer as the JAX ``_remat`` does: ``"dots"`` keeps the layer's plain matrix
products (``aten.mm`` / ``addmm``: XLA's dots with no batch dimensions) and
recomputes the rest, ``"full"`` keeps nothing, ``"none"`` checkpoints
nothing.  It changes memory, never values.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

from . import layers as L
from . import moe as M
from . import ssm as S


# ----------------------------------------------------------------- plan
@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str    # attn | moe | mamba | shared | dec
    count: int
    start: int   # global index of the first layer in this segment


def build_plan(cfg: ModelConfig) -> Tuple[Segment, ...]:
    """Decoder-stack segment plan (as the JAX package builds it)."""
    segs: List[Segment] = []
    if cfg.family == "ssm":
        segs.append(Segment("mamba", cfg.n_layers, 0))
    elif cfg.family == "hybrid":
        done = 0
        while done < cfg.n_layers:
            run = min(cfg.shared_attn_every, cfg.n_layers - done)
            segs.append(Segment("mamba", run, done))
            done += run
            if done < cfg.n_layers or run == cfg.shared_attn_every:
                segs.append(Segment("shared", 1, done))
    elif cfg.n_experts > 0:
        if cfg.first_dense_layers:
            segs.append(Segment("attn", cfg.first_dense_layers, 0))
        segs.append(Segment("moe", cfg.n_layers - cfg.first_dense_layers,
                            cfg.first_dense_layers))
    else:
        segs.append(Segment("attn", cfg.n_layers, 0))
    return tuple(segs)


def decoder_plan(cfg: ModelConfig) -> Tuple[Segment, ...]:
    """The plan every consumer runs (the JAX ``decode._dec_plan``): an
    encoder-decoder's decoder is one ``dec`` segment, which the JAX
    ``init_params`` builds in place of :func:`build_plan`'s ``attn``
    segment."""
    if cfg.is_encdec:
        return (Segment("dec", cfg.n_layers, 0),)
    return build_plan(cfg)


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding window (0 = global attention)."""
    w = np.zeros(cfg.n_layers, dtype=np.int32)
    if cfg.sliding_window:
        if cfg.global_every:
            w[:] = cfg.sliding_window
            w[cfg.global_every - 1::cfg.global_every] = 0   # LLLLLG pattern
        else:
            w[:] = cfg.sliding_window
    return w


def layer_thetas(cfg: ModelConfig) -> np.ndarray:
    t = np.full(cfg.n_layers, cfg.rope_theta, dtype=np.float32)
    if cfg.rope_theta_global and cfg.global_every:
        t[cfg.global_every - 1::cfg.global_every] = cfg.rope_theta_global
    return t


def _ssm_dims(cfg: ModelConfig) -> S.SSMDims:
    return S.SSMDims.from_config(cfg.d_model, cfg.ssm_state,
                                 cfg.ssm_expand, cfg.ssm_headdim)


# ----------------------------------------------------------------- blocks
class MambaBlock(nn.Module):
    """``ln`` + Mamba-2 ``mixer``."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.ln = L.Norm(cfg.norm, cfg.d_model, device, dtype)
        self.mixer = S.Mamba2(_ssm_dims(cfg), device, dtype)

    def forward(self, x, cfg: ModelConfig, positions, window, theta, dtype,
                enc=None, keep_cache: bool = True):
        """Returns (x, the layer's :class:`MambaCache` or None without
        ``keep_cache``, no aux loss)."""
        h = L.apply_norm(cfg.norm, self.ln, x)
        if not keep_cache:
            return x + S.apply_mamba2(self.mixer, h, _ssm_dims(cfg),
                                      dtype), None, None
        out, cache = S.apply_mamba2(self.mixer, h, _ssm_dims(cfg), dtype,
                                    return_cache=True)
        return x + out, cache, None


def uses_mla(cfg: ModelConfig, kind: str) -> bool:
    """Whether a block of ``kind`` attends with MLA (``attn`` and ``moe``
    blocks of an MLA config; zamba2's ``shared`` block is GQA)."""
    return cfg.attn == "mla" and kind in ("attn", "moe")


def self_attention(p, h, cfg: ModelConfig, kind: str, positions, window,
                   theta, dtype, causal: bool = True):
    """The block's self-attention over h (prefill).  Returns ``(out,
    leaf)``: the layer's decode-cache leaf, {"k", "v"} for GQA, the
    latent {"ckv", "krope"} for MLA."""
    if uses_mla(cfg, kind):
        c_kv, k_rope = L.mla_latent(p, h, positions, theta, dtype,
                                    kv_lora=cfg.kv_lora, qk_rope=cfg.qk_rope)
        att = L.mla_attention_from_latent(
            p, h, c_kv, k_rope, n_heads=cfg.n_heads, qk_nope=cfg.qk_nope,
            qk_rope=cfg.qk_rope, v_head=cfg.v_head, rope_theta=theta,
            causal=causal, dtype=dtype)
        return att, {"ckv": c_kv, "krope": k_rope[:, :, 0]}
    att, k, v = L.gqa_attention(
        p, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, positions=positions,
        rope_theta=None if cfg.rope_theta == 0 else theta, causal=causal,
        window=window, dtype=dtype)
    return att, {"k": k, "v": v}


def apply_ffn(blk, h2, cfg: ModelConfig, dtype):
    """The block's ``mlp``, or its ``moe``: ``(out, aux)``, aux the MoE
    load-balancing loss that training adds up (serving drops it), None for
    an ``mlp``."""
    if hasattr(blk, "moe"):
        return M.apply_moe(blk.moe, h2, n_experts=cfg.n_experts,
                           top_k=cfg.top_k, act=cfg.act, dtype=dtype,
                           capacity_factor=cfg.moe_capacity_factor)
    return L.apply_mlp(blk.mlp, h2, cfg.act, dtype), None


class AttnBlock(nn.Module):
    """``ln1`` + ``attn`` (GQA, or MLA for an MLA config) + ``ln2`` + an
    FFN: ``mlp`` for kinds ``attn``, ``shared`` (zamba2's one block applied
    at every marker), ``enc`` and ``dec``, ``moe`` for kind ``moe``.  An
    ``enc`` block's self-attention is not causal; a ``dec`` block adds
    ``lnx`` + ``cross`` (attention over the encoder states) after it."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32,
                 kind: str = "attn"):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.ln1 = L.Norm(cfg.norm, d, device, dtype)
        if uses_mla(cfg, kind):
            self.attn = L.MLA(d, cfg.n_heads, q_lora=cfg.q_lora,
                              kv_lora=cfg.kv_lora, qk_nope=cfg.qk_nope,
                              qk_rope=cfg.qk_rope, v_head=cfg.v_head,
                              device=device, dtype=dtype)
        else:
            self.attn = L.GQA(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              cfg.qkv_bias, device, dtype)
        self.ln2 = L.Norm(cfg.norm, d, device, dtype)
        if kind == "moe":
            self.moe = M.MoE(d, cfg.moe_d_ff, cfg.n_experts,
                             cfg.n_shared_experts, cfg.act, device, dtype)
        else:
            self.mlp = L.MLP(d, cfg.d_ff, cfg.act, device, dtype)
        if kind == "dec":
            self.lnx = L.Norm(cfg.norm, d, device, dtype)
            self.cross = L.CrossAttention(d, cfg.n_heads, cfg.head_dim,
                                          device, dtype)

    def forward(self, x, cfg: ModelConfig, positions, window, theta, dtype,
                enc=None):
        """Returns (x, the layer's decode-cache leaf, aux): a ``dec`` block
        attends over the encoder states ``enc`` and its leaf also holds
        their keys and values, ``ck`` / ``cv``; aux is a ``moe`` block's
        load-balancing loss, else None."""
        h = L.apply_norm(cfg.norm, self.ln1, x)
        att, leaf = self_attention(self.attn, h, cfg, self.kind, positions,
                                   window, theta, dtype,
                                   causal=self.kind != "enc")
        x = x + att
        if self.kind == "dec":
            heads = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                         dtype=dtype)
            leaf["ck"], leaf["cv"] = L.cross_kv(self.cross, enc, **heads)
            hx = L.apply_norm(cfg.norm, self.lnx, x)
            x = x + L.cross_cached(self.cross, hx, leaf["ck"], leaf["cv"],
                                   **heads)
        h2 = L.apply_norm(cfg.norm, self.ln2, x)
        out, aux = apply_ffn(self, h2, cfg, dtype)
        return x + out, leaf, aux


BLOCKS = {"mamba": MambaBlock,
          **{kind: functools.partial(AttnBlock, kind=kind)
             for kind in ("attn", "moe", "enc", "dec")}}


class LM(nn.Module):
    """The LM's parameters, uninitialised (see :func:`init_params`).

    ``segments[i]`` holds segment i's layers of :func:`decoder_plan`
    (empty for a ``shared`` marker, which applies ``shared_block``); an
    encoder-decoder also has ``enc_segments[0]``, its ``enc`` layers, and
    ``enc_norm``."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.plan = decoder_plan(cfg)
        self.embed = L.Embed(cfg.vocab, cfg.d_model, device, dtype)
        self.segments = nn.ModuleList(
            nn.ModuleList([] if seg.kind == "shared" else
                          [BLOCKS[seg.kind](cfg, device, dtype)
                           for _ in range(seg.count)])
            for seg in self.plan)
        if cfg.shared_attn_every:
            self.shared_block = AttnBlock(cfg, device, dtype, kind="shared")
        self.final_norm = L.Norm(cfg.norm, cfg.d_model, device, dtype)
        if not cfg.tie_embeddings:
            self.unembed = L._empty(cfg.d_model, cfg.vocab, device=device,
                                    dtype=dtype)
        if cfg.is_encdec:
            self.enc_segments = nn.ModuleList([nn.ModuleList(
                BLOCKS["enc"](cfg, device, dtype)
                for _ in range(cfg.enc_layers))])
            self.enc_norm = L.Norm(cfg.norm, cfg.d_model, device, dtype)


# ----------------------------------------------------------------- init
_ZEROS = ("bias", "bq", "bk", "bv", "conv_bias_x", "conv_bias_bc", "dt_bias")
_ONES = ("scale", "d_skip")


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> LM:
    """A model with the JAX ``init_params`` shapes and init scales, drawn
    from ``generator`` (on ``device``'s type) in parameter order.

    Dense weights are N(0, 1) / sqrt(d_in) (stacked experts (E, d_in,
    d_out) too), the embedding table N(0, 1) / sqrt(d_model), conv kernels
    N(0, 1) / sqrt(d_conv); norms and ``d_skip`` are 1, biases 0, ``a_log
    = log(linspace(1, 16, H))``.
    Not JAX's random stream: the same seed gives other weights.
    """
    dev = resolve_device(device)
    model = LM(cfg, dev, dtype)
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _ZEROS:
            prm.zero_()
        elif leaf in _ONES:
            prm.fill_(1.0)
        elif leaf == "a_log":
            prm.copy_(torch.log(torch.linspace(1.0, 16.0, prm.shape[0])))
        else:
            draw = torch.randn(prm.shape, generator=generator, device=dev,
                               dtype=torch.float32)
            if leaf == "table":
                draw /= math.sqrt(prm.shape[1])
            else:   # (d_in, d_out), (E, d_in, d_out) and (d_conv, C)
                draw /= math.sqrt(prm.shape[-2])
            prm.copy_(draw)
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ----------------------------------------------------------------- forward
def stack_layers(model: LM, cfg: ModelConfig):
    """``(segment index, block, window, theta)`` of each layer of the
    decoder plan, in order; a ``shared`` marker applies ``shared_block``
    with global attention and the config's theta."""
    windows, thetas = layer_windows(cfg), layer_thetas(cfg)
    for i, (seg, blocks) in enumerate(zip(model.plan, model.segments)):
        if seg.kind == "shared":
            yield i, model.shared_block, 0, float(np.float32(cfg.rope_theta))
        for j, blk in enumerate(blocks):
            layer = seg.start + j
            yield i, blk, int(windows[layer]), float(thetas[layer])


def run_stack(model: LM, cfg: ModelConfig, x, positions, dtype, enc=None):
    """Run the decoder segment plan over x (``dec`` blocks attend over the
    encoder states ``enc``).

    Returns ``(x, leaves)``: per segment, the ``shared`` marker's k / v, or
    the list of its layers' cache leaves (what prefill keeps)."""
    leaves = [None if seg.kind == "shared" else [] for seg in model.plan]
    for i, blk, window, theta in stack_layers(model, cfg):
        x, leaf, _ = blk(x, cfg, positions, window, theta, dtype, enc=enc)
        if leaves[i] is None:
            leaves[i] = leaf
        else:
            leaves[i].append(leaf)
    return x, leaves


REMAT_MODES = ("none", "dots", "full")
# what "dots" keeps: the plain matrix products (batched ones, the MoE's
# expert products, are recomputed, as under JAX's
# dots_with_no_batch_dims_saveable)
_SAVED_OPS = frozenset((torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default))


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(fn, remat: str, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the checkpoint policy ``remat`` (the
    JAX ``_remat``): ``"none"`` runs it plainly, ``"full"`` recomputes all
    of it in the backward, ``"dots"`` all but the matrix products."""
    if remat == "none":
        return fn(*args, **kwargs)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _keep_dots), **kwargs)
    raise ValueError(f"remat {remat!r} is not one of {REMAT_MODES}")


def train_stack(model: LM, cfg: ModelConfig, x, positions, dtype, *,
                enc=None, remat: str = "dots"):
    """Run the decoder plan over x for training: each layer under
    ``remat``, no cache leaf kept (a Mamba block builds none).  Returns
    ``(x, the MoE blocks' aux losses summed, f32)``."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, blk, window, theta in stack_layers(model, cfg):
        extra = ({"keep_cache": False} if isinstance(blk, MambaBlock)
                 else {})
        x, _, aux = remat_call(blk, remat, x, cfg, positions, window, theta,
                               dtype, enc=enc, **extra)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def run_encoder(model: LM, cfg: ModelConfig, frames, dtype,
                remat: str = "none"):
    """Whisper's encoder over precomputed frame embeddings (B, S, d) (the
    audio frontend is a stub): sinusoidal positions, the ``enc`` stack
    (non-causal, no RoPE; each layer under ``remat`` when training), then
    ``enc_norm``."""
    s = frames.shape[1]
    x = frames.to(dtype) + L.sinusoidal_positions(
        s, cfg.d_model, frames.device)[None].to(dtype)
    positions = torch.arange(s, device=x.device)
    for blk in model.enc_segments[0]:
        x, _, _ = remat_call(blk, remat, x, cfg, positions, 0, 0.0, dtype)
    return L.apply_norm(cfg.norm, model.enc_norm, x)


def embed_inputs(model: LM, cfg: ModelConfig, batch, dtype):
    """Token embedding, after the vision patches (B, P, d) of
    ``batch["patches"]`` for a vision config, + sinusoidal positions when
    the arch has no RoPE or is an encoder-decoder.  Returns ``(x,
    positions 0..P+S-1, P)``."""
    x = L.embed(model.embed, batch["tokens"], dtype)
    offset = 0
    if cfg.frontend == "vision" and "patches" in batch:
        x = torch.cat([batch["patches"].to(dtype), x], dim=1)
        offset = batch["patches"].shape[1]
    if cfg.rope_theta == 0 or cfg.is_encdec:
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                       x.device)[None].to(dtype)
    return x, torch.arange(x.shape[1], device=x.device), offset


def logits_fn(model: LM, cfg: ModelConfig, x, dtype):
    x = L.apply_norm(cfg.norm, model.final_norm, x)
    return L.unembed(model.embed, x, dtype, getattr(model, "unembed", None))


@torch.no_grad()
def forward_logits(model: LM, cfg: ModelConfig, batch, *,
                   dtype=torch.bfloat16):
    """Logits (B, S, vocab) of ``batch["tokens"]`` (B, S), after the
    encoder over ``batch["frames"]`` for an encoder-decoder; a vision
    config's ``batch["patches"]`` positions give no logits."""
    enc = (run_encoder(model, cfg, batch["frames"], dtype)
           if cfg.is_encdec else None)
    x, positions, offset = embed_inputs(model, cfg, batch, dtype)
    x, _ = run_stack(model, cfg, x, positions, dtype, enc=enc)
    return logits_fn(model, cfg, x[:, offset:], dtype)


def forward_train(model: LM, cfg: ModelConfig, batch, *,
                  dtype=torch.bfloat16, remat: str = "dots"):
    """``(loss, {"ce_loss", "aux_loss"})`` of ``batch``: ``tokens`` and
    ``labels`` (B, S), and ``frames`` for an encoder-decoder (the encoder
    runs first) or ``patches`` for a vision config (prepended; their
    positions give no loss).  The mean token cross-entropy in f32 plus the
    MoE blocks' aux losses, as the JAX ``forward_train`` computes them;
    every layer under ``remat`` (:data:`REMAT_MODES`)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} is not one of {REMAT_MODES}")
    enc = (run_encoder(model, cfg, batch["frames"], dtype, remat)
           if cfg.is_encdec else None)
    x, positions, offset = embed_inputs(model, cfg, batch, dtype)
    x, aux = train_stack(model, cfg, x, positions, dtype, enc=enc,
                         remat=remat)
    logits = logits_fn(model, cfg, x[:, offset:], dtype)
    loss = L.cross_entropy(logits, batch["labels"])
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}
