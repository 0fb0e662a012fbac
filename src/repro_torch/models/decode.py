"""Prefill / decode for the port's LM, with per-segment caches.

Counterpart of the JAX package's ``models/decode.py``.  Cache anatomy,
one entry per segment of ``decoder_plan`` (the JAX layout, layers stacked
on the leading axis):

  * GQA ``attn`` / ``moe`` segments -- {"k", "v"}: (L, B, S_cache, H_kv,
    D_h)
  * MLA ``attn`` / ``moe`` segments -- the compressed latent {"ckv":
    (L, B, S_cache, kv_lora), "krope": (L, B, S_cache, qk_rope)}
  * ``mamba`` segments  -- :class:`MambaCache` of (L, B, ...) tensors
  * ``shared`` markers  -- one {"k", "v"}: (B, S_cache, H_kv, D_h) each
  * whisper's ``dec`` segment -- {"k", "v"} of its self-attention and
    {"ck", "cv"}: (L, B, S_enc, H, D_h), the keys and values of the
    encoder states, which decoding reads and never writes

:func:`prefill` runs a whole prompt (after the encoder over
``batch["frames"]`` for an encoder-decoder, after ``batch["patches"]`` for
a vision config) and emits the cache, KV padded with zeros to
``cache_size``; :func:`decode_step` advances one token.  Unlike the JAX
functions, :func:`decode_step` updates the cache it is given in place (it
writes one KV or latent row per layer and the SSM states) and returns it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

from . import layers as L
from . import ssm as S
from .transformer import (LM, _ssm_dims, apply_ffn, decoder_plan,
                          embed_inputs, layer_thetas, layer_windows,
                          logits_fn, run_encoder, run_stack, uses_mla)


def init_decode_cache(cfg: ModelConfig, batch: int, cache_size: int,
                      dtype=torch.bfloat16, device=None,
                      enc_len: Optional[int] = None):
    """Zero-initialised cache for ``batch`` sequences of ``cache_size``.

    A ``dec`` segment's ``ck`` / ``cv`` hold ``enc_len`` encoder rows, one
    when ``enc_len`` is None, as the JAX function defaults."""
    dev = resolve_device(device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    segs = []
    dims = _ssm_dims(cfg) if cfg.ssm_state else None
    kv = (cache_size, cfg.n_kv_heads, cfg.head_dim)
    for seg in decoder_plan(cfg):
        if seg.kind == "mamba":
            segs.append(S.MambaCache(
                conv_x=zeros(seg.count, batch, dims.d_conv - 1, dims.d_inner),
                conv_bc=zeros(seg.count, batch, dims.d_conv - 1,
                              2 * dims.dstate),
                state=zeros(seg.count, batch, dims.nheads, dims.headdim,
                            dims.dstate, dt=torch.float32)))
        elif seg.kind == "shared":
            segs.append({"k": zeros(batch, *kv), "v": zeros(batch, *kv)})
        elif uses_mla(cfg, seg.kind):
            segs.append({
                "ckv": zeros(seg.count, batch, cache_size, cfg.kv_lora),
                "krope": zeros(seg.count, batch, cache_size, cfg.qk_rope)})
        else:
            c = {"k": zeros(seg.count, batch, *kv),
                 "v": zeros(seg.count, batch, *kv)}
            if seg.kind == "dec":
                enc = (enc_len or 1, cfg.n_heads, cfg.head_dim)
                c["ck"] = zeros(seg.count, batch, *enc)
                c["cv"] = zeros(seg.count, batch, *enc)
            segs.append(c)
    return {"segments": segs}


# ------------------------------------------------------------------ decode
def _attn_block_decode(p, x, cfg: ModelConfig, leaf, cache_len: int,
                       window: int, theta: float, dtype):
    """One token through an ``attn`` / ``shared`` / ``moe`` / ``dec``
    block; writes its KV (or latent) row into ``leaf``'s tensors in place
    (a ``dec`` block's cross keys and values are only read)."""
    h = L.apply_norm(cfg.norm, p.ln1, x)
    if uses_mla(cfg, p.kind):
        att, _, _ = L.mla_decode(
            p.attn, h, leaf["ckv"], leaf["krope"], cache_len,
            n_heads=cfg.n_heads, kv_lora=cfg.kv_lora, qk_nope=cfg.qk_nope,
            qk_rope=cfg.qk_rope, v_head=cfg.v_head, rope_theta=theta,
            dtype=dtype)
    else:
        att, _, _ = L.gqa_decode(
            p.attn, h, leaf["k"], leaf["v"], cache_len, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=None if cfg.rope_theta == 0 else theta, window=window,
            dtype=dtype)
    x = x + att
    if p.kind == "dec":
        hx = L.apply_norm(cfg.norm, p.lnx, x)
        x = x + L.cross_cached(p.cross, hx, leaf["ck"], leaf["cv"],
                               n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                               dtype=dtype)
    h2 = L.apply_norm(cfg.norm, p.ln2, x)
    return x + apply_ffn(p, h2, cfg, dtype)


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, token: torch.Tensor, cache,
                cache_len: int, *, dtype=torch.bfloat16):
    """One decoding step at position ``cache_len`` for every row (a vision
    prompt's patches count: P + S + i at step i).

    token: (B, 1) int; returns ``(logits (B, vocab), cache)``, the cache
    updated in place."""
    x = L.embed(model.embed, token, dtype)
    if cfg.rope_theta == 0 or cfg.is_encdec:
        pos = torch.full((), float(cache_len), device=x.device)
        x = x + L.sinusoidal_at(pos, cfg.d_model).to(dtype)[None, None, :]
    windows, thetas = layer_windows(cfg), layer_thetas(cfg)
    dims = _ssm_dims(cfg) if cfg.ssm_state else None
    for seg, blocks, c in zip(model.plan, model.segments, cache["segments"]):
        if seg.kind == "shared":
            x = _attn_block_decode(model.shared_block, x, cfg, c, cache_len,
                                   0, float(np.float32(cfg.rope_theta)),
                                   dtype)
            continue
        for i, blk in enumerate(blocks):
            layer = seg.start + i
            if seg.kind == "mamba":
                h = L.apply_norm(cfg.norm, blk.ln, x)
                out, new = S.mamba2_decode(
                    blk.mixer, h, S.MambaCache(*(t[i] for t in c)), dims,
                    dtype)
                for dst, src in zip(c, new):
                    dst[i].copy_(src)
                x = x + out
            else:
                x = _attn_block_decode(blk, x, cfg,
                                       {n: t[i] for n, t in c.items()},
                                       cache_len, int(windows[layer]),
                                       float(thetas[layer]), dtype)
    logits = logits_fn(model, cfg, x, dtype)
    return logits[:, 0], cache


# ------------------------------------------------------------------ prefill
def _pad_cache_seq(arr: torch.Tensor, cache_size: int) -> torch.Tensor:
    """Zero-pad (or cut) axis 1 to ``cache_size``."""
    pad = cache_size - arr.shape[1]
    if pad <= 0:
        return arr[:, :cache_size]
    return F.pad(arr, (0, 0) * (arr.ndim - 2) + (0, pad))


@torch.no_grad()
def prefill(model: LM, cfg: ModelConfig, batch, *,
            cache_size: Optional[int] = None, dtype=torch.bfloat16):
    """Whole-prompt forward: ``(last-position logits (B, vocab), cache)``.

    ``batch``: ``tokens`` (B, S), and ``frames`` (B, S_enc, d) for an
    encoder-decoder (the encoder runs first) or ``patches`` (B, P, d) for
    a vision config (prepended; the cache then holds P + S rows)."""
    enc = (run_encoder(model, cfg, batch["frames"], dtype)
           if cfg.is_encdec else None)
    x, positions, _ = embed_inputs(model, cfg, batch, dtype)
    cache_size = cache_size or x.shape[1]
    x, leaves = run_stack(model, cfg, x, positions, dtype, enc=enc)
    segments = []
    for seg, leaf in zip(model.plan, leaves):
        if seg.kind == "shared":
            segments.append({n: _pad_cache_seq(leaf[n], cache_size)
                             for n in ("k", "v")})
        elif seg.kind == "mamba":
            segments.append(S.MambaCache(*(torch.stack(t)
                                           for t in zip(*leaf))))
        else:   # the cross keys / values keep the encoder's length
            segments.append({n: torch.stack([
                lf[n] if n in ("ck", "cv") else
                _pad_cache_seq(lf[n], cache_size) for lf in leaf])
                for n in leaf[0]})
    logits = logits_fn(model, cfg, x[:, -1:], dtype)
    return logits[:, 0], {"segments": segments}
