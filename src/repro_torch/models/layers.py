"""Neural layers of the port's LLM path: norms, RoPE, sinusoidal positions,
GQA, MLA and cross attention, MLPs and embeddings.

Counterpart of the JAX package's ``models/layers.py``, for what the serving
and training paths need (training adds :func:`cross_entropy`).  Parameters
live in small ``nn.Module`` holders whose attribute names are the JAX
parameter dict's keys (``Norm.scale``, ``GQA.wq``, ...); the functions take
such a holder where the JAX functions take a dict.
Weights keep JAX's (d_in, d_out) layout and are applied as ``x @ w``.

* :func:`rmsnorm` goes through the CUDA kernel wrapper
  (:mod:`repro_torch.kernels.rmsnorm`), :func:`chunked_attention` through
  the flash-attention wrapper; on CPU tensors both use their plain versions.
  Both are differentiable through their backward kernels.
* Attention positions are contiguous on the whole path (prefill: 0..S-1;
  decode: one query at the cache length), so the attention functions take a
  query offset and a valid length as Python ints instead of position arrays.
* ``mesh_constrain`` has no counterpart: it is a no-op on one device.
* Under :func:`repro_torch.models.tp.tensor_parallel` (a model placed on a
  mesh whose ``model`` axis is above 1) attention, the MLP and the
  (un)embedding run on their parameters' local shards with the
  boundaries' collectives, each block as :mod:`repro_torch.models.tp`'s
  plan says.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel

from . import tp


def _empty(*shape, device=None, dtype=torch.float32) -> nn.Parameter:
    """A parameter without a gradient: serving's.  The train state turns
    gradients on (``repro_torch.train.train_step.init_train_state``)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ----------------------------------------------------------------- norms
class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``) parameters."""

    def __init__(self, kind: str, d: int, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = _empty(d, device=device, dtype=dtype)
        if kind != "rmsnorm":
            self.bias = _empty(d, device=device, dtype=dtype)


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm_kernel(x, p.scale, eps)


def layernorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p.scale.float() + p.bias.float()
    return y.to(x.dtype)


def apply_norm(kind: str, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ----------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, device=None):
    """``1 / theta ** (2i / head_dim)`` in f32 (theta a Python float, so no
    host-to-device copy)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh), rotated by halves (not interleaved);
    positions: (S,)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                  # (S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n, d)."""
    return sinusoidal_at(torch.arange(n, dtype=torch.float32, device=device),
                         d)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding at positions ``pos``: (..., d)."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    inv = torch.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))
    ang = pos.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------- attention
def chunked_attention(q, k, v, *, q_offset: int = 0, causal: bool = True,
                      window: int = 0, kv_valid_len: Optional[int] = None,
                      softmax_scale: Optional[float] = None,
                      block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention through the flash-attention kernel.

    q: (B, Sq, H, Dh) at positions ``q_offset ..``; k: (B, Sk, Hkv, Dh)
    and v: (B, Sk, Hkv, Dv), Dv <= Dh, at positions 0..Sk-1.  ``window <=
    0`` is global.  Returns (B, Sq, H, Dv) in q's dtype.
    """
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, kv_valid_len=kv_valid_len,
                           softmax_scale=softmax_scale, block_k=block_k)


class GQA(nn.Module):
    """Grouped-query attention weights ``wq wk wv wo`` (+ ``bq bk bv``)."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 bias: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        self.wq = _empty(d_model, n_heads * head_dim, device=device,
                         dtype=dtype)
        self.wk = _empty(d_model, n_kv * head_dim, device=device, dtype=dtype)
        self.wv = _empty(d_model, n_kv * head_dim, device=device, dtype=dtype)
        self.wo = _empty(n_heads * head_dim, d_model, device=device,
                         dtype=dtype)
        if bias:
            self.bq = _empty(n_heads * head_dim, device=device, dtype=dtype)
            self.bk = _empty(n_kv * head_dim, device=device, dtype=dtype)
            self.bv = _empty(n_kv * head_dim, device=device, dtype=dtype)


def gqa_project_qkv(p: GQA, x, n_heads: int, n_kv: int, head_dim: int,
                    positions, rope_theta: Optional[float], dtype):
    """``(q, k, v, index)``, (B, S, heads, Dh) each, ``index`` each q head's
    kv head among k's where the kernel's grouping is not theirs, else None.
    Under tensor parallelism q holds this rank's heads and k / v the kv
    heads they use: its own (``heads``), or those of ``wk`` / ``wv``
    gathered whole where the rules split a kv head (``kv_gather``)."""
    b, s, _ = x.shape
    heads = n_heads // tp.size()
    xd = tp.copy_to(x).to(dtype)
    kv = [n for n in ("wk", "wv", "bk", "bv") if hasattr(p, n)]
    index = None
    if tp.attn_mode(n_heads, n_kv, head_dim, tp.size()) == "kv_gather":
        first, hk, index = _kv_heads_of(tp.active().rank, heads, n_heads,
                                        n_kv)
        cols = slice(first * head_dim, (first + hk) * head_dim)
        w = {n: tp.full(getattr(p, n), "sum")[..., cols] for n in kv}
    else:
        hk = n_kv // tp.size()
        w = {n: tp.local(getattr(p, n)) for n in kv}
    xq = xd @ tp.local(p.wq).to(dtype)
    xk = xd @ w["wk"].to(dtype)
    xv = xd @ w["wv"].to(dtype)
    if hasattr(p, "bq"):
        xq = xq + tp.local(p.bq).to(dtype)
        xk = xk + w["bk"].to(dtype)
        xv = xv + w["bv"].to(dtype)
    q = xq.reshape(b, s, heads, head_dim)
    k = xk.reshape(b, s, hk, head_dim)
    v = xv.reshape(b, s, hk, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v, index


def gqa_attention(p: GQA, x, *, n_heads: int, n_kv: int, head_dim: int,
                  positions, rope_theta: Optional[float], causal: bool,
                  window: int, dtype, block_k: int = 512):
    """Self-attention over x (prefill path); ``positions`` are contiguous.

    Returns ``(out, k, v)``: the keys and values too, which prefill keeps
    as the decode cache (the JAX function returns ``out`` alone).  Under
    tensor parallelism k and v are this rank's heads, and the output its
    rows of ``wo``'s product summed over the group; where the rules split
    a q head every rank runs the block from gathered weights."""
    if tp.attn_mode(n_heads, n_kv, head_dim, tp.size()) == "whole":
        return tp.on_whole(
            gqa_attention, p, x, n_heads=n_heads, n_kv=n_kv,
            head_dim=head_dim, positions=positions, rope_theta=rope_theta,
            causal=causal, window=window, dtype=dtype, block_k=block_k)
    b, s, _ = x.shape
    q, k, v, index = gqa_project_qkv(p, x, n_heads, n_kv, head_dim,
                                     positions, rope_theta, dtype)
    kk, vv = (k, v) if index is None else (k[:, :, index], v[:, :, index])
    out = chunked_attention(q, kk, vv, causal=causal, window=window,
                            block_k=block_k)
    out = out.reshape(b, s, q.shape[2] * head_dim)
    return tp.reduce_from(out.to(dtype) @ tp.local(p.wo).to(dtype)), k, v


def _kv_heads_of(rank: int, heads: int, n_heads: int, n_kv: int):
    """The kv heads the q heads ``[rank * heads, (rank + 1) * heads)`` use:
    ``(first, count, index)``, ``index`` None where the kernel's grouping
    of ``heads`` q heads over ``count`` kv heads is theirs, else each q
    head's kv head among the ``count`` (the keys are then expanded)."""
    group = n_heads // n_kv
    lo, hi = rank * heads, (rank + 1) * heads - 1
    first, last = lo // group, hi // group
    count = last - first + 1
    if heads % count == 0 and all(
            (lo + j) // group - first == j // (heads // count)
            for j in range(heads)):
        return first, count, None
    return first, count, [(lo + j) // group - first for j in range(heads)]


def gqa_decode(p: GQA, x, cache_k, cache_v, cache_len: int, *, n_heads: int,
               n_kv: int, head_dim: int, rope_theta: Optional[float],
               window: int, dtype, block_k: int = 1024):
    """One-token decode.  cache_[kv]: (B, S_max, Hkv, Dh).

    Writes the new token's k and v into the caches at ``cache_len`` in
    place (the JAX function returns updated copies) and returns
    ``(out, cache_k, cache_v)``.
    """
    b, one, _ = x.shape
    assert one == 1
    if not 0 <= cache_len < cache_k.shape[1]:
        raise ValueError(f"cache_len {cache_len} outside a cache of "
                         f"{cache_k.shape[1]}")
    pos = torch.full((1,), cache_len, device=x.device)
    q, k, v, _ = gqa_project_qkv(p, x, n_heads, n_kv, head_dim, pos,
                                 rope_theta, dtype)
    cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
    out = chunked_attention(
        q, cache_k.to(dtype), cache_v.to(dtype), q_offset=cache_len,
        causal=True, window=window, kv_valid_len=cache_len + 1,
        block_k=block_k)
    out = out.reshape(b, 1, n_heads * head_dim)
    return out.to(dtype) @ p.wo.to(dtype), cache_k, cache_v


# ----------------------------------------------------------------- MLA
class MLA(nn.Module):
    """DeepSeek-V2 Multi-head Latent Attention (arXiv:2405.04434):
    ``wq_a wq_b wkv_a wk_b wv_b wo`` and the RMSNorms ``q_norm`` /
    ``kv_norm``."""

    def __init__(self, d_model: int, n_heads: int, *, q_lora: int,
                 kv_lora: int, qk_nope: int, qk_rope: int, v_head: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wq_a = _empty(d_model, q_lora, **kw)
        self.wq_b = _empty(q_lora, n_heads * (qk_nope + qk_rope), **kw)
        self.wkv_a = _empty(d_model, kv_lora + qk_rope, **kw)
        self.wk_b = _empty(kv_lora, n_heads * qk_nope, **kw)
        self.wv_b = _empty(kv_lora, n_heads * v_head, **kw)
        self.wo = _empty(n_heads * v_head, d_model, **kw)
        self.q_norm = Norm("rmsnorm", q_lora, device, dtype)
        self.kv_norm = Norm("rmsnorm", kv_lora, device, dtype)


def _latent(x, w, dtype):
    """``x @ w`` whole on every rank: this rank's columns of the product
    gathered where ``w`` is split (x past "f"), else the replicated
    weight's product."""
    if tp.shard_dim(w) is None:
        return x.to(dtype) @ w.to(dtype)
    return tp.gather(tp.copy_to(x).to(dtype) @ tp.local(w).to(dtype), -1)


def mla_latent(p: MLA, x, positions, rope_theta: float, dtype, *,
               kv_lora: int, qk_rope: int):
    """Project x to the compressed latent: ``(c_kv (B, S, kv_lora),
    k_rope (B, S, 1, qk_rope))``, whole on every rank under tensor
    parallelism (normed as on one device)."""
    b, s, _ = x.shape
    kv = _latent(x, p.wkv_a, dtype)
    c_kv, k_rope = kv[..., :kv_lora], kv[..., kv_lora:]
    c_kv = rmsnorm(p.kv_norm, c_kv)
    k_rope = apply_rope(k_rope.reshape(b, s, 1, qk_rope), positions,
                        rope_theta)
    return c_kv, k_rope


def _mla_queries(p: MLA, x, positions, rope_theta: float, dtype, *,
                 n_heads: int, qk_nope: int, qk_rope: int):
    """(q_nope (B, S, H, qk_nope), q_rope (B, S, H, qk_rope)), the latter
    rotated; this rank's heads under tensor parallelism."""
    b, s, _ = x.shape
    q = rmsnorm(p.q_norm, _latent(x, p.wq_a, dtype))
    q = (tp.copy_to(q) @ tp.local(p.wq_b).to(dtype)).reshape(
        b, s, n_heads // tp.size(), qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    return q_nope, apply_rope(q_rope, positions, rope_theta)


def mla_attention_from_latent(p: MLA, x, c_kv, k_rope, *, n_heads: int,
                              qk_nope: int, qk_rope: int, v_head: int,
                              rope_theta: float, causal: bool, dtype,
                              q_offset: int = 0,
                              kv_valid_len: Optional[int] = None,
                              block_k: int = 512):
    """Attention of the queries from x (at positions ``q_offset ..``)
    against a latent KV at positions 0..Sk-1, through the flash-attention
    kernel with 192-wide keys and 128-wide values at DeepSeek-V2's
    widths.  Under tensor parallelism: this rank's heads (``wq_b`` /
    ``wk_b`` / ``wv_b`` / ``wo``) from the whole latent, whose gradient
    is summed over the group, and the output summed over it."""
    b, sq, _ = x.shape
    heads = n_heads // tp.size()
    qpos = q_offset + torch.arange(sq, device=x.device)
    q_nope, q_rope = _mla_queries(p, x, qpos, rope_theta, dtype,
                                  n_heads=n_heads, qk_nope=qk_nope,
                                  qk_rope=qk_rope)
    sk = c_kv.shape[1]
    c = tp.copy_to(c_kv)
    k_nope = (c @ tp.local(p.wk_b).to(dtype)).reshape(b, sk, heads, qk_nope)
    v = (c @ tp.local(p.wv_b).to(dtype)).reshape(b, sk, heads, v_head)
    k_full = torch.cat([k_nope, tp.copy_to(k_rope).expand(
        b, sk, heads, qk_rope)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = chunked_attention(
        q_full, k_full, v, q_offset=q_offset, causal=causal, window=0,
        kv_valid_len=kv_valid_len,
        softmax_scale=1.0 / math.sqrt(qk_nope + qk_rope), block_k=block_k)
    out = out.reshape(b, sq, heads * v_head)
    return tp.reduce_from(out.to(dtype) @ tp.local(p.wo).to(dtype))


def mla_decode(p: MLA, x, cache_ckv, cache_krope, cache_len: int, *,
               n_heads: int, kv_lora: int, qk_nope: int, qk_rope: int,
               v_head: int, rope_theta: float, dtype):
    """One-token MLA decode with weight absorption.

    The cache is the compressed pair ``ckv`` (B, S_max, kv_lora) and
    ``krope`` (B, S_max, qk_rope); the new token's latent is written into
    both at ``cache_len`` in place (the JAX function returns updated
    copies).  Queries are mapped into latent space through ``wk_b``,
    scored against the latent directly (one logical KV head), and the
    outputs mapped back through ``wv_b``: plain products and a softmax in
    f32, as the reference computes them.  Returns ``(out, cache_ckv,
    cache_krope)``.
    """
    b, one, _ = x.shape
    assert one == 1
    s_max = cache_ckv.shape[1]
    if not 0 <= cache_len < s_max:
        raise ValueError(f"cache_len {cache_len} outside a cache of {s_max}")
    pos = torch.full((1,), cache_len, device=x.device)
    c_kv, k_rope = mla_latent(p, x, pos, rope_theta, dtype, kv_lora=kv_lora,
                              qk_rope=qk_rope)
    cache_ckv[:, cache_len] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_krope[:, cache_len] = k_rope[:, 0, 0].to(cache_krope.dtype)

    q_nope, q_rope = _mla_queries(p, x, pos, rope_theta, dtype,
                                  n_heads=n_heads, qk_nope=qk_nope,
                                  qk_rope=qk_rope)
    wk_b = p.wk_b.to(dtype).reshape(kv_lora, n_heads, qk_nope)
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, wk_b)   # absorbed
    ckv = cache_ckv.to(dtype).float()
    krp = cache_krope.to(dtype).float()
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    s = (torch.einsum("bqhl,bsl->bqhs", q_lat.float(), ckv)
         + torch.einsum("bqhr,bsr->bqhs", q_rope.float(), krp)) * scale
    valid = torch.arange(s_max, device=x.device) <= cache_len
    s = torch.where(valid, s, -torch.inf)
    probs = torch.softmax(s, dim=-1)                      # (B, 1, H, S)
    out = torch.einsum("bqhs,bsl->bqhl", probs, ckv).to(dtype)
    wv_b = p.wv_b.to(dtype).reshape(kv_lora, n_heads, v_head)
    out = torch.einsum("bqhl,lhv->bqhv", out, wv_b)
    out = out.reshape(b, 1, n_heads * v_head)
    return out.to(dtype) @ p.wo.to(dtype), cache_ckv, cache_krope


# --------------------------------------------------- cross attention (whisper)
class CrossAttention(nn.Module):
    """Decoder-to-encoder attention weights ``wq wk wv wo``."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        hd = n_heads * head_dim
        self.wq = _empty(d_model, hd, device=device, dtype=dtype)
        self.wk = _empty(d_model, hd, device=device, dtype=dtype)
        self.wv = _empty(d_model, hd, device=device, dtype=dtype)
        self.wo = _empty(hd, d_model, device=device, dtype=dtype)


def _cross_whole(n_heads: int, head_dim: int) -> bool:
    return tp.attn_mode(n_heads, n_heads, head_dim, tp.size()) == "whole"


def cross_kv(p: CrossAttention, enc, *, n_heads: int, head_dim: int, dtype):
    """The encoder states' keys and values, (B, Se, H, Dh) each: what
    prefill keeps as the decode cache's ``ck`` / ``cv`` (this rank's heads
    under tensor parallelism)."""
    if _cross_whole(n_heads, head_dim):
        return tp.on_whole(cross_kv, p, enc, n_heads=n_heads,
                           head_dim=head_dim, dtype=dtype)
    b, se, _ = enc.shape
    heads = n_heads // tp.size()
    e = tp.copy_to(enc).to(dtype)
    return ((e @ tp.local(p.wk).to(dtype)).reshape(b, se, heads, head_dim),
            (e @ tp.local(p.wv).to(dtype)).reshape(b, se, heads, head_dim))


def cross_cached(p: CrossAttention, x, ck, cv, *, n_heads: int,
                 head_dim: int, dtype, block_k: int = 512) -> torch.Tensor:
    """x's queries against the encoder's keys / values ``ck`` / ``cv``: no
    positions, no mask, every encoder row seen."""
    if _cross_whole(n_heads, head_dim):
        return tp.on_whole(cross_cached, p, x, ck, cv, n_heads=n_heads,
                           head_dim=head_dim, dtype=dtype, block_k=block_k)
    b, sq, _ = x.shape
    heads = n_heads // tp.size()
    q = (tp.copy_to(x).to(dtype) @ tp.local(p.wq).to(dtype)).reshape(
        b, sq, heads, head_dim)
    out = chunked_attention(q, ck.to(dtype), cv.to(dtype), causal=False,
                            block_k=block_k)
    out = out.reshape(b, sq, heads * head_dim)
    return tp.reduce_from(out.to(dtype) @ tp.local(p.wo).to(dtype))


def cross_attention(p: CrossAttention, x, enc, *, n_heads: int,
                    head_dim: int, dtype, block_k: int = 512):
    """Decoder-to-encoder attention (no positions, bidirectional)."""
    ck, cv = cross_kv(p, enc, n_heads=n_heads, head_dim=head_dim,
                      dtype=dtype)
    return cross_cached(p, x, ck, cv, n_heads=n_heads, head_dim=head_dim,
                        dtype=dtype, block_k=block_k)


# ----------------------------------------------------------------- MLPs
class MLP(nn.Module):
    """``w1``, ``w2`` (+ ``w3`` for the gated activations)."""

    def __init__(self, d_model: int, d_ff: int, act: str, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w1 = _empty(d_model, d_ff, device=device, dtype=dtype)
        self.w2 = _empty(d_ff, d_model, device=device, dtype=dtype)
        if act in ("swiglu", "geglu"):
            self.w3 = _empty(d_model, d_ff, device=device, dtype=dtype)


def mlp_partial(p: MLP, x, act: str, dtype) -> torch.Tensor:
    """The MLP on ``p``'s local shards: the whole MLP on one rank, a
    column-parallel rank's partial sum under tensor parallelism (x already
    past "f")."""
    x = x.to(dtype)
    h = x @ tp.local(p.w1).to(dtype)
    if act == "swiglu":
        h = F.silu(h) * (x @ tp.local(p.w3).to(dtype))
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ tp.local(p.w3).to(dtype))
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ tp.local(p.w2).to(dtype)


def apply_mlp(p: MLP, x, act: str, dtype) -> torch.Tensor:
    """The MLP: column-parallel under tensor parallelism where its
    ``d_ff`` splits (:func:`repro_torch.models.tp.mlp_mode`)."""
    if tp.mlp_mode(p.w1.shape[-1], tp.size()) == "columns":
        return tp.reduce_from(mlp_partial(p, tp.copy_to(x), act, dtype))
    return mlp_partial(p, x, act, dtype)


# ----------------------------------------------------------------- embeddings
class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, device=None, dtype=torch.float32):
        super().__init__()
        self.table = _empty(vocab, d, device=device, dtype=dtype)


def _vocab_parallel(p: Embed) -> bool:
    return tp.vocab_sharded(p.table.shape[0], tp.size())


def embed(p: Embed, tokens: torch.Tensor, dtype) -> torch.Tensor:
    if _vocab_parallel(p):
        # vocab-parallel: this rank's rows, zero for the others' tokens,
        # summed over the ranks (each token's row from its one owner)
        table = tp.local(p.table)
        ids = tokens - tp.active().rank * table.shape[0]
        out = (ids < 0) | (ids >= table.shape[0])
        rows = table[torch.where(out, 0, ids)]
        return tp.reduce_from(torch.where(out[..., None], 0.0,
                                          rows).to(dtype))
    return p.table[tokens].to(dtype)


def unembed(p_embed: Embed, x, dtype, w_unembed=None) -> torch.Tensor:
    """Logits (..., vocab); vocab-parallel under tensor parallelism (this
    rank's columns, gathered whole)."""
    if _vocab_parallel(p_embed):
        w = (tp.local(w_unembed) if w_unembed is not None
             else tp.local(p_embed.table).T)
        return tp.gather(tp.copy_to(x).to(dtype) @ w.to(dtype), -1)
    w = w_unembed if w_unembed is not None else p_embed.table.T
    return x.to(dtype) @ w.to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in f32, with optional z-loss."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss > 0:
        loss = loss + z_loss * torch.mean(lse * lse)
    return loss
