"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` and their
wrapper.

Replaces the JAX package's Pallas
``repro/kernels/flash_attention.py::flash_attention``.
:func:`flash_attention` launches a kernel for CUDA tensors and uses the
plain version (:func:`repro_torch.kernels.ref.attention_ref`) only for
tensors on the CPU.  :func:`plan` picks the kernel's variant: split-KV
decode when ``Sq * (H / Hkv) <= 16`` and V is as wide as K, the tensor-core
prefill otherwise.  V may be narrower than K (MLA: 192-wide keys, 128-wide
values); the prefill variant then runs P V and writes the output at V's
width, so V is never padded to K's.

Training: when q, k or v needs a gradient, :func:`flash_attention` runs as
an autograd function.  Its forward is the prefill variant, asked to write
each row's log-sum-exp as well; its backward is :func:`flash_attention_bwd`,
the kernels of ``csrc/flash_attention_bwd.cu`` (bf16 on Hopper's ``wgmma``,
f32 on split-TF32 ``mma.sync``; :func:`bwd_plan` mirrors their launch;
plain :func:`repro_torch.kernels.ref.attention_bwd_ref` on the CPU).  A
query offset and a valid length are decode's alone and are refused there.
"""
from __future__ import annotations

import functools
import math
import sys
from dataclasses import dataclass
from typing import Optional

import torch

from . import KernelModule
from .build import dtype_code, launch
from .ref import attention_bwd_ref, attention_ref

MAX_HEAD_DIM = 256
# a CTA's dynamic shared memory on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
# the kernel's constants (flash_attention.cu)
PREFILL_BLOCK_Q = 64
DECODE_BLOCK_K = 32
DECODE_ROWS = 16
# the decode variant aims at 4 CTAs on each of the 132 SMs
DECODE_CTAS = 4 * 132
MAX_SPLITS = 256


@dataclass(frozen=True)
class AttnPlan:
    """What the kernel runs for one call: ``variant`` "prefill" or
    "decode", the key and value head dims padded to 16, the KV tile, the
    decode split count (0 in prefill) and the CTA's shared memory in
    bytes."""
    variant: str
    d_pad: int
    block_k: int
    n_split: int
    smem_bytes: int
    dv_pad: int


@functools.lru_cache(maxsize=1024)
def plan(b: int, sq: int, sk: int, h: int, hkv: int, dh: int,
         elem_bytes: int, *, dv: Optional[int] = None, causal: bool = True,
         window: int = 0, q_offset: int = 0,
         kv_valid: Optional[int] = None) -> AttnPlan:
    """The variant, tiles, split count and shared memory of one call
    (``launch_typed`` and the ``*_smem_bytes`` functions of the kernel).
    ``dv`` is V's head dim (``dh`` when None); the decode variant needs
    it equal to ``dh``."""
    d_pad = -(-dh // 16) * 16
    dv = dh if dv is None else dv
    dv_pad = -(-dv // 16) * 16
    f32 = elem_bytes == 4
    if sq * (h // hkv) <= DECODE_ROWS and dv == dh:
        # [lo, hi): the keys some query of the call sees
        lo = max(0, q_offset - window + 1) if window > 0 else 0
        hi = min(sk if kv_valid is None else kv_valid, sk)
        if causal:
            hi = min(hi, q_offset + sq)
        tiles = -(-max(hi - lo, 0) // DECODE_BLOCK_K)
        n_split = max(1, min(-(-DECODE_CTAS // max(b * hkv, 1)), tiles,
                             MAX_SPLITS))
        ks = d_pad + (4 if f32 else 8)
        smem = (elem_bytes * 2 * DECODE_BLOCK_K * (ks + d_pad + 8)
                + 4 * (DECODE_ROWS * d_pad + DECODE_ROWS * DECODE_BLOCK_K
                       + 3 * DECODE_ROWS))
        return AttnPlan("decode", d_pad, DECODE_BLOCK_K, n_split, smem,
                        dv_pad)
    if f32:   # row strides: Q, K 16 words mod 32; V 4 mod 8
        qk, vv = d_pad + (16 if d_pad % 32 == 0 else 0), dv_pad + 4
    else:
        qk, vv = d_pad + 8, dv_pad + 8
    block_k = 32 if f32 else 64
    smem = elem_bytes * (PREFILL_BLOCK_Q * qk + 2 * block_k * (qk + vv))
    return AttnPlan("prefill", d_pad, block_k, 0, smem, dv_pad)


# the backward's constants (flash_attention_bwd.cu): the bf16 route's ring
# slots, warpgroup rows and dQ key tile, the f32 route's tiles
BWD_STAGES = 2
BWD_WG_ROWS = 64
BWD_DQ_KEYS = 32
BWD_F32_KEYS = 64
BWD_F32_TILE = 32


@dataclass(frozen=True)
class AttnBwdPlan:
    """What the backward runs for one call (``launch_bwd_typed`` and the
    ``*_smem_bytes`` functions of ``flash_attention_bwd.cu``): ``route``
    "wgmma" (bf16) or "mma.sync" (f32, split TF32); the key and value head
    dims as the kernels pad them; the dK / dV kernel's warpgroups, keys a
    CTA, query tile, whether its CTA splits dK from dV (bf16: two groups
    share the keys, one accumulating each; f32: half the CTAs each), CTAs
    and shared memory; the dQ kernel's queries and key tile a CTA, CTAs
    and shared memory; the ring's slots (1: a tile is waited for before
    its products); the kernels a call launches (delta, dK / dV, dQ) and
    the dK / dV launches among them."""
    route: str
    d_pad: int
    dv_pad: int
    kv_warpgroups: int
    kv_keys: int
    kv_query_tile: int
    kv_split: bool
    kv_ctas: int
    kv_smem_bytes: int
    dq_queries: int
    dq_key_tile: int
    dq_ctas: int
    dq_smem_bytes: int
    stages: int
    kernels: int
    kv_launches: int


@functools.lru_cache(maxsize=1024)
def bwd_plan(b: int, sq: int, sk: int, h: int, hkv: int, dh: int,
             elem_bytes: int, *, dv: Optional[int] = None) -> AttnBwdPlan:
    """The backward's kernels, tiles and shared memory for one call
    (``dv``: V's head dim, ``dh`` when None)."""
    dv = dh if dv is None else dv
    kernels = int(sq > 0) + int(sk > 0) + int(sq > 0)
    if elem_bytes == 2:
        d_pad, dv_pad = -(-dh // 64) * 64, -(-dv // 64) * 64
        if d_pad <= 128:
            d_pad = dv_pad = d_pad
        elif dv_pad > 128:
            d_pad = dv_pad = 256
        else:
            dv_pad = 128
        split = d_pad > 128
        slot = 2 * BWD_WG_ROWS * (d_pad + dv_pad) + 1024
        kv_smem = (1024 + 2 * BWD_WG_ROWS * (d_pad + dv_pad)
                   + BWD_STAGES * slot
                   + (2 * 2 * BWD_WG_ROWS ** 2 if split else 0))
        dq_smem = (1024 + 2 * BWD_WG_ROWS * (d_pad + dv_pad)
                   + BWD_STAGES * 2 * BWD_DQ_KEYS * (d_pad + dv_pad))
        return AttnBwdPlan(
            "wgmma", d_pad, dv_pad, 2 if split else 1, BWD_WG_ROWS,
            BWD_WG_ROWS, split, -(-sk // BWD_WG_ROWS) * hkv * b, kv_smem,
            BWD_WG_ROWS, BWD_DQ_KEYS, -(-sq // BWD_WG_ROWS) * h * b, dq_smem,
            BWD_STAGES, kernels, 1)
    dp, dvp = -(-dh // 16) * 16, -(-dv // 16) * 16
    bucket = (64 if dp <= 64 else 96 if dp <= 96 else 128 if dp <= 128
              else 256)
    split = bucket > 128
    # row strides as qk_stride<float>: 16 words mod 32
    qk, vv = (x + (16 if x % 32 == 0 else 0) for x in (dp, dvp))
    smem = (elem_bytes * (BWD_F32_KEYS + BWD_F32_TILE) * (qk + vv)
            + 2 * BWD_F32_TILE * 4)
    tiles = -(-sk // BWD_F32_KEYS)
    return AttnBwdPlan(
        "mma.sync", dp, dvp, 1, BWD_F32_KEYS, BWD_F32_TILE, split,
        (2 if split else 1) * tiles * hkv * b, smem, PREFILL_BLOCK_Q,
        BWD_F32_TILE, -(-sq // PREFILL_BLOCK_Q) * h * b, smem, 1, kernels, 1)


def bwd_query_range(k0: int, nk: int, sq: int, causal: bool, window: int,
                    tile: int) -> tuple:
    """``[q_begin, q_end)``: the queries the dK / dV kernel walks for keys
    ``[k0, k0 + nk)``, in tiles of ``tile`` from ``q_begin``."""
    q_begin = (k0 if causal else 0) // tile * tile
    q_end = min(sq, k0 + nk - 1 + window) if window > 0 else sq
    return q_begin, q_end


def bwd_key_range(q0: int, rows: int, sk: int, causal: bool, window: int,
                  tile: int) -> tuple:
    """``[k_begin, k_end)``: the keys the dQ kernel walks for queries
    ``[q0, q0 + rows)``, in tiles of ``tile`` from ``k_begin``."""
    k_end = min(sk, q0 + rows) if causal else sk
    k_begin = max(0, q0 - window + 1) // tile * tile if window > 0 else 0
    return k_begin, k_end


def bwd_kv_block(q0: int, nq: int, kw_lo: int, w_rows: int, causal: bool,
                 window: int) -> tuple:
    """``(live, masked)`` of a bf16 dK / dV warpgroup for the query tile
    at ``q0`` (``nq`` valid rows of 64) and its keys ``[kw_lo, kw_lo +
    w_rows)``: whether it runs the tile's products, and whether it masks
    each score (else every computed pair is seen: a query past the last
    has lse = +inf, so none is masked for the ragged edge)."""
    kw_hi = kw_lo + w_rows - 1
    live = w_rows > 0 and nq > 0
    if causal:
        live = live and q0 + nq - 1 >= kw_lo
    if window > 0:
        live = live and q0 < kw_hi + window
    masked = ((causal and q0 < kw_hi)
              or (window > 0 and q0 + BWD_WG_ROWS - 1 - window >= kw_lo))
    return live, masked


def bwd_q_block(k0: int, tile: int, q0: int, rows: int, sk: int,
                causal: bool, window: int) -> tuple:
    """``(live, masked)`` of a bf16 dQ warpgroup (queries ``[q0, q0 +
    rows)``) for the key tile ``[k0, k0 + tile)``; past the last key a
    score is masked, since keys are summed over."""
    q_hi = q0 + rows - 1
    live = rows > 0
    if causal:
        live = live and k0 <= q_hi
    if window > 0:
        live = live and k0 + tile - 1 > q0 - window
    masked = ((causal and k0 + tile - 1 > q0)
              or (window > 0 and k0 <= q_hi - window) or k0 + tile > sk)
    return live, masked


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q is (B, Sq, H, Dh), k (B, Sk, Hkv, Dh) and v
    (B, Sk, Hkv, Dv) with Dv <= Dh <= ``MAX_HEAD_DIM`` and H a multiple of
    Hkv: the shapes the kernel takes (on the CPU too)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: need rank-4 tensors")
    b, _, h, dh = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape != (b, sk, hkv, dh) or v.shape != (b, sk, hkv, dv)
            or hkv == 0 or h % hkv or not 0 < dv <= dh):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: need k (B, Sk, Hkv, Dh) and v "
                         "(B, Sk, Hkv, Dv) with Dv <= Dh and H a multiple "
                         "of Hkv")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_valid_len: Optional[int] = None,
                    softmax_scale: Optional[float] = None,
                    block_k: int = 512) -> torch.Tensor:
    """Masked softmax attention; returns (B, Sq, H, Dv) in q's dtype.

    q: (B, Sq, H, Dh); k: (B, Sk, Hkv, Dh); v: (B, Sk, Hkv, Dv) with
    Dv <= Dh; H a multiple of Hkv (query head h reads KV head
    ``h // (H // Hkv)``).  Query i sits at position ``q_offset + i``, key
    j at j; key j is seen when ``j < kv_valid_len``, (causal) ``j <=
    query`` and (``window > 0``) ``j > query - window``.
    A row that sees no key is 0.  ``block_k`` is the plain version's KV
    block; the kernel tiles by its own.  Differentiable (see the module's
    docstring) with ``q_offset`` 0 and no ``kv_valid_len``.
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    check_shapes(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset or kv_valid_len is not None:
            raise ValueError(
                f"q_offset {q_offset} / kv_valid_len {kv_valid_len}: the "
                "attention backward takes neither (they are decode's)")
        return _Attention.apply(q, k, v, bool(causal), int(window),
                                _scale(q, softmax_scale))
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_valid_len=kv_valid_len,
                             softmax_scale=softmax_scale, block_k=block_k)
    _check_dtypes(q, k, v)
    b, sq, h, dh = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    valid = sk if kv_valid_len is None else int(kv_valid_len)
    p = plan(b, sq, sk, h, hkv, dh, q.element_size(), dv=dv,
             causal=bool(causal), window=int(window), q_offset=int(q_offset),
             kv_valid=valid)
    return _launch(q, k, v, causal, window, int(q_offset), valid,
                   _scale(q, softmax_scale), p.n_split)[0]


def _scale(q, softmax_scale):
    return (softmax_scale if softmax_scale is not None
            else 1.0 / math.sqrt(q.shape[-1]))


def _check_dtypes(*ts):
    if any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{', '.join(str(t.dtype) for t in ts)}: need "
                         "every tensor in q's dtype")


def _launch(q, k, v, causal, window, q_offset, valid, scale, n_split,
            want_lse=False):
    """One launch of the forward kernel: ``(out, lse)``, ``lse`` (B, H, Sq)
    f32 from the prefill variant (``n_split`` 0) when ``want_lse``, else
    None."""
    b, sq, h, dh = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = q.new_empty((b, sq, h, dv))
    scratch = lse = None
    if n_split:
        scratch = torch.empty((b, h, sq, n_split, dh + 2),
                              dtype=torch.float32, device=q.device)
    if want_lse:
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.numel():
        launch("flash_attention", q, "repro_flash_attention", q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(),
               None if scratch is None else scratch.data_ptr(),
               None if lse is None else lse.data_ptr(), b, sq, sk, h, hkv,
               dh, dv, q_offset, valid, int(window), int(bool(causal)),
               scale, n_split, dtype_code(q.dtype))
    return out, lse


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             window: int = 0, softmax_scale=None):
    """The training forward: ``(out, lse)``, ``lse`` (B, H, Sq) f32 each
    row's log-sum-exp of its scaled scores (+inf for a row that sees no
    key), from the prefill variant (``q_offset`` 0, every key valid).  The
    autograd function's forward, without the graph."""
    check_shapes(q, k, v)
    scale = _scale(q, softmax_scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softmax_scale=scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_dtypes(q, k, v)
    return _launch(q, k, v, causal, window, 0, k.shape[1], scale, 0,
                   want_lse=True)


class _Attention(torch.autograd.Function):
    """Attention with the backward kernels as its gradient: the forward
    keeps q, k, v, the output and the rows' log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window,
                                            softmax_scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, do):
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors, do,
                                         causal=causal, window=window,
                                         softmax_scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softmax_scale=None):
    """The gradient of :func:`flash_attention` (``q_offset`` 0, every key
    valid) given its output ``o``, the rows' log-sum-exp ``lse`` (B, H, Sq)
    f32 and the output's gradient ``do``: ``(dq, dk, dv)`` in the inputs'
    dtype.  Deterministic: no atomics, so the same inputs give the same
    bits."""
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window, softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    b, sq, h, dh = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (o.shape != (b, sq, h, dv) or do.shape != o.shape
            or lse.shape != (b, h, sq) or lse.dtype != torch.float32):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}: need o and do "
                         f"{(b, sq, h, dv)} and lse {(b, h, sq)} float32")
    _check_dtypes(q, k, v, o, do)
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    if not (b and h):
        return dq, dk, dvv
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    launch("flash_attention_bwd", q, "repro_flash_attention_bwd",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
           dk.data_ptr(), dvv.data_ptr(), b, sq, sk, h, hkv, dh, dv,
           int(window), int(bool(causal)), _scale(q, softmax_scale),
           dtype_code(q.dtype))
    return dq, dk, dvv


# one name for the module and its wrapper: calling the module calls it
sys.modules[__name__].__class__ = KernelModule
