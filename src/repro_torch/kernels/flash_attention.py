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
from .ref import attention_ref

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
    block; the kernel tiles by its own.
    """
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_valid_len=kv_valid_len,
                             softmax_scale=softmax_scale, block_k=block_k)
    b, sq, h, dh = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: need k "
                         "and v of q's dtype")
    code = dtype_code(q.dtype)
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(dh))
    valid = sk if kv_valid_len is None else int(kv_valid_len)
    p = plan(b, sq, sk, h, hkv, dh, q.element_size(), dv=dv,
             causal=bool(causal), window=int(window), q_offset=int(q_offset),
             kv_valid=valid)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = q.new_empty((b, sq, h, dv))
    scratch = None
    if p.n_split:
        scratch = torch.empty((b, h, sq, p.n_split, dh + 2),
                              dtype=torch.float32, device=q.device)
    if q.numel():
        launch("flash_attention", q, "repro_flash_attention", q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(),
               None if scratch is None else scratch.data_ptr(), b, sq, sk, h,
               hkv, dh, dv, int(q_offset), valid, int(window),
               int(bool(causal)), scale, p.n_split, code)
    return out


# one name for the module and its wrapper: calling the module calls it
sys.modules[__name__].__class__ = KernelModule
