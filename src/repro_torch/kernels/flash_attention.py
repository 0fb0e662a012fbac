"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
wrapper.

Replaces the JAX package's Pallas
``repro/kernels/flash_attention.py::flash_attention``.
:func:`flash_attention` launches the kernel for CUDA tensors and uses the
plain version (:func:`repro_torch.kernels.ref.attention_ref`) only for
tensors on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .build import check_launch, dtype_code, load_library, stream_of
from .ref import attention_ref

MAX_HEAD_DIM = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_valid_len: Optional[int] = None,
                    softmax_scale: Optional[float] = None,
                    block_k: int = 512) -> torch.Tensor:
    """Masked softmax attention; returns (B, Sq, H, Dh) in q's dtype.

    q: (B, Sq, H, Dh); k, v: (B, Sk, Hkv, Dh), H a multiple of Hkv (query
    head h reads KV head ``h // (H // Hkv)``).  Query i sits at position
    ``q_offset + i``, key j at j; key j is seen when ``j < kv_valid_len``,
    (causal) ``j <= query`` and (``window > 0``) ``j > query - window``.
    A row that sees no key is 0.  ``block_k`` is the plain version's KV
    block; the kernel tiles by its own.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_valid_len=kv_valid_len,
                             softmax_scale=softmax_scale, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if (k.shape != (b, sk, hkv, dh) or v.shape != k.shape
            or k.dtype != q.dtype or v.dtype != q.dtype
            or hkv == 0 or h % hkv):
        raise ValueError(f"q {tuple(q.shape)} {q.dtype}, k "
                         f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
                         f"{v.dtype}: need k, v (B, Sk, Hkv, Dh) of q's "
                         "dtype with H a multiple of Hkv")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM}")
    code = dtype_code(q)
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(dh))
    valid = sk if kv_valid_len is None else int(kv_valid_len)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel():
        lib = load_library()
        with torch.cuda.device(q.device):
            err = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, sq, sk, h, hkv, dh, int(q_offset), valid, int(window),
                int(bool(causal)), scale, code, stream_of(q))
        check_launch(lib, err, "flash_attention")
    return out
