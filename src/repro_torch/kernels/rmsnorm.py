"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

Replaces the JAX package's Pallas ``repro/kernels/rmsnorm.py::rmsnorm``.
:func:`rmsnorm` launches the kernel for CUDA tensors and uses the plain
version (:func:`repro_torch.kernels.ref.rmsnorm_ref`) only for tensors on
the CPU.
"""
from __future__ import annotations

import torch

from .build import check_launch, dtype_code, load_library, stream_of
from .ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis.

    x: (..., d) float32 or bfloat16; scale: (d,).  Computes in f32 and
    returns x's dtype, as the model's ``layers.rmsnorm`` does (the Pallas
    kernel always returns f32).
    """
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x.device}")
    code = dtype_code(x)
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale of shape {tuple(scale.shape)} for rows of "
                         f"width {d}")
    rows = x.reshape(-1, d).contiguous()
    w = scale.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(rows)
    if rows.numel():
        lib = load_library()
        with torch.cuda.device(x.device):
            err = lib.repro_rmsnorm(rows.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), rows.shape[0], d, eps,
                                    code, stream_of(x))
        check_launch(lib, err, "rmsnorm")
    return out.reshape(x.shape)
