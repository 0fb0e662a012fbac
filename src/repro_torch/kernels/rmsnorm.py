"""RMSNorm: the CUDA kernels ``csrc/rmsnorm.cu`` and their wrappers.

Replaces the JAX package's Pallas ``repro/kernels/rmsnorm.py::rmsnorm``.
:func:`rmsnorm` launches the kernel for CUDA tensors and uses the plain
version (:func:`repro_torch.kernels.ref.rmsnorm_ref`) only for tensors on
the CPU.  :func:`plan` picks the kernel's load width and CTA shape.

Training: when x or the scale needs a gradient, :func:`rmsnorm` runs as an
autograd function whose backward is :func:`rmsnorm_bwd`, the backward
kernel (plain :func:`repro_torch.kernels.ref.rmsnorm_bwd_ref` on the CPU).
The kernel's output would otherwise carry no graph: it is filled through
ctypes, out of autograd's sight.
"""
from __future__ import annotations

import functools
import sys
from typing import NamedTuple

import torch

from . import KernelModule
from .build import dtype_code, launch, sm_count
from .ref import rmsnorm_bwd_ref, rmsnorm_ref

# vectors a thread keeps in registers: 4 for narrow rows (a warp per row);
# wide rows take the fewest of 4, 8 and 16 that hold the row in 256
# threads (so ~1,000 rows of 5,120 f32 fit one wave of CTAs), or 16 in up
# to 512 threads (csrc/rmsnorm.cu)
WARP_ROW_VECTORS = 4
ROWS_PER_CTA = 4
WIDE_ROW_VECTORS = (4, 8, 16)
CTA_THREADS = 256
MAX_THREADS = 512
# the backward's CTAs (each sums its rows' dscale terms into a partial row)
BWD_CTAS_PER_SM = 2


class NormPlan(NamedTuple):
    """What the kernel runs for rows of one width: ``vec`` elements per
    load and store (16 bytes of x, or 1 when the row's byte width or a
    pointer does not allow it), ``per_thread`` vectors a thread holds,
    ``threads`` a CTA and ``rows_per_cta`` (one warp per row when above 1,
    else the whole CTA normalises one row); ``code`` packs them with the
    C codes of x's and the weight's types into the one int the C entry
    point takes (``NormArgs::plan`` in ``kernels.h``; one argument instead
    of six, as ctypes converts every argument on every call)."""
    vec: int
    per_thread: int
    threads: int
    rows_per_cta: int
    code: int


def pack(dtype: int, wdtype: int, vec: int, per_thread: int, threads: int,
         rows_per_cta: int) -> int:
    """``NormArgs::plan``: bits 0-1 the types, 2-7 vec, 8-12 per_thread,
    13-15 rows_per_cta, 16-26 threads."""
    return (dtype | wdtype << 1 | vec << 2 | per_thread << 8
            | rows_per_cta << 13 | threads << 16)


@functools.lru_cache(maxsize=256)
def plan(d: int, dtype: torch.dtype, wdtype: torch.dtype,
         aligned: bool = True) -> NormPlan:
    """The kernel's plan for rows of ``d`` elements of ``dtype`` and a
    weight of ``wdtype``; ``aligned``: x, the weight and the output lie on
    16-byte boundaries.  Raises for rows wider than a CTA can hold in
    registers, or for other types than float32 and bfloat16."""
    codes = dtype_code(dtype), dtype_code(wdtype)
    vec = 16 // dtype.itemsize
    if not aligned or d % vec:
        vec = 1
    nv = -(-d // vec)
    if nv <= 32 * WARP_ROW_VECTORS:
        k, threads, rows = WARP_ROW_VECTORS, 32 * ROWS_PER_CTA, ROWS_PER_CTA
    else:
        for k in WIDE_ROW_VECTORS:
            threads, rows = -(-nv // (32 * k)) * 32, 1
            if threads <= CTA_THREADS:
                break
        if threads > MAX_THREADS:
            raise ValueError(f"rmsnorm rows of {d} elements are wider than "
                             f"the kernel holds ({MAX_THREADS * k * vec})")
    return NormPlan(vec, k, threads, rows, pack(*codes, vec, k, threads, rows))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis.

    x: (..., d) float32 or bfloat16; scale: (d,) float32 or bfloat16 on
    x's device, read in its own dtype.  Computes in f32 and returns x's
    dtype, as the model's ``layers.rmsnorm`` does (the Pallas kernel always
    returns f32).  Differentiable (see the module's docstring).
    """
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x, scale = x.contiguous(), scale.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """The gradient of :func:`rmsnorm` given the output's gradient ``dy``
    (x's shape and dtype): ``(dx, dscale)``, dx in x's dtype, dscale in
    scale's.  dscale's sums over rows take a fixed order: the same inputs
    give the same bits."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rmsnorm_bwd_ref(x, scale, dy, eps)
        raise ValueError(f"rmsnorm_bwd runs on cuda or cpu, not {x.device}")
    d = x.shape[-1]
    if (scale.shape != (d,) or dy.shape != x.shape or dy.dtype != x.dtype
            or scale.get_device() != x.get_device()
            or dy.get_device() != x.get_device()):
        raise ValueError(f"x {tuple(x.shape)} {x.dtype}, dy "
                         f"{tuple(dy.shape)} {dy.dtype}, scale "
                         f"{tuple(scale.shape)}: need dy of x's shape and "
                         "dtype and scale (d,), on x's device")
    x, dy, scale = x.contiguous(), dy.contiguous(), scale.contiguous()
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if not rows:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    parts = min(rows, BWD_CTAS_PER_SM * sm_count(x.get_device()))
    partial = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    types = dtype_code(x.dtype) | dtype_code(scale.dtype) << 1
    launch("rmsnorm_bwd", x, "repro_rmsnorm_bwd", x.data_ptr(),
           scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
           partial.data_ptr(), rows, d, parts, eps, types)
    return dx, dscale


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float):
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rmsnorm_ref(x, scale, eps)
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x.device}")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.get_device() != x.get_device():
        raise ValueError(f"scale of shape {tuple(scale.shape)} on "
                         f"{scale.device} for rows of width {d} on "
                         f"{x.device}")
    x = x.contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:
        xp, wp, op = x.data_ptr(), scale.data_ptr(), out.data_ptr()
        code = plan(d, x.dtype, scale.dtype, (xp | wp | op) % 16 == 0).code
        launch("rmsnorm", x, "repro_rmsnorm", xp, wp, op, rows, d, eps, code)
    return out


# one name for the module and its wrapper: calling the module calls it
sys.modules[__name__].__class__ = KernelModule
