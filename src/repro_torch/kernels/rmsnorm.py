"""RMSNorm: the CUDA kernels ``csrc/rmsnorm.cu`` (forward) and
``csrc/rmsnorm_bwd.cu`` (backward) and their wrappers.

Replaces the JAX package's Pallas ``repro/kernels/rmsnorm.py::rmsnorm``.
:func:`rmsnorm` launches the kernel for CUDA tensors and uses the plain
version (:func:`repro_torch.kernels.ref.rmsnorm_ref`) only for tensors on
the CPU.  :func:`plan` picks the kernel's load width and CTA shape.

Training: when x or the scale needs a gradient, :func:`rmsnorm` runs as an
autograd function whose backward is :func:`rmsnorm_bwd`, the backward
kernel (plain :func:`repro_torch.kernels.ref.rmsnorm_bwd_ref` on the CPU).
The kernel's output would otherwise carry no graph: it is filled through
ctypes, out of autograd's sight.  :func:`bwd_plan` picks the backward's
load width, threads, CTAs and cluster.
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
# the backward (csrc/rmsnorm_bwd.cu): the vectors of a row a thread may
# hold, by load width (1: scalar accesses; 4: f32; 8: bf16).  A thread holds
# at most BWD_HELD elements of x (and of dy) while its row fits
# BWD_MAX_THREADS threads that way, else twice as many; a row wider than
# that (past 16,384 elements) is walked twice by a CTA of BWD_MAX_THREADS,
# each thread taking up to BWD_STREAM_VECTORS vectors in turn (depth 0)
BWD_VECTORS = {1: (4, 16, 32), 4: (1, 2, 4, 8), 8: (1, 2, 4)}
BWD_HELD = 16
BWD_STREAM_VECTORS = 32
# a thread's two rows of x and dy (the next row loads while one is
# reduced) and its column sums in at most this many 32-bit registers, else
# one row at a time
BWD_HELD_REGISTERS = 96
# narrow rows take a warp each, BWD_WARP_ROWS a CTA; a wide row takes a CTA
# of the fewest vectors a thread, but 2 of 16 bytes, that hold it in up to
# BWD_ROW_THREADS threads, the most elements a thread otherwise
BWD_WARP_ROWS = 8
BWD_ROW_THREADS = 320
BWD_MAX_THREADS = 512
# a persistent grid: up to BWD_CTAS_PER_SM CTAs an SM, of at most
# BWD_THREADS_PER_SM threads and the SM's 65,536 registers together (the
# kernels' registers a thread from ptxas on the card: BWD_REGISTERS by (x's
# bytes, vec, vectors a thread), 128 -- the launch bound's most -- for the
# rest; a stale count sizes the grid worse, it covers the rows all the
# same); in clusters of BWD_CLUSTER CTAs, which the card spreads evenly
# (clusters of 8 left some SMs empty and others with 3 CTAs), or, for a
# grid of at most 8 CTAs, one cluster.  Chosen from device times of
# hand-made plans on the card (chip_smoke.py --phases rmsnorm-plans)
BWD_CTAS_PER_SM = 4
BWD_THREADS_PER_SM = 768
BWD_REGISTERS = {(4, 4, 1): 64, (4, 4, 2): 80, (2, 8, 1): 64}
BWD_CLUSTER = 2
BWD_MAX_CLUSTER = 8
# the column-sum kernel adds the partial rows in BWD_DW_GROUPS interleaved
# runs: no thread adds more than partials / BWD_DW_GROUPS in a row
BWD_DW_GROUPS = 8
# dynamic shared memory: two slots of a row's two sums for 32 warps, then
# the CTA's column sums
BWD_SMEM_HEAD = 2 * 2 * 32 * 4
MAX_SMEM_BYTES = 232_448


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


class BwdPlan(NamedTuple):
    """What the backward kernel runs for ``rows`` rows of ``d`` elements:
    ``vec`` elements a load, ``per_thread`` vectors of a row a thread
    takes, ``threads`` a CTA, ``row_threads`` a row (32: a warp a row, the
    CTA's ``threads / 32`` rows at a time; else the CTA's own), ``ctas`` in
    clusters of ``cluster``, ``partials`` partial rows (one a cluster, which
    a second kernel adds up), the CTA's dynamic shared memory; ``depth``:
    the rows of x and dy a thread holds at once, 2 (the next row's loads
    are issued before a row is reduced) where ``held_registers`` (32-bit
    registers of those rows and the f32 column sums) stay within
    BWD_HELD_REGISTERS, else 1, or 0 for a row too wide for the registers,
    which a CTA walks twice (its column sums in its own partial row, no
    registers held across rows); ``code`` packs the launch's choices into
    the one int the C entry point takes (``NormBwdArgs`` in
    ``kernels.h``)."""
    vec: int
    per_thread: int
    threads: int
    row_threads: int
    ctas: int
    cluster: int
    partials: int
    smem_bytes: int
    depth: int
    held_registers: int
    code: int


def bwd_pack(dtype: int, wdtype: int, vec: int, per_thread: int,
             cluster: int, threads: int, warp_rows: bool, depth: int) -> int:
    """``NormBwdArgs``' plan: bits 0-1 the types, 2-5 vec, 6-11 per_thread,
    12-15 cluster, 16-26 threads, 27 a warp a row, 28-29 depth."""
    return (dtype | wdtype << 1 | vec << 2 | per_thread << 6 | cluster << 12
            | threads << 16 | int(warp_rows) << 27 | depth << 28)


def make_bwd_plan(rows: int, d: int, dtype: torch.dtype,
                  wdtype: torch.dtype, vec: int, per_thread: int,
                  threads: int, warp_rows: bool, ctas: int,
                  cluster: int, depth: int | None = None) -> BwdPlan:
    """A backward plan as given (the C launch re-checks it); tests and the
    smoke's plan comparisons make their own this way.  ``depth`` None: 2
    or 1 by the register budget; 0: the row walked twice."""
    codes = dtype_code(dtype), dtype_code(wdtype)
    row = per_thread * -(-vec * dtype.itemsize // 4)
    sums = per_thread * vec
    if depth is None:
        depth = 2 if 4 * row + sums <= BWD_HELD_REGISTERS else 1
    return BwdPlan(vec, per_thread, threads, 32 if warp_rows else threads,
                   ctas, cluster, ctas // cluster,
                   BWD_SMEM_HEAD + (4 * d if depth else 0), depth,
                   2 * depth * row + sums if depth else 0,
                   bwd_pack(*codes, vec, per_thread, cluster, threads,
                            warp_rows, depth))


def bwd_row_shape(rows: int, nv: int, k: int):
    """``(threads, warp_rows, groups)`` of a CTA whose threads hold ``k``
    vectors of a row of ``nv``: a warp a row (up to BWD_WARP_ROWS rows a
    CTA) where 32 threads hold it, else the CTA's threads a row."""
    if nv <= 32 * k:
        groups = min(BWD_WARP_ROWS, rows)
        return 32 * groups, True, groups
    return -(-nv // (32 * k)) * 32, False, 1


def bwd_grid(rows: int, groups: int, per_sm: int, sms: int,
             cluster: int | None = None):
    """``(ctas, cluster)`` of a persistent grid of up to ``per_sm`` CTAs an
    SM, ``groups`` rows at a time a CTA: whole clusters of ``cluster``
    (None: BWD_CLUSTER, or one cluster, a power of 2, for a grid of at
    most BWD_MAX_CLUSTER CTAs, some of them idle)."""
    ctas = min(-(-rows // groups), per_sm * sms)
    if cluster is None:
        if ctas <= BWD_MAX_CLUSTER:
            cluster = 1 << (ctas - 1).bit_length()
            return cluster, cluster
        cluster = BWD_CLUSTER
    return max(cluster, ctas - ctas % cluster), cluster


def bwd_per_sm(threads: int, regs: int) -> int:
    """CTAs an SM of ``threads`` threads of ``regs`` registers."""
    return max(1, min(BWD_CTAS_PER_SM, BWD_THREADS_PER_SM // threads,
                      65536 // (threads * regs)))


@functools.lru_cache(maxsize=256)
def bwd_plan(rows: int, d: int, dtype: torch.dtype, wdtype: torch.dtype,
             sms: int, aligned: bool = True) -> BwdPlan:
    """The backward kernel's plan for ``rows`` rows of ``d`` elements of
    ``dtype`` and a scale of ``wdtype`` on a card of ``sms`` SMs;
    ``aligned``: x, dy, dx and the scale lie on 16-byte boundaries.  Rows
    wider than BWD_MAX_THREADS threads hold are walked twice (depth 0).
    Raises for rows wider than that walk takes (BWD_STREAM_VECTORS vectors
    a thread: 65,536 f32, 131,072 bf16, 16,384 of scalar accesses; the
    forward's :func:`plan` takes at most half of that), or for other types
    than float32 and bfloat16."""
    dtype_code(dtype), dtype_code(wdtype)
    vec = 16 // dtype.itemsize
    if not aligned or d % vec:
        vec = 1
    nv = d // vec
    ks = BWD_VECTORS[vec]
    held = [k for k in ks if k * vec <= BWD_HELD]
    if nv > BWD_MAX_THREADS * ks[-1]:     # the row walked twice
        threads = BWD_MAX_THREADS
        k = -(-nv // threads)
        if k > BWD_STREAM_VECTORS:
            raise ValueError(
                f"rmsnorm backward rows of {d} elements are wider than "
                f"the kernel takes ({BWD_MAX_THREADS * BWD_STREAM_VECTORS}"
                f" x {vec})")
        ctas = min(rows, bwd_per_sm(threads, 128) * sms)
        return make_bwd_plan(rows, d, dtype, wdtype, vec, k, threads, False,
                             ctas, 1, depth=0)
    if nv <= 32 * held[-1]:
        k = next(k for k in held if 32 * k >= nv)
    else:
        for k in held[held.index(2):] if 2 in held else held:
            if bwd_row_shape(rows, nv, k)[0] <= BWD_ROW_THREADS:
                break
        else:
            k = next(k for k in (held[-1], ks[-1])
                     if bwd_row_shape(rows, nv, k)[0] <= BWD_MAX_THREADS)
    threads, warp_rows, groups = bwd_row_shape(rows, nv, k)
    regs = BWD_REGISTERS.get((dtype.itemsize, vec, k), 128)
    ctas, cluster = bwd_grid(rows, groups, bwd_per_sm(threads, regs), sms)
    return make_bwd_plan(rows, d, dtype, wdtype, vec, k, threads, warp_rows,
                         ctas, cluster)


def bwd_kernel_args(x, scale, dy, dx, dscale, partial, plan: BwdPlan,
                    eps: float):
    """The C entry point's arguments but the stream (x, dy, dx: (rows, d)
    contiguous; ``partial``: f32 (plan.partials, d))."""
    d = x.shape[-1]
    return (x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), partial.data_ptr(), x.numel() // d, d,
            plan.ctas, eps, plan.code)


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
    scale's.  dscale's sums over rows take an order fixed by the plan
    (:func:`bwd_plan`): the same inputs give the same bits."""
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
    aligned = (x.data_ptr() | dy.data_ptr() | dx.data_ptr()
               | scale.data_ptr()) % 16 == 0
    plan = bwd_plan(rows, d, x.dtype, scale.dtype, sm_count(x.get_device()),
                    aligned)
    partial = torch.empty((plan.partials, d), dtype=torch.float32,
                          device=x.device)
    launch("rmsnorm_bwd", x, "repro_rmsnorm_bwd",
           *bwd_kernel_args(x, scale, dy, dx, dscale, partial, plan, eps))
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
