"""Mamba-2 SSD scan: the CUDA kernels ``csrc/ssd_scan.cu`` and their wrapper.

Replaces the JAX package's Pallas ``repro/kernels/ssd_scan.py::ssd_scan``.
:func:`ssd_scan` launches the kernels for CUDA tensors and uses the plain
version (:func:`repro_torch.kernels.ref.ssd_ref`) only for tensors on the
CPU.  :func:`plan` picks the chunk length and the heads a chunk-scan CTA
serves.
"""
from __future__ import annotations

import functools
import sys
from dataclasses import dataclass

import torch

from . import KernelModule
from .build import dtype_code, launch
from .ref import ssd_ref

# a CTA's dynamic shared memory on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
# the kernels' limits (csrc/ssd_scan.cu): 8 row tiles of 16 steps, and the
# head dim of the output accumulator
MAX_CHUNK = 128
MAX_HEADDIM = 128
# the card's SMs: a chunk-scan CTA (one an SM at the serve shape) computes
# C B^T once for the heads it serves, so the scan kernel takes one wave of
# CTAs, or as many waves as it takes to give every chunk one
SMS = 132


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(L: int, P: int, N: int) -> int:
    """Shared memory of the larger CTA of the kernels' two tile kernels
    (``scan_smem_bytes`` and ``state_smem_bytes`` in the source)."""
    lt, pp, np_ = _pad16(L), _pad16(P), _pad16(N)
    fs = np_ + 16 if np_ % 32 == 0 else np_
    xs = pp + 4
    scan = lt * (lt + 8) + lt * fs + max(lt * fs, lt * xs) + pp * fs + 2 * lt
    state = lt * xs + lt * (np_ + 4) + 3 * lt
    return 4 * max(scan, state)


def kernel_chunk(chunk: int, S: int, P: int, N: int) -> int:
    """The kernels' chunk length: ``chunk`` (no longer than the sequence
    or 128), halved until a CTA's shared memory holds it.  The scan's
    result does not depend on it."""
    L = max(1, min(chunk, S, MAX_CHUNK))
    while L > 1 and smem_bytes(L, P, N) > MAX_SMEM_BYTES:
        L //= 2
    if smem_bytes(L, P, N) > MAX_SMEM_BYTES:
        raise ValueError(f"headdim {P} x dstate {N} does not fit the SSD "
                         "kernel's shared memory")
    return L


@dataclass(frozen=True)
class SsdPlan:
    """What one call runs: the chunk length and count, the most heads a
    chunk-scan CTA serves, the CTAs of the chunk-state and chunk-scan
    kernels, and the larger CTA's shared memory in bytes."""
    chunk: int
    n_chunks: int
    heads_per_cta: int
    state_ctas: int
    scan_ctas: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def plan(b: int, s: int, h: int, p: int, n: int, chunk: int = 128) -> SsdPlan:
    """The plan of a call on x (b, s, h, p) and B, C (b, s, n).  The scan
    CTAs are spread over the b * n_chunks chunks as evenly as they go, and
    a chunk's CTAs split its heads as evenly as they go (csrc/ssd_scan.cu,
    scan_kernel)."""
    L = kernel_chunk(chunk, s, p, n)
    nc = -(-s // L)
    q = b * nc
    k = min(q * h, SMS * -(-q // SMS))
    heads = -(-h // (k // q)) if q else 0
    return SsdPlan(L, nc, heads, q * h, k, smem_bytes(L, p, n))


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, initial_state=None):
    """Chunked SSD scan; returns (y (B, S, H, P) f32, state (B, H, P, N) f32).

    x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) positive decay
    rates; b, c: (B, S, N) shared across heads; initial_state: (B, H, P, N)
    or None.  x, dt, b, c are float32 or bfloat16, of one dtype; P <= 128.
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return ssd_ref(x, dt, a, b, c, chunk=chunk,
                           initial_state=initial_state)
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if (dt.shape != (bsz, s, h) or a.shape != (h,) or b.shape != (bsz, s, n)
            or c.shape != b.shape
            or any(t.dtype != x.dtype for t in (dt, b, c))):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}: shapes or dtypes disagree")
    if p > MAX_HEADDIM:
        raise ValueError(f"headdim {p} > {MAX_HEADDIM}")
    code = dtype_code(x.dtype)
    pl = plan(bsz, s, h, p, n, chunk)
    x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
    a = a.to(device=x.device, dtype=torch.float32).contiguous()
    init = None
    if initial_state is not None:
        if initial_state.shape != (bsz, h, p, n):
            raise ValueError(f"initial_state {tuple(initial_state.shape)} "
                             f"!= {(bsz, h, p, n)}")
        init = initial_state.to(device=x.device,
                                dtype=torch.float32).contiguous()
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz and h:
        # the chunks' states (B, NC, H, P, N), then their last cumsums
        scratch = None
        if pl.n_chunks:
            scratch = torch.empty(bsz * pl.n_chunks * h * (p * n + 1),
                                  dtype=torch.float32, device=x.device)
        launch("ssd_scan", x, "repro_ssd_scan", x.data_ptr(), dt.data_ptr(),
               a.data_ptr(), b.data_ptr(), c.data_ptr(),
               None if init is None else init.data_ptr(), y.data_ptr(),
               state.data_ptr(),
               None if scratch is None else scratch.data_ptr(), bsz, s, h, p,
               n, pl.chunk, pl.scan_ctas, code)
    return y, state


# one name for the module and its wrapper: calling the module calls it
sys.modules[__name__].__class__ = KernelModule
