"""Mamba-2 SSD scan: the CUDA kernels ``csrc/ssd_scan.cu`` (forward) and
``csrc/ssd_scan_bwd.cu`` (backward) and their wrappers.

Replaces the JAX package's Pallas ``repro/kernels/ssd_scan.py::ssd_scan``.
:func:`ssd_scan` launches the kernels for CUDA tensors and uses the plain
version (:func:`repro_torch.kernels.ref.ssd_ref`) only for tensors on the
CPU.  :func:`plan` picks the chunk length and the heads a chunk-scan CTA
serves.

Training: when an input needs a gradient, :func:`ssd_scan` runs as an
autograd function whose backward is :func:`ssd_scan_bwd`, the backward
kernels (plain :func:`repro_torch.kernels.ref.ssd_bwd_ref` on the CPU).
Its forward (:func:`ssd_scan_with_states`) runs at the chunk length the
backward's shared memory allows (:func:`bwd_plan`) and keeps the forward's
scratch, the states before each chunk and the chunks' last cumsums, for
the backward.  The gradients do not depend on the chunk length but by
rounding.
"""
from __future__ import annotations

import functools
import sys
from dataclasses import dataclass

import torch

from . import KernelModule
from .build import dtype_code, launch
from .ref import ssd_bwd_ref, ssd_ref

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
# the backward (csrc/ssd_scan_bwd.cu): chunk <= 64 (4 row tiles of 16
# steps), dstate <= 128; a state CTA of (P / 16) x (N / 64) warps holds 16
# chunks' cumsums
BWD_MAX_CHUNK = 64
BWD_MAX_DSTATE = 128
BWD_CUM_BATCH = 16

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


def bwd_smem_bytes(L: int, P: int, N: int, sets: int = 1) -> int:
    """Shared memory of a backward chunk-scan CTA (``scan_smem`` in the
    source) holding ``sets`` sets of head tiles: C and B (rows + 8), C B^T
    and the head's decays (rows + 4), per set x (rows + 8), dy, before and
    dS (rows + 4), two sets of the warps' partials, three of the head
    vectors; f32, widths padded to 16."""
    lt, pp, np_ = _pad16(L), _pad16(P), _pad16(N)
    head = lt * (pp + 8) + lt * (pp + 4) + 2 * pp * (np_ + 4)
    parts = 16 * lt + 16
    return 4 * (2 * lt * (np_ + 8) + 2 * lt * (lt + 4) + sets * head
                + 2 * parts + 12 * lt)


def bwd_state_smem_bytes(L: int, P: int, N: int) -> int:
    """Shared memory of a backward state CTA (``state_smem_bytes``): two
    buffers of dy (L x P) and C (L x N), rows + 4, and ``BWD_CUM_BATCH``
    chunks' exp(cumsum) (rows + 1) and decay."""
    lt, pp, np_ = _pad16(L), _pad16(P), _pad16(N)
    return 4 * (2 * lt * (pp + 4 + np_ + 4) + BWD_CUM_BATCH * (lt + 2))


def bwd_scratch_floats(b: int, s: int, h: int, p: int, n: int, L: int,
                       groups: int) -> int:
    """The backward's f32 scratch: the dS states (B, NC, H, P, N), da's
    partials (B, NC, H) and the chunk-scan CTAs' dB and dC partials
    (B * NC, groups, L, N)."""
    nc = -(-s // L)
    return b * nc * h * (p * n + 1) + 2 * b * nc * groups * L * n


@dataclass(frozen=True)
class SsdBwdPlan:
    """What one backward call runs: the chunk length and count, a chunk's
    head groups (one chunk-scan CTA each) and the most heads in one, the
    chunk-scan CTAs, the head tile sets a chunk-scan CTA holds (2: the
    next head's copied while a head computes; 1: after it) and its shared
    memory in bytes, the state CTAs (one a batch row and head), their
    threads and shared memory, and the scratch's f32 elements."""
    chunk: int
    n_chunks: int
    groups: int
    heads_per_cta: int
    scan_ctas: int
    tile_sets: int
    smem_bytes: int
    state_ctas: int
    state_threads: int
    state_smem_bytes: int
    scratch_floats: int


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, s: int, h: int, p: int, n: int,
             chunk: int = 128) -> SsdBwdPlan:
    """The backward's plan of a call on x (b, s, h, p) and B, C (b, s, n):
    ``chunk`` (no longer than the sequence or 64) halved until a chunk-scan
    CTA with one set of head tiles fits in shared memory, two sets where
    they fit, and each chunk's heads split into as many groups as fill one
    wave of the SMs (csrc/ssd_scan_bwd.cu, ssd_scan_bwd_kernel).  The
    training forward runs at the same chunk."""
    if p > MAX_HEADDIM or n > BWD_MAX_DSTATE:
        raise ValueError(f"headdim {p} x dstate {n}: the SSD backward takes "
                         f"both up to {MAX_HEADDIM}")
    L = max(1, min(chunk, s, BWD_MAX_CHUNK))
    while L > 1 and bwd_smem_bytes(L, p, n) > MAX_SMEM_BYTES:
        L //= 2
    sets = 2 if bwd_smem_bytes(L, p, n, 2) <= MAX_SMEM_BYTES else 1
    nc = -(-s // L)
    q = b * nc
    groups = max(1, min(h, SMS // q)) if q else 1
    threads = 32 * (_pad16(p) // 16) * -(-_pad16(n) // 64)
    return SsdBwdPlan(L, nc, groups, -(-h // groups), q * groups, sets,
                      bwd_smem_bytes(L, p, n, sets), b * h, threads,
                      bwd_state_smem_bytes(L, p, n),
                      bwd_scratch_floats(b, s, h, p, n, L, groups))


def _check(x, dt, a, b, c, initial_state):
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
    if initial_state is not None and initial_state.shape != (bsz, h, p, n):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} "
                         f"!= {(bsz, h, p, n)}")


def _launch(x, dt, a, b, c, initial_state, chunk: int):
    """One launch of the forward kernels on CUDA tensors: ``(y, state,
    scratch)``, the scratch holding the states before each chunk (B, NC,
    H, P, N) then the chunks' last cumsums (B, NC, H), f32 (None when
    S = 0)."""
    _check(x, dt, a, b, c, initial_state)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    code = dtype_code(x.dtype)
    pl = plan(bsz, s, h, p, n, chunk)
    x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
    a = a.to(device=x.device, dtype=torch.float32).contiguous()
    init = None
    if initial_state is not None:
        init = initial_state.to(device=x.device,
                                dtype=torch.float32).contiguous()
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    scratch = None
    if bsz and h:
        if pl.n_chunks:
            scratch = torch.empty(bsz * pl.n_chunks * h * (p * n + 1),
                                  dtype=torch.float32, device=x.device)
        launch("ssd_scan", x, "repro_ssd_scan", x.data_ptr(), dt.data_ptr(),
               a.data_ptr(), b.data_ptr(), c.data_ptr(),
               None if init is None else init.data_ptr(), y.data_ptr(),
               state.data_ptr(),
               None if scratch is None else scratch.data_ptr(), bsz, s, h, p,
               n, pl.chunk, pl.scan_ctas, code)
    return y, state, scratch


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, initial_state=None):
    """Chunked SSD scan; returns (y (B, S, H, P) f32, state (B, H, P, N) f32).

    x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) positive decay
    rates; b, c: (B, S, N) shared across heads; initial_state: (B, H, P, N)
    or None.  x, dt, b, c are float32 or bfloat16, of one dtype; P <= 128.
    Differentiable in all six inputs (see the module's docstring).
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, initial_state)):
        return _SSD.apply(x, dt, a, b, c, initial_state, chunk)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return ssd_ref(x, dt, a, b, c, chunk=chunk,
                           initial_state=initial_state)
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    return _launch(x, dt, a, b, c, initial_state, chunk)[:2]


def ssd_scan_with_states(x, dt, a, b, c, *, chunk: int = 128,
                         initial_state=None):
    """The training forward: ``(y, state, states)``.  On the card the
    forward kernels run at :func:`bwd_plan`'s chunk and ``states`` is their
    scratch (the states before each chunk, then the chunks' last cumsums),
    what :func:`ssd_scan_bwd` reads; on the CPU ``states`` is None (the
    plain backward recomputes them)."""
    if x.device.type == "cpu":
        y, state = ssd_ref(x, dt, a, b, c, chunk=chunk,
                           initial_state=initial_state)
        return y, state, None
    if not x.is_cuda:
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    L = bwd_plan(bsz, s, h, p, n, chunk).chunk
    if plan(bsz, s, h, p, n, L).chunk != L:
        raise ValueError(f"the SSD forward cannot run at the backward's "
                         f"chunk {L} (P {p}, N {n})")
    return _launch(x, dt, a, b, c, initial_state, L)


class _SSD(torch.autograd.Function):
    """The SSD scan with the backward kernels as its gradient: the forward
    keeps its inputs and its scratch (the states before each chunk)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, initial_state, chunk):
        x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
        y, state, states = ssd_scan_with_states(
            x, dt, a, b, c, chunk=chunk, initial_state=initial_state)
        ctx.save_for_backward(x, dt, a, b, c, initial_state, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, init, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, da, db, dc, dinit = ssd_scan_bwd(
            x, dt, a, b, c, dy, dstate, states, chunk=ctx.chunk,
            initial_state=init)
        return (dx, ddt, da.to(a.dtype), db, dc,
                None if init is None else dinit.to(init.dtype), None)


def ssd_scan_bwd(x, dt, a, b, c, dy, dstate, states=None, *,
                 chunk: int = 128, initial_state=None):
    """The gradient of :func:`ssd_scan` given the outputs' gradients ``dy``
    (B, S, H, P) and ``dstate`` (B, H, P, N, or None: no pull on the final
    state): ``(dx, ddt, da, db, dc, dinit)``, dx, ddt, db, dc in the inputs'
    dtype, da (H,) f32, dinit (B, H, P, N) f32, None without an
    ``initial_state``.  On the card ``states`` is
    :func:`ssd_scan_with_states`' for the same inputs and ``chunk``.  The
    sums over heads, chunks and the batch take a fixed order: the same
    inputs give the same bits."""
    if x.device.type == "cpu":
        out = ssd_bwd_ref(x, dt, a, b, c, dy, dstate, chunk=chunk,
                          initial_state=initial_state)
        return out[:5] + ((out[5],) if initial_state is not None else (None,))
    if not x.is_cuda:
        raise ValueError(f"ssd_scan_bwd runs on cuda or cpu, not {x.device}")
    _check(x, dt, a, b, c, initial_state)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if dy.shape != x.shape or (dstate is not None
                               and dstate.shape != (bsz, h, p, n)):
        raise ValueError(f"dy {tuple(dy.shape)}, dstate "
                         f"{None if dstate is None else tuple(dstate.shape)}"
                         f": need {tuple(x.shape)} and {(bsz, h, p, n)}")
    code = dtype_code(x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b, c))
    da = torch.empty((h,), **f32)
    dinit = (None if initial_state is None
             else torch.empty((bsz, h, p, n), **f32))
    if not (bsz and s and h):
        for t in (dx, ddt, db, dc, da):
            t.zero_()
        if dinit is not None:
            dinit.copy_(dstate if dstate is not None else 0.0)
        return dx, ddt, da, db, dc, dinit
    pl = bwd_plan(bsz, s, h, p, n, chunk)
    if states is None or states.numel() != bsz * pl.n_chunks * h * (
            p * n + 1) or states.dtype != torch.float32:
        raise ValueError("ssd_scan_bwd needs the forward's states at the "
                         "backward's chunk (ssd_scan_with_states)")
    a = a.to(**f32).contiguous()
    dy = dy.to(**f32).contiguous()
    if dstate is not None:
        dstate = dstate.to(**f32).contiguous()
    scratch = torch.empty(pl.scratch_floats, **f32)
    launch("ssd_scan_bwd", x, "repro_ssd_scan_bwd", x.data_ptr(),
           dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
           dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
           states.data_ptr(), dx.data_ptr(), ddt.data_ptr(), db.data_ptr(),
           dc.data_ptr(), da.data_ptr(),
           None if dinit is None else dinit.data_ptr(), scratch.data_ptr(),
           bsz, s, h, p, n, pl.chunk, pl.groups, code)
    return dx, ddt, da, db, dc, dinit


# one name for the module and its wrapper: calling the module calls it
sys.modules[__name__].__class__ = KernelModule
