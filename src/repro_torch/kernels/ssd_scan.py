"""Mamba-2 SSD scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its wrapper.

Replaces the JAX package's Pallas ``repro/kernels/ssd_scan.py::ssd_scan``.
:func:`ssd_scan` launches the kernel for CUDA tensors and uses the plain
version (:func:`repro_torch.kernels.ref.ssd_ref`) only for tensors on the
CPU.
"""
from __future__ import annotations

import torch

from .build import check_launch, dtype_code, load_library, stream_of
from .ref import ssd_ref

# a CTA's dynamic shared memory on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024


def smem_bytes(L: int, P: int, N: int) -> int:
    """Shared memory of one CTA of the kernel (``ssd_smem_bytes``)."""
    return 4 * (L * P + 2 * L * (N + 1) + L * L + P * (N + 1) + 3 * L)


def kernel_chunk(chunk: int, S: int, P: int, N: int) -> int:
    """The kernel's chunk length: ``chunk`` (no longer than the sequence),
    halved until a CTA's shared memory holds it.  The scan's result does not
    depend on it."""
    L = max(1, min(chunk, S))
    while L > 1 and smem_bytes(L, P, N) > MAX_SMEM_BYTES:
        L //= 2
    if smem_bytes(L, P, N) > MAX_SMEM_BYTES:
        raise ValueError(f"headdim {P} x dstate {N} does not fit the SSD "
                         "kernel's shared memory")
    return L


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, initial_state=None):
    """Chunked SSD scan; returns (y (B, S, H, P) f32, state (B, H, P, N) f32).

    x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) positive decay
    rates; b, c: (B, S, N) shared across heads; initial_state: (B, H, P, N)
    or None.  x, dt, b, c are float32 or bfloat16, of one dtype.
    """
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a, b, c, chunk=chunk,
                       initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if (dt.shape != (bsz, s, h) or a.shape != (h,) or b.shape != (bsz, s, n)
            or c.shape != b.shape
            or any(t.dtype != x.dtype for t in (dt, b, c))):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}: shapes or dtypes disagree")
    code = dtype_code(x)
    L = kernel_chunk(chunk, s, p, n)
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
        lib = load_library()
        with torch.cuda.device(x.device):
            err = lib.repro_ssd_scan(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), None if init is None else init.data_ptr(),
                y.data_ptr(), state.data_ptr(), bsz, s, h, p, n, L, code,
                stream_of(x))
        check_launch(lib, err, "ssd_scan")
    return y, state
