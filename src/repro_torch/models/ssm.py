"""Mamba-2 block via State-Space Duality (SSD), arXiv:2405.21060.

Counterpart of the JAX package's ``models/ssm.py``.  The selective SSM

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,    y_t = C_t h_t + D x_t

runs as the chunked SSD scan over a whole prompt (:func:`ssd_chunked`,
through the CUDA kernel ``ssd_scan.cu`` on the card) and as a one-step
recurrence in decode (:func:`mamba2_decode`, plain PyTorch: the JAX package
has no kernel for it).  Projections are separate tensors (z, x, B, C, dt),
B and C shared across heads (ngroups = 1), as in the JAX package.

Under tensor parallelism (:mod:`repro_torch.models.tp`) a block whose SSD
heads split over the model group runs on its local heads: z, x, dt and
the SSD scan on this rank's ``d_inner`` / heads; B and C whole on every
rank, their gradient summed ("f") since each rank's heads use them; the
gated ``out_norm``, which reduces over the whole ``d_inner``, on the rows
gathered whole (the RMSNorm kernels unchanged, the norm the single
device's), then this rank's columns through the row-parallel
``out_proj`` and the sum over the group.  Otherwise the block runs whole
on every rank from gathered weights.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ssd_scan

from . import tp
from .layers import Norm, _empty, rmsnorm


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    nheads: int
    headdim: int
    dstate: int
    d_conv: int = 4

    @staticmethod
    def from_config(d_model: int, ssm_state: int, expand: int = 2,
                    headdim: int = 64) -> "SSMDims":
        d_inner = expand * d_model
        return SSMDims(d_model=d_model, d_inner=d_inner,
                       nheads=d_inner // headdim, headdim=headdim,
                       dstate=ssm_state)


class Mamba2(nn.Module):
    """The JAX ``init_mamba2`` dict's parameters, by the same names."""

    def __init__(self, dims: SSMDims, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_z = _empty(dims.d_model, dims.d_inner, **kw)
        self.in_x = _empty(dims.d_model, dims.d_inner, **kw)
        self.in_b = _empty(dims.d_model, dims.dstate, **kw)
        self.in_c = _empty(dims.d_model, dims.dstate, **kw)
        self.in_dt = _empty(dims.d_model, dims.nheads, **kw)
        self.conv_x = _empty(dims.d_conv, dims.d_inner, **kw)
        self.conv_bc = _empty(dims.d_conv, 2 * dims.dstate, **kw)
        self.conv_bias_x = _empty(dims.d_inner, **kw)
        self.conv_bias_bc = _empty(2 * dims.dstate, **kw)
        self.a_log = _empty(dims.nheads, **f32)
        self.dt_bias = _empty(dims.nheads, **f32)
        self.d_skip = _empty(dims.nheads, **f32)
        self.out_norm = Norm("rmsnorm", dims.d_inner, **kw)
        self.out_proj = _empty(dims.d_inner, dims.d_model, **kw)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C).

    Returns (y, new_state) where state carries the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xx = torch.cat([state, x], dim=1)
    y = sum(xx[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(k))
    new_state = xx[:, -(k - 1):, :] if k > 1 else state
    return F.silu(y + b[None, None, :]), new_state


def _project(p: Mamba2, x, dtype):
    xd = x.to(dtype)
    z = xd @ p.in_z.to(dtype)
    xin = xd @ p.in_x.to(dtype)
    bc = torch.cat([xd @ p.in_b.to(dtype), xd @ p.in_c.to(dtype)], dim=-1)
    dt = xd @ p.in_dt.to(dtype)
    return z, xin, bc, dt


def ssd_chunked(x, dt, a, b, c, *, chunk: int = 128, initial_state=None):
    """Chunked SSD scan through the kernel wrapper.

    x: (B, S, H, P); dt: (B, S, H) positive; a: (H,) positive (A = -a);
    b, c: (B, S, N).  Returns (y (B, S, H, P), final_state (B, H, P, N)),
    both f32.
    """
    return ssd_scan(x, dt, a, b, c, chunk=chunk, initial_state=initial_state)


class MambaCache(NamedTuple):
    conv_x: torch.Tensor   # (B, K-1, d_inner)
    conv_bc: torch.Tensor  # (B, K-1, 2N)
    state: torch.Tensor    # (B, H, P, N) f32


def apply_mamba2(p: Mamba2, x, dims: SSMDims, dtype, chunk: int = 128,
                 initial_state=None, return_cache: bool = False):
    """Full-sequence Mamba-2 block.  x: (B, S, d_model) -> same.

    With ``return_cache`` also returns the :class:`MambaCache` holding the
    final SSM state and conv tails (the prefill -> decode hand-off; this
    rank's heads under tensor parallelism)."""
    if tp.ssm_mode(dims.nheads, tp.size()) == "whole":
        return tp.on_whole(apply_mamba2, p, x, dims, dtype, chunk,
                           initial_state, return_cache)
    bsz, s, _ = x.shape
    heads = dims.nheads // tp.size()
    # z, x and dt feed this rank's heads alone ("f"); B and C every rank's
    xs = tp.copy_to(x).to(dtype)
    z = xs @ tp.local(p.in_z).to(dtype)
    xin = xs @ tp.local(p.in_x).to(dtype)
    dt = xs @ tp.local(p.in_dt).to(dtype)
    xd = x.to(dtype)
    bc = torch.cat([xd @ p.in_b.to(dtype), xd @ p.in_c.to(dtype)], dim=-1)
    xin, conv_x_state = _causal_conv(xin, tp.local(p.conv_x).to(dtype),
                                     tp.local(p.conv_bias_x).to(dtype))
    bc, conv_bc_state = _causal_conv(bc, p.conv_bc.to(dtype),
                                     p.conv_bias_bc.to(dtype))
    # each rank's gradient of B and C is its heads' share: summed here, so
    # the replicated weights behind them get it whole
    bc = tp.copy_to(bc)
    b = bc[..., :dims.dstate]
    c = bc[..., dims.dstate:]

    dt = F.softplus(dt.float() + tp.local(p.dt_bias))
    a = torch.exp(tp.local(p.a_log))
    xh = xin.reshape(bsz, s, heads, dims.headdim).float()
    y, state = ssd_chunked(xh, dt, a, b.float(), c.float(), chunk=chunk,
                           initial_state=initial_state)
    y = y + xh * tp.local(p.d_skip)[None, None, :, None]
    y = y.reshape(bsz, s, heads * dims.headdim).to(dtype)
    # the norm reduces over the whole d_inner: its rows gathered, normed as
    # on one device, then this rank's columns
    y = tp.gather(y * F.silu(z.to(dtype)), -1)
    y = tp.scatter(rmsnorm(p.out_norm, y), -1)
    out = tp.reduce_from(y @ tp.local(p.out_proj).to(dtype))
    if return_cache:
        return out, MambaCache(conv_x=conv_x_state, conv_bc=conv_bc_state,
                               state=state)
    return out


def mamba2_decode(p: Mamba2, x, cache: MambaCache, dims: SSMDims, dtype):
    """One-token recurrent step (O(1) in sequence length).  Returns
    ``(out, new_cache)``; the cache passed in is not modified."""
    bsz, one, _ = x.shape
    assert one == 1
    z, xin, bc, dt = _project(p, x, dtype)
    xin, conv_x = _causal_conv(xin, p.conv_x.to(dtype),
                               p.conv_bias_x.to(dtype), cache.conv_x)
    bc, conv_bc = _causal_conv(bc, p.conv_bc.to(dtype),
                               p.conv_bias_bc.to(dtype), cache.conv_bc)
    b = bc[..., :dims.dstate]
    c = bc[..., dims.dstate:]

    dt = F.softplus(dt.float() + p.dt_bias)[:, 0]          # (B, H)
    a = torch.exp(p.a_log)
    decay = torch.exp(-a[None, :] * dt)                     # (B, H)
    xh = xin.reshape(bsz, dims.nheads, dims.headdim).float()
    bu = b[:, 0].float()                                    # (B, N)
    cu = c[:, 0].float()
    state = (cache.state * decay[:, :, None, None]
             + dt[:, :, None, None] * xh[:, :, :, None] * bu[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, cu)
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(bsz, 1, dims.d_inner).to(dtype)
    y = rmsnorm(p.out_norm, y * F.silu(z.to(dtype)))
    return (y @ p.out_proj.to(dtype),
            MambaCache(conv_x=conv_x, conv_bc=conv_bc, state=state))
