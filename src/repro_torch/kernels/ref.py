"""Plain PyTorch versions of the port's CUDA kernels.

Each kernel wrapper falls back to its plain version only for tensors that
lie on the CPU; the CPU tests use these, and ``chip_smoke.py`` holds every
kernel against its plain version on the card.  Nothing on the main path
calls them when a card is present.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.passes import SHADOW_ITERS, plain_tick

I32 = torch.int32


def schedule_tick_ref(p, state, alloc, remaining, start_t, act, capacity,
                      t_now, *, fill_rounds: int, prio_lo: int, prio_hi: int,
                      shadow_iters: int = SHADOW_ITERS,
                      backfill_depth=None):
    """The greedy, class-free Steps-1..3 pass (what ``schedule_tick.cu``
    computes), as plain PyTorch ops.  Returns ``(state, alloc, start_t)``."""
    return plain_tick(
        p, state, alloc, remaining, start_t, act, capacity, t_now,
        structure="greedy", fill_rounds=fill_rounds, prio_lo=prio_lo,
        prio_hi=prio_hi, span_max=0, shadow_iters=shadow_iters,
        backfill_depth=backfill_depth)


def waterfill_ref(cap, target, order=None):
    """Per-row prefix waterfill: ``clip(min(target, total) - excl_cumsum(cap),
    0, cap)``.

    ``cap``: ``(N,)`` or ``(B, W)`` int32 >= 0 in priority order;
    ``target``: a scalar, or one int per row.  Each row's take sums to
    ``min(target, row total)``.  With ``order`` (a permutation of each row,
    argsort's output) the row is visited in that order and the take
    scattered back: ``repro.core.passes._pallas_give``'s gather, waterfill
    and scatter.
    """
    cap = torch.as_tensor(cap, dtype=I32)
    if order is not None:
        take = waterfill_ref(torch.gather(cap, -1, order), target)
        return torch.zeros_like(cap).scatter_(-1, order, take)
    target = torch.as_tensor(target, dtype=I32, device=cap.device)
    cum = torch.cumsum(cap, dim=-1, dtype=I32)
    if cap.shape[-1]:
        total = cum[..., -1]
    else:
        total = torch.zeros(cap.shape[:-1], dtype=I32, device=cap.device)
    tgt = torch.minimum(target, total)[..., None]
    return torch.minimum(torch.clamp(tgt - (cum - cap), min=0), cap)


# ---------------------------------------------------------------- LLM layer
def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis in f32,
    returned in x's dtype (the JAX package's ``models/layers.rmsnorm``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _online_softmax_block(acc, m, l, s, v, mask):
    """One online-softmax update.  s: (B, Hkv, Q, K); v: (B, K, Hkv, Dv)."""
    s = torch.where(mask, s, -torch.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v)
    return acc_new, m_new, l_new


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, kv_valid_len=None,
                  softmax_scale=None, block_k: int = 512):
    """Blockwise online-softmax attention in the grouped (Hkv-major) layout:
    the JAX package's ``models/layers._grouped_attention``, which its
    ``chunked_attention`` takes on one device.

    q: (B, Sq, H, Dh); k: (B, Sk, Hkv, Dh); v: (B, Sk, Hkv, Dv), V's width
    free (MLA's values are narrower than its keys).  Query i sits at position
    ``q_offset + i`` and key j at j; key j is seen when ``j <
    kv_valid_len``, (causal) ``j <= query``, and (``window > 0``) ``j >
    query - window``.  q is scaled before the product; sums are f32; a row
    that sees no key is 0.  KV blocks past the last visible key are not
    visited (the JAX scan visits them, but a fully masked block leaves
    (acc, m, l) as they were).  Returns (B, Sq, H, Dv) in q's dtype.
    """
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    groups = h // hkv
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(dh))
    qf = (q.float() * scale).transpose(1, 2).reshape(b, hkv, groups * sq, dh)
    qpos = (q_offset + torch.arange(sq, device=q.device)).repeat(groups)
    limit = sk if kv_valid_len is None else min(sk, int(kv_valid_len))
    if causal:
        limit = min(limit, q_offset + sq)
    acc = torch.zeros((b, hkv, groups * sq, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, hkv, groups * sq), -torch.inf, device=q.device)
    l = torch.zeros((b, hkv, groups * sq), device=q.device)
    for k0 in range(0, max(limit, 0), block_k):
        kpos = torch.arange(k0, min(k0 + block_k, sk), device=q.device)
        kblk = k[:, k0:k0 + block_k].float()
        vblk = v[:, k0:k0 + block_k].float()
        s = torch.einsum("bhqd,bkhd->bhqk", qf, kblk)
        mask = (kpos < limit)[None, :].expand(groups * sq, -1)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        acc, m, l = _online_softmax_block(acc, m, l, s, vblk, mask)
    out = acc / torch.clamp(l[..., None], min=1e-20)
    out = out.reshape(b, hkv, groups, sq, dv).reshape(b, h, sq, dv)
    return out.transpose(1, 2).to(q.dtype)


def ssd_ref(x, dt, a, b, c, *, chunk: int = 128, initial_state=None):
    """Chunked SSD scan: the JAX package's ``models/ssm.ssd_chunked``.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) positive decay
    rates; b, c: (B, S, N); initial_state: (B, H, P, N) or None.  Computes
    in f32; returns (y (B, S, H, P), final_state (B, H, P, N)), both f32.
    """
    x, dt, b, c = x.float(), dt.float(), b.float(), c.float()
    a = a.float()
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)

    la = -a[None, None, None, :] * dtc                     # (B,NC,L,H)
    cum = torch.cumsum(la, dim=2)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,NC,L,L,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], li,
                                  -torch.inf))
    cb = torch.einsum("zcln,zcmn->zclm", cc, bc)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]      # (B,NC,L,L,H)
    y_intra = torch.einsum("zclmh,zcmhp->zclhp", w, xc)

    tail = torch.exp(cum[:, :, -1:, :] - cum)              # (B,NC,L,H)
    sc = torch.einsum("zclhp,zcln->zchpn", xc * (tail * dtc)[..., None], bc)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,NC,H)
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((bsz, h, p, n), device=x.device))
    before = []
    for ci in range(nc):
        before.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + sc[:, ci]
    states_before = torch.stack(before, dim=1)             # (B,NC,H,P,N)
    y_inter = (torch.einsum("zcln,zchpn->zclhp", cc, states_before)
               * torch.exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y, state
