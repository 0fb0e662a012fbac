"""Plain PyTorch versions of the port's CUDA kernels.

Each kernel wrapper falls back to its plain version only for tensors that
lie on the CPU; the CPU tests use these, and ``chip_smoke.py`` holds every
kernel against its plain version on the card.  Nothing on the main path
calls them when a card is present.  The backward kernels have theirs too
(:func:`rmsnorm_bwd_ref`, :func:`attention_bwd_ref`, :func:`ssd_bwd_ref`):
they compute what the kernels compute, step by step, and the CPU path of
the autograd functions runs them.
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


def rmsnorm_bwd_ref(x, scale, dy, eps: float = 1e-6):
    """The gradient of :func:`rmsnorm_ref` given the output's gradient
    ``dy``: ``dx = r (scale dy) - x r^3 mean(x scale dy)`` with ``r =
    rsqrt(mean(x^2) + eps)``, in f32, returned in x's dtype, and ``dscale
    = sum over rows of dy x r`` in scale's dtype (what ``rmsnorm.cu``'s
    backward computes)."""
    xf, g = x.float(), dy.float()
    d = x.shape[-1]
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gw = scale.float() * g
    coef = torch.mean(xf * gw, dim=-1, keepdim=True) * (r * r * r)
    dx = r * gw - xf * coef
    dscale = (g * xf * r).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


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
                  softmax_scale=None, block_k: int = 512,
                  return_lse: bool = False):
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
    (acc, m, l) as they were).  Returns (B, Sq, H, Dv) in q's dtype; with
    ``return_lse`` also each row's log-sum-exp of its scaled scores, f32
    (B, H, Sq), +inf for a row that sees no key (what the kernel writes for
    the backward).
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
    out = out.transpose(1, 2).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)
    return out, lse.reshape(b, h, sq)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, softmax_scale=None):
    """The gradient of :func:`attention_ref` (``q_offset`` 0, every key
    valid) given its output ``o``, the rows' log-sum-exp ``lse`` (B, H, Sq)
    and the output's gradient ``do``: P recomputed from ``lse``, D =
    rowsum(dO * O), dS = P (dP - D), in f32 and the grouped (Hkv-major)
    layout of :func:`attention_ref`, as ``flash_attention_bwd.cu`` computes
    them.  Returns ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    groups = h // hkv
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(dh))

    def grouped(t, width):     # (B, Sq, H, w) -> (B, Hkv, G * Sq, w)
        return t.float().transpose(1, 2).reshape(b, hkv, groups * sq, width)

    qf, dof, of = grouped(q, dh), grouped(do, dv), grouped(o, dv)
    kf = k.float().permute(0, 2, 1, 3)                      # (B, Hkv, Sk, D)
    vf = v.float().permute(0, 2, 1, 3)
    qpos = torch.arange(sq, device=q.device).repeat(groups)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((groups * sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    s = scale * (qf @ kf.transpose(-1, -2))                 # (B, Hkv, R, Sk)
    lse_g = lse.float().reshape(b, hkv, groups * sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = scale * (ds @ kf)
    dk = scale * (ds.transpose(-1, -2) @ qf)
    dvv = p.transpose(-1, -2) @ dof
    dq = dq.reshape(b, h, sq, dh).transpose(1, 2)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dvv.permute(0, 2, 1, 3).to(v.dtype))


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


def ssd_bwd_ref(x, dt, a, b, c, dy, dstate, *, chunk: int = 128,
                initial_state=None):
    """The gradient of :func:`ssd_ref` given the output's gradient ``dy``
    (B, S, H, P) and the final state's ``dstate`` (B, H, P, N) or None (no
    pull), step by step in the order of ``ssd_scan_bwd.cu``.  With ``cum``
    the inclusive cumsum of ``la = -a_h dt`` within a chunk, ``W[t, u] =
    (C_t . B_u) exp(cum_t - cum_u)`` on the lower triangle and ``before[c]``
    the state before chunk c:

    1. per chunk, the output's pull on the state before it:
       ``G_c = sum_t exp(cum_t) dy_t^T C_t`` (P x N);
    2. the reverse state pass: ``dbefore[NC] = dstate``, ``dbefore[c] =
       exp(cum_end) dbefore[c + 1] + G_c``, and the chunk decay's gradient
       ``<dbefore[c + 1], before[c]>``; ``dinit = dbefore[0]``;
    3. per chunk and head, with ``dS = dbefore[c + 1]``: the gradient of
       ``dt_u x_u`` (through which alone y sees x and dt directly),
       ``gx_u = (W^T dy)_u + tail_u dS B_u``, so ``dx = dt gx`` and the
       direct ``ddt = x . gx``; dC from the intra term and ``exp(cum_t)
       before^T dy_t``; dB from the intra term and ``tail_u dt_u x_u^T
       dS``; d cum from the row and column sums of ``CB o D`` (``D =
       (dy x^T) dt_u exp(cum_t - cum_u)``, the gradient of CB), the inter
       term ``exp(cum_t) C_t . before^T dy_t``, the tail terms and the
       chunk decay's; then ``dla`` is d cum's reverse cumsum within the
       chunk, ``ddt += -a_h dla`` and ``da_h -= sum dt dla``;
    4. dB and dC summed over heads, da over batch and chunks.

    Computes in f32; returns ``(dx, ddt, da, db, dc, dinit)``: dx, ddt, db,
    dc in x's, dt's, b's and c's dtypes, da and dinit f32.
    """
    dtypes = x.dtype, dt.dtype, b.dtype, c.dtype
    x, dt, b, c, dy = (t.float() for t in (x, dt, b, c, dy))
    a = a.float()
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:
        x, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                 for t in (x, dy))
        dt, b, c = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                    for t in (dt, b, c))
    nc = x.shape[1] // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dyc = dy.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)

    cum = torch.cumsum(-a * dtc, dim=2)                    # (B,NC,L,H)
    last = cum[:, :, -1]                                   # (B,NC,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay = torch.exp(torch.where(
        tri[None, None, :, :, None],
        cum[:, :, :, None, :] - cum[:, :, None, :, :], -torch.inf))
    cb = torch.einsum("zctn,zcun->zctu", cc, bc)           # (B,NC,L,L)
    w = cb[..., None] * decay                              # (B,NC,t,u,H)
    ecum = torch.exp(cum)
    tail = torch.exp(last[:, :, None] - cum)
    chunk_decay = torch.exp(last)
    # the forward's states before each chunk
    sc = torch.einsum("zcuhp,zcun->zchpn", xc * (tail * dtc)[..., None], bc)
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((bsz, h, p, n), device=x.device))
    before = []
    for ci in range(nc):
        before.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + sc[:, ci]
    before = torch.stack(before, dim=1)                    # (B,NC,H,P,N)

    # 1. the output's pull on the state before each chunk
    g = torch.einsum("zcthp,zctn->zchpn", dyc * ecum[..., None], cc)
    # 2. the reverse state pass
    carry = (dstate.float() if dstate is not None
             else torch.zeros((bsz, h, p, n), device=x.device))
    ds, dots = [None] * nc, [None] * nc
    for ci in reversed(range(nc)):
        ds[ci] = carry
        dots[ci] = (carry * before[:, ci]).sum(dim=(-1, -2))
        carry = carry * chunk_decay[:, ci, :, None, None] + g[:, ci]
    dinit = carry
    ds = torch.stack(ds, dim=1)                            # (B,NC,H,P,N)
    dot = torch.stack(dots, dim=1)                         # (B,NC,H)
    # 3. per chunk and head
    q = torch.einsum("zcthp,zcuhp->zctuh", dyc, xc)
    d = q * dtc[:, :, None] * decay                        # dt_u: axis u
    v = torch.einsum("zcun,zchpn->zcuhp", bc, ds)          # dS B_u
    gx = torch.einsum("zctuh,zcthp->zcuhp", w, dyc) + tail[..., None] * v
    dx = dtc[..., None] * gx
    ddt = (xc * gx).sum(dim=-1)
    z = torch.einsum("zcthp,zchpn->zcthn", dyc, before)    # before^T dy_t
    dcm = (torch.einsum("zctuh,zcun->zctn", d, bc)
           + torch.einsum("zcth,zcthn->zctn", ecum, z))
    dbm = (torch.einsum("zctuh,zctn->zcun", d, cc)
           + torch.einsum("zcuhp,zchpn->zcuhn",
                          xc * (tail * dtc)[..., None], ds).sum(dim=3))
    r = cb[..., None] * d
    tails = tail * dtc * (xc * v).sum(dim=-1)              # (B,NC,L,H)
    dcum = (r.sum(dim=3) - r.sum(dim=2)
            + ecum * (cc[:, :, :, None, :] * z).sum(dim=-1) - tails)
    dcum[:, :, -1] += tails.sum(dim=2) + chunk_decay * dot
    dla = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = ddt - a * dla
    da = -(dtc * dla).sum(dim=(0, 1, 2))
    s_all = nc * chunk
    return (dx.reshape(bsz, s_all, h, p)[:, :s].to(dtypes[0]),
            ddt.reshape(bsz, s_all, h)[:, :s].to(dtypes[1]), da,
            dbm.reshape(bsz, s_all, n)[:, :s].to(dtypes[2]),
            dcm.reshape(bsz, s_all, n)[:, :s].to(dtypes[3]), dinit)
