"""The plain backward versions of the LLM kernels and the autograd
functions around the kernels, on the CPU.

* ``rmsnorm_bwd_ref`` and ``attention_bwd_ref`` (what the backward kernels
  compute, step by step, from the saved row log-sum-exp) against
  ``torch.autograd`` of the plain forwards ``rmsnorm_ref`` and
  ``attention_ref``: causal, sliding window, non-causal, cross (Sq != Sk),
  GQA and values narrower than keys.  Inputs are float64; the plain
  versions compute in f32, so the tolerance is 1e-5 of the largest |grad|.
* ``attention_ref(return_lse=True)``: the log-sum-exp of the scaled scores,
  +inf for a row that sees no key.
* the wrappers as autograd functions: their gradients are the plain
  backward versions' on the CPU; the attention backward refuses decode's
  ``q_offset`` / ``kv_valid_len``; ``ssd_scan`` is differentiable on the
  CPU (``tests/test_torch_ssd_bwd.py`` holds its backward).
* ``check_trainable``: every registered config passes on a CUDA device,
  Mamba-2's too; a Mamba-2 state wider than the SSD backward kernel takes
  is refused there (no card needed: the device's type decides).
* ``bwd_plan``, the Python mirror of the backward's launch choices, at
  every head-dim bucket in f32 and bf16 (shared memory within the card's,
  bf16 on wgmma, f32 on mma.sync, one dK / dV launch), and the kernels'
  walks (``bwd_query_range`` / ``bwd_key_range``) and block predicates
  (``bwd_kv_block`` / ``bwd_q_block``) against a brute-force mask.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_with_lse)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.train.train_step import check_trainable  # noqa: E402

TOL = 1e-5


def _close_to_max(got, exp, tol=TOL):
    got, exp = got.detach(), exp.detach()
    big = float(exp.abs().max())
    err = float((got.double() - exp.double()).abs().max())
    assert err <= tol * max(big, 1e-12), (err, big)


def _rand(gen, *shape):
    return torch.randn(shape, generator=gen, dtype=torch.float64)


@pytest.mark.parametrize("shape", [(3, 5, 33), (1, 2561), (7, 20)])
def test_rmsnorm_bwd_ref_is_the_gradient_of_rmsnorm_ref(shape):
    gen = torch.Generator().manual_seed(sum(shape))
    x = _rand(gen, *shape).requires_grad_()
    w = _rand(gen, shape[-1]).requires_grad_()
    dy = _rand(gen, *shape)
    gx, gw = torch.autograd.grad(ref.rmsnorm_ref(x, w), (x, w), dy)
    dx, dw = ref.rmsnorm_bwd_ref(x.detach(), w.detach(), dy)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    _close_to_max(dx, gx)
    _close_to_max(dw, gw)
    # the wrapper's autograd function runs the plain backward on the CPU
    fx, fw = torch.autograd.grad(rmsnorm(x, w), (x, w), dy)
    assert torch.equal(fx, dx) and torch.equal(fw, dw)
    assert all(torch.equal(a, b) for a, b in zip(
        rmsnorm_bwd(x.detach(), w.detach(), dy), (dx, dw)))


CASES = {
    "causal": dict(B=2, Sq=13, Sk=13, H=4, Hkv=2, D=16, Dv=16),
    "window": dict(B=2, Sq=21, Sk=21, H=4, Hkv=4, D=16, Dv=16, window=5),
    "non-causal": dict(B=1, Sq=17, Sk=17, H=3, Hkv=3, D=8, Dv=8,
                       causal=False),
    "cross": dict(B=2, Sq=4, Sk=19, H=2, Hkv=2, D=8, Dv=8, causal=False),
    "causal cross": dict(B=1, Sq=5, Sk=9, H=2, Hkv=1, D=8, Dv=8),
    "GQA 4:1": dict(B=1, Sq=11, Sk=11, H=8, Hkv=2, D=12, Dv=12),
    "Dv < Dk": dict(B=2, Sq=9, Sk=9, H=4, Hkv=4, D=24, Dv=16),
    "no key": dict(B=1, Sq=6, Sk=6, H=2, Hkv=2, D=8, Dv=8, window=1),
}


def _attn_case(name):
    case = dict(CASES[name])
    b, sq, sk, h, hkv, d, dv = (case.pop(k) for k in
                                ("B", "Sq", "Sk", "H", "Hkv", "D", "Dv"))
    gen = torch.Generator().manual_seed(sq * sk + d)
    q = _rand(gen, b, sq, h, d).requires_grad_()
    k = _rand(gen, b, sk, hkv, d).requires_grad_()
    v = _rand(gen, b, sk, hkv, dv).requires_grad_()
    return q, k, v, _rand(gen, b, sq, h, dv), case


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_bwd_ref_is_the_gradient_of_attention_ref(name):
    q, k, v, do, kw = _attn_case(name)
    out = ref.attention_ref(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v), do)
    o, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, out.detach()) and lse.shape == (
        q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32
    got = ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, lse,
                                do, **kw)
    for g, e in zip(got, grads):
        assert g.dtype == e.dtype and g.shape == e.shape
        _close_to_max(g, e)
    # the wrapper's autograd function: the plain forward and backward
    fgrads = torch.autograd.grad(flash_attention(q, k, v, **kw), (q, k, v),
                                 do)
    for g, e in zip(fgrads, got):
        assert torch.equal(g, e)
    fo, flse = flash_attention_with_lse(q.detach(), k.detach(), v.detach(),
                                        **kw)
    assert torch.equal(fo, o) and torch.equal(flse, lse)
    assert all(torch.equal(a, b) for a, b in zip(flash_attention_bwd(
        q.detach(), k.detach(), v.detach(), o, lse, do, **kw), got))


def test_attention_lse_is_the_scaled_scores_logsumexp():
    q, k, v, _, _ = _attn_case("no key")
    _, lse = ref.attention_ref(q, k, v, window=1, softmax_scale=0.3,
                               return_lse=True)
    s = 0.3 * torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    exp = torch.logsumexp(s.masked_fill(
        ~torch.eye(6, dtype=torch.bool), -math.inf), dim=-1)
    torch.testing.assert_close(lse, exp, atol=1e-5, rtol=1e-5)
    _, lse = ref.attention_ref(q[:, :2], k[:, :3], v[:, :3],
                               kv_valid_len=0, return_lse=True)
    assert torch.isinf(lse).all() and (lse > 0).all()


@pytest.mark.parametrize("kw", [dict(q_offset=3), dict(kv_valid_len=5)])
def test_attention_backward_refuses_decode_arguments(kw):
    q, k, v, _, _ = _attn_case("causal")
    with pytest.raises(ValueError, match="backward"):
        flash_attention(q, k, v, **kw)
    with torch.no_grad():
        assert flash_attention(q, k, v, **kw).shape == q.shape


def test_ssd_scan_is_differentiable_on_the_cpu():
    gen = torch.Generator().manual_seed(5)
    x = _rand(gen, 1, 20, 2, 4).float().requires_grad_()
    dt = (0.1 + 0.4 * torch.rand((1, 20, 2), generator=gen))
    a = 0.5 + torch.rand(2, generator=gen)
    b, c = _rand(gen, 1, 20, 3).float(), _rand(gen, 1, 20, 3).float()
    y, state = ssd_scan(x, dt, a, b, c, chunk=8)
    (y.sum() + state.sum()).backward()
    assert x.grad.shape == x.shape and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("arch,mamba", [
    ("mamba2-1.3b", True), ("zamba2-2.7b", True), ("stablelm-1.6b", False),
    ("deepseek-v2-236b", False), ("whisper-large-v3", False)])
def test_check_trainable_refuses_mamba_blocks_on_the_card(arch, mamba):
    """The SSD scan has a backward kernel, so every config trains on a CUDA
    device, published and reduced, Mamba-2 blocks included; what the card
    refuses is a Mamba-2 block wider than that kernel takes (a state past
    128), which the CPU trains."""
    cfg = get_config(arch).reduced()
    check_trainable(cfg, "cpu")
    check_trainable(cfg, torch.device("cuda"))
    check_trainable(get_config(arch), "cuda")
    if mamba:
        wide = dataclasses.replace(cfg, ssm_state=256)
        with pytest.raises(ValueError, match="SSD backward kernel"):
            check_trainable(wide, "cuda")
        check_trainable(wide, "cpu")


BWD_DIMS = [(dk, dv) for dk in (20, 48, 64, 80, 128, 192, 256)
            for dv in sorted({dk, min(dk, 128), min(dk, 64), 16})]


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("dk,dv", BWD_DIMS)
def test_bwd_plan_fits_the_card(elem_bytes, dk, dv):
    """Every head-dim bucket: both kernels' shared memory within a CTA's
    232,448 bytes, bf16 on wgmma (head dims padded to the 64-column
    swizzle atom; dK and dV split across the two warpgroups above 128) and
    f32 on mma.sync, one dK / dV launch and three kernels a call."""
    p = fa.bwd_plan(4, 512, 512, 16, 8, dk, elem_bytes, dv=dv)
    assert max(p.kv_smem_bytes, p.dq_smem_bytes) <= fa.MAX_SMEM_BYTES
    assert p.d_pad >= dk and p.dv_pad >= dv and p.dv_pad <= p.d_pad
    assert p.kv_launches == 1 and p.kernels == 3
    if elem_bytes == 2:
        assert p.route == "wgmma" and p.stages >= 2
        assert p.d_pad % 64 == 0 and p.dv_pad % 64 == 0
        assert p.kv_split == (p.d_pad > 128)
        assert p.kv_warpgroups == (2 if p.kv_split else 1)
        assert p.kv_keys == 64 and p.kv_ctas == 8 * 8 * 4
        # the dQ accumulator and its two score tiles in one thread's 255
        # registers
        assert p.d_pad // 2 + p.dq_key_tile <= 160
    else:
        assert p.route == "mma.sync" and p.stages == 1
        assert p.kv_split == (p.d_pad > 128)
        assert p.kv_ctas == (2 if p.kv_split else 1) * 8 * 8 * 4
    assert p.dq_ctas == 8 * 16 * 4


WALKS = [(40, 40, dict(causal=True)), (130, 130, dict(causal=True)),
         (200, 200, dict(causal=True, window=7)),
         (300, 300, dict(causal=True, window=100)),
         (129, 129, dict(causal=False, window=70)),
         (100, 40, dict(causal=False)), (45, 150, dict(causal=False)),
         (1, 9, dict(causal=False)), (77, 77, dict(causal=True)),
         (129, 129, dict(causal=True)), (65, 65, dict(causal=True,
                                                     window=64)),
         (200, 200, dict(causal=True, window=66)),
         (260, 260, dict(causal=True, window=127))]


def _seen(sq, sk, causal, window=0):
    q = torch.arange(sq)[:, None]
    k = torch.arange(sk)[None, :]
    m = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        m &= k <= q
    if window > 0:
        m &= k > q - window
    return m


@pytest.mark.parametrize("sq,sk,kw", WALKS)
def test_bwd_walks_cover_every_seen_pair(sq, sk, kw):
    """Every seen (query, key) pair lies in a tile the dK / dV kernel walks
    for its key tile and the dQ kernel walks for its query block, at both
    routes' tiles; a live-false block holds no seen pair, a mask-free one
    no unseen pair the kernel would sum."""
    causal, window = kw["causal"], kw.get("window", 0)
    seen = _seen(sq, sk, causal, window)
    for keys, tile in ((128, 64), (64, 64), (64, 32)):
        for k0 in range(0, sk, keys):
            nk = min(keys, sk - k0)
            lo, hi = fa.bwd_query_range(k0, nk, sq, causal, window, tile)
            assert lo % tile == 0
            rows = seen[:, k0:k0 + nk].any(dim=1).nonzero().flatten()
            if len(rows):
                assert lo <= int(rows.min()) and int(rows.max()) < hi
    for tile in (64, 32):
        for q0 in range(0, sq, 64):
            rows = min(64, sq - q0)
            lo, hi = fa.bwd_key_range(q0, rows, sk, causal, window, tile)
            assert lo % tile == 0
            cols = seen[q0:q0 + rows].any(dim=0).nonzero().flatten()
            if len(cols):
                assert lo <= int(cols.min()) and int(cols.max()) < hi
            for k0 in range(lo, hi, tile):
                live, masked = fa.bwd_q_block(k0, tile, q0, rows, sk,
                                              causal, window)
                block = seen[q0:q0 + rows, k0:k0 + tile]
                if not live:
                    assert not block.any()
                if not masked:
                    assert block.shape[1] == tile and block.all()
    for kw_lo in range(0, sk, 64):
        w_rows = min(64, sk - kw_lo)
        for q0 in range(0, sq, 64):
            nq = min(64, sq - q0)
            live, masked = fa.bwd_kv_block(q0, nq, kw_lo, w_rows, causal,
                                           window)
            block = seen[q0:q0 + nq, kw_lo:kw_lo + w_rows]
            if not live:
                assert not block.any()
            if not masked:
                assert block.all()
