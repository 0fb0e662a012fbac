"""The plain versions of the port's LLM kernels against the JAX package.

Each plain version in ``repro_torch.kernels.ref`` (what the kernel wrappers
run on CPU tensors, and what ``chip_smoke.py`` holds the CUDA kernels to
on the card) is held, on the same numpy inputs, to

* the Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs
  it on the CPU),
* the naive oracle ``repro/kernels/ref.py``, and
* the model's function the port puts the kernel in place of
  (``models/layers.rmsnorm``, ``chunked_attention``, ``ssm.ssd_chunked``).

Tolerances (f32): rmsnorm and attention 2e-5, SSD 2e-4, those of
``tests/test_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_attention  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402

ATOL = dict(atol=2e-5, rtol=2e-5)
SSD_TOL = dict(atol=2e-4, rtol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("shape", [(3, 5, 128), (7, 80), (1, 1, 80)])
def test_rmsnorm_plain_matches_pallas_oracle_and_model(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    got = tref.rmsnorm_ref(_t(x), _t(w)).numpy()
    pallas = pallas_rmsnorm(jnp.asarray(x), jnp.asarray(w), block_rows=4,
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **ATOL)
    np.testing.assert_allclose(got, np.asarray(jref.rmsnorm(x, w)), **ATOL)
    model = jlayers.rmsnorm({"scale": jnp.asarray(w)}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(model), **ATOL)
    np.testing.assert_array_equal(rmsnorm(_t(x), _t(w)).numpy(), got)


def test_rmsnorm_keeps_the_input_dtype():
    x = torch.randn(4, 128, generator=torch.Generator().manual_seed(0))
    w = torch.ones(128)
    assert rmsnorm(x.to(torch.bfloat16), w).dtype == torch.bfloat16
    assert rmsnorm(x, w).dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [20, 80, 2560, 5120, 2561])
def test_rmsnorm_plan_covers_the_row(d, dtype):
    """The kernel's load width and CTA shape: 16-byte vectors where the
    row's byte width allows them, a warp per narrow row (4 rows a CTA), a
    CTA sized to a wide row, and every element held by some thread."""
    expect = {  # (d, x bytes): (vec, per_thread, threads, rows_per_cta)
        (20, 4): (4, 4, 128, 4), (20, 2): (1, 4, 128, 4),
        (80, 4): (4, 4, 128, 4), (80, 2): (8, 4, 128, 4),
        (2560, 4): (4, 4, 160, 1), (2560, 2): (8, 4, 96, 1),
        (5120, 4): (4, 8, 160, 1), (5120, 2): (8, 4, 160, 1),
        (2561, 4): (1, 16, 192, 1), (2561, 2): (1, 16, 192, 1)}
    for wdtype in (torch.float32, torch.bfloat16):
        p = trms.plan(d, dtype, wdtype)
        assert (p.vec, p.per_thread, p.threads, p.rows_per_cta) == \
            expect[d, dtype.itemsize]
        assert p.code == trms.pack(dtype == torch.bfloat16,
                                   wdtype == torch.bfloat16, *p[:4])
        width = 32 if p.rows_per_cta > 1 else p.threads
        assert width * p.per_thread * p.vec >= d
        assert p.threads <= trms.MAX_THREADS and p.threads % 32 == 0
    # a pointer off the 16-byte grid takes scalar accesses
    assert trms.plan(d, dtype, dtype, aligned=False).vec == 1
    with pytest.raises(ValueError, match="wider"):
        trms.plan(8192 * 16 // dtype.itemsize + 16, dtype, dtype)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trms.plan(d, torch.float16, dtype)


# ---------------------------------------------------------------- attention
ATTN_CASES = {
    # b, sq, sk, h, hkv, dh, causal, window
    "causal-mha": (1, 32, 32, 4, 4, 32, True, 0),
    "gqa-ragged": (2, 40, 40, 4, 2, 32, True, 0),
    "bidirectional": (2, 24, 24, 4, 2, 16, False, 0),
    "mqa-window": (1, 64, 64, 8, 1, 16, True, 24),
    "odd-window": (2, 17, 33, 2, 2, 64, True, 8),
    "dh80": (1, 37, 37, 4, 4, 80, True, 0),
    "gqa8-dh80": (1, 20, 20, 8, 1, 80, True, 0),
    "gqa2-window-dh256": (1, 40, 40, 8, 4, 256, True, 16),   # gemma3
    "gqa16-dh128": (1, 24, 24, 16, 1, 128, True, 0),         # glm4
}


def _qkv(rng, b, sq, sk, h, hkv, dh):
    return (rng.normal(size=(b, sq, h, dh)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_plain_matches_pallas_oracle_and_model(case):
    b, sq, sk, h, hkv, dh, causal, window = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = _qkv(rng, b, sq, sk, h, hkv, dh)
    got = tref.attention_ref(_t(q), _t(k), _t(v), causal=causal,
                             window=window, block_k=16).numpy()
    pallas = pallas_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **ATOL)
    oracle = jref.attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), **ATOL)
    if sq == sk:   # the model's own call: q and kv at positions 0..S-1
        pos = jnp.arange(sq)
        model = jlayers.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=pos,
            kv_positions=pos, causal=causal,
            window=jnp.asarray(window) if window else None, block_k=16)
        np.testing.assert_allclose(got, np.asarray(model), **ATOL)
    wrapped = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, block_k=16)
    np.testing.assert_array_equal(wrapped.numpy(), got)


@pytest.mark.parametrize("h,hkv,dh,valid,window", [
    (4, 2, 32, 37, 0), (32, 32, 80, 50, 0), (8, 1, 80, 64, 0),
    (4, 4, 32, 61, 16)])
def test_attention_plain_decode_mode(h, hkv, dh, valid, window):
    """Sq = 1 against a cache of 64 rows, ``valid`` of them written: the
    query sits at ``valid - 1`` (gqa_decode's q_offset = cache_len)."""
    rng = np.random.default_rng(valid)
    b, cache = 2, 64
    q, k, v = _qkv(rng, b, 1, cache, h, hkv, dh)
    kw = dict(causal=True, q_offset=valid - 1, kv_valid_len=valid)
    got = tref.attention_ref(_t(q), _t(k), _t(v), window=window,
                             block_k=16, **kw).numpy()
    pallas = pallas_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=8, block_k=16, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), **ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.attention(q, k, v, window=window, **kw)),
        **ATOL)
    model = jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray([valid - 1]), kv_positions=jnp.arange(cache),
        causal=True, window=jnp.asarray(window) if window else None,
        kv_valid_len=jnp.asarray(valid), block_k=1024)
    np.testing.assert_allclose(got, np.asarray(model), **ATOL)


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", [*range(16, 257, 16), 72])
def test_attention_plan_fits_shared_memory(dh, elem_bytes):
    """Each variant's CTA fits Hopper's shared memory at every head dim up
    to 256, and the plan picks the variant and split count it should."""
    # zamba2's serve decode: 8 slots at 1,027 cached rows, 32 KV heads
    dec = tfa.plan(8, 1, 1280, 32, 32, dh, elem_bytes, q_offset=1026,
                   kv_valid=1027)
    assert (dec.variant, dec.n_split, dec.block_k) == ("decode", 3, 32)
    assert dec.d_pad == -(-dh // 16) * 16
    # a 996-token prefill
    pre = tfa.plan(1, 996, 996, 32, 32, dh, elem_bytes)
    assert (pre.variant, pre.n_split) == ("prefill", 0)
    assert pre.block_k == (32 if elem_bytes == 4 else 64)
    for p in (dec, pre):
        assert p.smem_bytes <= tfa.MAX_SMEM_BYTES == 232_448
    # Sq * H / Hkv = 16 still decodes; 32 does not
    assert tfa.plan(2, 2, 70, 16, 2, dh, elem_bytes).variant == "decode"
    assert tfa.plan(2, 4, 70, 16, 2, dh, elem_bytes).variant == "prefill"
    # a long cache: 16 (batch, KV head) pairs take 33 splits, 4 CTAs an SM
    long = tfa.plan(2, 1, 4096, 8, 8, dh, elem_bytes, q_offset=3000,
                    kv_valid=3001)
    assert long.n_split == 33
    # no more splits than 32-key tiles; one split when no key is seen
    assert tfa.plan(1, 1, 64, 4, 4, dh, elem_bytes, q_offset=40,
                    kv_valid=41).n_split == 2
    assert tfa.plan(2, 4, 8, 2, 2, dh, elem_bytes, kv_valid=0).n_split == 1


@pytest.mark.parametrize("arch", list_archs())
def test_attention_head_dims_fit_the_kernel(arch):
    """Every registered config with attention runs its head dims through
    the kernel: GQA's head dim, and MLA's prefill keys (qk_nope + qk_rope)
    with its narrower values (v_head)."""
    cfg = get_config(arch)
    if cfg.attn == "gqa":
        assert cfg.head_dim <= tfa.MAX_HEAD_DIM
        assert cfg.n_heads % cfg.n_kv_heads == 0
    if cfg.attn == "mla":
        assert cfg.v_head <= cfg.qk_nope + cfg.qk_rope <= tfa.MAX_HEAD_DIM


# MLA's prefill: keys of qk_nope + qk_rope, values of v_head, one KV head a
# query head (reduced deepseek 48 / 32; DeepSeek-V2 192 / 128)
@pytest.mark.parametrize("b,s,h,dk,dv,valid", [
    (2, 37, 4, 48, 32, None), (1, 70, 8, 192, 128, None),
    (1, 40, 4, 192, 128, 23), (2, 5, 4, 48, 32, None)])
def test_attention_plain_value_width_matches_model(b, s, h, dk, dv, valid):
    """attention_ref and the wrapper with Dv < Dk against the JAX
    ``chunked_attention`` (its "value width may differ" path)."""
    rng = np.random.default_rng(dk + s)
    q = rng.normal(size=(b, s, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, s, h, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    scale = 1.0 / np.sqrt(dk)
    got = tref.attention_ref(_t(q), _t(k), _t(v), kv_valid_len=valid,
                             softmax_scale=scale, block_k=16)
    assert got.shape == (b, s, h, dv)
    pos = jnp.arange(s)
    model = jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=pos,
        kv_positions=pos, causal=True, softmax_scale=scale,
        kv_valid_len=None if valid is None else jnp.asarray(valid),
        block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(model), **ATOL)
    wrapped = flash_attention(_t(q), _t(k), _t(v), kv_valid_len=valid,
                              softmax_scale=scale, block_k=16)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
def test_attention_plan_value_width(elem_bytes):
    """DeepSeek-V2's prefill (1 x 512 x 128 heads, Dk 192 in the 256 bucket,
    Dv 128) fits a CTA's shared memory, its V rows at V's own width; a Dv
    that differs from Dk takes the prefill variant even where the decode
    variant would serve Dv == Dk."""
    p = tfa.plan(1, 512, 512, 128, 128, 192, elem_bytes, dv=128)
    assert (p.variant, p.d_pad, p.dv_pad) == ("prefill", 192, 128)
    assert p.smem_bytes <= tfa.MAX_SMEM_BYTES
    same = tfa.plan(1, 512, 512, 128, 128, 192, elem_bytes)
    assert p.smem_bytes < same.smem_bytes
    # Q's 64 rows and two K / V buffers at padded row strides: f32 208 / 132
    # words (32-key tiles), bf16 200 / 136 elements (64-key tiles)
    assert p.smem_bytes == {4: 4 * (64 * 208 + 2 * 32 * (208 + 132)),
                            2: 2 * (64 * 200 + 2 * 64 * (200 + 136))
                            }[elem_bytes] == {4: 140_288,
                                              2: 111_616}[elem_bytes]
    assert tfa.plan(1, 4, 64, 4, 4, 48, elem_bytes).variant == "decode"
    assert tfa.plan(1, 4, 64, 4, 4, 48, elem_bytes,
                    dv=32).variant == "prefill"
    assert tfa.plan(1, 4, 64, 4, 4, 48, elem_bytes,
                    dv=48).variant == "decode"


def test_attention_wrapper_value_width_bounds():
    """The wrapper takes Dv <= Dk and refuses Dv > Dk (and other ragged
    shapes), on the CPU as on the card."""
    q = torch.zeros(1, 3, 4, 32)
    k = torch.zeros(1, 5, 2, 32)
    assert flash_attention(q, k, torch.zeros(1, 5, 2, 16)).shape == (
        1, 3, 4, 16)
    assert flash_attention(q, k, torch.zeros(1, 5, 2, 32)).shape == (
        1, 3, 4, 32)
    for v in (torch.zeros(1, 5, 2, 48), torch.zeros(1, 4, 2, 16),
              torch.zeros(1, 5, 1, 16), torch.zeros(1, 5, 2, 0)):
        with pytest.raises(ValueError, match="Dv <= Dh"):
            flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 2, 1, 272)
        flash_attention(big, big, big)


def test_attention_rows_that_see_no_key_are_zero():
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 4, 8, 2, 2, 16)
    got = tref.attention_ref(_t(q), _t(k), _t(v), causal=True, q_offset=0,
                             kv_valid_len=0)
    assert torch.count_nonzero(got) == 0
    exp = jref.attention(q, k, v, causal=True, kv_valid_len=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


# ------------------------------------------------------------------ SSD
def _ssd_inputs(rng, b, s, h, p, n):
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32),
            rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 32, 2, 8, 16, 16), (2, 50, 3, 8, 16, 16), (1, 16, 1, 16, 8, 16),
    (2, 33, 2, 4, 4, 8), (1, 140, 2, 16, 16, 128)])
def test_ssd_plain_matches_pallas_oracle_and_model(b, s, h, p, n, chunk):
    rng = np.random.default_rng(s * 7 + h)
    x, dt, a, bm, cm = _ssd_inputs(rng, b, s, h, p, n)
    y, st = tref.ssd_ref(*map(_t, (x, dt, a, bm, cm)), chunk=chunk)
    jx = [jnp.asarray(t) for t in (x, dt, a, bm, cm)]
    for name, (ye, ste) in {
            "pallas": pallas_ssd(*jx, chunk=chunk, interpret=True),
            "oracle": jref.ssd(*jx),
            "model": jssm.ssd_chunked(*jx, chunk=chunk)}.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(ye), **SSD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(st.numpy(), np.asarray(ste), **SSD_TOL,
                                   err_msg=name)


def test_ssd_plain_initial_state_and_continuation():
    rng = np.random.default_rng(11)
    b, s, h, p, n, cut = 2, 40, 2, 8, 8, 24
    x, dt, a, bm, cm = _ssd_inputs(rng, b, s, h, p, n)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    tx = list(map(_t, (x, dt, a, bm, cm)))
    y, st = tref.ssd_ref(*tx, chunk=8, initial_state=_t(s0))
    ye, ste = jref.ssd(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)),
                       initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ye), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(ste), **SSD_TOL)
    yp, stp = pallas_ssd(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)),
                            chunk=8, initial_state=jnp.asarray(s0),
                            interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(stp), **SSD_TOL)

    def part(sl, init):
        xs, dts, bs, cs = (t[:, sl] for t in (tx[0], tx[1], tx[3], tx[4]))
        return tref.ssd_ref(xs, dts, tx[2], bs, cs, chunk=8,
                            initial_state=init)
    y_full, st_full = tref.ssd_ref(*tx, chunk=8)
    y1, st1 = part(slice(0, cut), None)
    y2, st2 = part(slice(cut, s), st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), **SSD_TOL)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(), **SSD_TOL)


@pytest.mark.parametrize("chunk,s,p,n,expect,kb", [
    (128, 1024, 64, 64, 128, 169),   # zamba2-2.7b prefill
    (128, 37, 64, 64, 37, 60),       # a prompt shorter than a chunk
    (128, 1024, 64, 128, 64, 126),   # mamba2-1.3b's dstate: halved to fit
    (256, 4096, 64, 64, 128, 169)])  # at most 8 tiles of 16 steps
def test_ssd_kernel_chunk_fits_shared_memory(chunk, s, p, n, expect, kb):
    """The chunk length and the larger tile CTA's shared memory (KB): the
    chunk-scan CTA holds C B^T, C, B or x, and the state before the
    chunk."""
    L = tssd.kernel_chunk(chunk, s, p, n)
    assert L == expect
    assert tssd.smem_bytes(L, p, n) // 1024 == kb
    assert tssd.smem_bytes(L, p, n) <= tssd.MAX_SMEM_BYTES
    if L < min(chunk, s, tssd.MAX_CHUNK):
        assert tssd.smem_bytes(2 * L, p, n) > tssd.MAX_SMEM_BYTES


@pytest.mark.parametrize("b,s,h,p,n,plan", [
    # zamba2-2.7b's 996-token prefill: 80 heads, 8 chunks, one wave of
    # chunk-scan CTAs (16 or 17 a chunk, 4 or 5 heads each)
    (1, 996, 80, 64, 64, (128, 8, 5, 640, 132)),
    # mamba2-1.3b (64 heads, dstate 128): 16 chunks of 64
    (1, 1000, 64, 64, 128, (64, 16, 8, 1024, 132)),
    # a short prompt: one head a CTA; a batch of two
    (1, 37, 80, 64, 64, (37, 1, 1, 80, 80)),
    (2, 300, 80, 64, 64, (128, 3, 4, 480, 132))])
def test_ssd_plan_fills_the_card(b, s, h, p, n, plan):
    """Chunk length and count, the most heads a chunk-scan CTA serves, and
    the CTAs of the chunk-state and chunk-scan kernels; at the zamba2 serve
    shape both have at least one CTA for each of the 132 SMs."""
    pl = tssd.plan(b, s, h, p, n)
    assert (pl.chunk, pl.n_chunks, pl.heads_per_cta, pl.state_ctas,
            pl.scan_ctas) == plan
    assert pl.smem_bytes <= tssd.MAX_SMEM_BYTES
    if (s, h) == (996, 80):
        assert pl.state_ctas >= 132 and pl.scan_ctas >= 132
    # the kernel's map of scan CTAs to (chunk, heads) covers each pair once
    Q, K = b * pl.n_chunks, pl.scan_ctas
    first = lambda i: (i * K + Q - 1) // Q  # noqa: E731
    seen = []
    for cid in range(K):
        q = cid * Q // K
        j, n_q = cid - first(q), first(q + 1) - first(q)
        heads = range(j * h // n_q, (j + 1) * h // n_q)
        assert 1 <= len(heads) <= pl.heads_per_cta
        seen += [(q, hh) for hh in heads]
    assert sorted(seen) == [(q, hh) for q in range(Q) for hh in range(h)]


def test_ssd_plain_chunk_length_does_not_change_the_result():
    """The kernel may scan in shorter chunks than asked (shared memory);
    the function is the same."""
    rng = np.random.default_rng(3)
    tx = list(map(_t, _ssd_inputs(rng, 1, 70, 2, 8, 16)))
    y1, s1 = tref.ssd_ref(*tx, chunk=64)
    y2, s2 = tref.ssd_ref(*tx, chunk=16)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **SSD_TOL)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), **SSD_TOL)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rmsnorm(x, torch.ones(8, device="meta"))
    q = torch.zeros(1, 2, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tssd.ssd_scan(torch.zeros(1, 4, 2, 8, device="meta"),
                      *(torch.zeros(1, 4, 2, device="meta"),
                        torch.ones(2, device="meta"),
                        torch.zeros(1, 4, 8, device="meta"),
                        torch.zeros(1, 4, 8, device="meta")))
