"""The port's MLA (``repro_torch.models.layers``: ``MLA``, ``mla_latent``,
``mla_attention_from_latent``, ``mla_decode``) against the JAX package's
``repro.models.layers``, on the CPU.

The same ``init_mla`` weights (crossed with ``module_from_numpy``) and
inputs go through both, in f32 at 2e-4: the latent pair, prefill
attention from the latent (through the flash-attention wrapper's plain
version, keys of qk_nope + qk_rope and narrower values), and decode steps
with weight absorption, the latent caches compared leaf by leaf after
each step.  Widths: reduced DeepSeek-V2 (d 128, 4 heads, q_lora 64,
kv_lora 32, qk_nope 32, qk_rope 16, v_head 32) and a wider one (8 heads,
keys 96, values 64).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.convert import module_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
THETA = 10_000.0
DIMS = {
    "reduced": dict(d=128, h=4, q_lora=64, kv_lora=32, qk_nope=32,
                    qk_rope=16, v_head=32),
    "wide": dict(d=96, h=8, q_lora=48, kv_lora=64, qk_nope=64, qk_rope=32,
                 v_head=64),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(name):
    dm = DIMS[name]
    kw = {k: dm[k] for k in ("q_lora", "kv_lora", "qk_nope", "qk_rope",
                             "v_head")}
    p = JL.init_mla(jax.random.key(len(name)), dm["d"], dm["h"], **kw)
    flat = {}
    for k, v in p.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{n}": np.asarray(a) for n, a in v.items()})
        else:
            flat[k] = np.asarray(v)
    model = module_from_numpy(TL.MLA(dm["d"], dm["h"], device="cpu", **kw),
                              flat)
    return dm, p, model


def _x(dm, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, dm["d"])).astype(np.float32)


@pytest.mark.parametrize("name", sorted(DIMS))
def test_mla_latent_matches_jax(name):
    dm, p, model = _pair(name)
    x = _x(dm, 2, 11, 0)
    pos = np.arange(3, 14)
    jc, jr = JL.mla_latent(p, jnp.asarray(x), jnp.asarray(pos), THETA,
                           jnp.float32, kv_lora=dm["kv_lora"],
                           qk_rope=dm["qk_rope"])
    tc, tr = TL.mla_latent(model, _t(x), _t(pos), THETA, torch.float32,
                           kv_lora=dm["kv_lora"], qk_rope=dm["qk_rope"])
    assert tc.shape == (2, 11, dm["kv_lora"])
    assert tr.shape == (2, 11, 1, dm["qk_rope"])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)


@pytest.mark.parametrize("s", [1, 9, 40])
@pytest.mark.parametrize("name", sorted(DIMS))
def test_mla_attention_from_latent_matches_jax(name, s):
    """Prefill over s tokens at positions 0..s-1 (causal), the port's
    attention through the flash-attention wrapper with Dv < Dk."""
    dm, p, model = _pair(name)
    x = _x(dm, 2, s, s)
    pos = jnp.arange(s)
    jc, jr = JL.mla_latent(p, jnp.asarray(x), pos, THETA, jnp.float32,
                           kv_lora=dm["kv_lora"], qk_rope=dm["qk_rope"])
    kw = dict(n_heads=dm["h"], qk_nope=dm["qk_nope"], qk_rope=dm["qk_rope"],
              v_head=dm["v_head"], rope_theta=THETA, causal=True)
    exp = JL.mla_attention_from_latent(
        p, jnp.asarray(x), jc, jr, q_positions=pos, kv_positions=pos,
        dtype=jnp.float32, block_k=16, **kw)
    tc, tr = TL.mla_latent(model, _t(x), torch.arange(s), THETA,
                           torch.float32, kv_lora=dm["kv_lora"],
                           qk_rope=dm["qk_rope"])
    got = TL.mla_attention_from_latent(model, _t(x), tc, tr,
                                       dtype=torch.float32, block_k=16,
                                       **kw)
    assert got.shape == (2, s, dm["d"])
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("name", sorted(DIMS))
def test_mla_decode_matches_jax(name):
    """Four decode steps from a prefilled latent cache of 24 rows (13
    written), each writing its row in place; outputs and both caches leaf
    by leaf after every step."""
    dm, p, model = _pair(name)
    b, size, clen = 2, 24, 13
    rng = np.random.default_rng(7)
    ckv = np.zeros((b, size, dm["kv_lora"]), np.float32)
    krope = np.zeros((b, size, dm["qk_rope"]), np.float32)
    ckv[:, :clen] = rng.normal(size=(b, clen, dm["kv_lora"]))
    krope[:, :clen] = rng.normal(size=(b, clen, dm["qk_rope"]))
    jck, jkr = jnp.asarray(ckv), jnp.asarray(krope)
    tck, tkr = _t(ckv), _t(krope)
    kw = dict(n_heads=dm["h"], kv_lora=dm["kv_lora"], qk_nope=dm["qk_nope"],
              qk_rope=dm["qk_rope"], v_head=dm["v_head"], rope_theta=THETA)
    for step in range(4):
        x = _x(dm, b, 1, 20 + step)
        jo, jck, jkr = JL.mla_decode(p, jnp.asarray(x), jck, jkr,
                                     jnp.asarray(clen), dtype=jnp.float32,
                                     **kw)
        to, tck2, tkr2 = TL.mla_decode(model, _t(x), tck, tkr, clen,
                                       dtype=torch.float32, **kw)
        assert tck2 is tck and tkr2 is tkr      # written in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL,
                                   err_msg=f"step {step}")
        for got, exp, leaf in ((tck, jck, "ckv"), (tkr, jkr, "krope")):
            np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL,
                                       err_msg=f"{leaf} step {step}")
        clen += 1


def test_mla_decode_refuses_a_full_cache():
    dm, _, model = _pair("reduced")
    ckv = torch.zeros(1, 4, dm["kv_lora"])
    krope = torch.zeros(1, 4, dm["qk_rope"])
    with pytest.raises(ValueError, match="outside a cache of 4"):
        TL.mla_decode(model, torch.zeros(1, 1, dm["d"]), ckv, krope, 4,
                      n_heads=dm["h"], kv_lora=dm["kv_lora"],
                      qk_nope=dm["qk_nope"], qk_rope=dm["qk_rope"],
                      v_head=dm["v_head"], rope_theta=THETA,
                      dtype=torch.float32)
