"""The port's encoder-decoder and modality frontends against the JAX package,
on the CPU.

Reduced whisper-large-v3 (``enc`` and ``dec`` blocks, cross-attention, the
cross-KV cache, precomputed audio frames) and reduced internvl2-2b (vision
patches prepended to the tokens).  The JAX ``init_params(jax.random.key(0),
cfg)`` weights cross into the port with ``lm_params_from_numpy``; frames
and patches come from ``numpy.random.default_rng(seed)``; everything is f32
at atol = rtol = 2e-4.

Fault C9 (ROADMAP §C): the reference's serving engine prefills tokens only,
so it cannot serve an encoder-decoder (``KeyError: 'frames'``).  The port's
engine refuses one at construction; the strict xfail flips when the
reference is fixed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,  # noqa
                                 lm_params_from_numpy, module_from_numpy)
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from test_torch_llm import TOL, _flat, _tokens  # noqa: E402

ARCHS = {"whisper": "whisper-large-v3", "internvl2": "internvl2-2b"}
_CACHE = {}


def _pair(name):
    """(cfg, JAX params, the port's model), built once per arch."""
    if name not in _CACHE:
        cfg = get_config(ARCHS[name]).reduced()
        params = JT.init_params(jax.random.key(0), cfg)
        _CACHE[name] = (cfg, params,
                        lm_params_from_numpy(_flat(params), cfg, "cpu"))
    return _CACHE[name]


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(name, cfg, b, s, seed):
    """(JAX batch, the port's batch): tokens, and the arch's frames or
    patches (``n_frontend_tokens`` rows of width d)."""
    arrays = {"tokens": _tokens(cfg, (b, s), seed)}
    extra = "frames" if name == "whisper" else "patches"
    arrays[extra] = _normal((b, cfg.n_frontend_tokens, cfg.d_model),
                            seed + 100)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _layer(flat, prefix, layer):
    """One layer's leaves of a stacked JAX segment, keyed below
    ``prefix``."""
    return {k[len(prefix):]: v[layer] for k, v in flat.items()
            if k.startswith(prefix)}


def test_cross_attention_matches_jax():
    cfg, params, _ = _pair("whisper")
    flat = _flat(params)
    cross = module_from_numpy(
        TL.CrossAttention(cfg.d_model, cfg.n_heads, cfg.head_dim),
        _layer(flat, "segments/0/cross/", 1))
    x, enc = _normal((2, 7, cfg.d_model), 1), _normal((2, 23, cfg.d_model), 2)
    heads = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim)
    exp = JL.cross_attention(
        jax.tree_util.tree_map(lambda a: a[1], params["segments"][0]["cross"]),
        jnp.asarray(x), jnp.asarray(enc), dtype=jnp.float32, **heads)
    got = TL.cross_attention(cross, torch.from_numpy(x),
                             torch.from_numpy(enc), dtype=torch.float32,
                             **heads)
    assert got.shape == (2, 7, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    ck, cv = TL.cross_kv(cross, torch.from_numpy(enc), dtype=torch.float32,
                         **heads)
    assert ck.shape == cv.shape == (2, 23, cfg.n_heads, cfg.head_dim)
    again = TL.cross_cached(cross, torch.from_numpy(x), ck, cv,
                            dtype=torch.float32, **heads)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_run_encoder_matches_jax():
    cfg, params, model = _pair("whisper")
    frames = _normal((2, cfg.n_frontend_tokens, cfg.d_model), 3)
    exp = JT.run_encoder(params, cfg, jnp.asarray(frames), jnp.float32,
                         remat="none")
    got = T.run_encoder(model, cfg, torch.from_numpy(frames), torch.float32)
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_logits_with_frontend_matches_jax(name):
    cfg, params, model = _pair(name)
    jb, tb = _batch(name, cfg, 2, 21, 4)
    exp = JT.forward_logits(params, cfg, jb, dtype=jnp.float32)
    got = T.forward_logits(model, cfg, tb, dtype=torch.float32)
    assert got.shape == (2, 21, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_and_three_decode_steps_with_frontend_match_jax(name):
    cfg, params, model = _pair(name)
    s, size = 19, 48
    jb, tb = _batch(name, cfg, 2, s, 5)
    jl, jc = JD.prefill(params, cfg, jb, cache_size=size, dtype=jnp.float32)
    tl, tc = TD.prefill(model, cfg, tb, cache_size=size, dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jflat, tflat = _flat(jc), cache_to_numpy(tc)
    assert sorted(jflat) == sorted(tflat)
    leaves = {k.rsplit("/", 1)[1] for k in jflat}
    assert leaves == ({"k", "v", "ck", "cv"} if name == "whisper"
                      else {"k", "v"})
    for key in jflat:
        assert jflat[key].shape == tflat[key].shape, key
        np.testing.assert_allclose(tflat[key], jflat[key], **TOL,
                                   err_msg=key)

    # decode from the JAX cache carried across; a vision prompt's patches
    # take the first P positions
    tc = cache_from_numpy(jflat, cfg, "cpu")
    clen = s + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    for step in range(3):
        tok = _tokens(cfg, (2, 1), 20 + step)
        jl, jc = JD.decode_step(params, cfg, jnp.asarray(tok), jc,
                                jnp.asarray(clen + step), dtype=jnp.float32)
        tl, tc = TD.decode_step(model, cfg, torch.from_numpy(tok), tc,
                                clen + step, dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
    jflat, tflat = _flat(jc), cache_to_numpy(tc)
    for key in jflat:
        np.testing.assert_allclose(tflat[key], jflat[key], **TOL,
                                   err_msg=key)


def test_convert_round_trips_encoder_and_cross_leaves():
    """Every JAX leaf (``enc_segments``, ``enc_norm`` and the ``dec``
    layers' ``cross`` / ``lnx`` among them) lands in the port's parameter
    of the same path, and the ``dec`` cache (``k v ck cv``) crosses both
    ways unchanged."""
    cfg, params, model = _pair("whisper")
    flat = _flat(params)
    named = dict(model.named_parameters())
    assert {k.split("/")[0] for k in flat} >= {"enc_segments", "enc_norm"}
    for part in ("/cross/wq", "/cross/wo", "/lnx/scale", "/lnx/bias"):
        assert any(k.startswith("segments/0") and k.endswith(part)
                   for k in flat), part
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] in ("segments", "enc_segments"):
            got = np.stack([named[".".join(parts[:2] + [str(i)]
                                           + parts[2:])].detach().numpy()
                            for i in range(arr.shape[0])])
        else:
            got = named[".".join(parts)].detach().numpy()
        np.testing.assert_array_equal(got, arr, err_msg=key)
    assert T.param_count(model) == sum(a.size for a in flat.values())
    assert sum(1 for k in named if k.endswith("cross.wk")) == cfg.n_layers
    assert [b.kind for b in model.enc_segments[0]] == ["enc"] * cfg.enc_layers
    assert [s.kind for s in model.plan] == ["dec"]
    jb, _ = _batch("whisper", cfg, 2, 9, 6)
    _, jc = JD.prefill(params, cfg, jb, cache_size=12, dtype=jnp.float32)
    jflat = _flat(jc)
    assert jflat["segments/0/ck"].shape == (
        cfg.n_layers, 2, cfg.n_frontend_tokens, cfg.n_heads, cfg.head_dim)
    back = cache_to_numpy(cache_from_numpy(jflat, cfg, "cpu"))
    assert sorted(back) == sorted(jflat)
    for key in jflat:
        np.testing.assert_array_equal(back[key], jflat[key], err_msg=key)


@pytest.mark.parametrize("enc_len", [None, 16])
def test_init_decode_cache_cross_rows_as_jax(enc_len):
    """``enc_len=None`` gives the cross cache one row, as JAX does."""
    cfg, _, _ = _pair("whisper")
    exp = _flat(JD.init_decode_cache(cfg, 3, 10, jnp.float32,
                                     enc_len=enc_len))
    got = cache_to_numpy(TD.init_decode_cache(cfg, 3, 10, torch.float32,
                                              "cpu", enc_len=enc_len))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in exp.items()}
    assert got["segments/0/ck"].shape[2] == (enc_len or 1)
    assert all(not v.any() for v in got.values())


def test_c9_port_engine_refuses_an_encoder_decoder():
    cfg, _, model = _pair("whisper")
    with pytest.raises(ValueError, match="ROADMAP §C9"):
        TE.ServeEngine(model, cfg, n_slots=2, max_len=32, device="cpu")
    TE.check_servable(_pair("internvl2")[0])


def test_c9_launch_serve_whisper_exits_nonzero(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "whisper-large-v3", "--reduced", "--device",
                 "cpu", "--requests", "2"]) != 0
    out = capsys.readouterr()
    assert "frontend is stubbed" in out.out
    assert "ROADMAP §C9" in out.err


def test_launch_serve_serves_internvl2_text_only(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "internvl2-2b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "frontend is stubbed" in out and "3/3 requests done" in out


@pytest.mark.xfail(strict=True, raises=KeyError,
                   reason="C9: the reference's ServeEngine prefills tokens "
                   "only; an encoder-decoder's prefill reads batch['frames'] "
                   "(serve/engine.py, models/decode.py)")
def test_c9_reference_engine_serves_whisper():
    cfg, params, _ = _pair("whisper")
    eng = JE.ServeEngine(params, cfg, n_slots=2, max_len=32)
    req = JE.Request(rid=0, prompt=_tokens(cfg, (5,), 7), max_new_tokens=3)
    eng.submit(req)
    eng.run_until_drained()
    assert req.done and len(req.out_tokens) == 3
