"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` local path, on the CPU.

The same ``init_moe`` weights (crossed with ``module_from_numpy``) and
inputs go through both; the gate indices and the dropped (token, slot)
assignments must be equal, ``out`` and ``aux`` within 2e-4.  The JAX
function does not return which assignments it dropped: it is read off
``_dispatch_compute`` with the gates of one slot at a time set to 1 (a
dropped assignment gives an exactly zero row).  Modelled on
``tests/test_moe.py``.

Fault C8 (ROADMAP §C): the reference's ``_dispatch_compute`` on an expert
shard (``e_local < E``, the body of ``apply_moe_sharded``) writes every
non-local assignment at position -1 of local expert 0, which its scatter
wraps to the last capacity slot, so a token kept there is lost.  The port
writes no non-local assignment; the strict xfail keeps the reference's
fault visible and flips when it is fixed.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro_torch.convert import module_from_numpy  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _pair(d, ff, e, n_shared, act, seed=0):
    p = JM.init_moe(jax.random.key(seed), d, ff, e, n_shared, act)
    model = TM.MoE(d, ff, e, n_shared, act, "cpu")
    return p, module_from_numpy(model, _flat(p))


def _jax_dropped(p, xf, gate_vals, gate_idx, capacity, act):
    """(T, k) bool: the JAX dispatch's dropped assignments, one slot at a
    time with that slot's gate set to 1 and the others to 0."""
    t, k = gate_idx.shape
    dropped = np.zeros((t, k), bool)
    for j in range(k):
        gates = jnp.zeros_like(gate_vals).at[:, j].set(1.0)
        out = JM._dispatch_compute(
            p, xf, gates, gate_idx, e_local=p["w1"].shape[0],
            expert_offset=0, capacity=capacity, act=act, dtype=jnp.float32)
        dropped[:, j] = np.all(np.asarray(out) == 0.0, axis=-1)
    return dropped


def _check(p, model, x, *, e, k, act, cf):
    """Route, drop and output of both packages on x; returns the dropped
    mask."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    jv, ji, jaux = JM._route(xf, p["router"], e, k, 0.01)
    tv, ti, taux = TM.route(_t(xf), model.router, e, k, 0.01)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)

    capacity = max(int(math.ceil(b * s * k / e * cf)), k)
    _, _, keep = TM.dispatch_plan(ti, e_local=e, expert_offset=0,
                                  capacity=capacity)
    dropped = ~keep.numpy().reshape(-1, k)
    np.testing.assert_array_equal(
        dropped, _jax_dropped(p, xf, jv, ji, capacity, act))

    jout, jaux2 = JM.apply_moe(p, x, n_experts=e, top_k=k, act=act,
                               dtype=jnp.float32, capacity_factor=cf)
    tout, taux2 = TM.apply_moe(model, _t(x), n_experts=e, top_k=k, act=act,
                               dtype=torch.float32, capacity_factor=cf)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux2), float(jaux2), **TOL)
    return dropped


@pytest.mark.parametrize("n_shared", [0, 1, 2])
@pytest.mark.parametrize("act", ["swiglu", "gelu", "geglu"])
def test_moe_matches_jax(act, n_shared):
    """Random tokens at the default capacity factor (1.25) and with room
    for every assignment (E)."""
    d, ff, e, k = 32, 16, 8, 2
    p, model = _pair(d, ff, e, n_shared, act)
    x = jax.random.normal(jax.random.key(1), (2, 12, d), jnp.float32)
    _check(p, model, x, e=e, k=k, act=act, cf=1.25)
    assert not _check(p, model, x, e=e, k=k, act=act, cf=float(e)).any()


@pytest.mark.parametrize("cf,k", [(0.125, 1), (0.5, 2), (0.3, 3)])
def test_moe_overflow_drops_the_same_assignments(cf, k):
    """A batch that overflows capacity: half the tokens identical (they
    route alike and collide), half random; the same (token, slot) pairs
    are dropped as in JAX."""
    d, ff, e = 16, 8, 4
    p, model = _pair(d, ff, e, 0, "swiglu", seed=2)
    same = jnp.broadcast_to(jax.random.normal(jax.random.key(2), (1, 1, d)),
                            (1, 8, d))
    rand = jax.random.normal(jax.random.key(3), (1, 8, d))
    x = jnp.concatenate([same, rand], axis=1)
    dropped = _check(p, model, x, e=e, k=k, act="swiglu", cf=cf)
    assert dropped.any(), "expected overflow drops"
    # the first token keeps every slot; drops only follow earlier takers
    assert not dropped[0].any()


def test_moe_bf16_weights_and_activations():
    """bf16 compute against JAX's bf16 path, at bf16's tolerance."""
    d, ff, e, k = 32, 16, 8, 2
    p, _ = _pair(d, ff, e, 1, "swiglu")
    pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
    pb["router"] = p["router"]
    model = module_from_numpy(TM.MoE(d, ff, e, 1, "swiglu", "cpu",
                                     torch.bfloat16),
                              {n: a.astype(np.float32) for n, a in
                               _flat(pb).items()})
    x = jax.random.normal(jax.random.key(4), (2, 9, d), jnp.bfloat16)
    jout, _ = JM.apply_moe(pb, x, n_experts=e, top_k=k, act="swiglu",
                           dtype=jnp.bfloat16)
    tout, _ = TM.apply_moe(
        model, _t(x.astype(jnp.float32)).to(torch.bfloat16), n_experts=e,
        top_k=k, act="swiglu", dtype=torch.bfloat16)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=5e-2, rtol=5e-2)


def test_moe_aux_loss_prefers_balance():
    """Uniform routing gives a lower aux loss than collapsed routing."""
    d, ff, e = 16, 8, 4
    _, model = _pair(d, ff, e, 0, "swiglu", seed=3)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 64, d)).astype(np.float32))
    _, aux_uniform = TM.apply_moe(model, x, n_experts=e, top_k=1,
                                  act="swiglu", dtype=torch.float32)
    with torch.no_grad():
        model.router.zero_()
        model.router[:, 0] = 10.0
    _, aux_collapsed = TM.apply_moe(model, x, n_experts=e, top_k=1,
                                    act="swiglu", dtype=torch.float32)
    assert float(aux_collapsed) > float(aux_uniform)


def _shard_case():
    d, ff, e, k, capacity = 32, 16, 8, 2, 4
    p = JM.init_moe(jax.random.key(0), d, ff, e, 0, "swiglu")
    xf = jax.random.normal(jax.random.key(1), (24, d), jnp.float32)
    gv, gi, _ = JM._route(xf, p["router"], e, k, 0.01)
    return p, xf, gv, gi, e, capacity


def test_port_expert_shards_sum_to_the_full_dispatch():
    """dispatch_compute over two expert shards (``e_local`` = E / 2 at
    offsets 0 and E / 2) sums to the full dispatch, which equals JAX's."""
    p, xf, gv, gi, e, capacity = _shard_case()
    args = [_t(a) for a in (xf, gv, gi)]
    args[2] = args[2].long()

    def port(lo, hi):
        m = TM.MoE(xf.shape[1], 16, hi - lo, 0, "swiglu", "cpu")
        module_from_numpy(m, {"router": np.zeros((xf.shape[1], hi - lo),
                                                 np.float32),
                              **{n: np.asarray(p[n][lo:hi])
                                 for n in ("w1", "w2", "w3")}})
        return TM.dispatch_compute(m, *args, e_local=hi - lo,
                                   expert_offset=lo, capacity=capacity,
                                   act="swiglu", dtype=torch.float32)

    full = port(0, e)
    torch.testing.assert_close(port(0, e // 2) + port(e // 2, e), full,
                               atol=1e-6, rtol=1e-6)
    jfull = JM._dispatch_compute(p, xf, gv, gi, e_local=e, expert_offset=0,
                                 capacity=capacity, act="swiglu",
                                 dtype=jnp.float32)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **TOL)


@pytest.mark.xfail(strict=True, reason="C8: a shard's non-local "
                   "assignments overwrite local expert 0's last capacity "
                   "slot (repro/models/moe.py _dispatch_compute)")
def test_c8_reference_expert_shards_sum_to_the_full_dispatch():
    p, xf, gv, gi, e, capacity = _shard_case()

    def ref(lo, hi):
        shard = {n: (a[lo:hi] if n != "router" else a) for n, a in p.items()}
        return JM._dispatch_compute(shard, xf, gv, gi, e_local=hi - lo,
                                    expert_offset=lo, capacity=capacity,
                                    act="swiglu", dtype=jnp.float32)

    full = ref(0, e)
    np.testing.assert_allclose(np.asarray(ref(0, e // 2) + ref(e // 2, e)),
                               np.asarray(full), atol=1e-5, rtol=1e-5)
