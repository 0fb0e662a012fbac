"""The SSD scan's backward on the CPU: the plain version the kernels
compute, the autograd function around the scan, and the backward's launch
plan.

* ``ssd_bwd_ref`` (what ``csrc/ssd_scan_bwd.cu`` computes, step by step)
  against ``jax.vjp`` of the JAX package's ``models/ssm.ssd_chunked`` and
  against ``torch.autograd`` of ``ssd_ref``: inputs, the output's and the
  final state's cotangents made with numpy from a seed; S a multiple of the
  chunk and ragged; with and without an initial state; (P, N) = (8, 16),
  (64, 64), (64, 128); chunks of 16, 64 and 128.  Both references compute
  in f32 in another order, so each output is held within 1e-4 of its
  largest |ref|.
* ``ssd_scan`` as an autograd function on the CPU: its gradients are
  ``ssd_bwd_ref``'s, for each of the six inputs, with either output unused.
* ``bwd_plan`` at every registered Mamba-2 config, published and reduced,
  at the training call, the serving path's prefill and a ragged short
  call: the chunk, a chunk-scan CTA's shared memory within the card's
  232,448 bytes (two sets of head tiles where they fit), the forward able
  to run at the backward's chunk, one wave of chunk-scan CTAs, the state
  CTAs' threads and shared memory, the scratch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.build import dtype_code  # noqa: E402
from repro_torch.kernels.ref import ssd_bwd_ref, ssd_ref  # noqa: E402

TOL = 1e-4
NAMES = ("dx", "ddt", "da", "db", "dc", "dinit")


def case(seed, bsz, s, h, p, n, init):
    """numpy-seeded f32 inputs (x, dt, a, b, c), the cotangents of y and of
    the final state, and an initial state or None."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    ins = (f(bsz, s, h, p), rng.uniform(0.05, 0.6, (bsz, s, h)).astype(
        np.float32), rng.uniform(0.5, 3.0, (h,)).astype(np.float32),
        f(bsz, s, n), f(bsz, s, n))
    return ins, f(bsz, s, h, p), f(bsz, h, p, n), f(bsz, h, p, n) if init \
        else None


def close(got, ref, label):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    big = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= TOL * max(big, 1e-30), (label, err, big)


CASES = [  # (B, S, H, P, N, chunk, initial state)
    (2, 48, 3, 8, 16, 16, False),      # S a multiple of the chunk
    (2, 40, 3, 8, 16, 16, True),       # ragged, from a state
    (1, 300, 4, 64, 64, 128, True),
    (1, 256, 2, 64, 64, 128, False),
    (2, 130, 2, 64, 128, 64, False),
    (1, 128, 2, 64, 128, 64, True),
    (1, 100, 3, 64, 64, 64, False)]


@pytest.mark.parametrize("bsz,s,h,p,n,chunk,init", CASES)
def test_ssd_bwd_ref_is_jaxs_gradient_of_ssd_chunked(bsz, s, h, p, n, chunk,
                                                     init):
    ins, dy, dstate, i0 = case(s + p + n, bsz, s, h, p, n, init)

    def fwd(x, dt, a, b, c, *state):
        return jssm.ssd_chunked(x, dt, a, b, c, chunk=chunk,
                                initial_state=state[0] if state else None)

    primals = tuple(jnp.asarray(t) for t in ins) + (
        (jnp.asarray(i0),) if init else ())
    _, vjp = jax.vjp(fwd, *primals)
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    got = ssd_bwd_ref(*(torch.from_numpy(t) for t in ins),
                      torch.from_numpy(dy), torch.from_numpy(dstate),
                      chunk=chunk, initial_state=None if i0 is None
                      else torch.from_numpy(i0))
    for name, g, w in zip(NAMES, got, want):
        close(g, w, name)


@pytest.mark.parametrize("bsz,s,h,p,n,chunk,init", CASES)
def test_ssd_bwd_ref_is_autograd_of_ssd_ref(bsz, s, h, p, n, chunk, init):
    ins, dy, dstate, i0 = case(s * h + chunk, bsz, s, h, p, n, init)
    ts = [torch.from_numpy(t).requires_grad_() for t in ins]
    t0 = torch.from_numpy(i0).requires_grad_() if init else None
    y, state = ssd_ref(*ts, chunk=chunk, initial_state=t0)
    want = torch.autograd.grad(
        (y, state), ts + ([t0] if init else []),
        (torch.from_numpy(dy), torch.from_numpy(dstate)))
    got = ssd_bwd_ref(*(t.detach() for t in ts), torch.from_numpy(dy),
                      torch.from_numpy(dstate), chunk=chunk,
                      initial_state=None if t0 is None else t0.detach())
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        close(g, w, name)


@pytest.mark.parametrize("use", ["both", "y", "state"])
def test_ssd_scan_on_the_cpu_is_the_autograd_function_of_ssd_bwd_ref(use):
    """The wrapper's gradients on the CPU, through its autograd function,
    are the plain backward's for all six inputs (an unused output pulls
    nothing); float64 inputs get float64 gradients."""
    ins, dy, dstate, i0 = case(7, 2, 40, 3, 8, 16, True)
    ts = [torch.from_numpy(t).double().requires_grad_()
          for t in ins + (i0,)]
    y, state = ss.ssd_scan(*ts[:5], chunk=16, initial_state=ts[5])
    gy = torch.from_numpy(dy).double() if use != "state" else None
    gs = torch.from_numpy(dstate).double() if use != "y" else None
    loss = sum((o * g).sum() for o, g in ((y, gy), (state, gs))
               if g is not None)
    got = torch.autograd.grad(loss, ts)
    want = ssd_bwd_ref(*(t.detach() for t in ts[:5]),
                       torch.zeros(y.shape) if gy is None else gy,
                       gs, chunk=16, initial_state=ts[5].detach())
    for name, g, w, t in zip(NAMES, got, want, ts):
        assert g.dtype == torch.float64, name
        assert torch.equal(g, w.to(t.dtype)), name


def mamba_configs():
    return [cfg for arch in list_archs()
            for cfg in (get_config(arch), get_config(arch).reduced())
            if cfg.ssm_state]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", mamba_configs(), ids=lambda c: c.name)
@pytest.mark.parametrize("bsz,s", [(4, 512), (1, 996), (1, 37)])
def test_ssd_bwd_plan_fits_the_card(dtype, cfg, bsz, s):
    """Both dtypes size their tiles as f32 (bf16 x takes less), so one plan
    serves them: the chunk min(S, 64), a chunk-scan CTA within 232,448
    bytes with two sets of head tiles where they fit, the forward able to
    run at the backward's chunk, a chunk's heads split into groups that
    fill at most one wave of the SMs (or one group a chunk), one state CTA
    of (P / 16) x (N / 64) warps a batch row and head, within the card's
    1,024 threads and its shared memory, and the scratch holding the dS
    states, da's partials and the dB / dC partials."""
    dtype_code(dtype)
    h, p = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim, cfg.ssm_headdim
    n = cfg.ssm_state
    pl = ss.bwd_plan(bsz, s, h, p, n)
    assert pl.chunk == min(s, 64)
    assert pl.smem_bytes == ss.bwd_smem_bytes(pl.chunk, p, n, pl.tile_sets)
    assert pl.smem_bytes <= 232_448
    assert pl.tile_sets == (2 if ss.bwd_smem_bytes(pl.chunk, p, n, 2)
                            <= 232_448 else 1)
    assert ss.plan(bsz, s, h, p, n, pl.chunk).chunk == pl.chunk
    q = bsz * pl.n_chunks
    assert pl.n_chunks == -(-s // pl.chunk)
    assert 1 <= pl.groups <= h and pl.scan_ctas == q * pl.groups
    assert pl.scan_ctas <= max(ss.SMS, q)
    assert pl.heads_per_cta * pl.groups >= h
    assert pl.state_ctas == bsz * h
    assert pl.state_threads == 32 * (-(-p // 16)) * -(-n // 64) <= 1024
    assert pl.state_smem_bytes == ss.bwd_state_smem_bytes(pl.chunk, p, n)
    assert pl.state_smem_bytes <= 232_448
    assert pl.scratch_floats == (bsz * pl.n_chunks * h * (p * n + 1)
                                 + 2 * q * pl.groups * pl.chunk * n)


def test_ssd_bwd_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="SSD backward"):
        ss.bwd_plan(1, 64, 2, 64, 256)
    with pytest.raises(ValueError, match="SSD backward"):
        ss.bwd_plan(1, 64, 2, 256, 64)
    assert ss.bwd_plan(1, 64, 2, 128, 128).chunk == 32
