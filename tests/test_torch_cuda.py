"""Card-only checks of the port: the CUDA kernels against their plain
versions, and the engine on the card against the engine on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device; this
file imports no JAX, so it also runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` runs the same checks at the main path's sizes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import STRATEGIES, Workload  # noqa: E402
from repro_torch.core.passes import PassParams  # noqa: E402
from repro_torch.kernels.ref import schedule_tick_ref, waterfill_ref  # noqa
from repro_torch.kernels.schedule_tick import fused_schedule_tick  # noqa
from repro_torch.kernels.waterfill import waterfill  # noqa: E402
from repro_torch.sweep.batch import (EngineConfig, build_lanes,  # noqa
                                     simulate_lanes)

KW = dict(fill_rounds=2, prio_lo=-4, prio_hi=12, shadow_iters=26)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tick_case(rng, dev, B=16, W=300):
    mn = rng.integers(1, 3, (B, W)).astype(np.int32)
    mx = (mn + rng.integers(0, 6, (B, W))).astype(np.int32)
    want = np.clip(rng.integers(1, 7, (B, W)), mn, mx).astype(np.int32)
    state = rng.choice(4, size=(B, W), p=[0.2, 0.4, 0.3, 0.1]).astype(
        np.int32)
    alloc = np.where(state == 2, want, 0).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    p = PassParams(
        t(rng.random((B, W)) < 0.7), t(mn), t(mx), t(want), t(mn), t(mn),
        t(rng.integers(0, 3, (B, W)).astype(np.int32)),
        t(rng.uniform(0.3, 1.0, (B, W)).astype(np.float32)),
        t(rng.uniform(20.0, 200.0, (B, W)).astype(np.float32)))
    return (p, t(state), t(alloc),
            t(rng.uniform(1.0, 80.0, (B, W)).astype(np.float32)),
            t(np.where(state == 2, rng.uniform(0.0, 40.0, (B, W)),
                       np.nan).astype(np.float32)),
            t((rng.random(B) < 0.8)[:, None]),
            t(rng.integers(8, 40, B).astype(np.int32)),
            t(rng.uniform(30.0, 60.0, B).astype(np.float32)))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [None, 2])
def test_tick_kernel_matches_plain(cuda_device, depth):
    args = _tick_case(np.random.default_rng(9), cuda_device)
    d = None if depth is None else torch.full(
        (16,), depth, dtype=torch.int32, device=cuda_device)
    got = fused_schedule_tick(*args, backfill_depth=d, **KW)
    ref = schedule_tick_ref(*args, backfill_depth=d, **KW)
    for g, r in zip(got, ref):
        assert torch.equal(_bits(g), _bits(r))


@pytest.mark.cuda
def test_waterfill_kernel_matches_plain(cuda_device):
    gen = torch.Generator().manual_seed(4)
    cap = torch.randint(0, 64, (7, 3000), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    tgt = torch.randint(0, 200_000, (7,), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    assert torch.equal(waterfill(cap, tgt), waterfill_ref(cap, tgt))
    assert torch.equal(waterfill(cap[0], tgt[0]), waterfill_ref(cap[0],
                                                                tgt[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("structure,lanes,backend", [
    ("greedy", [("easy", 0.0, 0), ("min", 0.6, 0), ("pref", 1.0, 1)],
     "fused"),
    ("greedy", [("easy", 0.0, 0), ("min", 0.6, 0), ("pref", 1.0, 1)],
     "waterfill"),
    ("balanced", [("avg", 0.6, 0), ("avg", 1.0, 1)], "bisect")])
def test_engine_on_card_matches_cpu(cuda_device, structure, lanes, backend):
    """The engine on the card, through the kernels where the backend
    launches them, equals the plain CPU run bit for bit."""
    rng = np.random.default_rng(3)
    w = Workload.rigid(submit=np.sort(rng.uniform(0, 400, 60)),
                       runtime=rng.uniform(20, 120, 60),
                       nodes_req=rng.choice([1, 2, 4, 8], 60))
    lanes = [(STRATEGIES[s], p, sd) for s, p, sd in lanes]
    res = {}
    for dev, be in (("cpu", "bisect"), (cuda_device, backend)):
        cfg = EngineConfig(structure=structure, window=16, chunk=32,
                           expand_backend=be)
        res[dev] = simulate_lanes(build_lanes(w, 10, lanes, device=dev)[0],
                                  cfg)
    assert res["cpu"]["steps"] > 2 * 32  # several chunks and windows
    for key in ("state", "alloc", "start_t", "end_t", "expand_ops",
                "shrink_ops", "bf_starts", "sched_steps", "trace_t",
                "trace_busy", "trace_qlen"):
        np.testing.assert_array_equal(res["cpu"][key], res[cuda_device][key],
                                      err_msg=key)
