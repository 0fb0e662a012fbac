"""Card-only checks of the port: the CUDA kernels against their plain
versions, the scheduling engine on the card against the engine on the
CPU, and the reduced zamba2 serving engine likewise.

Every test here is marked ``cuda`` and skips without a CUDA device; this
file imports no JAX, so it also runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` runs the same checks at the main path's sizes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import STRATEGIES, Workload  # noqa: E402
from repro_torch.core.passes import PassParams, give_asc_prefix  # noqa
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import waterfill as wf  # noqa: E402
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
@pytest.mark.parametrize("B,W", [
    (16, 128), (16, 300), (64, 1000),   # warp tier, CTA tier
    (16, 16_384), (16, 32_768),         # cluster tier (256, 512 threads)
    (2, 65_536)])                       # global tier
@pytest.mark.parametrize("depth", [None, 2])
def test_tick_kernel_matches_plain(cuda_device, depth, B, W):
    """Bit-equal to the plain pass in every tier of the kernel's plan."""
    args = _tick_case(np.random.default_rng(9), cuda_device, B, W)
    d = None if depth is None else torch.full(
        (B,), depth, dtype=torch.int32, device=cuda_device)
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
@pytest.mark.parametrize("shape,tier", [
    ((31, 128), "warp"), ((7, 33), "warp"), ((300, 256), "warp"),
    ((64, 1000), "cta"), ((132, 2048), "cta"), ((16, 4095), "cta"),
    ((64, 4097), "lookback"), ((16, 16_384), "lookback"),
    ((1, 16_384), "lookback"), ((143_829,), "lookback")])
def test_waterfill_kernel_matches_plain_in_every_tier(cuda_device, shape,
                                                      tier):
    """Bit-equal to the plain version in the tier the plan picks, for
    targets <= 0, inside and above each row's total (Python ints, per-row
    tensors, one 0-d tensor for all rows), with and without ``order``, and
    again in a second launch (the look-back's scratch starts clean)."""
    B, N = (1, shape[0]) if len(shape) == 1 else shape
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert wf.plan(B, N, sms).tier == tier
    gen = torch.Generator().manual_seed(N + B)
    cap = (torch.randint(0, 64, shape, generator=gen, dtype=torch.int32)
           * (torch.rand(shape, generator=gen) < 0.8)).to(torch.int32)
    prio = torch.randint(-4, 5, shape, generator=gen, dtype=torch.int32)
    cap, prio = cap.to(cuda_device), prio.to(cuda_device)
    total = cap.sum(dim=-1, dtype=torch.int32)
    frac = torch.rand(total.shape, generator=gen).to(cuda_device)
    targets = [0, -5, int(total.min()) // 2, int(total.max()) + 1,
               (frac * total.float()).to(torch.int32), total - 3,
               total + 17, torch.zeros_like(total)]
    if len(shape) == 2:
        targets.append(torch.tensor(int(total.min()) // 3,
                                    dtype=torch.int32, device=cuda_device))
    for order in (None, torch.argsort(prio, dim=-1, stable=True)):
        for tgt in targets:
            ref = waterfill_ref(cap, tgt, order)
            for _ in range(2):
                assert torch.equal(waterfill(cap, tgt, order), ref)


@pytest.mark.cuda
def test_greedy_give_waterfill_is_one_launch(cuda_device):
    """The give is one argsort and one kernel launch, equal to the
    bisection give."""
    gen = torch.Generator().manual_seed(5)
    prio = torch.randint(-4, 5, (31, 128), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    room = torch.randint(0, 6, (31, 128), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    idle = torch.randint(0, 400, (31,), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    before = build.LAUNCH_COUNTS["waterfill"]
    give = wf.greedy_give_waterfill(prio, room, idle)
    assert build.LAUNCH_COUNTS["waterfill"] == before + 1
    assert torch.equal(give, give_asc_prefix(prio, room, idle, -5, 5))


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


# ------------------------------------------------------------ LLM kernels
LLM_TOL = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (2e-2, 5e-2)}


def _close(got, ref, tol):
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def _rand(gen, *shape, dev, dtype=torch.float32, lo=None, hi=None):
    t = (torch.randn(shape, generator=gen) if lo is None else
         lo + (hi - lo) * torch.rand(shape, generator=gen))
    return t.to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,kw", [
    (37, 128, {}), (8, 80, {}), (300, 2560, {}),
    # scalar accesses: an odd width, and bf16 rows of 40 bytes
    (5, 2561, {}), (3, 20, {}),
    # one row; a non-contiguous x; a bf16 weight
    (1, 5120, {}), (6, 2560, dict(strided=True)),
    (4, 5120, dict(weight=torch.bfloat16))])
def test_rmsnorm_kernel_matches_plain(cuda_device, dtype, rows, d, kw):
    from repro_torch.kernels.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    gen = torch.Generator().manual_seed(rows + d)
    x = _rand(gen, 2, rows, 2 * d if kw.get("strided") else d,
              dev=cuda_device, dtype=dtype)
    if kw.get("strided"):
        x = x[..., ::2]
        assert not x.is_contiguous()
    w = _rand(gen, d, dev=cuda_device, dtype=kw.get("weight", torch.float32))
    got = rmsnorm(x, w)
    assert got.dtype == dtype
    _close(got, rmsnorm_ref(x, w), LLM_TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,kw", [
    (1, 77, 77, 4, 4, 80, {}),
    (2, 40, 40, 8, 1, 32, dict(window=16)),
    (2, 33, 33, 4, 2, 64, dict(causal=False)),
    (3, 1, 96, 32, 4, 80, dict(q_offset=60, kv_valid_len=61)),
    (2, 4, 8, 2, 2, 16, dict(kv_valid_len=0)),
    # gemma3's head dim with GQA and a window; glm4's 16:1 grouping
    (1, 300, 300, 8, 4, 256, dict(window=100)),
    (2, 130, 130, 16, 1, 128, {}),
    # head dims padded inside the kernel (72 to 80; 20 to 32, whose bf16
    # rows are copied element by element, not in 16-byte pieces)
    (2, 100, 100, 4, 2, 72, {}),
    (1, 50, 50, 4, 2, 20, {}),
    (2, 1, 64, 4, 4, 20, dict(q_offset=40, kv_valid_len=41)),
    # a decode reading a long cache over many splits
    (2, 1, 4096, 8, 8, 80, dict(q_offset=3000, kv_valid_len=3001)),
    # either side of the variant boundary (Sq * H / Hkv = 16 decodes)
    (2, 2, 70, 16, 2, 64, dict(q_offset=60, kv_valid_len=62)),
    (2, 4, 70, 16, 2, 64, dict(q_offset=60, kv_valid_len=64))])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, b, sq, sk,
                                              h, hkv, d, kw):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator().manual_seed(sq * sk)
    q = _rand(gen, b, sq, h, d, dev=cuda_device, dtype=dtype)
    k = _rand(gen, b, sk, hkv, d, dev=cuda_device, dtype=dtype)
    v = _rand(gen, b, sk, hkv, d, dev=cuda_device, dtype=dtype)
    got = flash_attention(q, k, v, **kw)
    assert got.dtype == dtype
    _close(got, attention_ref(q, k, v, **kw), LLM_TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,init", [
    (1, 200, 4, 64, 64, False), (2, 50, 3, 16, 16, True),
    (1, 130, 2, 64, 128, False),
    # 32 chunks; shorter than a chunk; an exact multiple of the chunk
    (1, 4096, 2, 64, 64, False), (1, 37, 4, 64, 64, False),
    (1, 256, 4, 64, 64, True),
    # a batch of two from a state; zamba2's 80 heads (2 a CTA)
    (2, 300, 6, 64, 64, True), (1, 700, 80, 64, 64, False)])
def test_ssd_scan_kernel_matches_plain(cuda_device, dtype, b, s, h, p, n,
                                       init):
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    gen = torch.Generator().manual_seed(s)
    args = (_rand(gen, b, s, h, p, dev=cuda_device, dtype=dtype),
            _rand(gen, b, s, h, dev=cuda_device, dtype=dtype, lo=0.01,
                  hi=0.5),
            _rand(gen, h, dev=cuda_device, lo=0.5, hi=2.0),
            _rand(gen, b, s, n, dev=cuda_device, dtype=dtype),
            _rand(gen, b, s, n, dev=cuda_device, dtype=dtype))
    s0 = _rand(gen, b, h, p, n, dev=cuda_device) if init else None
    got = ssd_scan(*args, initial_state=s0)
    ref = ssd_ref(*args, initial_state=s0)
    for g, r in zip(got, ref):
        _close(g, r, LLM_TOL[dtype][1])


@pytest.mark.cuda
def test_reduced_zamba2_engine_on_card_matches_cpu(cuda_device):
    """The same seeded weights serve the same greedy tokens on the card
    (through the kernels) as on the CPU (plain versions)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("zamba2-2.7b").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    models = {"cpu": cpu, cuda_device: copy.deepcopy(cpu).to(cuda_device)}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab, size=n).astype(np.int32)
               for n in (9, 30, 4, 17)]
    out = {}
    build.LAUNCH_COUNTS.clear()
    for dev, model in models.items():
        eng = ServeEngine(model, cfg, n_slots=2, max_len=64, device=dev)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        out[dev] = [r.out_tokens for r in reqs]
    assert out["cpu"] == out[cuda_device]
    assert all(build.LAUNCH_COUNTS[k] > 0
               for k in ("rmsnorm", "flash_attention", "ssd_scan"))
