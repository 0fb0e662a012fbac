"""Card-only checks of the port: the CUDA kernels (the backward kernels of
RMSNorm, attention and the SSD scan too) against their plain versions, the
scheduling engine on the card against the engine on the CPU, the reduced
zamba2, olmoe and DeepSeek serving engines, reduced whisper and internvl2
through prefill / decode likewise, and one reduced train step card == CPU.

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


def _dense_workload(classes=None):
    """``tests/test_sim_jax.py``'s 20-job workload on 10 nodes."""
    from repro_torch.core import (JobClasses, ScenarioConfig, apply_scenario,
                                  transform_rigid_to_malleable)
    rng = np.random.default_rng(0)
    w = Workload.rigid(submit=np.sort(rng.uniform(0, 150, 20)),
                       runtime=rng.uniform(20, 120, 20),
                       nodes_req=rng.choice([1, 2, 4, 8], 20))
    if classes:
        w = apply_scenario(w, ScenarioConfig(job_classes=JobClasses(
            rigid=0.1, on_demand=0.1, malleable=0.8)))
    return transform_rigid_to_malleable(w, 0.6, seed=0, cluster_nodes=10)


@pytest.mark.cuda
@pytest.mark.parametrize("name,classes,backend,kernel", [
    ("min", False, "fused", "schedule_tick"),
    ("rigid_sjf", False, "fused", "schedule_tick"),
    ("pref_common_pool", False, "fused", "waterfill"),
    ("pref", True, "fused", "waterfill"),
    ("keeppref", False, "waterfill", "waterfill"),
    ("avg", False, "waterfill", None)])
def test_dense_engine_on_card_matches_cpu(cuda_device, name, classes,
                                          backend, kernel):
    """The dense per-tick engine on the card, through the kernel its
    backend routes the pass to, equals ``bisect`` on the CPU bit for bit
    in every field of ``SimState`` and ``SimTrace``."""
    from repro_torch.core.sim_dense import simulate_dense
    w = _dense_workload(classes)
    cpu = simulate_dense(w, 10, 1.0, 800, STRATEGIES[name], device="cpu")
    torch.cuda.synchronize()
    build.LAUNCH_COUNTS.clear()
    card = simulate_dense(w, 10, 1.0, 800, STRATEGIES[name],
                          device=cuda_device, expand_backend=backend)
    torch.cuda.synchronize()
    for r, g in zip(cpu, card):
        for f in r._fields:
            assert torch.equal(_bits(getattr(r, f)),
                               _bits(getattr(g, f).cpu())), f
    launched = {k for k, v in build.LAUNCH_COUNTS.items() if v}
    assert launched == ({kernel} if kernel else set())
    if kernel == "schedule_tick":
        assert build.LAUNCH_COUNTS[kernel] == 800


@pytest.mark.cuda
def test_greedy_wrappers_on_card_are_one_launch(cuda_device):
    """``greedy_shrink_waterfill`` / ``greedy_expand_waterfill`` on the
    card equal the numpy redistribution, one waterfill launch a call."""
    from repro_torch.core.passes import greedy_expand, greedy_shrink
    rng = np.random.default_rng(17)
    n = 777
    alloc = rng.integers(1, 64, size=n).astype(np.int64)
    floor = np.maximum(alloc - rng.integers(0, 32, size=n), 1)
    cap = alloc + rng.integers(0, 32, size=n)
    prio = rng.normal(size=n)
    a, f, c, pr = (torch.from_numpy(x).to(cuda_device)
                   for x in (alloc, floor, cap, prio))
    for need in (0, 100, 10_000, int((alloc - floor).sum())):
        before = build.LAUNCH_COUNTS["waterfill"]
        got = wf.greedy_shrink_waterfill(a, f, pr, need)
        assert build.LAUNCH_COUNTS["waterfill"] == before + 1
        exp = greedy_shrink(alloc, floor, prio, need, xp=np)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      exp.astype(np.int32))
    for idle in (0, 100, 10_000):
        got = wf.greedy_expand_waterfill(a, c, pr, idle)
        exp = greedy_expand(alloc, cap, prio, idle, xp=np)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      exp.astype(np.int32))


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
    (2, 4, 70, 16, 2, 64, dict(q_offset=60, kv_valid_len=64)),
    # whisper: the cross-attention prefill (4 queries over every encoder
    # row: the decode variant with Sq > 1 and no mask), the cross decode,
    # the decoder's own 4-token prefill (decode variant, causal from 0)
    # and the encoder's non-causal prefill with a ragged last tile
    (2, 4, 1500, 20, 20, 64, dict(causal=False)),
    (3, 1, 1500, 20, 20, 64, dict(causal=False)),
    (2, 4, 448, 20, 20, 64, dict(kv_valid_len=4)),
    (1, 1500, 1500, 20, 20, 64, dict(causal=False))])
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
@pytest.mark.parametrize("b,sq,h,hkv,d,dv,kw", [
    # DeepSeek-V2's prefill (keys 192 in the 256 bucket, values 128) and
    # reduced DeepSeek's (48 / 32); a short prompt (prefill variant: the
    # decode variant needs Dv == D); a valid length; GQA; values padded
    # inside the kernel (72 to 80; bf16 20, copied element by element)
    (1, 512, 128, 128, 192, 128, {}),
    (2, 37, 4, 4, 48, 32, {}),
    (2, 5, 4, 4, 48, 32, {}),
    (1, 100, 8, 8, 192, 128, dict(kv_valid_len=60)),
    (1, 70, 4, 2, 96, 64, {}),
    (1, 50, 4, 4, 128, 72, {}),
    (1, 40, 2, 2, 64, 20, dict(causal=False))])
def test_flash_attention_value_width_matches_plain(cuda_device, dtype, b,
                                                   sq, h, hkv, d, dv, kw):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator().manual_seed(sq * d + dv)
    q = _rand(gen, b, sq, h, d, dev=cuda_device, dtype=dtype)
    k = _rand(gen, b, sq, hkv, d, dev=cuda_device, dtype=dtype)
    v = _rand(gen, b, sq, hkv, dv, dev=cuda_device, dtype=dtype)
    got = flash_attention(q, k, v, **kw)
    assert got.shape == (b, sq, h, dv) and got.dtype == dtype
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_reduced_moe_engine_on_card_matches_cpu(cuda_device, arch):
    """Reduced olmoe (MoE blocks) and reduced DeepSeek-V2 (MLA, a dense
    first layer, shared experts) serve the same greedy tokens on the card
    as on the CPU, through the rmsnorm and flash-attention kernels."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(arch).reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    models = {"cpu": cpu, cuda_device: copy.deepcopy(cpu).to(cuda_device)}
    rng = np.random.default_rng(5)
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
               for k in ("rmsnorm", "flash_attention"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-2b"])
def test_reduced_encdec_and_vision_on_card_match_cpu(cuda_device, arch):
    """Reduced whisper (encoder, cross-attention, the cross-KV cache) and
    reduced internvl2 (patches prepended) give the same greedy tokens
    through ``prefill`` and 6 ``decode_step``s on the card as on the CPU,
    and last logits within 1e-3."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import decode as D
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch).reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(
        rng.integers(2, cfg.vocab, size=(2, 11)).astype(np.int64)),
        ("frames" if cfg.is_encdec else "patches"): torch.from_numpy(
            rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model))
            .astype(np.float32))}
    start = 11 + (0 if cfg.is_encdec else cfg.n_frontend_tokens)
    out = {}
    build.LAUNCH_COUNTS.clear()
    for dev, model in (("cpu", cpu),
                       (cuda_device, copy.deepcopy(cpu).to(cuda_device))):
        logits, cache = D.prefill(model, cfg,
                                  {k: v.to(dev) for k, v in batch.items()},
                                  cache_size=48, dtype=torch.float32)
        toks = [logits.argmax(-1)]
        for i in range(6):
            logits, cache = D.decode_step(model, cfg, toks[-1][:, None],
                                          cache, start + i,
                                          dtype=torch.float32)
            toks.append(logits.argmax(-1))
        out[str(dev)] = (torch.stack(toks, 1).cpu(), logits.cpu())
    (t_cpu, l_cpu), (t_card, l_card) = out.values()
    assert torch.equal(t_cpu, t_card)
    assert float((l_cpu - l_card).abs().max()) <= 1e-3
    assert build.LAUNCH_COUNTS["flash_attention"] > 0
    assert (build.LAUNCH_COUNTS["rmsnorm"] > 0) == (cfg.norm == "rmsnorm")


@pytest.mark.cuda
def test_lane_metrics_do_not_move_with_the_lane_position(cuda_device):
    """A cell's metrics are the same bits at any lane position of a batch
    on the card, and equal the CPU's (a CUDA reduction's order follows the
    row's alignment; the metric sums are a fixed tree instead)."""
    from repro_torch.sweep.metrics import batched_metrics
    rng = np.random.default_rng(3)
    n = 2550  # 10,200-byte rows: every other row starts 8 bytes off
    w = Workload.rigid(submit=np.sort(rng.uniform(0, 5e4, n)),
                       runtime=rng.uniform(60, 4e3, n),
                       nodes_req=rng.choice([1, 2, 4, 8, 16], n))
    lanes = [(STRATEGIES["easy"], 0.0, 0)] + [
        (STRATEGIES[s], p, 0) for s in ("min", "pref", "keeppref")
        for p in (0.2, 0.6, 1.0)]
    perm = [9, 3, 0, 7, 5, 1, 8, 2, 6, 4]
    out = {}
    for dev in ("cpu", "cuda"):
        for order in (list(range(len(lanes))), perm):
            batch, _ = build_lanes(w, 64, [lanes[i] for i in order],
                                   device=dev)
            res = simulate_lanes(batch, EngineConfig(expand_backend="bisect"))
            m = batched_metrics(res, batch.submit, batch.malleable,
                                (0.0, 5e4), 64)
            out[(dev, tuple(order))] = {i: m[k] for k, i in enumerate(order)}
    first = out[("cpu", tuple(range(len(lanes))))]
    for key, got in out.items():
        assert got == first, key


# ------------------------------------------------- LLM backward kernels
# the backward kernels against their plain versions: max |err| within tol
# times the largest |ref| of each output (its sums run over the rows, the
# keys or the queries, so the error grows with that length as |ref| does)
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}


def _close_to_max(got, ref, tol, label):
    err = float((got.float() - ref.float()).abs().max())
    big = float(ref.float().abs().max())
    assert err <= tol * big, f"{label}: max |err| {err:.3g} > {tol} x {big}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,wdtype", [
    # internvl2's training rows, zamba2's prefill rows, an odd width (the
    # forward's scalar accesses), a narrow one, a bf16 weight, one row
    (2048, 2048, torch.float32), (996, 2560, torch.float32),
    (7, 2561, torch.float32), (3, 20, torch.float32),
    (33, 512, torch.bfloat16), (1, 5120, torch.float32),
    # qwen2-72b's width (512 threads a row) and DeepSeek-V2's (320), rows
    # fewer than a cluster's CTAs, and past 8,192 (32 values a thread)
    (600, 8192, torch.float32), (300, 5120, torch.float32),
    (5, 2048, torch.float32), (3, 8192, torch.bfloat16),
    (40, 12288, torch.float32)])
def test_rmsnorm_backward_kernel_matches_plain(cuda_device, dtype, rows, d,
                                               wdtype):
    """dx and dscale within tolerance of ``rmsnorm_bwd_ref``, the same bits
    on a second call (no atomics), and the autograd function's gradients
    are the kernel's."""
    _check_rmsnorm_backward(cuda_device, dtype, rows, d, wdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows,d", [
    # past the registers (the row walked twice): just past 16,384, and the
    # widest rows the forward takes, f32 and bf16
    (torch.float32, 40, 16388), (torch.float32, 300, 32768),
    (torch.bfloat16, 300, 32768), (torch.bfloat16, 200, 65536),
    (torch.bfloat16, 3, 65536)])
def test_rmsnorm_backward_kernel_walks_rows_past_the_registers(
        cuda_device, dtype, rows, d):
    """As :func:`test_rmsnorm_backward_kernel_matches_plain`, for rows too
    wide for a thread's registers."""
    from repro_torch.kernels.rmsnorm import bwd_plan
    from repro_torch.kernels.build import sm_count
    assert bwd_plan(rows, d, dtype, torch.float32,
                    sm_count(cuda_device.index or 0)).depth == 0
    _check_rmsnorm_backward(cuda_device, dtype, rows, d, torch.float32)


def _check_rmsnorm_backward(cuda_device, dtype, rows, d, wdtype):
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import rmsnorm_bwd_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    gen = torch.Generator().manual_seed(rows + d)
    x = _rand(gen, rows, d, dev=cuda_device, dtype=dtype)
    w = _rand(gen, d, dev=cuda_device, dtype=wdtype)
    dy = _rand(gen, rows, d, dev=cuda_device, dtype=dtype)
    dx, dw = rmsnorm_bwd(x, w, dy)
    assert dx.dtype == dtype and dw.dtype == wdtype
    rdx, rdw = rmsnorm_bwd_ref(x, w, dy)
    _close_to_max(dx, rdx, BWD_TOL[dtype], "dx")
    _close_to_max(dw, rdw, BWD_TOL[dtype], "dscale")
    dx2, dw2 = rmsnorm_bwd(x, w, dy)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = build.LAUNCH_COUNTS["rmsnorm_bwd"]
    rmsnorm(xg, wg).backward(dy)
    assert build.LAUNCH_COUNTS["rmsnorm_bwd"] == before + 1
    assert torch.equal(xg.grad, dx) and torch.equal(wg.grad, dw)


@pytest.mark.cuda
def test_rmsnorm_backward_gives_the_same_bits_on_two_streams(cuda_device):
    """Calls on a side stream and on the default stream, in turns and
    while the other's may still run, each give the first call's bits (each
    call its own partial rows, no state kept between launches)."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    gen = torch.Generator().manual_seed(17)
    x = _rand(gen, 1024, 2048, dev=cuda_device, dtype=torch.bfloat16)
    w = _rand(gen, 2048, dev=cuda_device)
    dy = _rand(gen, 1024, 2048, dev=cuda_device, dtype=torch.bfloat16)
    want = rmsnorm_bwd(x, w, dy)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    outs = []
    for _ in range(3):
        with torch.cuda.stream(side):
            outs.append(rmsnorm_bwd(x, w, dy))
        outs.append(rmsnorm_bwd(x, w, dy))
    torch.cuda.synchronize(cuda_device)
    for got in outs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,dv,kw", [
    # internvl2's training call (GQA 16 / 8 of 128, causal)
    (4, 512, 512, 16, 8, 128, 128, {}),
    # gemma3's head dim with a window (bf16: two warpgroups share the
    # keys, one accumulating dK, the other dV)
    (1, 300, 300, 8, 4, 256, 256, dict(window=100)),
    # keys 256 wide, values 128
    (1, 130, 130, 4, 2, 256, 128, {}),
    # DeepSeek's widths (keys 192, values 128) and reduced DeepSeek's
    (1, 200, 200, 16, 16, 192, 128, {}), (2, 37, 37, 4, 4, 48, 32, {}),
    # whisper: the encoder (non-causal) and the cross attention (Sq != Sk)
    (2, 150, 150, 20, 20, 64, 64, dict(causal=False)),
    (2, 45, 150, 20, 20, 64, 64, dict(causal=False)),
    # head dims padded in the kernel, rows copied element by element, a
    # 8:1 grouping with a window, one query
    (2, 77, 77, 8, 2, 80, 80, {}), (1, 50, 50, 4, 2, 20, 20, {}),
    (2, 40, 40, 8, 1, 32, 32, dict(window=16)),
    (1, 1, 9, 2, 2, 64, 64, dict(causal=False)),
    # a ragged query tile over fewer keys than one tile; a window narrower
    # than a tile; 8:1 GQA at 128 walking more query tiles than the ring
    # has slots
    (2, 100, 40, 4, 4, 64, 64, dict(causal=False)),
    (1, 200, 200, 4, 4, 128, 128, dict(window=7)),
    (1, 300, 300, 8, 1, 128, 128, {})])
def test_flash_attention_backward_kernel_matches_plain(
        cuda_device, dtype, b, sq, sk, h, hkv, d, dv, kw):
    """The training forward's output and log-sum-exp, and dq / dk / dv
    through autograd, within tolerance of ``attention_ref`` and
    ``attention_bwd_ref``; a second backward gives the same bits."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_with_lse)
    from repro_torch.kernels.ref import attention_bwd_ref, attention_ref
    gen = torch.Generator().manual_seed(sq * sk + d)
    q = _rand(gen, b, sq, h, d, dev=cuda_device, dtype=dtype)
    k = _rand(gen, b, sk, hkv, d, dev=cuda_device, dtype=dtype)
    v = _rand(gen, b, sk, hkv, dv, dev=cuda_device, dtype=dtype)
    do = _rand(gen, b, sq, h, dv, dev=cuda_device, dtype=dtype)
    out, lse = flash_attention_with_lse(q, k, v, **kw)
    rout, rlse = attention_ref(q, k, v, return_lse=True, **kw)
    _close(out, rout, LLM_TOL[dtype][0])
    _close(lse, rlse, 2e-5)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    flash_attention(qg, kg, vg, **kw).backward(do)
    ref = attention_bwd_ref(q, k, v, rout, rlse, do, **kw)
    for name, got, r in zip("qkv", (qg.grad, kg.grad, vg.grad), ref):
        assert got.dtype == dtype
        _close_to_max(got, r, BWD_TOL[dtype], f"d{name}")
    again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    for got, g2 in zip((qg.grad, kg.grad, vg.grad), again):
        assert torch.equal(got, g2)


def _ssd_case(gen, dev, dtype, b, s, h, p, n, init):
    """Seeded SSD inputs on the card, the outputs' gradients and an initial
    state (or None)."""
    args = (_rand(gen, b, s, h, p, dev=dev, dtype=dtype),
            _rand(gen, b, s, h, dev=dev, dtype=dtype, lo=0.01, hi=0.5),
            _rand(gen, h, dev=dev, lo=0.5, hi=2.0),
            _rand(gen, b, s, n, dev=dev, dtype=dtype),
            _rand(gen, b, s, n, dev=dev, dtype=dtype))
    s0 = _rand(gen, b, h, p, n, dev=dev) if init else None
    return args, _rand(gen, b, s, h, p, dev=dev), _rand(gen, b, h, p, n,
                                                        dev=dev), s0


@pytest.mark.cuda
def test_ssd_scan_refuses_a_gradient_on_the_card(cuda_device):
    """The SSD scan takes a gradient on the card now (its backward
    kernels): through autograd, every input's gradient is the plain
    backward's within BWD_TOL, from one ssd_scan_bwd launch; without a
    gradient it runs the forward alone."""
    from repro_torch.kernels.ref import ssd_bwd_ref
    from repro_torch.kernels.ssd_scan import bwd_plan, ssd_scan
    gen = torch.Generator().manual_seed(0)
    args, dy, dstate, s0 = _ssd_case(gen, cuda_device, torch.float32, 1, 16,
                                     2, 8, 4, True)
    ins = [t.clone().requires_grad_() for t in args + (s0,)]
    before = build.LAUNCH_COUNTS["ssd_scan_bwd"]
    y, state = ssd_scan(*ins[:5], initial_state=ins[5])
    torch.autograd.backward((y, state), (dy, dstate))
    torch.cuda.synchronize()
    assert build.LAUNCH_COUNTS["ssd_scan_bwd"] == before + 1
    ref = ssd_bwd_ref(*args, dy, dstate, chunk=bwd_plan(1, 16, 2, 8, 4).chunk,
                      initial_state=s0)
    for name, t, r in zip(("dx", "ddt", "da", "db", "dc", "dinit"), ins,
                          ref):
        assert t.grad.dtype == t.dtype
        _close_to_max(t.grad, r, BWD_TOL[torch.float32], name)
    with torch.no_grad():
        assert ssd_scan(*ins[:5])[0].shape == (1, 16, 2, 8)
    assert build.LAUNCH_COUNTS["ssd_scan_bwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,init,pull", [
    (1, 200, 4, 64, 64, False, True), (2, 50, 3, 16, 16, True, True),
    (1, 130, 2, 64, 128, False, False), (1, 37, 4, 64, 64, True, True),
    (2, 300, 6, 64, 64, True, False), (1, 700, 80, 64, 64, False, True),
    (4, 512, 8, 64, 64, False, False)])
def test_ssd_scan_backward_kernel_matches_plain(cuda_device, dtype, b, s, h,
                                                p, n, init, pull):
    """The training forward (at the backward's chunk) against the plain
    forward at that chunk, within the forward's tolerance; the backward
    kernels on its saved states against the plain backward: every output
    within BWD_TOL of its largest |ref|, in the inputs' dtype (da and dinit
    f32), and the same bits on a second call."""
    from repro_torch.kernels.ref import ssd_bwd_ref, ssd_ref
    from repro_torch.kernels.ssd_scan import (bwd_plan, ssd_scan_bwd,
                                              ssd_scan_with_states)
    gen = torch.Generator().manual_seed(s + h)
    args, dy, dstate, s0 = _ssd_case(gen, cuda_device, dtype, b, s, h, p, n,
                                     init)
    dstate = dstate if pull else None
    chunk = bwd_plan(b, s, h, p, n).chunk
    y, state, states = ssd_scan_with_states(*args, initial_state=s0)
    for g, r in zip((y, state), ssd_ref(*args, chunk=chunk,
                                        initial_state=s0)):
        _close(g, r, LLM_TOL[dtype][1])
    got = ssd_scan_bwd(*args, dy, dstate, states, initial_state=s0)
    ref = ssd_bwd_ref(*args, dy, dstate, chunk=chunk, initial_state=s0)
    for name, g, r in zip(("dx", "ddt", "da", "db", "dc", "dinit"), got,
                          ref):
        if not init and name == "dinit":
            assert g is None
            continue
        want = torch.float32 if name in ("da", "dinit") else dtype
        assert g.dtype == want, name
        _close_to_max(g, r, BWD_TOL[dtype], name)
    again = ssd_scan_bwd(*args, dy, dstate, states, initial_state=s0)
    for g, g2 in zip(got, again):
        assert g is None or torch.equal(g, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-2b",
                                  "olmoe-1b-7b", "whisper-large-v3",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_reduced_train_step_on_card_matches_cpu(cuda_device, arch):
    """One f32 train step of the reduced config, the same seeded weights
    and batch on the card (the backward kernels) and on the CPU: loss,
    every gradient (through the grad norm) and every updated parameter
    within 1e-3 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.convert import to_tensors
    from repro_torch.train.data import batch_for
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)
    cfg = get_config(arch).reduced()
    tc = TrainConfig(compute_dtype=torch.float32)
    batch = batch_for(cfg, 32, 2, step=1, seed=0)
    out = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(cfg, tc, torch.Generator().manual_seed(0),
                                 "cpu")
        state["params"].to(dev)
        state = {"params": state["params"], "opt": {
            k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                else v) for k, v in state["opt"].items()}}
        state, stats = make_train_step(cfg, tc)(state, to_tensors(batch,
                                                                  dev))
        out[dev] = (float(stats["loss"]), float(stats["grad_norm"]),
                    {n: p.detach().cpu()
                     for n, p in state["params"].named_parameters()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-3
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-3 * out["cpu"][1]
    for n, p in out["cpu"][2].items():
        torch.testing.assert_close(out["cuda"][2][n], p, atol=1e-3,
                                   rtol=1e-3)
