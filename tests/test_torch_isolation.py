"""The port stands alone and never falls back to the CPU quietly.

* every ``repro_torch`` module imports with ``jax`` and ``repro`` blocked;
* no file of the port (nor ``chip_smoke.py``) imports ``jax`` or ``repro``;
* without a card, the entry points raise unless ``device="cpu"`` is given;
* kernel backends refuse CPU tensors at the engine level;
* training in the LLM layer raises ``NotImplementedError`` naming its
  ROADMAP item, while MoE, MLA, the encoder-decoder and the vision
  frontend build, and every structure and flag of the scheduling pass
  runs;
* the smoke's library call for attention computes the same function.

Kernel launches need a card: the ``cuda``-marked tests in
``test_torch_cuda.py`` skip here; they and ``chip_smoke.py`` run on the
GPU.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
        "print('ok', len(" + repr(MODULES) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA device")


def _small():
    from repro_torch.core import STRATEGIES, Workload
    rng = np.random.default_rng(0)
    w = Workload.rigid(submit=np.sort(rng.uniform(0, 50, 8)),
                       runtime=rng.uniform(20, 60, 8),
                       nodes_req=rng.choice([1, 2], 8))
    return w, [(STRATEGIES["easy"], 0.0, 0), (STRATEGIES["min"], 0.5, 0)]


def test_entry_points_without_device_raise_on_a_cpu_box(no_card):
    from repro_torch import resolve_device
    from repro_torch.convert import to_tensors
    from repro_torch.experiments.backend_torch import run_cells
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.sweep.batch import build_lanes
    from repro_torch.sweep.metrics import batched_metrics
    w, lanes = _small()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_lanes(w, 4, lanes)
    with pytest.raises(RuntimeError):
        to_tensors({"a": np.zeros(3)})
    spec = ExperimentSpec(workloads=("theta",), scale=0.005, seeds=1)
    with pytest.raises(RuntimeError):
        run_cells(spec, [("theta", ("easy", 0.0, 0))], None, {})
    with pytest.raises(RuntimeError):
        batched_metrics({}, np.zeros(3), np.zeros((1, 3), bool), (0.0, 1.0),
                        4)
    from repro_torch.experiments.__main__ import main
    with pytest.raises(RuntimeError):
        main(["--workload", "theta", "--scale", "0.005", "--seeds", "1"])


def test_dense_engine_and_sweep_alias_without_device_raise(no_card):
    from repro_torch.core import STRATEGIES
    from repro_torch.core.sim_dense import JobArrays, simulate_dense
    from repro_torch.sweep.runner import main, sweep_workload_torch
    w, _ = _small()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_dense(w, 4, 1.0, 10, STRATEGIES["min"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JobArrays.from_workload(w)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_workload_torch("theta", scale=0.005, seeds=1, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--workload", "theta", "--scale", "0.005", "--seeds", "1"])
    st, tr = simulate_dense(w, 4, 1.0, 10, STRATEGIES["min"], device="cpu")
    assert st.state.device.type == "cpu" and tr.busy.shape == (10,)


def test_llm_entry_points_without_device_raise_on_a_cpu_box(no_card):
    from repro_torch.configs import get_config
    from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
    from repro_torch.launch.serve import main
    from repro_torch.models.decode import init_decode_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("zamba2-2.7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache_from_numpy({}, cfg)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, cfg, n_slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "zamba2-2.7b", "--reduced", "--requests", "1"])


@pytest.mark.parametrize("size", ["published", "reduced"])
@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-2b"])
def test_llm_encoder_decoder_and_frontends_build(arch, size):
    """The encoder-decoder (A10c) and the modality frontends (A10d) are
    ported: both configs build, published (on the meta device: no
    storage) and reduced, and nothing names a ROADMAP item."""
    from repro_torch.configs import get_config
    from repro_torch.models.decode import init_decode_cache
    from repro_torch.models.transformer import LM, init_params
    cfg = get_config(arch)
    if size == "reduced":
        cfg = cfg.reduced()
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    else:
        model = LM(cfg, "meta")
    kinds = {b.kind for seg in model.segments for b in seg}
    assert kinds == ({"dec"} if cfg.is_encdec else {"attn"})
    if cfg.is_encdec:
        assert len(model.enc_segments[0]) == cfg.enc_layers
    cache = init_decode_cache(cfg, 1, 8, device="meta" if size ==
                              "published" else "cpu", enc_len=5)
    names = {"k", "v", "ck", "cv"} if cfg.is_encdec else {"k", "v"}
    assert all(set(seg) == names for seg in cache["segments"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_llm_moe_and_mla_build(arch):
    """MoE blocks (A10a) and MLA with its latent cache (A10b) are ported:
    both configs build, published and reduced, and name no ROADMAP item."""
    from repro_torch.configs import get_config
    from repro_torch.models.decode import init_decode_cache
    from repro_torch.models.transformer import LM, init_params
    LM(get_config(arch), "meta")
    cfg = get_config(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [b.kind for seg in model.segments for b in seg][-1] == "moe"
    assert isinstance(LM(cfg, "cpu"), LM)
    cache = init_decode_cache(cfg, 1, 8, device="cpu")
    names = ({"ckv", "krope"} if cfg.attn == "mla" else {"k", "v"})
    assert all(set(seg) == names for seg in cache["segments"])


def test_llm_training_raises_not_implemented():
    from repro_torch.models.transformer import forward_train
    with pytest.raises(NotImplementedError, match="ROADMAP §A10e"):
        forward_train()


def test_serve_engine_refuses_a_model_on_another_device():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("zamba2-2.7b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="lives on"):
        ServeEngine(model, cfg, n_slots=1, max_len=8, device="meta")


@pytest.mark.parametrize("backend", ["fused", "waterfill"])
def test_kernel_backends_refuse_the_cpu(backend):
    from repro_torch.core import passes
    from repro_torch.sweep.batch import (EngineConfig, build_lanes,
                                         simulate_lanes)
    w, lanes = _small()
    batch, _ = build_lanes(w, 4, lanes, device="cpu")
    with pytest.raises(ValueError, match="only 'bisect' runs on the CPU"):
        simulate_lanes(batch, EngineConfig(window=8, expand_backend=backend))
    with pytest.raises(ValueError, match="only 'bisect'"):
        passes.check_backend(backend, torch.device("cpu"))
    res = simulate_lanes(batch, EngineConfig(window=8))  # auto -> bisect
    assert res["finished"]


@pytest.mark.parametrize("kw", [
    dict(structure="pooled"), dict(structure="stealing"),
    dict(with_classes=True), dict(with_sjf=True)])
def test_next_slice_features_raise_not_implemented(kw):
    from repro_torch.core.passes import PassParams, schedule_tick
    B, W = 1, 4
    i = torch.ones((B, W), dtype=torch.int32)
    f = torch.ones((B, W), dtype=torch.float32)
    p = PassParams(torch.ones((B, W), dtype=torch.bool), i, i, i, i, i, i,
                   f, f, on_demand=torch.ones((B, W), dtype=torch.bool),
                   pref_nodes=i, sort_key=f)
    args = (p, i, i, f, f, torch.ones((B, 1), dtype=torch.bool),
            torch.full((B,), 4, dtype=torch.int32),
            torch.zeros((B,), dtype=torch.float32))
    kw = dict(dict(structure="greedy"), **kw)
    # the registry's structures and flags once raised here; all now run
    out = schedule_tick(*args, fill_rounds=2, prio_lo=-1, prio_hi=1,
                        span_max=1, **kw)
    assert [tuple(t.shape) for t in out] == [(B, W)] * 3
    with pytest.raises(ValueError, match="unknown pass structure"):
        schedule_tick(*args, fill_rounds=2, prio_lo=-1, prio_hi=1,
                      span_max=1, structure="nested")


def test_chip_smoke_fails_without_a_card_or_without_the_repo(no_card,
                                                             tmp_path):
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_kernel_c_interface_matches_the_loader():
    """The parameter kinds of ``bindings.cpp``'s entry points, read from the
    source, are those ``kernels.build`` passes (the library's own
    ``repro_abi()`` is compared with the same string when it loads)."""
    import re
    from repro_torch.kernels import build
    src = (PORT / "kernels" / "csrc" / "bindings.cpp").read_text()
    sig = ""
    for fn in build._SIGNATURES:
        params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
        kinds = ["P" if "*" in prm else "F" if prm.split()[0] == "float"
                 else "I" for prm in params.split(",")]
        sig += f"{fn}={''.join(kinds)};"
    assert sig == build.expected_abi()


def _load_chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("elapsed_s,rate,scale", [
    (600.0, 5.0e-3, 1.0), (700.0, 4.5e-3, 1.0), (850.0, 6.0e-3, 0.5),
    # an H100 run whose haswell batch at 1.0 took 338.75 s from here and
    # ended the smoke past the limit: it cuts now
    (861.0, 3.763e-3, 0.5),
    (1100.0, 6.0e-3, 0.25), (0.0, None, 1.0)])
def test_chip_smoke_cuts_haswell_only_when_it_cannot_fit(elapsed_s, rate,
                                                         scale):
    report = {} if rate is None else {"greedy_s_per_step": rate}
    assert _load_chip_smoke().haswell_scale(report, elapsed_s) == scale


@pytest.mark.parametrize("rule,elapsed_s,rate,scale", [
    ("registry_scale", 500.0, 5.34e-3, 0.1),
    ("registry_scale", 1050.0, 5.0e-3, 0.05),
    ("registry_scale", 0.0, None, 0.1),
    ("whatif_scale", 600.0, 5.0e-3, 0.1),
    ("whatif_scale", 800.0, 3.84e-3, 0.1),
    ("whatif_scale", 900.0, 5.34e-3, 0.05),
    ("whatif_scale", 0.0, None, 0.1)])
def test_chip_smoke_cuts_theta_phases_only_when_they_cannot_fit(
        rule, elapsed_s, rate, scale):
    """The registry phase and what-if (d) run theta at 0.1 and cut to 0.05
    only when the time left would not hold them (what-if (d) also leaves
    room for the dense phase and haswell at its least scale)."""
    report = {} if rate is None else {"greedy_s_per_step": rate}
    assert getattr(_load_chip_smoke(), rule)(report, elapsed_s) == scale


@pytest.mark.parametrize("case", [
    # whisper's encoder: non-causal self-attention (a prefill)
    dict(B=2, Sq=33, Sk=33, H=4, Hkv=4, causal=False),
    # a causal GQA prefill
    dict(B=1, Sq=37, Sk=37, H=8, Hkv=2, causal=True),
    # the cross-attention prefill: 4 queries over every encoder row
    dict(B=2, Sq=4, Sk=45, H=4, Hkv=4, causal=False),
    # a one-query decode call over a part-filled cache
    dict(B=2, Sq=1, Sk=40, H=8, Hkv=2, causal=True, q_offset=29,
         kv_valid_len=30)])
def test_chip_smoke_library_call_is_the_kernels_function(case):
    """The smoke's library call (SDPA) computes what the attention kernel
    computes, its ``causal`` read from the call (CPU tensors)."""
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator().manual_seed(3)
    b, sq, sk, h, hkv = (case.pop(k) for k in ("B", "Sq", "Sk", "H", "Hkv"))
    q = torch.randn((b, sq, h, 16), generator=gen)
    k, v = (torch.randn((b, sk, hkv, 16), generator=gen) for _ in "kv")
    lib = _load_chip_smoke().library_call("flash_attention", (q, k, v), case)
    np.testing.assert_allclose(lib().transpose(1, 2).numpy(),
                               attention_ref(q, k, v, **case).numpy(),
                               atol=2e-5, rtol=2e-5)


def test_chip_smoke_library_call_refuses_what_sdpa_cannot_mask():
    q, k = torch.zeros((1, 3, 2, 8)), torch.zeros((1, 9, 2, 8))
    smoke = _load_chip_smoke()
    assert smoke.library_call("flash_attention", (q, k, k),
                              dict(causal=True, q_offset=5)) is None
    assert smoke.library_call("flash_attention", (q, k, k),
                              dict(window=4)) is None
