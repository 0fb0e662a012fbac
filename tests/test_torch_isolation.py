"""The port stands alone and never falls back to the CPU quietly.

* every ``repro_torch`` module imports with ``jax`` and ``repro`` blocked;
* no file of the port (nor ``chip_smoke.py``) imports ``jax`` or ``repro``;
* without a card, the entry points raise unless ``device="cpu"`` is given;
* kernel backends refuse CPU tensors at the engine level;
* training refuses Mamba-2 blocks on the card with a
  ``NotImplementedError`` naming its ROADMAP item (the SSD scan has no
  backward kernel yet) and takes every other config; MoE, MLA, the
  encoder-decoder and the vision frontend build, and every structure and
  flag of the scheduling pass runs;
* the smoke's library calls compute the kernels' functions and their
  gradients, and its card-vs-CPU gate of a compressed train step takes
  rounding-boundary flips only.

Kernel launches need a card: the ``cuda``-marked tests in
``test_torch_cuda.py`` skip here; they and ``chip_smoke.py`` run on the
GPU.
"""
import ast
import dataclasses
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
# the training slice's modules, which the two checks below must cover
TRAINING_MODULES = ("repro_torch.train", "repro_torch.train.data",
                    "repro_torch.train.optimizer",
                    "repro_torch.train.train_step", "repro_torch.elastic",
                    "repro_torch.elastic.compression",
                    "repro_torch.launch.train")
# the malleable training job's modules (A10g and the data-parallel half of
# A10f), which the two checks below must cover
ELASTIC_MODULES = ("repro_torch.elastic.checkpoint",
                   "repro_torch.elastic.failures",
                   "repro_torch.elastic.manager",
                   "repro_torch.elastic.resharding",
                   "repro_torch.launch.mesh", "repro_torch.models.sharding")
# the tensor-parallel slice's modules (A10f2), which the two checks below
# must cover
TP_MODULES = ("repro_torch.models.tp", "repro_torch.models.moe",
              "repro_torch.sweep.shard", "repro_torch.train.optimizer")


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
    assert set(TRAINING_MODULES) <= set(MODULES)
    assert set(ELASTIC_MODULES) <= set(MODULES)
    assert set(TP_MODULES) <= set(MODULES)
    assert PORT / "models" / "tp.py" in set(PORT_FILES)
    assert {PORT / "train" / "data.py", PORT / "elastic" / "compression.py",
            PORT / "launch" / "train.py"} <= set(PORT_FILES)
    assert {PORT / (m.replace("repro_torch.", "").replace(".", "/") + ".py")
            for m in ELASTIC_MODULES} <= set(PORT_FILES)
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
    from repro_torch.launch.train import main as train_main
    from repro_torch.train.train_step import TrainConfig, init_train_state
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(get_config("stablelm-1.6b").reduced(),
                         TrainConfig(), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "1"])


def test_elastic_entry_points_without_device_raise_on_a_cpu_box(no_card):
    """The malleable job runs on the card unless ``device="cpu"`` is given:
    the trainer and ``launch.train --malleable`` raise before they open a
    process group."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.elastic.manager import ElasticTrainer
    from repro_torch.launch.train import main
    from repro_torch.train.train_step import TrainConfig
    cfg = get_config("stablelm-1.6b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticTrainer(cfg, TrainConfig(), global_batch=2, seq_len=8,
                       width=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "1",
              "--malleable"])
    assert not dist.is_initialized()


def test_tensor_parallel_job_raises_naming_the_next_slice(no_card):
    """``model_parallel`` > 1 is ported (ROADMAP §A10f2, the runs in
    ``tests/test_torch_tensor_parallel.py``): no ``NotImplementedError``
    is left.  Without a card a tensor-parallel job of every family, MLA
    included, raises only for its device, before a world or a state is
    built, and on the CPU its plan runs every block (none is refused)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, list_archs
    from repro_torch.elastic.manager import ElasticTrainer
    from repro_torch.launch.mesh import MeshView
    from repro_torch.models.tp import tp_plan
    from repro_torch.train.train_step import TrainConfig
    for arch in ("stablelm-1.6b", "deepseek-v2-236b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ElasticTrainer(get_config(arch).reduced(), TrainConfig(),
                           global_batch=2, seq_len=8, width=1,
                           model_parallel=2)
    assert not dist.is_initialized()
    modes = {"plain", "heads", "kv_gather", "whole", "columns", "experts",
             ""}
    for arch in list_archs():
        plan = tp_plan(get_config(arch), MeshView(("data", "model"), {
            "data": 1, "model": 2}))
        for block in plan.blocks.values():
            assert set(dataclasses.astuple(block)) <= modes, (arch, block)


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
    """Training is ported (A10e), Mamba-2 blocks on the card too (A10e2):
    the train-step check passes every registered config, published and
    reduced, for a ``cuda`` device and the CPU, without a card, and names
    no ROADMAP item."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.train.train_step import (TrainConfig, check_trainable,
                                              init_train_state)
    for arch in list_archs():
        for cfg in (get_config(arch), get_config(arch).reduced()):
            check_trainable(cfg, "cuda")
            check_trainable(cfg, "cpu")
    state = init_train_state(get_config("zamba2-2.7b").reduced(),
                             TrainConfig(), torch.Generator().manual_seed(0),
                             "cpu")
    assert all(p.requires_grad for p in state["params"].parameters())


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


def test_chip_smoke_defines_each_top_level_name_once():
    """A second definition of a name (a class, a function, a constant)
    would replace the first for every phase that uses it."""
    import collections
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    assert [n for n, c in names.items() if c > 1] == []


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
    (1000.0, 6.0e-3, 0.25),
    (1100.0, 6.0e-3, 0.25), (0.0, None, 1.0)])
def test_chip_smoke_cuts_haswell_only_when_it_cannot_fit(elapsed_s, rate,
                                                         scale):
    report = {} if rate is None else {"greedy_s_per_step": rate}
    assert _load_chip_smoke().haswell_scale(report, elapsed_s) == scale


@pytest.mark.parametrize("elapsed_s,rate,lanes", [
    # an H100 smoke at 4.90 ms a greedy step (the fused run's greedy lanes
    # ended at 94 s): every greedy lane
    (94.0, 4.90e-3, 31), (300.0, 4.16e-3, 31),
    # slow hosts (6.80 / 6.88 ms a step; their greedy lanes end near
    # 120-130 s): every lane, its run ending inside the balanced lanes'
    # beside it and the phases after at their least scales in the limit
    (125.0, 6.80e-3, 31), (130.0, 6.88e-3, 31),
    # later: the whole batch's run would end the smoke past the limit,
    # seed 0's ends before the balanced lanes
    (170.0, 6.88e-3, 16), (400.0, 6.88e-3, 16), (600.0, 5.15e-3, 16),
    (0.0, None, 31)])
def test_chip_smoke_cuts_the_main_comparisons_only_when_they_cannot_fit(
        elapsed_s, rate, lanes):
    """The main phase's waterfill run (and bisect on the CPU beside it)
    keep every greedy lane or seed 0's: the largest set whose waterfill run
    ends before the balanced lanes beside it or leaves the phases after it
    the time left."""
    report = {} if rate is None else {"greedy_s_per_step": rate}
    _name, keep, _steps = _load_chip_smoke().main_lanes(report, elapsed_s)
    assert (31 if keep is None else 16 if keep == "seed 0"
            else len(keep)) == lanes


def test_chip_smoke_main_lane_sets_cover_every_greedy_strategy():
    """Each cut lane set is cells of the main phase's greedy grid and keeps
    EASY, MIN, PREF and KEEPPREF (KEEPPREF at 0.4: the 256-slot window)."""
    from repro_torch.experiments.spec import ExperimentSpec
    smoke = _load_chip_smoke()
    cells = ExperimentSpec(workloads=("theta",), scale=1.0, seeds=2,
                           strategies=smoke.GREEDY_STRATEGIES).cells()
    assert len(cells) == 31
    steps = [n for _name, _keep, n in smoke.MAIN_LANE_SETS]
    assert steps == sorted(steps, reverse=True)
    for _name, keep, _n in smoke.MAIN_LANE_SETS[1:]:
        kept = ([c for c in cells if c[2] == 0] if keep == "seed 0"
                else list(keep))
        assert set(kept) <= set(cells)
        assert {c[0] for c in kept} == {"easy", "min", "pref", "keeppref"}
        assert ("keeppref", 0.4, 0) in kept


@pytest.mark.parametrize("rule,elapsed_s,rate,scale", [
    ("registry_scale", 500.0, 5.34e-3, 0.1),
    ("registry_scale", 1050.0, 5.0e-3, 0.05),
    # a slow host (6.80 ms a greedy step): the registry itself would fit,
    # the phases after it at their least scales would not
    ("registry_scale", 700.0, 6.80e-3, 0.05),
    # an H100 final-tree smoke at 6.53 ms a greedy step kept 0.1 from about
    # here (its registry took ~230 s; the smoke ended at 1,183.7 s), and
    # one at 5.72 ms from ~490 s (~216 s; it ended at 1,161.2 s)
    ("registry_scale", 480.0, 6.53e-3, 0.05),
    ("registry_scale", 490.0, 5.72e-3, 0.05),
    ("registry_scale", 0.0, None, 0.1),
    ("whatif_scale", 600.0, 5.0e-3, 0.1),
    ("whatif_scale", 800.0, 3.84e-3, 0.1),
    ("whatif_scale", 900.0, 5.34e-3, 0.05),
    ("whatif_scale", 0.0, None, 0.1)])
def test_chip_smoke_cuts_theta_phases_only_when_they_cannot_fit(
        rule, elapsed_s, rate, scale):
    """The registry phase and what-if (d) run theta at 0.1 and cut to 0.05
    only when the time left would not hold them and the phases after them
    at their least scales (the registry: experiment, what-if, dense and
    haswell; what-if (d): dense and haswell)."""
    report = {} if rate is None else {"greedy_s_per_step": rate}
    assert getattr(_load_chip_smoke(), rule)(report, elapsed_s) == scale


@pytest.mark.parametrize("elapsed_s,rate,steps", [
    # a 4.90 ms host reaching (c') at ~450 s: every step
    (450.0, 4.90e-3, 6), (300.0, 6.53e-3, 6),
    # a 6.53 ms host there at ~550 s (PR 26's final tree's train phase
    # began near 500 s): the phases after it at their least scales take
    # ~600 s, so (c') keeps its least steps; never fewer, never skipped
    (550.0, 6.53e-3, 4), (1100.0, 6.88e-3, 4), (0.0, None, 6)])
def test_chip_smoke_cuts_the_zamba2_steps_only_when_they_cannot_fit(
        elapsed_s, rate, steps):
    """The train phase's (c') zamba2-2.7b run keeps its 6 steps or cuts to
    4 where the time left would not hold them and the phases after it at
    their least scales; the cut is reported."""
    smoke = _load_chip_smoke()
    report = {} if rate is None else {"greedy_s_per_step": rate}
    got, cut = smoke.train_steps(report, elapsed_s, smoke.TRAIN_ZAMBA2)
    assert got == steps and cut == (steps < smoke.TRAIN_ZAMBA2["steps"])


@pytest.mark.parametrize("elapsed_s,rate,steps", [
    # a 4.90 ms host reaching the elastic phase at ~520 s: every step
    (520.0, 4.90e-3, 6), (0.0, None, 6),
    # a 5.98 ms host there at ~590 s (PR 28's final tree's train phase
    # ended near 560 s): the phases after it at their least scales take
    # ~580 s, so the phase keeps its least steps
    (590.0, 5.98e-3, 4), (450.0, 6.88e-3, 4),
    # never fewer, never skipped
    (1150.0, 6.88e-3, 4)])
def test_chip_smoke_cuts_the_elastic_steps_only_when_they_cannot_fit(
        elapsed_s, rate, steps):
    """The elastic phase keeps its 6 steps or cuts to 4 where the time left
    would not hold them and the phases after it at their least scales; the
    cut is reported, and the phase is never skipped."""
    smoke = _load_chip_smoke()
    report = {} if rate is None else {"greedy_s_per_step": rate}
    got, cut = smoke.elastic_steps(report, elapsed_s)
    assert got == steps and cut == (steps < smoke.ELASTIC["steps"])
    assert smoke.ELASTIC["least_steps"] == 4


def test_chip_smoke_elastic_config_is_one_hybrid_period_at_full_width():
    """The elastic phase's zamba2-2.7b keeps the published widths and cuts
    the depth to one period: 6 Mamba-2 layers, then the shared block."""
    from repro_torch.configs import get_config
    smoke = _load_chip_smoke()
    cfg, full = smoke.elastic_config(), get_config("zamba2-2.7b")
    for f in ("d_model", "ssm_state", "ssm_headdim", "ssm_expand", "n_heads",
              "d_ff", "vocab", "shared_attn_every"):
        assert getattr(cfg, f) == getattr(full, f), f
    assert (cfg.d_model, cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim,
            cfg.ssm_headdim, cfg.ssm_state, cfg.n_heads, cfg.d_ff,
            cfg.vocab) == (2560, 80, 64, 64, 32, 10240, 32000)
    assert cfg.n_layers == 6 < full.n_layers
    launches = smoke.expected_train_launches(cfg, "dots")
    assert all(launches[k] > 0 for k in smoke.TRAIN_KERNELS)


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


@pytest.mark.parametrize("case", [
    # internvl2's call: causal GQA
    dict(B=1, Sq=37, Sk=37, H=8, Hkv=2, D=16, Dv=16),
    # gemma3's: a sliding window
    dict(B=1, Sq=37, Sk=37, H=4, Hkv=2, D=16, Dv=16, window=8),
    # DeepSeek's: a value width below the key width
    dict(B=1, Sq=20, Sk=20, H=4, Hkv=4, D=24, Dv=16),
    # whisper's encoder (non-causal) and cross attention
    dict(B=2, Sq=33, Sk=33, H=4, Hkv=4, D=16, Dv=16, causal=False),
    dict(B=2, Sq=4, Sk=45, H=4, Hkv=4, D=16, Dv=16, causal=False)])
def test_chip_smoke_backward_library_call_is_the_gradient(case):
    """The smoke's timed forward + backward calls, the kernels' autograd
    and SDPA's with the call's mask and value width, give the gradients
    the backward kernel computes, and its timed SDPA forward the output
    (CPU tensors, within 2e-5)."""
    from repro_torch.kernels.ref import attention_bwd_ref, attention_ref
    gen = torch.Generator().manual_seed(5)
    b, sq, sk, h, hkv, d, dv = (case.pop(k) for k in
                                ("B", "Sq", "Sk", "H", "Hkv", "D", "Dv"))
    q = torch.randn((b, sq, h, d), generator=gen)
    k = torch.randn((b, sk, hkv, d), generator=gen)
    v = torch.randn((b, sk, hkv, dv), generator=gen)
    do = torch.randn((b, sq, h, dv), generator=gen)
    o, lse = attention_ref(q, k, v, return_lse=True, **case)
    args = (q, k, v, o, lse, do)
    want = attention_bwd_ref(*args, **case)
    _, _, both, lib, lib_fwd = _load_chip_smoke().bwd_fns(
        "flash_attention_bwd", args, case)
    for fn in (both, lib):
        for got, ref in zip(fn(), want):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                                       rtol=2e-5)
    np.testing.assert_allclose(lib_fwd().transpose(1, 2).detach().numpy(),
                               o.numpy(), atol=2e-5, rtol=2e-5)


def test_chip_smoke_backward_library_call_of_rmsnorm_is_the_gradient():
    from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref
    gen = torch.Generator().manual_seed(6)
    x, dy = (torch.randn((7, 33), generator=gen) for _ in "xy")
    w = torch.randn((33,), generator=gen)
    want = rmsnorm_bwd_ref(x, w, dy)
    _, _, both, lib, lib_fwd = _load_chip_smoke().bwd_fns(
        "rmsnorm_bwd", (x, w, dy), {})
    for fn in (both, lib):
        for got, ref in zip(fn(), want):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                                       rtol=2e-5)
    np.testing.assert_allclose(lib_fwd().detach().numpy(),
                               rmsnorm_ref(x, w).numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("fault", [None, "gradient", "step", "scale",
                                   "residual"])
def test_chip_smoke_compression_gate_takes_only_boundary_flips(fault):
    """The smoke's card-vs-CPU gate of a compressed step: the card's side
    is the CPU's gradients with 1e-6 noise (sums in another order), one of
    them just past a rounding boundary, so one element rounds one int8
    step apart and passes; a changed gradient, one step off away from a
    boundary, a wrong scale or a wrong residual fails (CPU tensors)."""
    from repro_torch.elastic.compression import (compress_decompress,
                                                 init_residuals)
    smoke = _load_chip_smoke()
    gen = torch.Generator().manual_seed(11)
    shapes = {"embed.table": (64, 16), "segments.0.0.attn.wq": (16, 32),
              "segments.0.1.attn.wq": (16, 32), "final_norm.scale": (16,)}
    g_c = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    t = g_c["embed.table"]
    t[0, 0], t[1, 1], t[2, 2] = 127.0, 10.5, 5.0   # scale 1: 10.5 -> 10
    g_d = {n: g + 1e-6 * torch.randn(g.shape, generator=gen)
           for n, g in g_c.items()}
    g_d["embed.table"][1, 1] = 10.5 + 2e-6          # -> 11
    if fault == "gradient":
        g_d["segments.0.1.attn.wq"][3, 4] += 1.0
    out = {}
    for dev, g in (("cpu", g_c), (smoke.DEVICE, g_d)):
        deq, res = compress_decompress(g, init_residuals(g))
        out[dev] = (0.0, 0.0, None, None, (g, deq, res))
    _, deq, res = out[smoke.DEVICE][4]
    if fault == "step":      # 5.0 is half a step from any boundary
        deq["embed.table"][2, 2] += 1.0
        res["embed.table"][2, 2] -= 1.0
    elif fault == "scale":
        for n in deq:
            deq[n] *= 1.001
            res[n] = g_d[n] - deq[n]
    elif fault == "residual":
        res["final_norm.scale"][3] += 1e-3
    if fault is None:
        flips, total, worst = smoke.check_compression(out)
        assert (flips, total) == (1, sum(g.numel() for g in g_c.values()))
        assert worst == pytest.approx(1.0 / 127.0, rel=1e-5)
    else:
        with pytest.raises(AssertionError):
            smoke.check_compression(out)
