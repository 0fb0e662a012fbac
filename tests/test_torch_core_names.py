"""Every public name of the reference's scheduling core has its port.

* the numpy functions copied into the port this slice (the speedup
  helpers, the trace-cleaning pipeline, the paper's Table 2) equal the
  reference's outputs byte for byte;
* the 1-D shrink / expand wrappers over the waterfill kernel equal the
  numpy redistribution (``tests/test_kernels.py``'s 777-slot case);
* an AST check: each public name of the reference's ``core``, ``sweep``,
  ``configs`` and ``kernels`` packages (their ``__all__`` / lazy exports)
  and of the modules listed in ``MODULES`` resolves in ``repro_torch``
  under the port's renames (``*_jax`` -> ``*_torch``, ``*_pallas`` ->
  ``*_waterfill``, ``simulate_jax`` -> ``simulate_dense``), apart from
  the names ``BY_DESIGN`` covers; the modules include the training
  slice's (``train.*``, ``elastic.compression``).
"""
import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.configs.workloads import WORKLOADS as J_WORKLOADS  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import WORKLOADS as T_WORKLOADS  # noqa: E402
from repro_torch.core.passes import greedy_expand, greedy_shrink  # noqa
from repro_torch.kernels import (greedy_expand_waterfill,  # noqa: E402
                                 greedy_shrink_waterfill)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# names of the reference with no counterpart, and why
BY_DESIGN = {
    ("repro.kernels", "ops"): "each wrapper dispatches on its tensor's "
                              "device; no TPU / XLA dispatch module",
    ("repro.sweep.runner", "enable_compilation_cache"): "JAX's persistent "
                                                        "XLA cache",
}
PACKAGES = ("core", "sweep", "configs", "kernels")
MODULES = (("core.speedup", "core.speedup"), ("core.traces", "core.traces"),
           ("core.sim_jax", "core.sim_dense"),
           ("kernels.waterfill", "kernels.waterfill"),
           ("sweep.runner", "sweep.runner"),
           # the training slice
           ("train.data", "train.data"),
           ("train.optimizer", "train.optimizer"),
           ("train.train_step", "train.train_step"),
           ("elastic.compression", "elastic.compression"))


def port_name(name: str) -> str:
    if name == "simulate_jax":
        return "simulate_dense"
    for old, new in (("_jax", "_torch"), ("_pallas", "_waterfill")):
        if name.endswith(old):
            return name[:-len(old)] + new
    return name


def _source(dotted: str) -> str:
    path = SRC / pathlib.Path(*dotted.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    return path.read_text()


def exported_names(package: str) -> list:
    """``__all__`` of a package, or the keys of its lazy ``_EXPORTS``."""
    for node in ast.parse(_source(package)).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0].id
            if target == "_EXPORTS":
                return [k.value for k in node.value.keys]
            if target == "__all__" and isinstance(node.value, ast.List):
                return [e.value for e in node.value.elts]
    raise AssertionError(f"{package} exports nothing")


def public_defs(module: str) -> list:
    """Top-level public functions, classes, constants and marked
    re-exports of a module."""
    text = _source(module)
    lines = text.splitlines()
    names = []
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif (isinstance(node, ast.ImportFrom) and "re-export" in
              "".join(lines[node.lineno - 1:node.end_lineno])):
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


@pytest.mark.parametrize("package", PACKAGES)
def test_every_package_export_has_its_port(package):
    port = importlib.import_module(f"repro_torch.{package}")
    missing = []
    for name in exported_names(f"repro.{package}"):
        if (f"repro.{package}", name) in BY_DESIGN:
            continue
        mapped = port_name(name)
        if mapped not in port.__all__ or not hasattr(port, mapped):
            missing.append(mapped)
    assert not missing, f"repro_torch.{package} lacks {missing}"


@pytest.mark.parametrize("ref,port", MODULES, ids=[m for m, _ in MODULES])
def test_every_module_name_has_its_port(ref, port):
    mod = importlib.import_module(f"repro_torch.{port}")
    names = [n for n in public_defs(f"repro.{ref}")
             if (f"repro.{ref}", n) not in BY_DESIGN]
    missing = [port_name(n) for n in names
               if not hasattr(mod, port_name(n))]
    assert names and not missing, f"repro_torch.{port} lacks {missing}"


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_speedup_helpers_equal_the_reference():
    rng = np.random.default_rng(3)
    n = rng.integers(0, 300, 500)
    p = rng.uniform(0.0, 1.0, 500)
    _same(jcore.amdahl_efficiency(n, p), tcore.amdahl_efficiency(n, p))
    req, rt = rng.integers(1, 64, 500), rng.uniform(30.0, 9e4, 500)
    _same(jcore.progress_rate(n, p, req, rt),
          tcore.progress_rate(n, p, req, rt))
    nodes = [1, 2, 4, 8, 16, 64]
    coll = [0.0, 0.3, 0.5, 0.9, 1.4, 2.5]
    for kw in ({}, {"collective_s_per_node": coll}):
        tj = jcore.TabulatedSpeedup.from_roofline(nodes, 12.0, 7.5, **kw)
        tt = tcore.TabulatedSpeedup.from_roofline(nodes, 12.0, 7.5, **kw)
        assert (tj.nodes, tj.speedup) == (tt.nodes, tt.speedup)
        _same(tj(n), tt(n))


@pytest.mark.parametrize("name,kw", [
    ("haswell", dict(seed=0)), ("knl", dict(seed=2, shared_frac=0.0)),
    ("theta", dict(seed=1, shared_frac=0.3, gpu_frac=0.1))])
def test_trace_cleaning_equals_the_reference(name, kw):
    raw_j = jcore.traces.corrupt_trace(
        jcore.traces.generate(name, 0, 0.005), **kw)
    raw_t = tcore.traces.corrupt_trace(
        tcore.traces.generate(name, 0, 0.005), **kw)
    for f in dataclasses.fields(raw_j):
        _same(getattr(raw_j, f.name), getattr(raw_t, f.name))
    assert raw_j.n_rows == raw_t.n_rows
    (w_j, rep_j), (w_t, rep_t) = (jcore.traces.clean_trace(raw_j),
                                  tcore.traces.clean_trace(raw_t))
    assert dataclasses.astuple(rep_j) == dataclasses.astuple(rep_t)
    for f in dataclasses.fields(w_j):
        _same(getattr(w_j, f.name), getattr(w_t, f.name))
    for grid in (3600.0, 900.0):
        for a, b in zip(jcore.traces.raw_utilization_timeline(raw_j, grid),
                        tcore.traces.raw_utilization_timeline(raw_t, grid)):
            _same(a, b)


def test_workloads_table_equals_the_reference():
    assert J_WORKLOADS.keys() == T_WORKLOADS.keys()
    for name, cfg in J_WORKLOADS.items():
        assert dataclasses.astuple(cfg) == dataclasses.astuple(
            T_WORKLOADS[name])
        assert cfg.duration_s == T_WORKLOADS[name].duration_s


def test_greedy_wrappers_equal_the_numpy_redistribution():
    """``tests/test_kernels.py``'s 777-slot case, every ``need`` / ``idle``:
    numpy arrays in, the plain waterfill on the CPU, int32 out."""
    rng = np.random.default_rng(17)
    n = 777
    alloc = rng.integers(1, 64, size=n).astype(np.int64)
    floor = np.maximum(alloc - rng.integers(0, 32, size=n), 1)
    cap = alloc + rng.integers(0, 32, size=n)
    prio = rng.normal(size=n)
    for need in (0, 100, 10_000, int((alloc - floor).sum())):
        got = greedy_shrink_waterfill(alloc, floor, prio, need)
        exp = greedy_shrink(alloc, floor, prio, need, xp=np)
        _same(got.numpy(), exp.astype(np.int32))
    for idle in (0, 100, 10_000):
        got = greedy_expand_waterfill(torch.from_numpy(alloc),
                                      torch.from_numpy(cap),
                                      torch.from_numpy(prio),
                                      torch.tensor(idle, dtype=torch.int32))
        exp = greedy_expand(alloc, cap, prio, idle, xp=np)
        _same(got.numpy(), exp.astype(np.int32))


def test_kernel_exports_resolve_lazily_and_modules_call_their_wrapper():
    import subprocess
    import sys
    code = ("import sys, repro_torch.kernels as k\n"
            "assert 'repro_torch.kernels.waterfill' not in sys.modules\n"
            "import torch\n"
            "cap = torch.tensor([3, 4, 5], dtype=torch.int32)\n"
            "out = k.waterfill(cap, 6)\n"
            "assert out.tolist() == [3, 3, 0], out\n"
            "assert k.waterfill.plan(1, 3, 132).tier == 'warp'\n"
            "assert callable(k.rmsnorm) and k.ref.waterfill_ref\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
