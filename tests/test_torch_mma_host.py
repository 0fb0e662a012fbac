"""The host emulation's tensor-core products against numpy.

``tests/host_cuda/mma_probe.cpp`` gathers one warp's fragments from
row-major A and B and scatters its accumulator to C by the layout table of
``csrc/mma.cuh``'s header, and runs the emulated product of
``tests/host_cuda/mma.cuh`` (the stand-in the kernels' host builds use) on
them: m16n8k8 TF32, the same in split TF32, m16n8k16 bf16.  C += A B is
held to numpy's float64 product of the operands as the tensor cores read
them (rounded to TF32 or bf16; split TF32 reads f32 to ~2^-21), so a
fragment layout in the stand-in that disagrees with the table fails here
instead of hiding an error in a kernel.  Skips where no C++20 compiler is
found.
"""
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

HOST = pathlib.Path(__file__).resolve().parent / "host_cuda"
SHAPES = {"tf32": (0, 8), "split_tf32": (1, 8), "bf16": (2, 16)}
# max |C - want| over max |want|: the emulation sums exact products in f32
TOL = {"tf32": 1e-6, "split_tf32": 1e-6, "bf16": 1e-6}


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host emulation")
    h = hashlib.sha256()
    for f in sorted(HOST.iterdir()):
        h.update(f.read_bytes())
    out = tmp_path_factory.mktemp("mma_probe")
    lib = out / f"libmma_probe_{h.hexdigest()[:16]}.so"
    done = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-I",
         str(HOST), str(HOST / "mma_probe.cpp"), "-o", str(lib)],
        capture_output=True, text=True)
    if done.returncode != 0 and "barrier" in done.stderr:
        pytest.skip(f"{cxx} has no C++20 <barrier>")
    assert done.returncode == 0, done.stderr[-4000:]
    so = ctypes.CDLL(str(lib))
    so.repro_mma_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    so.repro_mma_probe.restype = ctypes.c_int
    return so.repro_mma_probe


def tf32(v):
    """f32 rounded to TF32 as ``to_tf32`` rounds it: 10 mantissa bits, to
    nearest, ties away from zero."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def bf16(v):
    """f32 rounded to bf16 to nearest even, as ``__float2bfloat16_rn``."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7fff + ((u >> 16) & 1)) & 0xffff0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_mma_is_the_product_of_its_fragments(probe, shape, seed):
    code, k = SHAPES[shape]
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((16, k)).astype(np.float32)
    b = rng.standard_normal((k, 8)).astype(np.float32)
    c = rng.standard_normal((16, 8)).astype(np.float32)
    got = c.copy()
    assert probe(code, a.ctypes.data, b.ctypes.data, got.ctypes.data) == 0
    read = {"tf32": tf32, "bf16": bf16}.get(shape, lambda v: v)
    want = c.astype(np.float64) + (read(a).astype(np.float64)
                                   @ read(b).astype(np.float64))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL[shape], (shape, err)
    # B's k in another order than A's (a layout error) is far outside it
    wrong = c + read(a) @ read(b)[::-1]
    assert np.abs(wrong - want).max() / np.abs(want).max() > 100 * TOL[shape]
