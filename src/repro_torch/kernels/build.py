"""Build and load the port's CUDA kernels at first use.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface
(``bindings.cpp``), loaded with :mod:`ctypes`.  The files include no PyTorch
header, so a build takes seconds instead of the minutes an extension that
includes ``torch/extension.h`` takes; ``nvcc`` is found through
``torch.utils.cpp_extension.CUDA_HOME``.  Each source compiles in its own
``nvcc`` process, all started together, and the objects are linked into
``build/torch_ext/librepro_kernels_<hash>.so`` at the root of the checkout,
named by a hash of the sources and flags so an edited source rebuilds.

Flags: ``-O3 --fmad=false`` and the default IEEE division, never fast math,
so the kernels' float expressions round exactly as the plain PyTorch pass
does.  A failed build raises; nothing falls back to the plain path.

The argument lists are kept by hand on both sides of the C interface
(``_SIGNATURES`` here, the entry points in ``bindings.cpp``).  The library
exports ``repro_abi()``, each entry point's parameter kinds as the compiler
sees them, and loading refuses a library whose kinds or counts differ from
``_SIGNATURES``.

Every wrapper launches through :func:`launch`, one lean prologue: the
library is read without the lock once it is loaded, the current stream's
raw handle comes without building a ``torch.cuda.Stream`` object, and a
device guard is entered only when the tensor is not on the current device.
``LAUNCH_COUNTS`` counts kernel launches by name; :func:`launch` adds one
for each wrapper call that launches, and nothing else does.  Launches may
come from several threads (the what-if service's dispatcher, one thread a
card of a split chunk), so the count is taken under a lock; the first
load is locked too, so any thread may be the one that builds.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
SOURCES = ("schedule_tick.cu", "waterfill.cu", "rmsnorm.cu",
           "flash_attention.cu", "ssd_scan.cu", "bindings.cpp")
HEADERS = ("kernels.h", "block.cuh", "dtype.cuh", "mma.cuh", "atomics.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

LAUNCH_COUNTS: collections.Counter = collections.Counter()
# filled by the first load: seconds spent building (0 when cached), the
# library path and the compiler's output (ptxas register / spill report)
BUILD_INFO: dict = {}

_LIB = None
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_schedule_tick": [_P] * 20 + [_I] * 14 + [_P],
    "repro_waterfill": [_P] * 5 + [_I] * 4 + [_P],
    "repro_rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _P],
    "repro_flash_attention": [_P] * 5 + [_I] * 11 + [_F, _I, _I, _P],
    "repro_ssd_scan": [_P] * 9 + [_I] * 8 + [_P],
}
_CODES = {_P: "P", _I: "I", _F: "F"}


def build_dir() -> pathlib.Path:
    """``build/torch_ext`` at the root of the checkout."""
    return CSRC.parents[3] / "build" / "torch_ext"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset); "
                           "cannot build the port's kernels")
    nvcc = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: pathlib.Path) -> str:
    """Compile every source in parallel, then link; returns the log."""
    nvcc = _nvcc()
    out = lib_path.parent
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        obj = out / f"{name}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for name, _obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    objs = [str(obj) for _name, obj, _proc in procs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "\n".join(log))
        tmp = out / f"{lib_path.name}.{os.getpid()}.tmp"
        link = subprocess.run(
            [nvcc, "-shared", "-gencode=arch=compute_90a,code=sm_90a",
             *objs, "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernel library failed:\n"
                               f"{link.stdout}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objs:
            pathlib.Path(obj).unlink(missing_ok=True)
    return "\n".join(log)


def expected_abi() -> str:
    """``_SIGNATURES`` spelled as ``repro_abi()`` spells the library's."""
    return "".join(f"{fn}={''.join(_CODES[t] for t in argtypes)};"
                   for fn, argtypes in _SIGNATURES.items())


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use (raises if it cannot be)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib_path = build_dir() / f"librepro_kernels_{_tag()}.so"
        t0 = time.monotonic()
        log = "" if lib_path.exists() else _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.repro_abi.argtypes = []
        lib.repro_abi.restype = ctypes.c_char_p
        abi = lib.repro_abi().decode()
        if abi != expected_abi():
            raise RuntimeError(
                f"{lib_path.name} takes {abi!r} but build._SIGNATURES "
                f"passes {expected_abi()!r}; bring the two in line")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(seconds=time.monotonic() - t0, path=str(lib_path),
                          log=log)
        _LIB = lib
        return lib


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    """The C code of an LLM kernel's activation or weight type (``DType``
    in ``kernels.h``): 0 for float32, 1 for bfloat16; raises otherwise."""
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise ValueError(f"the kernels take float32 or bfloat16, not {dtype}")
    return code


@functools.lru_cache(maxsize=16)
def sm_count(device: int) -> int:
    """The multiprocessors of CUDA device ``device`` (the launch plans fill
    the card with them)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(name: str, t, entry: str, *args) -> None:
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``t``'s device (``torch._C._cuda_getCurrentRawStream``: the handle as
    an int, with no ``torch.cuda.Stream`` object built), raise if the
    launch was refused, else count one launch of ``name``."""
    lib = _LIB if _LIB is not None else load_library()
    fn = getattr(lib, entry)
    dev = t.get_device()
    if dev == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    with _COUNT_LOCK:
        LAUNCH_COUNTS[name] += 1
