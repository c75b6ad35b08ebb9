"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Counterpart of ``raytracing_test_tpu/kernels/support.py``: the reference
probed whether Pallas compiles and fell back to interpret mode; here the
kernels are compiled with ``nvcc`` into a shared library with a plain C
interface, and a failed build raises. There is no interpreted fallback.

The library is keyed on a hash of the sources and the flags, and lands in
``_build/`` beside this package (listed in ``.gitignore``). Only a library
that built and loaded is cached (the reference's lesson: never cache a
probe's failure, kernels/support.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# -fmad=false: no a*b+c contraction, so the kernel's DDA arithmetic rounds
# exactly like the plain PyTorch version (one rounding per operation).
# IEEE division and square root stay on (no --use_fast_math).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
]

_LIB = None
BUILD_INFO = {}  # seconds, nvcc's resource report, library path


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): cannot build csrc/*.cu")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first call. Raises on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not out.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp)] + [str(p) for p in srcs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)
        BUILD_INFO["nvcc_report"] = (res.stdout + res.stderr).strip()
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["path"] = str(out)
    _LIB = lib
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_march_launch.argtypes = (
        [P, P, I]  # grid_enc, flags, n_flags
        + [I] * 4  # sx, sy, sz, y_max
        + [I] * 4  # budget, shadow_budget, enable_materials, enable_shadows
        + [F] * 4  # time_s, sun x/y/z
        + [P] * 6  # cell, tmax, dir, step, abs_delta, seg_origin
        + [I]  # n
        + [P] * 12  # mat0, mat, cell, la, refl, shad, steps, dir, step, seg, lt, cmod
        + [P]  # stream
    )
    lib.fused_march_launch.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
