"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Counterpart of ``raytracing_test_tpu/kernels/support.py``: the reference
probed whether Pallas compiles and fell back to interpret mode; here each
``csrc/<name>.cu`` is compiled with ``nvcc`` into its own shared library with
a plain C interface, and a failed build raises. There is no interpreted
fallback.

``library(name)`` builds one source on first use (``fused_march``,
``fused_window``, ``brick_march``, ``chebyshev``); ``build_all()`` starts one
``nvcc`` per source, all at once, and loads them. A library is keyed on a
hash of its source and the flags, and lands in ``_build/`` beside this
package (listed in ``.gitignore``). Only a library that built and loaded is
cached (the reference's lesson: never cache a probe's failure,
kernels/support.py).
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

# -fmad=false: no a*b+c contraction, so the kernels' arithmetic rounds
# exactly like the plain PyTorch versions (one rounding per operation).
# IEEE division and square root stay on (no --use_fast_math).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
]

_LIBS = {}  # name -> loaded ctypes.CDLL
BUILD_INFO = {}  # name -> {seconds, nvcc_report, path}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): cannot build csrc/*.cu")


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src] + sorted(CSRC_DIR.glob("*.cuh")):  # the shared headers too
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _start(src: Path):
    """Start nvcc on one source, or return None when its library is built."""
    out = _target(src)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return cmd, proc, tmp, out


def _finish(name: str, job, t0: float) -> None:
    if job is not None:
        cmd, proc, tmp, out = job
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stdout}\n{stderr}"
            )
        os.replace(tmp, out)
        BUILD_INFO.setdefault(name, {})["nvcc_report"] = (stdout + stderr).strip()
    path = _target(CSRC_DIR / f"{name}.cu")
    lib = ctypes.CDLL(str(path))
    _DECLARE[name](lib)
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    BUILD_INFO.setdefault(name, {}).update(seconds=time.perf_counter() - t0, path=str(path))
    _LIBS[name] = lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; builds it on first call.
    Raises on failure."""
    if name not in _LIBS:
        t0 = time.perf_counter()
        _finish(name, _start(CSRC_DIR / f"{name}.cu"), t0)
    return _LIBS[name]


def build_all() -> None:
    """Build every ``csrc/*.cu`` at once (one nvcc process each) and load them."""
    t0 = time.perf_counter()
    jobs = {src.stem: _start(src) for src in sources() if src.stem not in _LIBS}
    try:
        for name, job in jobs.items():
            _finish(name, job, t0)
    finally:
        for job in jobs.values():
            if job is not None and job[1].poll() is None:
                job[1].kill()
                job[1].wait()


def _declare_fused_march(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_march_launch.argtypes = (
        [P, P, I, P, I]  # grid_enc, prox_enc, prox, flags, n_flags
        + [I] * 4  # sx, sy, sz, y_max
        + [I] * 4  # budget, shadow_budget, enable_materials, enable_shadows
        + [F] * 4  # time_s, sun x/y/z
        + [P] * 6  # cell, tmax, dir, step, abs_delta, seg_origin
        + [I, I]  # n, image width (0: natural order)
        + [P] * 12  # mat0, mat, cell, la, refl, shad, steps, dir, step, seg, lt, cmod
        + [P]  # stream
    )
    lib.fused_march_launch.restype = ctypes.c_int
    lib.fused_march_blocks_per_sm.argtypes = [I]
    lib.fused_march_blocks_per_sm.restype = ctypes.c_int
    lib.fused_march_threads.argtypes = []
    lib.fused_march_threads.restype = ctypes.c_int


def _declare_fused_window(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    rays = (
        [P, I, I, I]  # field, sx, sy, sz
        + [P] * 4  # cell, tmax, istep, abs_delta
        + [I] * 3  # n, S, shading
        + [F] * 3  # sun x/y/z
    )
    lib.window_fwd_launch.argtypes = rays + [P] * 4 + [P]  # surf, t_end, w_sum, t_exp; stream
    lib.window_fwd_launch.restype = ctypes.c_int
    lib.window_bwd_launch.argtypes = (
        rays + [P] * 4  # g_surf, g_tend, surf, t_end
        + [P] * 3  # grad field, g_tmax, g_abs
        + [P]  # stream
    )
    lib.window_bwd_launch.restype = ctypes.c_int
    lib.window_blocks_per_sm.argtypes = [I, P]
    lib.window_blocks_per_sm.restype = ctypes.c_int


def _declare_brick_march(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    state = [P] * 9  # cell, tmax, step, abs_delta, mat, done, last_t, last_axis, steps
    lib.brick_advance_launch.argtypes = (
        [P] + [I] * 6  # brick_dist, sx, sy, sz, shift, y_max, budget
        + state + [I, P]  # the state, written in place; n; stream
    )
    lib.brick_advance_launch.restype = ctypes.c_int
    lib.brick_blocks_per_sm.argtypes = [I, P]
    lib.brick_blocks_per_sm.restype = ctypes.c_int
    lib.brick_fine_launch.argtypes = (
        [P, P] + [I] * 5  # brick_mat, luts, sx, sy, sz, shift, budget
        + state + [P, P, P, I]  # the state, written in place; blin, evt, lanes, n
        + [P] * 3 + [P]  # list_out, count_out, count_clear; stream
    )
    lib.brick_fine_launch.restype = ctypes.c_int


def _declare_chebyshev(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cheb_pass_launch.argtypes = (
        [P, P, P]  # in, out, ids (null but in the licence pass)
        + [I] * 3  # O, L, I: the view [O, L, I], the pass along L
        + [I] * 3  # cap, first, licence
        + [P]  # stream
    )
    lib.cheb_pass_launch.restype = ctypes.c_int


_DECLARE = {
    "fused_march": _declare_fused_march,
    "fused_window": _declare_fused_window,
    "brick_march": _declare_brick_march,
    "chebyshev": _declare_chebyshev,
}
