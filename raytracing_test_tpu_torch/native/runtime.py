"""ctypes bindings for the native C++ voxel runtime.

Port of ``raytracing_test_tpu/native/runtime.py``. ``native/src/
voxel_runtime.cpp`` (a copy of the reference's, unchanged) is compiled with
``g++ -O2 -std=c++17 -shared -fPIC`` at first use into ``_build/`` beside
the package (gitignored), keyed by a hash of the source and the flags as
``kernels/build.py`` keys the CUDA libraries. ``NativeVoxelTree`` has the
API of ``core.tree.VoxelTree``.

Unlike the reference, a failed build raises with the compiler's message; it
never falls back to the python tree. A caller that wants the python tree
asks for it (``WorldSession(use_native=False)``, the CLI's ``--no-native``).

The native tree is the production host runtime: the reference's worldgen is a
~2M-insertion putBlock storm (world_gen.cpp:19-40), which runs in
milliseconds here against tens of seconds in python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..core.types import AIR, Block

SRC = Path(__file__).resolve().parent / "src" / "voxel_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libvoxel_runtime_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native runtime: {' '.join(cmd)} failed to run: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native runtime: g++ failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stderr[-4000:]}")
    os.replace(tmp, out)


def _declare(lib: ctypes.CDLL) -> None:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.vt_create.argtypes = []
    lib.vt_create.restype = ctypes.c_void_p
    lib.vt_destroy.argtypes = [ctypes.c_void_p]
    lib.vt_destroy.restype = None
    lib.vt_put_block.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint64, ctypes.c_float, ctypes.c_int,
    ]
    lib.vt_put_block.restype = None
    lib.vt_get_block.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u32p, u64p, f32p,
    ]
    lib.vt_get_block.restype = ctypes.c_int
    lib.vt_delete_block.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    lib.vt_delete_block.restype = ctypes.c_int
    lib.vt_num_nodes.argtypes = [ctypes.c_void_p]
    lib.vt_num_nodes.restype = ctypes.c_int
    lib.vt_export_dense.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u32p, u64p, f32p,
    ]
    lib.vt_export_dense.restype = ctypes.c_int
    lib.vt_dirty_count.argtypes = [ctypes.c_void_p]
    lib.vt_dirty_count.restype = ctypes.c_int
    lib.vt_get_dirty.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.vt_get_dirty.restype = None
    lib.vt_clear_dirty.argtypes = [ctypes.c_void_p]
    lib.vt_clear_dirty.restype = None
    lib.vt_noise2.argtypes = [ctypes.c_int64, ctypes.c_double, ctypes.c_double]
    lib.vt_noise2.restype = ctypes.c_double
    lib.vt_gen_world.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.vt_gen_world.restype = None


def library() -> ctypes.CDLL:
    """The loaded runtime; builds it on first call. Raises on failure (a
    failure is not cached: the next call tries again)."""
    global _lib
    with _lock:
        if _lib is None:
            out = _target()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            _declare(lib)
            _lib = lib
        return _lib


def noise2(seed: int, x: float, y: float) -> float:
    """Seed-exact OpenSimplex 2D eval from the native runtime."""
    return library().vt_noise2(seed, x, y)


class NativeVoxelTree:
    """Native-backed sparse voxel tree; API-compatible with core.tree.VoxelTree."""

    def __init__(self):
        self._lib = library()
        self._t = self._lib.vt_create()

    def __del__(self):
        if getattr(self, "_t", None):
            self._lib.vt_destroy(self._t)
            self._t = None

    def put_block(self, pos, block: Block, level: int = 6) -> None:
        x, y, z = (int(v) for v in pos)
        self._lib.vt_put_block(
            self._t, x, y, z,
            ctypes.c_uint32(block.flags & 0xFFFFFFFF),
            ctypes.c_uint64(block.color & (2**64 - 1)),
            float(block.metadata), level,
        )

    def get_block(self, pos) -> Block:
        x, y, z = (int(v) for v in pos)
        f = ctypes.c_uint32()
        c = ctypes.c_uint64()
        m = ctypes.c_float()
        if self._lib.vt_get_block(self._t, x, y, z, ctypes.byref(f), ctypes.byref(c),
                                  ctypes.byref(m)):
            return Block(int(f.value), int(c.value), float(m.value))
        return AIR

    def delete_block(self, pos, level: int = 6) -> Block:
        prev = self.get_block(pos)
        self._lib.vt_delete_block(self._t, int(pos[0]), int(pos[1]), int(pos[2]), level)
        return prev

    @property
    def num_nodes(self) -> int:
        return self._lib.vt_num_nodes(self._t)

    # ------------------------------------------------------------ worldgen

    def gen_world(self, cfg) -> None:
        """Run the reference terrain recipe natively (per-voxel putBlock storm)."""
        from ..core.color import rgb_to_u64
        from ..core.types import Properties
        from ..worldgen.terrain import INIT_BLOCKS

        if cfg.include_init_blocks:
            for pos, blk, level in INIT_BLOCKS:
                self.put_block(pos, blk, level)
        self._lib.vt_gen_world(
            self._t, cfg.width, cfg.length,
            cfg.seeds[0], cfg.seeds[1], cfg.seeds[2],
            cfg.base_height, cfg.water_level,
            ctypes.c_uint64(int(rgb_to_u64(0, 150, 10))),
            ctypes.c_uint64(int(rgb_to_u64(45, 18, 0))),
            ctypes.c_uint64(int(rgb_to_u64(33, 33, 33))),
            ctypes.c_uint64(int(rgb_to_u64(0, 150, 10))),
            ctypes.c_uint32(int(Properties.REFRACTIVE | Properties.LIQUID)),
        )

    # ------------------------------------------------------------- flatten

    def export_dense(self, shape, max_palette: int = 256):
        """Rasterize to (grid u8[shape], pal_flags, pal_color, pal_meta)."""
        sx, sy, sz = shape
        grid = np.zeros((sx, sy, sz), dtype=np.uint8)
        pf = np.zeros(max_palette, dtype=np.uint32)
        pc = np.zeros(max_palette, dtype=np.uint64)
        pm = np.zeros(max_palette, dtype=np.float32)
        n = self._lib.vt_export_dense(
            self._t,
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sx, sy, sz, max_palette,
            pf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            pc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            pm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if n < 0:
            raise RuntimeError(
                "palette overflow during dense export (>256 distinct blocks in the native "
                "tree); the python palette merges to the nearest colour (core/tree.Palette): "
                "rebuild the session with use_native=False for huge palettes"
            )
        return grid, pf[:n], pc[:n], pm[:n]

    def dirty_bricks(self) -> List[Tuple[int, int, int]]:
        n = self._lib.vt_dirty_count(self._t)
        buf = np.zeros(3 * n, dtype=np.int32)
        if n:
            self._lib.vt_get_dirty(self._t, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return [tuple(int(v) for v in buf[3 * i: 3 * i + 3]) for i in range(n)]

    def clear_dirty(self) -> None:
        self._lib.vt_clear_dirty(self._t)
