"""Plain reference of the world generator: seed-exact 2D OpenSimplex noise,
the three-octave column terrain, the startup smoke blocks, the palette and
the reference's colour packing.

A frozen copy of the port's ``worldgen/opensimplex.py`` (the vectorised 2D
evaluation), ``worldgen/terrain.py``, ``core/color.py`` and the palette of
``core/tree.py``, arithmetic unchanged; it imports nothing of the program.
Upstream: src/world_gen.cpp:13-42, include/OpenSimplexNoise.cpp:52-209,
src/types.hpp:6-9 of https://github.com/reedthorngag/raytracing_test.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

LEAF = 0x1
REFLECTIVE = 0x2
REFRACTIVE = 0x4
LIQUID = 0x10

# ------------------------------------------------------------------ colours

COLOR_MASK = (1 << 21) - 1
SCALED_COLOR = 1.0 / (1 << 21)
AIR_COLOR = (1 << 64) - 1


def _convert_scale(byte_val) -> np.ndarray:
    x = np.asarray(byte_val, dtype=np.float32)
    scaled = x / np.float32(255.0) * np.float32(COLOR_MASK)
    return np.uint64(np.trunc(scaled).astype(np.int64)) & np.uint64(COLOR_MASK)


def rgb_to_u64(r, g, b) -> int:
    return int((_convert_scale(r) << np.uint64(42)) | (_convert_scale(g) << np.uint64(21))
               | _convert_scale(b))


def u64_to_unit_f32(packed) -> np.ndarray:
    p = np.asarray(packed, dtype=np.uint64)
    chans = [(p >> np.uint64(42)) & np.uint64(COLOR_MASK),
             (p >> np.uint64(21)) & np.uint64(COLOR_MASK), p & np.uint64(COLOR_MASK)]
    out = np.stack([np.asarray(c, dtype=np.float64) * SCALED_COLOR for c in chans], axis=-1)
    return out.astype(np.float32)


# The reference's hotbar (src/globals.cpp:36-62): (properties, rgb, metadata).
HOTBAR = [
    (0, (255, 0, 0), 0.0),
    (0, (0, 255, 0), 0.0),
    (REFLECTIVE, (255, 0, 0), 0.94),
    (REFLECTIVE, (255, 255, 255), 0.94),
    (REFRACTIVE, (0, 0, 0), 1.5),
]


class Palette:
    """Material ids for (flags, colour, metadata) blocks; id 0 is air. A
    stored block always carries the leaf bit."""

    def __init__(self):
        self.entries: List[Tuple[int, int, float]] = [(0, AIR_COLOR, 0.0)]
        self._index: Dict[Tuple[int, int, float], int] = {}

    def id_for(self, flags: int, color: int, meta: float = 0.0) -> int:
        key = (int(flags) | LEAF, int(color), float(np.float32(meta)))
        if key not in self._index:
            if len(self.entries) >= 128:
                raise ValueError("palette full: material ids must fit 7 bits")
            self._index[key] = len(self.entries)
            self.entries.append(key)
        return self._index[key]

    def arrays(self, pad_to: int = 8):
        """(albedo f32 [P, 3], flags i32 [P], metadata f32 [P]), P a power of
        two of at least ``pad_to``; air's row is zero."""
        n = len(self.entries)
        P = max(pad_to, int(2 ** np.ceil(np.log2(n))))
        albedo = np.zeros((P, 3), np.float32)
        flags = np.zeros(P, np.int32)
        meta = np.zeros(P, np.float32)
        albedo[:n] = u64_to_unit_f32(np.array([e[1] for e in self.entries], np.uint64))
        albedo[0] = 0.0
        flags[:n] = [e[0] for e in self.entries]
        flags[0] = 0
        meta[:n] = [e[2] for e in self.entries]
        return albedo, flags, meta


# ------------------------------------------------------------------- noise

STRETCH_2D = -0.211324865405187
SQUISH_2D = 0.366025403784439
NORM_2D = 47.0
GRADIENTS_2D = np.array([5, 2, 2, 5, -5, 2, -2, 5, 5, -2, 2, -5, -5, -2, -2, -5], np.float64)
_LCG_MUL = 6364136223846793005
_LCG_ADD = 1442695040888963407
_U64 = (1 << 64) - 1


def _lcg(seed: int) -> int:
    s = (seed * _LCG_MUL + _LCG_ADD) & _U64
    return s - (1 << 64) if s >= (1 << 63) else s


def build_perm(seed: int) -> np.ndarray:
    source = list(range(256))
    perm = np.zeros(256, dtype=np.int64)
    for _ in range(3):
        seed = _lcg(seed)
    for i in range(255, -1, -1):
        seed = _lcg(seed)
        r = (seed + 31) % (i + 1)
        perm[i] = source[r]
        source[r] = source[i]
    return perm


def simplex2(seed: int, x, y) -> np.ndarray:
    """2D OpenSimplex noise of ``seed`` over same-shaped arrays, in [-1, 1]."""
    perm = build_perm(seed)
    grads = GRADIENTS_2D

    def extrap(xsb, ysb, dx, dy):
        i0 = perm[xsb & 0xFF]
        index = perm[(i0 + ysb) & 0xFF] & 0x0E
        return grads[index] * dx + grads[index + 1] * dy

    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    stretch_offset = (x + y) * STRETCH_2D
    xs, ys = x + stretch_offset, y + stretch_offset
    xsb = np.floor(xs).astype(np.int64)
    ysb = np.floor(ys).astype(np.int64)
    squish_offset = (xsb + ysb) * SQUISH_2D
    dx0, dy0 = x - (xsb + squish_offset), y - (ysb + squish_offset)
    xins, yins = xs - xsb, ys - ysb
    in_sum = xins + yins

    def contrib(attn, val):
        a = np.maximum(attn, 0.0)
        a *= a
        return a * a * val

    dx1, dy1 = dx0 - 1 - SQUISH_2D, dy0 - SQUISH_2D
    v1 = contrib(2 - dx1 * dx1 - dy1 * dy1, extrap(xsb + 1, ysb, dx1, dy1))
    dx2, dy2 = dx0 - SQUISH_2D, dy0 - 1 - SQUISH_2D
    v2 = contrib(2 - dx2 * dx2 - dy2 * dy2, extrap(xsb, ysb + 1, dx2, dy2))
    lo = in_sum <= 1
    zins = np.where(lo, 1 - in_sum, 2 - in_sum)
    corner = np.where(lo, zins > np.minimum(xins, yins), zins < np.maximum(xins, yins))
    xgty = xins > yins
    xoff = np.where(lo, np.where(corner, np.where(xgty, 1, -1), 1),
                    np.where(corner, np.where(xgty, 2, 0), 0))
    yoff = np.where(lo, np.where(corner, np.where(xgty, -1, 1), 1),
                    np.where(corner, np.where(xgty, 0, 2), 0))
    sq = np.where(lo, np.where(corner, 0.0, 2 * SQUISH_2D),
                  np.where(corner, 2 * SQUISH_2D, 0.0))
    dx_ext = dx0 - xoff - sq
    dy_ext = dy0 - yoff - sq
    xsb2 = np.where(lo, xsb, xsb + 1)
    ysb2 = np.where(lo, ysb, ysb + 1)
    dx0b = np.where(lo, dx0, dx0 - 1 - 2 * SQUISH_2D)
    dy0b = np.where(lo, dy0, dy0 - 1 - 2 * SQUISH_2D)
    v0 = contrib(2 - dx0b * dx0b - dy0b * dy0b, extrap(xsb2, ysb2, dx0b, dy0b))
    ve = contrib(2 - dx_ext * dx_ext - dy_ext * dy_ext,
                 extrap(xsb + xoff, ysb + yoff, dx_ext, dy_ext))
    return (v0 + v1 + v2 + ve) / NORM_2D


# ----------------------------------------------------------------- terrain

# initTetraHexaTree's smoke blocks (tetrahexa_tree.cpp:20-27): pos, flags, level
INIT_BLOCKS = [
    ((1000, 1000, 1000), 1, 5), ((10, 100, 10), 2, 6), ((100, 10, 100), 3, 6),
    ((20, 10, 200), 4, 5), ((1, 10, 10), 5, 6), ((2, 10, 10), 6, 6),
    ((3, 10, 10), 7, 6), ((4, 10, 10), 8, 6),
]


def heightmap(world: dict) -> np.ndarray:
    def c_round(v):
        return np.sign(v) * np.floor(np.abs(v) + 0.5)

    x = np.arange(world["width"], dtype=np.float64)[:, None]
    z = np.arange(world["length"], dtype=np.float64)[None, :]
    h = np.zeros((world["width"], world["length"]), dtype=np.float64)
    for seed, freq, amp in zip(world["seeds"], world["octave_freqs"], world["octave_amps"]):
        h += c_round(simplex2(seed, x * freq, z * freq) * amp)
    return (h + world["base_height"]).astype(np.int32)


def gen_world(world: dict):
    """The dense material grid [Sx, Sy, Sz] (0 = air) and its palette, from a
    configuration file's ``world`` group."""
    shape = tuple(world["grid_shape"])
    Sx, Sy, Sz = shape
    grid = np.zeros(shape, dtype=np.uint8)
    pal = Palette()
    grass = pal.id_for(0, rgb_to_u64(0, 150, 10))
    dirt = pal.id_for(0, rgb_to_u64(45, 18, 0))
    stone = pal.id_for(0, rgb_to_u64(33, 33, 33))
    water = pal.id_for(REFRACTIVE | LIQUID, rgb_to_u64(0, 150, 10))
    if world["include_init_blocks"]:
        for (bx, by, bz), fl, level in INIT_BLOCKS:
            size = 1 << (2 * (6 - level))
            base = tuple((c >> (2 * (6 - level))) << (2 * (6 - level)) for c in (bx, by, bz))
            if all(0 <= base[i] and base[i] + size <= shape[i] for i in range(3)):
                grid[base[0]:base[0] + size, base[1]:base[1] + size,
                     base[2]:base[2] + size] = pal.id_for(fl, 0)
    h = heightmap(world)
    W = min(world["width"], Sx)
    L = min(world["length"], Sz)
    hh = np.clip(h[:W, :L], 0, Sy - 1)
    ys = np.arange(Sy, dtype=np.int32)[None, None, :]
    hcol = hh[:, :, None]
    wl = world["water_level"]
    col = np.where((ys >= 1) & (ys <= hcol - 4), stone, 0).astype(np.uint8)
    col = np.where((ys >= np.maximum(hcol - 3, 1)) & (ys <= hcol - 1), dirt, col).astype(np.uint8)
    col = np.where(ys == hcol, np.where(hcol < wl, dirt, grass), col).astype(np.uint8)
    col = np.where((hcol < wl) & (ys > hcol) & (ys <= wl), water, col).astype(np.uint8)
    region = grid[:W, :, :L].transpose(0, 2, 1)
    grid[:W, :, :L] = np.where(col > 0, col, region).transpose(0, 2, 1)
    return grid, pal
