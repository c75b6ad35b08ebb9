"""Host-side picking raycaster — the reference's CPU DDA used for block
selection and editing (src/ray_caster.cpp).

Semantics parity with castRayFromCam (ray_caster.cpp:54-87):
  - Amanatides-Woo DDA from the camera, default 30 steps (input.cpp:143);
  - LIQUID blocks are transparent to the pick ray (ray_caster.cpp:82);
  - returns the hit voxel, the previous voxel (the face to place against), and
    the remaining step count (0 => nothing hit in range);
  - pos.round uses trunc (not floor!) like the reference's ivec3(trunc(...)),
    and the tie-break prefers x, then y, then z.

Runs against any block source with a ``get_block(pos) -> Block`` method (the
python tree, the native tree, or a dense-grid adapter).

This port's own copy of ``raytracing_test_tpu/app/picking.py``: the port imports nothing of
the JAX package. The arithmetic is unchanged, so worlds and palettes
come out bit for bit the same (tests/test_torch_host.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np

from ..core.types import Block, Properties


class RayResult(NamedTuple):
    pos: Tuple[int, int, int]  # hit voxel (or last marched voxel)
    last_pos: Tuple[int, int, int]  # voxel before the hit (placement face)
    steps: int  # remaining budget; 0 => no hit


class GridBlockSource:
    """Adapter: dense material grid + palette as a get_block source."""

    def __init__(self, grid: np.ndarray, palette):
        self.grid = grid
        self.palette = palette

    def get_block(self, pos) -> Block:
        x, y, z = (int(p) & 1023 for p in pos)
        Sx, Sy, Sz = self.grid.shape
        if x < Sx and y < Sy and z < Sz:
            return self.palette.block(int(self.grid[x, y, z]))
        from ..core.types import AIR

        return AIR


def cast_ray(source, origin, direction, steps: int = 30) -> RayResult:
    """The reference pick ray: DDA until a non-air, non-LIQUID block."""
    ox, oy, oz = (float(v) for v in origin)
    dx, dy, dz = (float(v) for v in direction)
    eps = 1e-12
    dx = dx if abs(dx) > eps else eps
    dy = dy if abs(dy) > eps else eps
    dz = dz if abs(dz) > eps else eps
    step = [1 if dx >= 0 else -1, 1 if dy >= 0 else -1, 1 if dz >= 0 else -1]
    delta = [1.0 / dx, 1.0 / dy, 1.0 / dz]
    abs_delta = [abs(d) for d in delta]
    cell = [int(math.trunc(ox)), int(math.trunc(oy)), int(math.trunc(oz))]
    exact = [ox, oy, oz]
    for a in range(3):
        if step[a] < 0:
            exact[a] -= 1.0
    tmax = [abs_delta[a] - (exact[a] - cell[a]) * delta[a] for a in range(3)]

    last = tuple(cell)
    while steps:
        steps -= 1
        last = tuple(cell)
        if tmax[0] < tmax[1] and tmax[0] < tmax[2]:
            a = 0
        elif tmax[1] < tmax[2]:
            a = 1
        else:
            a = 2
        cell[a] += step[a]
        tmax[a] += abs_delta[a]
        blk = source.get_block(cell)
        if not blk.is_air and not (blk.flags & Properties.LIQUID):
            return RayResult(tuple(cell), last, steps)
    return RayResult(tuple(cell), last, 0)
