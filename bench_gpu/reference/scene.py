"""Plain reference of the scene tables the march and the brick path read:
the distance-encoded grid, the brick rows and brick distance fields, the
palette tables and ``y_max``.

A frozen copy of the table functions of the port's ``core/flatten.py``
(``build_grid_enc``, ``build_brick_fields``, ``world_y_max``), arithmetic
unchanged; it imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .world import LIQUID

BRICK_DIST_CAP = 8


def _dilate_cheb(occ: np.ndarray, radius_log2: int) -> np.ndarray:
    m = occ.copy()
    for j in range(radius_log2):
        k = 1 << j
        for ax in range(3):
            shifted = np.zeros_like(m)
            sl = [slice(None)] * 3
            sr = [slice(None)] * 3
            sl[ax] = slice(k, None)
            sr[ax] = slice(None, -k)
            shifted[tuple(sl)] = m[tuple(sr)]
            m |= shifted
            shifted[:] = False
            shifted[tuple(sr)] = m[tuple(sl)]
            m |= shifted
    return m


def build_grid_enc(grid: np.ndarray) -> np.ndarray:
    """A value < 128 is the material of a solid cell; 128 + d is air whose
    Chebyshev distance to a solid cell is at least d (a power of two)."""
    occ = grid > 0
    enc = np.full(occ.shape, 129, np.uint8)
    for j in range(1, 6):
        enc[~_dilate_cheb(occ, j)] = 128 + (1 << j)
    enc[occ] = grid[occ]
    return enc


def chebyshev_distance_field(occupied: np.ndarray, cap: int) -> np.ndarray:
    occ = np.asarray(occupied, bool)
    dist = np.where(occ, 0, cap).astype(np.uint8)
    cur = occ.copy()
    for d in range(1, cap):
        nxt = cur.copy()
        for ax in range(3):
            sl = [slice(None)] * 3
            sr = [slice(None)] * 3
            sl[ax] = slice(1, None)
            sr[ax] = slice(None, -1)
            grown = nxt.copy()
            grown[tuple(sl)] |= nxt[tuple(sr)]
            grown[tuple(sr)] |= nxt[tuple(sl)]
            nxt = grown
        dist[nxt & ~cur] = d
        cur = nxt
        if cur.all():
            break
    return dist


def brick_shift(shape) -> int:
    for s in (2, 3, 4):
        nb = (shape[0] >> s) * (shape[1] >> s) * (shape[2] >> s)
        if nb <= (1 << 18) and all(d % (1 << s) == 0 for d in shape):
            return s
    raise ValueError(f"no brick decomposition for grid shape {shape}")


def brick_fields(grid: np.ndarray, flags: np.ndarray):
    """(brick_mat u8 [NB, bs^3], brick_dist, brick_dist_shadow): the voxel
    rows of each brick and the capped brick distances, LIQUID-only bricks
    counted as air in the shadow field. ``flags`` is indexed by material."""
    s = brick_shift(grid.shape)
    bs = 1 << s
    Sx, Sy, Sz = grid.shape
    rows = np.ascontiguousarray(
        grid.reshape(Sx >> s, bs, Sy >> s, bs, Sz >> s, bs).transpose(0, 2, 4, 1, 3, 5)
    ).reshape(-1, bs**3)
    bgrid = (Sx >> s, Sy >> s, Sz >> s)
    occ = (rows > 0).any(axis=1).reshape(bgrid)
    liquid = (np.asarray(flags) & LIQUID) > 0
    occ_hard = ((rows > 0) & ~liquid[rows]).any(axis=1).reshape(bgrid)
    return (rows, chebyshev_distance_field(occ, BRICK_DIST_CAP),
            chebyshev_distance_field(occ_hard, BRICK_DIST_CAP))


def y_max(grid: np.ndarray) -> int:
    solid_y = np.nonzero(grid.any(axis=(0, 2)))[0]
    return int(solid_y.max()) + 1 if len(solid_y) else 0


@dataclass(frozen=True)
class RefScene:
    """What the reference march reads, as tensors on one device."""

    grid_enc: torch.Tensor
    flags: torch.Tensor
    albedo: torch.Tensor
    y_max: int

    @property
    def shape3(self):
        return tuple(self.grid_enc.shape)


def ref_scene(grid: np.ndarray, albedo: np.ndarray, flags: np.ndarray, device) -> RefScene:
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return RefScene(put(build_grid_enc(grid)), put(flags), put(albedo), y_max(grid))
