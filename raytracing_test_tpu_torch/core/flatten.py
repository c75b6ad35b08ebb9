"""Flattening: host world -> device-resident render scene (PyTorch tensors).

Port of ``raytracing_test_tpu/core/flatten.py``. The numpy builders are
re-expressed here because the reference module imports JAX at import time;
their arithmetic is unchanged, so the tensors equal the reference arrays
bit for bit (tests/test_torch_scene.py).

The scene carries what the march and shading read:

  - ``grid_enc``: u8 [Sx, Sy, Sz]. A value < 128 is the material id of a solid
    cell; a value >= 128 is air with Chebyshev distance ``v - 128 >= 1`` to
    the nearest solid cell, licensing a radius ``v - 129`` all-air jump box.
    One u8 load per march iteration gives the material or the licence.
  - ``y_max``: one above the highest solid voxel (analytic sky exits).
  - palette tables ``albedo`` f32[P, 3], ``flags`` i32[P], ``metadata`` f32[P].
  - ``macro``: occupancy of 4^3 cells (u8), kept for parity with the
    reference scene.

The reference's brick fields (``brick_mat``, ``brick_nib*``) serve only its
brick path and are not carried.
"""

from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields
from typing import Dict, Tuple

import numpy as np
import torch

from .color import u64_to_unit_f32
from .tree import Palette

MACRO_SHIFT = 2  # macro cells are 4^3 voxels


@dataclass(frozen=True)
class Scene:
    """Render scene: every field is a tensor on one device, except ``y_max``."""

    grid_enc: torch.Tensor  # u8 [Sx, Sy, Sz] distance-encoded material grid
    macro: torch.Tensor  # u8 [Sx/4, Sy/4, Sz/4] occupancy of 4^3 cells
    albedo: torch.Tensor  # f32 [P, 3] canonical unpacked colour
    flags: torch.Tensor  # i32 [P] property bitfields (leaf bit included)
    metadata: torch.Tensor  # f32 [P]
    y_max: int  # max solid y + 1

    @property
    def shape3(self) -> Tuple[int, int, int]:
        return tuple(self.grid_enc.shape)

    @property
    def device(self) -> torch.device:
        return self.grid_enc.device

    @property
    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in (getattr(self, f.name) for f in dc_fields(self))
            if isinstance(t, torch.Tensor)
        )


def build_macro(grid: np.ndarray) -> np.ndarray:
    """Occupancy of each 4^3 cell of the grid."""
    s = 1 << MACRO_SHIFT
    Sx, Sy, Sz = grid.shape
    g = grid.reshape(Sx // s, s, Sy // s, s, Sz // s, s)
    return (g.max(axis=(1, 3, 5)) > 0).astype(np.uint8)


def palette_arrays(pal: Palette, pad_to: int = 8):
    """Palette -> (albedo f32[P,3], flags i32[P], metadata f32[P]) numpy arrays."""
    n = max(len(pal), 1)
    P = max(pad_to, int(2 ** np.ceil(np.log2(n))))
    albedo = np.zeros((P, 3), dtype=np.float32)
    flags = np.zeros(P, dtype=np.int32)
    meta = np.zeros(P, dtype=np.float32)
    albedo[:n] = u64_to_unit_f32(pal.color)
    albedo[0] = 0.0  # air's sentinel colour must not leak into shading
    flags[:n] = pal.flags
    flags[0] = 0
    meta[:n] = pal.metadata
    return albedo, flags, meta


def _dilate_cheb(occ: np.ndarray, radius_log2: int) -> np.ndarray:
    """occ dilated by an L-inf cube of radius 2^radius_log2 - 1, via
    log-doubling shift-ORs (separable per axis)."""
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
    """Material grid -> distance-encoded grid (see the module docstring).

    Air distances are power-of-two lower bounds (1, 2, 4, 8, 16, 32) built
    with log-doubling dilations.
    """
    if int(grid.max(initial=0)) >= 128:
        raise ValueError("material ids must fit 7 bits (< 128)")
    occ = grid > 0
    enc = np.full(grid.shape, 128 + 1, np.uint8)  # air, distance >= 1
    for j in range(1, 6):  # dilation radii 1, 3, 7, 15, 31
        covered = _dilate_cheb(occ, j)
        enc[~covered] = 128 + (1 << j)  # distance > 2^j - 1  =>  >= 2^j
    enc[occ] = grid[occ]
    return enc


def world_y_max(grid: np.ndarray) -> int:
    solid_y = np.nonzero(grid.any(axis=(0, 2)))[0]
    return int(solid_y.max()) + 1 if len(solid_y) else 0


def scene_from_grid(grid: np.ndarray, pal: Palette, device) -> Scene:
    """Build the render Scene on ``device`` from a dense material grid + palette."""
    albedo, flags, meta = palette_arrays(pal)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Scene(
        grid_enc=put(build_grid_enc(grid)),
        macro=put(build_macro(grid)),
        albedo=put(albedo),
        flags=put(flags),
        metadata=put(meta),
        y_max=world_y_max(grid),
    )


def scene_from_jax(fields: Dict[str, np.ndarray], device) -> Scene:
    """The reference Scene's arrays (``np.asarray`` of each field of
    ``Scene`` in ``raytracing_test_tpu/core/flatten.py``) -> this package's Scene.

    Fields the port does not carry (``mat``, the brick fields) are ignored.
    """
    put = lambda k: torch.from_numpy(np.array(fields[k], order="C")).to(device)
    return Scene(
        grid_enc=put("grid_enc"),
        macro=put("macro"),
        albedo=put("albedo"),
        flags=put("flags"),
        metadata=put("metadata"),
        y_max=int(fields["y_max"]),
    )
