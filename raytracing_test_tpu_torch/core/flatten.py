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
  - ``prox_enc`` (built at first use, not by ``scene_from_grid``): the grid
    the march's prox mode reads (``build_prox_enc``). The reference derives
    its stop rule from the class of each 8^3 brick in its MXU tables
    (``core/fused_tables.py``); here it is one more u8 grid.
  - the brick fields of the brick path (render/bricks.py,
    kernels/brick_kernels.py): ``brick_mat`` u8 [NB, bs^3], the voxel rows
    of each brick; ``brick_dist`` u8 [Bx, By, Bz], the exact Chebyshev
    distance in bricks to the nearest brick with a solid voxel, capped at
    ``BRICK_DIST_CAP`` (0 = this brick holds solids, d >= 1 licenses an
    all-air box of radius d - 1 bricks); ``brick_dist_shadow``, the same with
    bricks that hold only LIQUID counted as air (shadow rays skip LIQUID).

``scene_from_grid`` takes a numpy grid, built on the host by the numpy
builders below, or a u8 tensor, built on that tensor's device
(``_scene_from_tensor``: the distance fields by the kernel of
``kernels/chebyshev.py``, the rest by PyTorch operations); both give the
same fields bit for bit. ``SCENES_FROM_NUMPY`` and ``SCENES_FROM_TENSOR``
count the Scenes each path built. ``core/mirror.py`` builds an edit's boxes
with the same tensor builders (``macro_tensor``, ``brick_rows_tensor``,
``brick_occupancy_tensor``, the distance kernel).

The reference packs the two distance fields as f32 one-hot tables of nibble
pairs (``brick_nib``, ``brick_nib_shadow``) only so that its TPU matrix unit
can look them up (``ops/mxu_lookup.py:68-126``); on the card one u8 load
does that job, so the port keeps them as plain u8 arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, fields as dc_fields
from functools import cached_property
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .color import u64_to_unit_f32
from .tree import Palette, VoxelTree
from .types import WORLD_MASK, Block, Properties

MACRO_SHIFT = 2  # macro cells are 4^3 voxels
BRICK_DIST_CAP = 8  # max brick-level Chebyshev distance (licence <= 7 bricks)
PROX_BRICK = 8  # edge of the bricks whose first entry stops a prox march
PROX_AIR = 127  # prox_enc code of an air cell in an occupied brick (a stop cell)

SCENES_FROM_NUMPY = 0  # Scenes scene_from_grid built from a numpy grid
SCENES_FROM_TENSOR = 0  # Scenes scene_from_grid built from a tensor, on its device


@dataclass(frozen=True)
class Scene:
    """Render scene: every field is a tensor on one device, except ``y_max``."""

    grid_enc: torch.Tensor  # u8 [Sx, Sy, Sz] distance-encoded material grid
    macro: torch.Tensor  # u8 [Sx/4, Sy/4, Sz/4] occupancy of 4^3 cells
    albedo: torch.Tensor  # f32 [P, 3] canonical unpacked colour
    flags: torch.Tensor  # i32 [P] property bitfields (leaf bit included)
    metadata: torch.Tensor  # f32 [P]
    y_max: int  # max solid y + 1
    # brick path only (None on scenes that never render with bricks)
    brick_mat: Optional[torch.Tensor] = None  # u8 [NB, bs^3] voxel rows,
    # vox (dx*bs + dy)*bs + dz, brick lin (bx*By + by)*Bz + bz
    brick_dist: Optional[torch.Tensor] = None  # u8 [Bx, By, Bz]
    brick_dist_shadow: Optional[torch.Tensor] = None  # u8 [Bx, By, Bz], LIQUID as air

    @property
    def shape3(self) -> Tuple[int, int, int]:
        return tuple(self.grid_enc.shape)

    @property
    def brick_shift(self) -> int:
        """log2 of the brick edge, from the width of a ``brick_mat`` row."""
        return {64: 2, 512: 3, 4096: 4}[self.brick_mat.shape[1]]

    @property
    def brick_grid(self) -> Tuple[int, int, int]:
        s = self.brick_shift
        Sx, Sy, Sz = self.shape3
        return Sx >> s, Sy >> s, Sz >> s

    @property
    def device(self) -> torch.device:
        return self.grid_enc.device

    @cached_property
    def prox_enc(self) -> torch.Tensor:
        """u8 [Sx, Sy, Sz]: the grid the march reads in its prox mode
        (``build_prox_enc``), built from ``grid_enc`` at first use and kept."""
        enc = build_prox_enc(self.grid_enc.cpu().numpy())
        return torch.from_numpy(enc).to(self.device)

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


def _air_licences(occ: np.ndarray) -> np.ndarray:
    """128 + d per cell, d a power-of-two lower bound (1, 2, 4, 8, 16, 32) of
    the Chebyshev distance to the nearest ``occ`` cell, from log-doubling
    dilations. Only the values of cells outside ``occ`` mean anything."""
    enc = np.full(occ.shape, 128 + 1, np.uint8)  # air, distance >= 1
    for j in range(1, 6):  # dilation radii 1, 3, 7, 15, 31
        covered = _dilate_cheb(occ, j)
        enc[~covered] = 128 + (1 << j)  # distance > 2^j - 1  =>  >= 2^j
    return enc


def build_grid_enc(grid: np.ndarray) -> np.ndarray:
    """Material grid -> distance-encoded grid (see the module docstring)."""
    if int(grid.max(initial=0)) >= 128:
        raise ValueError("material ids must fit 7 bits (< 128)")
    occ = grid > 0
    enc = _air_licences(occ)
    enc[occ] = grid[occ]
    return enc


def build_prox_enc(grid_enc: np.ndarray) -> np.ndarray:
    """``grid_enc`` -> the grid of the march's prox mode, in the same layout.

    Stop cells are the cells of every 8^3 brick that holds a solid cell: a
    solid one keeps its material id, an air one holds ``PROX_AIR``. Every
    other cell holds ``128 + d``, the licence of ``build_grid_enc`` computed
    with the stop cells as occupied, so no licence box holds a stop cell.
    Reads only ``grid_enc`` (a value < 128 is solid).
    """
    shape = grid_enc.shape
    if any(d % PROX_BRICK for d in shape):
        raise ValueError(f"grid shape {shape} not divisible by {PROX_BRICK}")
    solid = grid_enc < 128
    if (grid_enc[solid] == PROX_AIR).any():
        raise ValueError(f"material id {PROX_AIR} is reserved by the prox grid")
    b = PROX_BRICK
    Bx, By, Bz = (d // b for d in shape)
    occupied = solid.reshape(Bx, b, By, b, Bz, b).any(axis=(1, 3, 5))
    stop = np.broadcast_to(occupied[:, None, :, None, :, None],
                           (Bx, b, By, b, Bz, b)).reshape(shape)
    enc = _air_licences(stop)
    enc[stop] = PROX_AIR
    enc[solid] = grid_enc[solid]
    return enc


def chebyshev_distance_field(occupied: np.ndarray, cap: int = 15) -> np.ndarray:
    """L-inf distance (in cells) to the nearest occupied cell, capped.

    Copy of ``raytracing_test_tpu/ops/mxu_lookup.py:135``, arithmetic
    unchanged. occupied: bool [X, Y, Z]; returns uint8 with 0 = occupied.
    Distance d >= 1 certifies that every cell within Chebyshev radius d-1 is
    empty.
    """
    occ = np.asarray(occupied, bool)
    dist = np.where(occ, 0, cap).astype(np.uint8)
    cur = occ.copy()
    for d in range(1, cap):
        # one Chebyshev dilation = 3^3 max-pool; separable as composed
        # per-axis +/-1 shift-ORs (each axis applied to the running result)
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
        newly = nxt & ~cur
        dist[newly] = d
        cur = nxt
        if cur.all():
            break
    return dist


def pick_brick_shift(shape) -> int:
    """Smallest brick edge 2^s in {4, 8, 16} keeping the brick count within
    2^18 (the reference's lookup-table budget, kept so both packages pick the
    same bricks)."""
    for s in (2, 3, 4):
        nb = (shape[0] >> s) * (shape[1] >> s) * (shape[2] >> s)
        if nb <= (1 << 18) and all(d % (1 << s) == 0 for d in shape):
            return s
    raise ValueError(f"no brick decomposition for grid shape {shape}")


def brick_rows(grid: np.ndarray, s: int) -> np.ndarray:
    """Dense grid -> per-brick voxel rows u8[NB, (2^s)^3] (vox (dx*bs+dy)*bs+dz)."""
    bs = 1 << s
    Sx, Sy, Sz = grid.shape
    g = grid.reshape(Sx >> s, bs, Sy >> s, bs, Sz >> s, bs)
    return np.ascontiguousarray(g.transpose(0, 2, 4, 1, 3, 5)).reshape(-1, bs**3)


def build_brick_fields(grid: np.ndarray, flags: np.ndarray):
    """(brick_mat, brick_dist, brick_dist_shadow) numpy arrays."""
    s = pick_brick_shift(grid.shape)
    rows = brick_rows(grid, s)
    bgrid = tuple(d >> s for d in grid.shape)
    occ = (rows > 0).any(axis=1).reshape(bgrid)
    dist = chebyshev_distance_field(occ, cap=BRICK_DIST_CAP)
    liquid_ids = (np.asarray(flags) & int(Properties.LIQUID)) > 0
    occ_hard = ((rows > 0) & ~liquid_ids[rows]).any(axis=1).reshape(bgrid)
    return rows, dist, chebyshev_distance_field(occ_hard, cap=BRICK_DIST_CAP)


def world_y_max(grid: np.ndarray) -> int:
    solid_y = np.nonzero(grid.any(axis=(0, 2)))[0]
    return int(solid_y.max()) + 1 if len(solid_y) else 0


def scene_from_grid(grid, pal: Palette, device) -> Scene:
    """Build the render Scene on ``device`` from a dense material grid + palette.

    A numpy grid is built on the host by the numpy builders; a u8 tensor on
    its own device (``_scene_from_tensor``), to the same fields."""
    global SCENES_FROM_NUMPY
    if isinstance(grid, torch.Tensor):
        return _scene_from_tensor(grid, pal, device)
    SCENES_FROM_NUMPY += 1
    albedo, flags, meta = palette_arrays(pal)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    b_mat, b_dist, b_dist_sh = build_brick_fields(grid, flags)
    return Scene(
        grid_enc=put(build_grid_enc(grid)),
        macro=put(build_macro(grid)),
        albedo=put(albedo),
        flags=put(flags),
        metadata=put(meta),
        y_max=world_y_max(grid),
        brick_mat=put(b_mat),
        brick_dist=put(b_dist),
        brick_dist_shadow=put(b_dist_sh),
    )


def macro_tensor(grid: torch.Tensor) -> torch.Tensor:
    """``build_macro`` of a u8 tensor, on its device."""
    m = 1 << MACRO_SHIFT
    Sx, Sy, Sz = grid.shape
    occ = grid.reshape(Sx // m, m, Sy // m, m, Sz // m, m).amax(dim=(1, 3, 5))
    return (occ != 0).to(torch.uint8)


def brick_rows_tensor(grid: torch.Tensor, s: int) -> torch.Tensor:
    """``brick_rows`` of a u8 tensor, on its device."""
    bs = 1 << s
    bgrid = tuple(d >> s for d in grid.shape)
    rows = grid.reshape(bgrid[0], bs, bgrid[1], bs, bgrid[2], bs).permute(0, 2, 4, 1, 3, 5)
    return rows.contiguous().reshape(-1, bs ** 3)


def brick_occupancy_tensor(rows: torch.Tensor, flags: np.ndarray) -> torch.Tensor:
    """u8 [2, ...] of brick rows u8 [..., bs^3]: whether each brick holds a
    solid voxel, and whether it holds one that is not LIQUID (the occupancy
    of ``brick_dist`` and of ``brick_dist_shadow``)."""
    solid = rows != 0
    # the shadow field counts LIQUID voxels as air: the palette's few LIQUID
    # ids are compared on the device, with no index tensor of the rows' size
    hard = solid
    for i in np.nonzero(np.asarray(flags) & int(Properties.LIQUID))[0]:
        hard = hard & (rows != int(i))
    return torch.stack([solid.any(dim=-1), hard.any(dim=-1)]).to(torch.uint8)


def build_brick_fields_tensor(grid: torch.Tensor, flags: np.ndarray, s: int):
    """``build_brick_fields`` of a u8 tensor at brick shift ``s``, on the
    tensor's device: (brick_mat, brick_dist, brick_dist_shadow), the two
    distance fields as one batch of ``kernels/chebyshev.py``'s passes."""
    from ..kernels import chebyshev

    bgrid = tuple(d >> s for d in grid.shape)
    rows = brick_rows_tensor(grid, s)
    occ = brick_occupancy_tensor(rows, flags).reshape(2, *bgrid)
    dist, dist_shadow = chebyshev.distance(occ, cap=BRICK_DIST_CAP)
    return rows, dist, dist_shadow


def _scene_from_tensor(grid: torch.Tensor, pal: Palette, device) -> Scene:
    """``scene_from_grid`` of a u8 [Sx, Sy, Sz] tensor: every field is built
    on the tensor's device and equals the numpy builders' bit for bit. The
    distance fields come from ``kernels/chebyshev.py``; the palette tables
    are three small uploads; ``y_max`` and the largest id come back to the
    host in one read, after everything else has been queued."""
    global SCENES_FROM_TENSOR
    from ..kernels import chebyshev

    if grid.dtype != torch.uint8 or grid.dim() != 3:
        raise ValueError(f"scene_from_grid: a tensor grid must be u8 [Sx, Sy, Sz], got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    g = grid.contiguous()
    dev = g.device
    Sy = g.shape[1]
    albedo, flags, meta = palette_arrays(pal)
    macro = macro_tensor(g)
    rows, b_dist, b_dist_sh = build_brick_fields_tensor(g, flags, pick_brick_shift(g.shape))
    enc = chebyshev.distance(g, cap=chebyshev.MAX_CAP, licence=True)
    col = g.amax(dim=(0, 2))  # the largest id of each y
    top = torch.where(col != 0, torch.arange(1, Sy + 1, device=dev), 0).max()
    y_max, largest = torch.stack([top, col.max().long()]).tolist()
    if largest >= 128:
        raise ValueError("material ids must fit 7 bits (< 128)")
    SCENES_FROM_TENSOR += 1
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Scene(
        grid_enc=enc.to(device),
        macro=macro.to(device),
        albedo=put(albedo),
        flags=put(flags),
        metadata=put(meta),
        y_max=int(y_max),
        brick_mat=rows.to(device),
        brick_dist=b_dist.to(device),
        brick_dist_shadow=b_dist_sh.to(device),
    )


def scene_from_tree(tree: VoxelTree, pal: Palette, grid_shape, device) -> Scene:
    """Rasterize a tree window and build the Scene on ``device`` (full flatten)."""
    return scene_from_grid(rasterize_tree(tree, pal, grid_shape), pal, device)


def rasterize_tree(tree: VoxelTree, pal: Palette, grid_shape) -> np.ndarray:
    """Tree -> dense material-id grid over the window [0, shape) (reference
    :258); blocks new to ``pal`` are added to it."""
    ext = max(grid_shape)
    flags, color, meta = tree.to_dense(ext)
    grid = np.zeros((ext,) * 3, dtype=np.uint8)
    solid = (flags & 1) == 1
    if solid.any():
        # dedupe (flags, color, meta) triples before the python palette loop
        f, c, m = flags[solid], color[solid], meta[solid]
        triples = np.stack([f.astype(np.int64), c.astype(np.int64), m.view(np.int32).astype(np.int64)], -1)
        uniq, inv = np.unique(triples, axis=0, return_inverse=True)
        uniq_ids = np.array(
            [
                pal.id_for(Block(int(uf), int(np.uint64(uc)), float(np.int32(um).view(np.float32))))
                for uf, uc, um in uniq
            ],
            dtype=np.uint8,
        )
        grid[solid] = uniq_ids[inv]
    return grid[: grid_shape[0], : grid_shape[1], : grid_shape[2]]


def lookup_material(scene: Scene, x, y, z) -> torch.Tensor:
    """Material ids (int32) at integer voxel coordinates (int tensors on the
    scene's device). Coordinates wrap with & 1023 (the reference's address
    digest, tetrahexa_tree.cpp:127); outside the grid window is air (0). The
    reference reads its ``mat`` grid; here ``grid_enc``, whose values below
    128 are the same ids and whose others are air."""
    Sx, Sy, Sz = scene.shape3
    xm, ym, zm = x & WORLD_MASK, y & WORLD_MASK, z & WORLD_MASK
    inside = (xm < Sx) & (ym < Sy) & (zm < Sz)
    zero = torch.zeros_like(xm)
    v = scene.grid_enc[torch.where(inside, xm, zero).long(), torch.where(inside, ym, zero).long(),
                       torch.where(inside, zm, zero).long()].to(torch.int32)
    return torch.where(inside & (v < 128), v, torch.zeros_like(v))


def _nibbles_from_table(table: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` values packed in a reference nibble table: byte i sits
    at [i // B, i % B] of the f32 [A, B] table (``pack_bytes_rect``), and
    value i is bits 4*(i&1).. of byte i >> 1 (``pack_nibble_pairs``)."""
    b = np.asarray(table).reshape(-1).astype(np.uint8)
    return np.stack([b & 0xF, b >> 4], axis=1).reshape(-1)[:n]


def scene_from_jax(fields: Dict[str, np.ndarray], device) -> Scene:
    """The reference Scene's arrays (``np.asarray`` of each field of
    ``Scene`` in ``raytracing_test_tpu/core/flatten.py``) -> this package's Scene.

    ``mat`` and ``brick_nib`` are not carried; ``brick_dist_shadow`` is
    decoded from ``brick_nib_shadow``. A reference Scene without brick
    fields gives a Scene without them.
    """
    put = lambda a: torch.from_numpy(np.array(a, order="C")).to(device)
    bricks = {}
    if fields.get("brick_mat") is not None:
        dist = np.asarray(fields["brick_dist"])
        bricks = dict(
            brick_mat=put(fields["brick_mat"]),
            brick_dist=put(dist),
            brick_dist_shadow=put(
                _nibbles_from_table(fields["brick_nib_shadow"], dist.size).reshape(dist.shape)),
        )
    return Scene(
        grid_enc=put(fields["grid_enc"]),
        macro=put(fields["macro"]),
        albedo=put(fields["albedo"]),
        flags=put(fields["flags"]),
        metadata=put(fields["metadata"]),
        y_max=int(fields["y_max"]),
        **bricks,
    )
