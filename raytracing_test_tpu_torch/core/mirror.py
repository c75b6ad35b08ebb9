"""Incremental device mirroring: the reference's dirty-slab protocol on tensors.

Port of ``raytracing_test_tpu/core/mirror.py``. The reference re-uploads only
dirty 4 MiB slabs per frame (glBufferSubData, voxel_allocator.hpp:38-78).
Here the per-edit sync cost is independent of world size:

  - the authoritative dense grid lives on the host (the session owns it);
    edits arrive as dirty 8^3 bricks. ``y_max`` is maintained there from
    per-height solid counts (O(brick) per edit);
  - the dirty bricks' voxel ids go to the Scene's device in one copy (512 B a
    brick; from pinned memory and asynchronous on a card) and are written
    into the Scene's ``brick_mat`` rows, the dense grid in brick-major order
    (``write_bricks``);
  - every derived field is then recomputed on that device, only in the box
    that an edit can affect, with the JAX module's boxes and margins, by the
    tensor builders of ``core/flatten.py`` (``build_boxes``): ``grid_enc``
    within Chebyshev 31 of the brick (its largest dilation radius,
    ``_ENC_MARGIN`` 32) from the ids of a read box gathered out of
    ``brick_mat``; both brick distance fields within ``BRICK_DIST_CAP``
    bricks from the occupancy of a read box of ``brick_mat`` rows, as one
    batch of two volumes; ``macro`` from the brick itself. Each write box is
    cut out and written into the Scene's tensor in place (the analog of the
    reference's ``_device_apply`` scan of ``dynamic_update_slice``).

Nothing is computed on the host beyond the box bounds, and nothing is read
back from the device. On a card the distance work is the ``cheb_pass``
kernel (``kernels/chebyshev.py``), six launches a dirty brick: three for the
licences of ``grid_enc``, three for the batch of brick distance fields; CPU
tensors run its plain version. ``BOX_BUILDS`` counts the dirty bricks whose
boxes were built.

At brick shifts 2 and 3 every box starts and ends on a multiple of the brick
edge (the edit brick starts at a multiple of 8 or at ``S - 8``, and every
margin is a multiple of 8), so a box of voxel ids is a box of whole
``brick_mat`` rows. Larger bricks, and grids thinner than a brick, are
rebuilt whole. Axes shorter than the recompute boxes fall back to full-axis
boxes (still local along the other axes).

The reference Scene carries only the nibble table of the shadow brick
distances; this port's Scene keeps ``brick_dist_shadow`` as a tensor, so it
is updated box by box like ``brick_dist``. ``prox_enc`` is not maintained:
each sync returns a new Scene, whose ``prox_enc`` is rebuilt at first use.
tests/test_torch_session.py holds the incremental result equal to a full
``scene_from_grid`` rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import chebyshev
from .flatten import (
    BRICK_DIST_CAP,
    MACRO_SHIFT,
    Scene,
    brick_occupancy_tensor,
    brick_rows_tensor,
    macro_tensor,
    palette_arrays,
    pick_brick_shift,
    scene_from_grid,
)

_ENC_MARGIN = 32  # grid_enc's largest dilation radius is 31
_EDIT_BRICK = 8  # host dirty tracking granularity (core/tree.py _mark_dirty)

BOX_BUILDS = 0  # dirty bricks whose boxes a mirror built on its Scene's device

Brick = Tuple[int, int, int]


def y_brick_counts(grid: np.ndarray, brick: Brick) -> np.ndarray:
    """Per-height solid counts of one dirty brick's current content (captured
    before rasterizing an edit so y_max can be maintained in O(box))."""
    bx, by, bz = brick
    x0, y0, z0 = bx * _EDIT_BRICK, by * _EDIT_BRICK, bz * _EDIT_BRICK
    sub = grid[x0: x0 + _EDIT_BRICK, y0: y0 + _EDIT_BRICK, z0: z0 + _EDIT_BRICK]
    return (sub > 0).sum(axis=(0, 2)).astype(np.int64)


def _box_dims(shape, core, margin):
    """Per-axis (write, read) box extents for recomputing a derived field
    whose value at a cell depends on content within ``margin``: the write box
    is core + 2*margin (everything the edit can affect), the read box adds
    another margin of context. Axes too short fall back to full extent (still
    exact: the whole axis is recomputed)."""
    w, r = [], []
    for s in shape:
        wi = core + 2 * margin
        ri = wi + 2 * margin
        if s >= ri:
            w.append(wi)
            r.append(ri)
        else:
            w.append(s)
            r.append(s)
    return tuple(w), tuple(r)


def _boxes(origin, core, write, read, shape):
    """(write start, read start) per axis of a box around ``origin``'s core,
    clipped into the grid."""
    ws = [int(np.clip(o - (w - core) // 2, 0, s - w)) for o, w, s in zip(origin, write, shape)]
    rs = [int(np.clip(w0 - (r - w) // 2, 0, s - r)) for w0, w, r, s in zip(ws, write, read, shape)]
    return ws, rs


def _cut(a, off, ext):
    """The box [off, off + ext) of the first three axes of an array or tensor."""
    return a[off[0]: off[0] + ext[0], off[1]: off[1] + ext[1], off[2]: off[2] + ext[2]]


def _dense(rows: torch.Tensor, s: int) -> torch.Tensor:
    """Brick rows u8 [bx, by, bz, bs^3] -> the voxel ids they hold, u8
    [bx * bs, by * bs, bz * bs] (the inverse of ``brick_rows_tensor``)."""
    bs = 1 << s
    bx, by, bz = rows.shape[:3]
    g = rows.reshape(bx, by, bz, bs, bs, bs).permute(0, 3, 1, 4, 2, 5)
    return g.reshape(bx * bs, by * bs, bz * bs)


class SceneMirror:
    """Host grid + incremental updater for one device Scene."""

    def __init__(self, grid: np.ndarray, pal, device):
        self.grid = grid  # authoritative host grid (shared with the session)
        self.pal = pal
        self.device = torch.device(device)
        self.shift = pick_brick_shift(grid.shape)
        self._rebuild()
        bshape = tuple(d >> self.shift for d in grid.shape)
        self._enc_dims = _box_dims(grid.shape, _EDIT_BRICK, _ENC_MARGIN)
        self._bd_dims = _box_dims(bshape, _EDIT_BRICK >> self.shift, BRICK_DIST_CAP)

    def _rebuild(self) -> None:
        self.scene = scene_from_grid(self.grid, self.pal, self.device)
        self.y_counts = (self.grid > 0).sum(axis=(0, 2)).astype(np.int64)
        self._palette = palette_arrays(self.pal)  # what the Scene's palette tables hold

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the Scene's device in one copy: from pinned memory and
        asynchronous on a card, so the host does not wait for the device."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def write_bricks(self, bricks: Sequence[Brick],
                     old_counts: Optional[Dict[Brick, np.ndarray]] = None) -> List[tuple]:
        """The first half of ``apply_bricks``: maintain ``y_counts``, send the
        dirty bricks' voxel ids to the device in one copy and write them into
        the ``brick_mat`` rows; ``self.scene`` becomes a new Scene with the
        new ``y_max`` (and palette tables, uploaded again only when the
        palette changed). Returns [(edit brick start, its ids on the
        device)] for ``build_boxes``. Without a local decomposition the
        Scene is rebuilt whole, and the list is empty."""
        if not bricks:
            return []
        grid = self.grid
        if self.shift > 3 or min(grid.shape) < _EDIT_BRICK:
            # no local decomposition at this brick size: full rebuild
            self._rebuild()
            return []
        Sx, Sy, Sz = grid.shape
        if old_counts is not None:
            for b, old in old_counts.items():
                y0 = b[1] * _EDIT_BRICK
                new = y_brick_counts(grid, b)
                self.y_counts[y0: y0 + len(new)] += new - old
        else:
            self.y_counts = (grid > 0).sum(axis=(0, 2)).astype(np.int64)
        nz = np.nonzero(self.y_counts)[0]
        y_max = int(nz.max()) + 1 if len(nz) else 0

        # each edit brick's box, shifted inward at borders (idempotent: the
        # values come from the authoritative grid either way)
        starts = [(min(x0, Sx - _EDIT_BRICK), min(y0, Sy - _EDIT_BRICK), min(z0, Sz - _EDIT_BRICK))
                  for x0, y0, z0 in ((bx * _EDIT_BRICK, by * _EDIT_BRICK, bz * _EDIT_BRICK)
                                     for bx, by, bz in bricks)
                  if 0 <= x0 < Sx and 0 <= y0 < Sy and 0 <= z0 < Sz]
        if not starts:
            return []
        blocks = np.stack([_cut(grid, m0, (_EDIT_BRICK,) * 3) for m0 in starts])
        if int(blocks.max()) >= 128:
            raise ValueError("material ids must fit 7 bits (< 128)")
        ids = self._upload(blocks)

        sc = self.scene
        s = self.shift
        nb = _EDIT_BRICK >> s
        rows = sc.brick_mat.view(*sc.brick_grid, -1)
        for m0, block in zip(starts, ids):
            b0 = [m >> s for m in m0]
            _cut(rows, b0, (nb,) * 3).copy_(brick_rows_tensor(block, s).view(nb, nb, nb, -1))
        tables = {}
        palette = palette_arrays(self.pal)
        if not all(np.array_equal(a, b) for a, b in zip(palette, self._palette)):
            self._palette = palette
            tables = dict(zip(("albedo", "flags", "metadata"), map(self._upload, palette)))
        self.scene = dataclasses.replace(sc, y_max=y_max, **tables)
        return list(zip(starts, ids))

    def build_boxes(self, edits: List[tuple]) -> Scene:
        """The second half of ``apply_bricks``: for each edit brick of
        ``write_bricks``, recompute every box it affects on the Scene's device
        from the updated ``brick_mat`` and write it in place. Returns the
        Scene."""
        global BOX_BUILDS
        sc = self.scene
        s = self.shift
        rows = sc.brick_mat.view(*sc.brick_grid, -1)
        flags = self._palette[1]
        enc_w, enc_r = self._enc_dims
        bd_w, bd_r = self._bd_dims
        core_b = _EDIT_BRICK >> s
        for m0, block in edits:
            # grid_enc write box, recomputed from the ids of a read box
            ws, rs = _boxes(m0, _EDIT_BRICK, enc_w, enc_r, sc.shape3)
            box_ids = _dense(_cut(rows, [r >> s for r in rs], [r >> s for r in enc_r]), s)
            enc = chebyshev.distance(box_ids, cap=chebyshev.MAX_CAP, licence=True)
            _cut(sc.grid_enc, ws, enc_w).copy_(_cut(enc, [w - r for w, r in zip(ws, rs)], enc_w))

            _cut(sc.macro, [m >> MACRO_SHIFT for m in m0], (_EDIT_BRICK >> MACRO_SHIFT,) * 3).copy_(
                macro_tensor(block))

            # both brick distance fields' write boxes, from a read box's rows
            bws, brs = _boxes([m >> s for m in m0], core_b, bd_w, bd_r, sc.brick_grid)
            dist = chebyshev.distance(brick_occupancy_tensor(_cut(rows, brs, bd_r), flags),
                                      cap=BRICK_DIST_CAP)
            o = [w - r for w, r in zip(bws, brs)]
            for name, d in zip(("brick_dist", "brick_dist_shadow"), dist):
                _cut(getattr(sc, name), bws, bd_w).copy_(_cut(d, o, bd_w))
            BOX_BUILDS += 1
        return sc

    def apply_bricks(self, bricks: Sequence[Brick],
                     old_counts: Optional[Dict[Brick, np.ndarray]] = None) -> Scene:
        """Update the device Scene after the host grid changed inside the
        given dirty 8^3 bricks. ``old_counts`` (optional) is the per-height
        solid count of the old content {brick: int64[8]} for exact y_max
        maintenance; without it y_counts is recomputed (O(world)).

        Returns a new Scene; the tensors of the grid and the brick fields are
        updated in place, so the previous Scene object sees the edit too."""
        return self.build_boxes(self.write_bricks(bricks, old_counts))
