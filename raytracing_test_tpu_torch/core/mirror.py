"""Incremental device mirroring: the reference's dirty-slab protocol on tensors.

Port of ``raytracing_test_tpu/core/mirror.py``. The reference re-uploads only
dirty 4 MiB slabs per frame (glBufferSubData, voxel_allocator.hpp:38-78).
Here the per-edit sync cost is independent of world size:

  - the authoritative dense grid lives on the host (the session owns it);
    edits arrive as dirty 8^3 bricks;
  - every derived field is recomputed only in the local box that an edit can
    affect, with the JAX module's boxes and margins: ``grid_enc`` within
    Chebyshev 31 of the brick (its largest dilation radius, ``_ENC_MARGIN``
    32), both brick distance fields within ``BRICK_DIST_CAP`` bricks, brick
    rows and ``macro`` within the brick itself;
  - the boxes go to the card in one host-to-device copy and are written into
    the Scene's tensors by slice assignment and ``index_copy_`` (the analog
    of the reference's ``_device_apply`` scan of ``dynamic_update_slice``;
    its power-of-two padding of the batch only bounds XLA recompiles, and is
    not needed here);
  - ``y_max`` is maintained from per-height solid counts (O(box) per edit).

The reference Scene carries only the nibble table of the shadow brick
distances; this port's Scene keeps ``brick_dist_shadow`` as a tensor, so it
is updated box by box like ``brick_dist``. ``prox_enc`` is not maintained:
each sync returns a new Scene, whose ``prox_enc`` is rebuilt at first use.

Axes shorter than the recompute boxes fall back to full-axis boxes (still
local along the other axes); tests/test_torch_session.py holds the
incremental result equal to a full ``scene_from_grid`` rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .flatten import (
    BRICK_DIST_CAP,
    Scene,
    brick_rows,
    build_grid_enc,
    build_macro,
    chebyshev_distance_field,
    palette_arrays,
    pick_brick_shift,
    scene_from_grid,
)
from .types import Properties

_ENC_MARGIN = 32  # grid_enc's largest dilation radius is 31
_EDIT_BRICK = 8  # host dirty tracking granularity (core/tree.py _mark_dirty)

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


def _cut(a: np.ndarray, off, ext) -> np.ndarray:
    return a[off[0]: off[0] + ext[0], off[1]: off[1] + ext[1], off[2]: off[2] + ext[2]]


class SceneMirror:
    """Host grid + incremental updater for one device Scene."""

    def __init__(self, grid: np.ndarray, pal, device):
        self.grid = grid  # authoritative host grid (shared with the session)
        self.pal = pal
        self.device = torch.device(device)
        self.shift = pick_brick_shift(grid.shape)
        self.scene = scene_from_grid(grid, pal, self.device)
        self.y_counts = (grid > 0).sum(axis=(0, 2)).astype(np.int64)

    def _brick_occ(self, grid_box: np.ndarray):
        """(occupancy, occupancy without LIQUID) of the bricks of a box."""
        s = self.shift
        bs = 1 << s
        g = grid_box.reshape(grid_box.shape[0] >> s, bs, grid_box.shape[1] >> s, bs,
                             grid_box.shape[2] >> s, bs)
        _, flags, _ = palette_arrays(self.pal)
        liquid = (flags & int(Properties.LIQUID)) > 0
        return (g > 0).any(axis=(1, 3, 5)), ((g > 0) & ~liquid[g]).any(axis=(1, 3, 5))

    def host_boxes(self, bricks: Sequence[Brick],
                   old_counts: Optional[Dict[Brick, np.ndarray]] = None):
        """The host half of ``apply_bricks``: maintain ``y_counts`` and
        recompute every box the dirty bricks touch. Returns (y_max, boxes),
        boxes a list of (field, start, array) with start a 3-tuple for a box
        and an index array for ``brick_mat`` rows."""
        grid = self.grid
        Sx, Sy, Sz = grid.shape
        sh = self.shift
        if old_counts is not None:
            for b, old in old_counts.items():
                y0 = b[1] * _EDIT_BRICK
                new = y_brick_counts(grid, b)
                self.y_counts[y0: y0 + len(new)] += new - old
        else:
            self.y_counts = (grid > 0).sum(axis=(0, 2)).astype(np.int64)
        nz = np.nonzero(self.y_counts)[0]
        y_max = int(nz.max()) + 1 if len(nz) else 0

        enc_w, enc_r = _box_dims(grid.shape, _EDIT_BRICK, _ENC_MARGIN)
        bshape = (Sx >> sh, Sy >> sh, Sz >> sh)
        core_b = max(_EDIT_BRICK >> sh, 1)
        bd_w, bd_r = _box_dims(bshape, core_b, BRICK_DIST_CAP)
        nbx = _EDIT_BRICK >> sh
        boxes = []
        for bx, by, bz in bricks:
            x0, y0, z0 = bx * _EDIT_BRICK, by * _EDIT_BRICK, bz * _EDIT_BRICK
            if not (0 <= x0 < Sx and 0 <= y0 < Sy and 0 <= z0 < Sz):
                continue
            # the edit brick's box, shifted inward at borders (idempotent: the
            # values come from the authoritative grid either way)
            m0 = (min(x0, Sx - _EDIT_BRICK), min(y0, Sy - _EDIT_BRICK), min(z0, Sz - _EDIT_BRICK))
            mb = _cut(grid, m0, (_EDIT_BRICK,) * 3)

            # grid_enc write box, recomputed from a read box with margin
            ws, rs = _boxes(m0, _EDIT_BRICK, enc_w, enc_r, grid.shape)
            enc = build_grid_enc(_cut(grid, rs, enc_r))
            boxes.append(("grid_enc", ws, _cut(enc, [w - r for w, r in zip(ws, rs)], enc_w)))

            # brick rows + macro of the edit brick
            b0 = [m >> sh for m in m0]
            ids = [((b0[0] + dx) * bshape[1] + b0[1] + dy) * bshape[2] + b0[2] + dz
                   for dx in range(nbx) for dy in range(nbx) for dz in range(nbx)]
            boxes.append(("brick_mat", np.asarray(ids, np.int64), brick_rows(mb, sh)))
            boxes.append(("macro", [m >> 2 for m in m0], build_macro(mb)))

            # both brick distance fields' write boxes, recomputed locally
            bws, brs = _boxes(b0, core_b, bd_w, bd_r, bshape)
            occ, occ_sh = self._brick_occ(
                _cut(grid, [r << sh for r in brs], [r << sh for r in bd_r]))
            o = [w - r for w, r in zip(bws, brs)]
            for name, oc in (("brick_dist", occ), ("brick_dist_shadow", occ_sh)):
                boxes.append((name, bws, _cut(chebyshev_distance_field(oc, BRICK_DIST_CAP), o,
                                              bd_w)))
        return y_max, boxes

    def device_apply(self, y_max: int, boxes) -> Scene:
        """The device half of ``apply_bricks``: one host-to-device copy of
        every box, then each is written in place into the Scene's tensors.
        Returns a new Scene (fresh palette tensors, ``y_max``, no cached
        ``prox_enc``) whose grid and brick tensors are the previous Scene's,
        now updated: the previous Scene object aliases the new one."""
        sc = self.scene
        flat = [a.reshape(-1) for _, _, a in boxes]
        dev = torch.from_numpy(np.concatenate(flat)).to(self.device)
        pos = 0
        for (name, start, arr), f in zip(boxes, flat):
            src = dev[pos: pos + f.size].view(arr.shape)
            pos += f.size
            dst = getattr(sc, name)
            if name == "brick_mat":
                dst.index_copy_(0, torch.from_numpy(start).to(self.device), src)
            else:
                dst[start[0]: start[0] + arr.shape[0], start[1]: start[1] + arr.shape[1],
                    start[2]: start[2] + arr.shape[2]] = src
        albedo, flags, meta = palette_arrays(self.pal)
        put = lambda a: torch.from_numpy(a).to(self.device)
        self.scene = dataclasses.replace(sc, albedo=put(albedo), flags=put(flags),
                                         metadata=put(meta), y_max=y_max)
        return self.scene

    def apply_bricks(self, bricks: Sequence[Brick],
                     old_counts: Optional[Dict[Brick, np.ndarray]] = None) -> Scene:
        """Update the device Scene after the host grid changed inside the
        given dirty 8^3 bricks. ``old_counts`` (optional) is the per-height
        solid count of the old content {brick: int64[8]} for exact y_max
        maintenance; without it y_counts is recomputed (O(world)).

        Returns a new Scene; the tensors of the grid and the brick fields are
        updated in place, so the previous Scene object sees the edit too."""
        if not bricks:
            return self.scene
        if self.shift > 3 or min(self.grid.shape) < _EDIT_BRICK:
            # no local decomposition at this brick size: full rebuild
            self.scene = scene_from_grid(self.grid, self.pal, self.device)
            self.y_counts = (self.grid > 0).sum(axis=(0, 2)).astype(np.int64)
            return self.scene
        y_max, boxes = self.host_boxes(bricks, old_counts)
        if not boxes:
            return self.scene
        return self.device_apply(y_max, boxes)
