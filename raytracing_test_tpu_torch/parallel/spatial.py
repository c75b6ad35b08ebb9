"""Spatial world sharding: the grid's x axis split over the mesh's space
axis, every voxel lookup answered collectively.

Port of ``raytracing_test_tpu/parallel/spatial.py``. Each space rank keeps
one x-slab of ``grid_enc`` (``Sx / n_space`` columns; the palette tables and
``macro`` are replicated). The reference march (``render/renderer.py``) runs
on every space rank with the same rays, and each lookup becomes one sum over
the space axis: a rank answers for the cells in its slab and 0 (air) for
all others (``_slab_lookup``). Rays stay split over the data axis, so dp and
sp compose. The march loops end on the same iteration on every rank of a
space group: their live-lane test is itself summed over the axis.

This is the reference's semantics anchor for parallel/handoff.py; it trades
one [N] all-reduce per DDA step for holding 1/n_space of the world.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch

from ..config import RenderConfig
from ..core.flatten import Scene
from ..render import renderer
from ..render.camera import Camera, ray_directions
from .mesh import DATA_AXIS, SPACE_AXIS, Mesh


@dataclass(frozen=True)
class SpatialScene:
    """One space rank's share of a Scene: ``slab.grid_enc`` holds x columns
    ``x0 .. x0 + slab_w - 1`` of the world's ``shape3``; the palette tables,
    ``macro`` and ``y_max`` are the whole world's."""

    slab: Scene
    shape3: Tuple[int, int, int]
    x0: int

    @property
    def slab_w(self) -> int:
        return self.slab.grid_enc.shape[0]


def shard_scene_spatial(scene: Scene, mesh: Mesh) -> SpatialScene:
    """This rank's x-slab of ``scene`` on its device (``Sx / n_space``
    columns of ``grid_enc``; the brick fields are dropped). Raises when Sx
    does not split evenly over the space axis."""
    Sx = scene.shape3[0]
    n = mesh.n_space
    if Sx % n:
        raise ValueError(f"grid x extent {Sx} does not split over {n} space ranks")
    w = Sx // n
    x0 = mesh.axis_index(SPACE_AXIS) * w
    dev = mesh.device
    slab = replace(
        scene,
        grid_enc=scene.grid_enc[x0:x0 + w].contiguous().to(dev),
        macro=scene.macro.to(dev),
        albedo=scene.albedo.to(dev),
        flags=scene.flags.to(dev),
        metadata=scene.metadata.to(dev),
        brick_mat=None, brick_dist=None, brick_dist_shadow=None,
    )
    return SpatialScene(slab, tuple(scene.shape3), x0)


def _slab_cells(sscene: SpatialScene, cell):
    """(local, lin): whether each wrapped cell lies in this rank's slab, and
    its linear index into the slab (0 where it does not)."""
    Sx, Sy, Sz = sscene.shape3
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lx = c[:, 0] - sscene.x0
    local = inside & (lx >= 0) & (lx < sscene.slab_w)
    lin = (lx * Sy + c[:, 1]) * Sz + c[:, 2]
    return local, torch.where(local, lin, torch.zeros_like(lin)).long()


def _slab_material(sscene: SpatialScene, cell):
    """Material id at cells of this rank's slab, 0 (air) elsewhere."""
    local, lin = _slab_cells(sscene, cell)
    v = torch.take(sscene.slab.grid_enc, lin).to(torch.int32)
    return torch.where(local & (v < 128), v, torch.zeros_like(v))


def _slab_lookup(sscene: SpatialScene, mesh: Mesh, cell):
    """The world's material id at each cell: every space rank answers for its
    slab, and the answers are summed over the axis (exactly one rank owns a
    cell inside the world)."""
    return mesh.psum(_slab_material(sscene, cell), SPACE_AXIS)


def space_any(mesh: Mesh):
    """A live-lane test that agrees on every rank of the space axis."""
    return lambda mask: bool(mesh.psum(mask.any().to(torch.int32), SPACE_AXIS) > 0)


@torch.no_grad()
def render_rays_spatial(sscene: SpatialScene, origin, dirs, cfg: RenderConfig, mesh: Mesh):
    """The full-feature reference render over a spatially sharded world:
    this rank's block of ``dirs`` (split over the data axis) marched with
    the collective slab lookup in the primary, shadow and AO marches.
    Returns this block's rgb [N / n_data, 3]."""
    f32 = torch.float32
    dev = mesh.device
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    dirs = mesh.block(torch.as_tensor(dirs, dtype=f32, device=dev))
    scene = sscene.slab

    def lookup(cell):
        return _slab_lookup(sscene, mesh, cell)

    any_fn = space_any(mesh)
    s, raw0, mat0, sun = renderer._primary_march(scene, origin, dirs, cfg, time_s=cfg.time,
                                                 lookup_fn=lookup, any_fn=any_fn)

    def shadow_fn(p, cell, last_axis, step, active):
        return renderer._shadow_march(scene, p, cell, last_axis, step, cfg, sun, active,
                                      lookup_fn=lookup, any_fn=any_fn)

    col, _ = renderer.shade(scene, s, raw0, mat0, sun, cfg, shadow_fn, ao_lookup_fn=lookup)
    return col


def render_image_spatial(sscene: SpatialScene, camera: Camera, cfg: RenderConfig, mesh: Mesh):
    """A frame [H, W, 3] on every rank: ``render_rays_spatial`` on each data
    block, gathered over the data axis."""
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col = render_rays_spatial(sscene, camera.pos, dirs, cfg, mesh)
    return mesh.all_gather(col, DATA_AXIS).reshape(cfg.height, cfg.width, 3)
