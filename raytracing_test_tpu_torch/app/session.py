"""Interactive world session: the reference's frame loop + input handling
(src/main.cpp, src/input.cpp), headless, on the card.

Port of ``raytracing_test_tpu/app/session.py``. The session owns the
authoritative host tree (the native C++ runtime, or the python tree with
``use_native=False``), the dense grid + palette, and the device Scene, and
keeps them in sync incrementally: edits mark bricks dirty in the tree, and
``sync`` re-rasterizes only those bricks into the grid before updating the
derived boxes on the device (core/mirror.py), the analog of
updateSsboData's dirty-slab upload (voxel_allocator.hpp:38-78).

Camera parity (src/input.cpp):
  - dir = Ry(yaw) · Rx(pitch) · (0,0,1), pitch clamped to (-90, 90), yaw
    wrapped to [-180, 180] (rotateCamera, input.cpp:19-29)
  - move: forward along dir, strafe along -cross(dir, up), vertical along
    -cross(dir, cross(dir, up)), shift x4 (doInputUpdates, input.cpp:31-65)
  - LMB = delete picked block, RMB = place hotbar block at the pick's
    last_pos face, 30-step pick ray (input.cpp:135-168)

Where the port departs from the reference session:
  - a failed native build raises (the reference falls back to the python
    tree quietly);
  - ``fast``, ``fused`` and ``progressive`` (both of its passes) march
    through ``kernels/fused_march``: the CUDA kernel on the card, its plain
    version (``render/fast.py``, the reference's ``fast`` march) on the CPU;
  - there is no fused-to-fast fallback: the kernel reads ``grid_enc``
    directly, so any palette up to ``Palette.MAX_IDS`` renders through it.

``spatial`` and ``handoff`` render on a (1, world size) mesh, as the
reference does (session.py:286-296): the world's x axis split over every
rank of the process group (a plain process joins a one-rank group of its
own), AO off for ``handoff``.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig, RenderConfig, WorldConfig
from ..core.color import rgb_to_u64
from ..core.mirror import SceneMirror, y_brick_counts
from ..core.tree import Palette
from ..core.types import HOTBAR_RGB, Block
from ..render.camera import Camera, yaw_pitch_dir
from ..utils.log import Timer
from . import picking

RENDER_MODES = ("fast", "fused", "bricks", "bricks-pallas", "reference", "progressive",
                "spatial", "handoff")


def _hotbar():
    return [Block(int(flags), int(rgb_to_u64(*rgb)), meta) for flags, rgb, meta in HOTBAR_RGB]


class WorldSession:
    def __init__(self, wcfg: WorldConfig = WorldConfig(), use_native: bool = True,
                 device="cuda"):
        self.wcfg = wcfg
        self.device = torch.device(device)
        self.palette = Palette()
        self.hotbar = _hotbar()
        self.selected = 0
        self._native = None
        with Timer("worldgen"):
            if use_native:
                from ..native.runtime import NativeVoxelTree

                self._native = NativeVoxelTree()  # raises when the runtime does not build
                self._native.gen_world(wcfg)
                self.tree = self._native
                self.grid = self._export_native_grid()
            else:
                from ..worldgen import terrain

                self.grid, self.palette = terrain.gen_world_grid(wcfg)
                self.tree = terrain.gen_world_tree(wcfg, self.grid, self.palette)
        self._clear_dirty()
        with Timer("device flatten"):
            self._mirror = SceneMirror(self.grid, self.palette, self.device)
            self.scene = self._mirror.scene
        self.sync_ms = {}  # host times of the last sync's phases
        self._space_mesh = None  # the (1, world size) mesh of spatial / handoff

        # camera state (ref defaults: globals.cpp:20-21)
        self.pos = np.asarray(CameraConfig().pos, np.float64)
        self.yaw = 45.0  # matches the (1,0,1) default direction
        self.pitch = 0.0
        self.time = 0.0

    # ----------------------------------------------------------- tree helpers

    def _export_native_grid(self) -> np.ndarray:
        grid, pf, pc, pm = self._native.export_dense(self.wcfg.grid_shape)
        remap = np.zeros(len(pf), np.uint8)
        for i in range(1, len(pf)):
            remap[i] = self.palette.id_for(Block(int(pf[i]), int(pc[i]), float(pm[i])))
        return remap[grid]

    def _dirty(self):
        if self._native is not None:
            return self._native.dirty_bricks()
        return list(self.tree.dirty_bricks)

    def _clear_dirty(self):
        if self._native is not None:
            self._native.clear_dirty()
        else:
            self.tree.dirty_bricks.clear()

    # --------------------------------------------------------------- camera

    def camera_dir(self) -> np.ndarray:
        return np.asarray(yaw_pitch_dir(self.yaw, self.pitch), np.float32)

    def rotate(self, yaw_delta: float, pitch_delta: float) -> None:
        """rotateCamera parity: pitch hard-clamped, yaw wrapped."""
        if not (-90 < self.pitch + pitch_delta < 90):
            pitch_delta = 0.0
        self.pitch += pitch_delta
        self.yaw += yaw_delta
        if self.yaw > 180:
            self.yaw -= 360
        if self.yaw < -180:
            self.yaw += 360

    def move(self, forward=0.0, strafe=0.0, vertical=0.0, sprint=False) -> None:
        d = self.camera_dir().astype(np.float64)
        up = np.array([0.0, 1.0, 0.0])
        left = np.cross(d, up)
        down = np.cross(d, left)
        speed = 4.0 if sprint else 1.0
        self.pos = (
            self.pos + d * forward * speed - left * strafe * speed - down * vertical * speed
        )

    def camera(self) -> Camera:
        return Camera(
            pos=torch.as_tensor(self.pos, dtype=torch.float32, device=self.device),
            dir=torch.as_tensor(self.camera_dir(), dtype=torch.float32, device=self.device),
        )

    # --------------------------------------------------------------- editing

    def pick(self, steps: int = 30) -> picking.RayResult:
        return picking.cast_ray(self.tree, self.pos, self.camera_dir(), steps)

    def place(self, slot: Optional[int] = None) -> Optional[Tuple[int, int, int]]:
        """RMB parity: put the hotbar block at the face cell of the pick."""
        res = self.pick()
        if slot is not None:
            self.selected = slot % len(self.hotbar)
        pos = res.last_pos
        self.tree.put_block(pos, self.hotbar[self.selected], 6)
        return pos

    def delete(self) -> Optional[Tuple[int, int, int]]:
        """LMB parity: delete the picked block (only if something was hit)."""
        res = self.pick()
        if not res.steps:
            return None
        self.tree.delete_block(res.pos, 6)
        return res.pos

    def sync(self) -> int:
        """Mirror dirty bricks into the grid + device scene; returns their count.

        Only dirty 8^3 bricks are re-rasterized into the host grid (512
        ``tree.get_block`` calls each). Their voxel ids go to the Scene's
        device in one copy, and only the derived boxes they can affect are
        recomputed there and written in place (core/mirror.py).
        ``sync_ms`` keeps the host times of the three parts: ``rasterize``;
        ``apply``, the upload and the ``brick_mat`` row writes; ``boxes``,
        the box builders. On a card the last two are host launch time (the
        work runs on, asynchronously; a trace shows the box builders'
        distance passes as ``cheb_pass``'s kernels ``cheb_strided`` and
        ``cheb_contig``)."""
        bricks = self._dirty()
        if not bricks:
            return 0
        t0 = time.perf_counter()
        Sx, Sy, Sz = self.grid.shape
        bs = 8
        in_window = []
        old_counts = {}
        for b in bricks:
            bx, by, bz = b
            x0, y0, z0 = bx * bs, by * bs, bz * bs
            if not (0 <= x0 < Sx and 0 <= y0 < Sy and 0 <= z0 < Sz):
                continue
            in_window.append(b)
            old_counts[b] = y_brick_counts(self.grid, b)
            for dx in range(min(bs, Sx - x0)):
                for dy in range(min(bs, Sy - y0)):
                    for dz in range(min(bs, Sz - z0)):
                        blk = self.tree.get_block((x0 + dx, y0 + dy, z0 + dz))
                        self.grid[x0 + dx, y0 + dy, z0 + dz] = (
                            0 if blk.is_air else self.palette.id_for(blk)
                        )
        self._clear_dirty()
        t1 = time.perf_counter()
        edits = self._mirror.write_bricks(in_window, old_counts)
        t2 = time.perf_counter()
        self.scene = self._mirror.build_boxes(edits)
        t3 = time.perf_counter()
        self.sync_ms = {"rasterize": (t1 - t0) * 1e3, "boxes": (t3 - t2) * 1e3,
                        "apply": (t2 - t1) * 1e3}
        return len(bricks)

    # --------------------------------------------------------------- render

    @torch.no_grad()
    def render(self, rcfg: RenderConfig, highlight: bool = True, fast_path: bool = True,
               mode: str = None) -> torch.Tensor:
        """One frame [H, W, 3] on the session's device, mirroring the
        reference render() flow: sync dirty state, pick for the looked-at
        highlight, then draw (main.cpp:68-108).

        ``mode``: fast (default) and fused, the fused march; progressive,
        coarse-to-fine through the same march; bricks / bricks-pallas, the
        brick kernels; reference, the per-cell march as PyTorch operations.
        ``enable_ao`` is served by the shared ``renderer.shade`` in every
        mode but handoff; spatial and handoff, the world sharded along x
        over every rank of the process group (the collective-lookup
        reference march; the ray-handoff fast march, AO off)."""
        self.sync()
        if highlight:
            res = self.pick()
            if res.steps:
                rcfg = replace(rcfg, looking_at=res.pos)
        rcfg = replace(rcfg, time=self.time)
        mode = mode or ("fast" if fast_path else "reference")
        cam = self.camera()
        if mode in ("fast", "fused"):
            from ..kernels.fused_march import render_image_fused

            return render_image_fused(self.scene, cam, rcfg, time_s=rcfg.time)
        if mode in ("bricks", "bricks-pallas"):
            from ..kernels.brick_kernels import render_image_bricks_pallas

            return render_image_bricks_pallas(self.scene, cam, rcfg, time_s=rcfg.time)
        if mode == "reference":
            from ..render import renderer

            return renderer.render_jit(self.scene, cam, rcfg)
        if mode == "progressive":
            from ..render import progressive

            return progressive.render_image_progressive(self.scene, cam, rcfg)[0]
        if mode in ("spatial", "handoff"):
            from ..parallel import handoff, mesh as meshlib, spatial

            if self._space_mesh is None:
                self._space_mesh = meshlib.make_mesh(1, meshlib.world_size(), self.device)
            mesh = self._space_mesh
            sc = spatial.shard_scene_spatial(self.scene, mesh)
            if mode == "handoff":
                rcfg = replace(rcfg, enable_ao=False)
                return handoff.render_image_handoff(sc, cam, rcfg, mesh)
            return spatial.render_image_spatial(sc, cam, rcfg, mesh)
        raise ValueError(f"unknown render mode {mode!r}")
