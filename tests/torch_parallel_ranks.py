"""The rank side of tests/test_torch_parallel.py: inputs made from numpy
seeds, and the checks each rank of a gloo world runs on CPU tensors.

This module imports torch, numpy and the port only (never JAX or the JAX
package), because ``launch.run_ranks`` imports it by name in every rank
process; the test imports it too, for the same inputs on the JAX side.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from raytracing_test_tpu_torch.config import RenderConfig, WorldConfig
from raytracing_test_tpu_torch.core.flatten import scene_from_grid, scene_from_jax
from raytracing_test_tpu_torch.kernels.fused_march import render_rays_fused_dp
from raytracing_test_tpu_torch.kernels.fused_window import render_window_fused_dp
from raytracing_test_tpu_torch.parallel import dryrun, handoff, mesh as meshlib, scaling
from raytracing_test_tpu_torch.parallel import sharding, spatial
from raytracing_test_tpu_torch.render.camera import Camera, ray_directions
from raytracing_test_tpu_torch.render.diff import DiffScene
from raytracing_test_tpu_torch.worldgen import terrain

TERRAIN = WorldConfig(width=64, length=64, grid_shape=(64, 64, 64))
# (pos, dir, width, height, time, ao): the terrain views of tests/test_handoff.py,
# the boundary crossings among them (:58), and one with AO
TERRAIN_VIEWS = [
    ((35.0, 50.0, 35.0), (0.6, -0.5, 0.5), 32, 16, 0.0, False),
    ((500.0, 200.0, 500.0), (-1.0, -0.35, -1.0), 16, 16, 0.0, False),  # from outside
    ((-40.0, 20.0, 32.0), (1.0, 0.05, 0.1), 16, 16, 0.0, False),  # through the -x face
    ((32.0, 5.0, 32.0), (1.0, 0.0, 0.0), 16, 16, 0.0, False),  # inside solid, +x
    ((63.0, 40.0, 32.0), (-1.0, -0.4, 0.01), 16, 16, 0.0, False),  # every slab boundary
    ((60.0, 52.0, 30.0), (-1.0, -0.3, 0.05), 16, 16, 0.0, False),  # above, across the slabs
    ((35.0, 50.0, 35.0), (0.6, -0.5, 0.5), 16, 16, 0.0, True),  # AO
]
# tests/test_render_parity.py CASES[:3] on its material world
MATERIAL_VIEWS = [
    ((35.0, 50.0, 35.0), (0.5, -0.6, 0.6), 16, 16, 0.0, False),
    ((32.0, 12.0, 5.0), (0.1, 0.05, 1.0), 16, 16, 0.3, False),
    ((12.0, 14.0, 12.0), (0.2, -0.8, 0.3), 16, 16, 1.7, False),
]
DP_VIEW = ((35.0, 50.0, 35.0), (0.5, -0.3, 0.6), 16, 16)  # sharded and fused dp frames (sky too)
FIELD_SHAPE = (24, 20, 28)  # the train steps' fields (tests/test_torch_train.py)
WINDOW_SHAPE = (48, 48, 48)  # the window's fields: the reference runs its XLA window here
LR = 0.05


def camera(pos, dirn, dev="cpu") -> Camera:
    return Camera(pos=torch.tensor(pos, dtype=torch.float32, device=dev),
                  dir=torch.tensor(dirn, dtype=torch.float32, device=dev))


def raw_params(seed: int = 6):
    rng = np.random.default_rng(seed)
    d = rng.normal(-3.5, 1.5, FIELD_SHAPE).astype(np.float32)
    a = rng.normal(0.0, 1.0, FIELD_SHAPE + (3,)).astype(np.float32)
    return d, a


def train_batch(n: int, seed: int = 5):
    """(origins, dirs, targets) float32 [n, 3]: rays from above one side of
    the fields toward their middle (tests/test_torch_train.py)."""
    rng = np.random.default_rng(seed)
    center = np.array([12.0, 8.0, 14.0])
    o = rng.normal(0, 1, (n, 3)) * np.array([4.0, 2.0, 4.0]) + np.array([-6.0, 26.0, -5.0])
    d = center + rng.normal(0, 4, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0, 1, (n, 3))
    return tuple(x.astype(np.float32) for x in (o, d, t))


def window_inputs(n: int = 256, seed: int = 11):
    """(density, albedo, origins, dirs, cotangent): fields with a floor and a
    pillar, density jittered so every cell has a gradient; rays from one
    corner toward the pillar; a random cotangent for the rgb."""
    rng = np.random.default_rng(seed)
    Sx, Sy, Sz = WINDOW_SHAPE
    solid = np.zeros(WINDOW_SHAPE, bool)
    solid[:, :6, :] = True
    solid[20:26, 6:30, 18:24] = True
    density = (np.where(solid, 8.0, 0.0) + rng.uniform(0.0, 0.3, WINDOW_SHAPE)).astype(np.float32)
    albedo = rng.uniform(0.1, 0.9, WINDOW_SHAPE + (3,)).astype(np.float32)
    o = (np.array([4.0, 30.0, 4.0]) + rng.normal(0, 1.5, (n, 3))).astype(np.float32)
    d = np.array([23.0, 10.0, 21.0]) + rng.normal(0, 5, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    g = rng.normal(size=(n, 3)).astype(np.float32)
    return density, albedo, o, d, g


def _save(out_dir: str, name: str, x) -> None:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    np.save(os.path.join(out_dir, f"{name}_r{meshlib.process_rank()}.npy"), np.asarray(x))


def _frames(mesh, sscene, views, prefix, out_dir, stats):
    for i, (pos, dirn, w, h, t, ao) in enumerate(views):
        rcfg = RenderConfig(width=w, height=h, time=t, enable_ao=ao)
        cam = camera(pos, dirn)
        _save(out_dir, f"{prefix}{i}_spatial", spatial.render_image_spatial(sscene, cam, rcfg, mesh))
        img, st = handoff.render_image_handoff(sscene, cam, rcfg, mesh, return_stats=True)
        _save(out_dir, f"{prefix}{i}_handoff", img)
        stats[f"{prefix}{i}"] = st


def run_checks(n_data: int, n_space: int, out_dir: str, mat_fields: dict, extras: bool):
    """Every multi-rank path of the port on an (n_data, n_space) mesh of CPU
    ranks; arrays go to ``out_dir`` as ``<name>_r<rank>.npy``. Returns the
    handoff stats, the slab widths and the extras' results (the dry run on
    4 ranks and the scaling harness, with ``extras``)."""
    mesh = meshlib.make_mesh(n_data, n_space, "cpu")
    grid, pal = terrain.gen_world_grid(TERRAIN)
    scene = scene_from_grid(grid, pal, "cpu")
    out = {"slab_w": {}, "stats": {}}

    # data parallel: the reference frame and the fused march
    pos, dirn, w, h = DP_VIEW
    rcfg = RenderConfig(width=w, height=h)
    _save(out_dir, "sharded", sharding.render_image_sharded(scene, camera(pos, dirn), rcfg, mesh))
    dirs = ray_directions(camera(pos, dirn), w, h)
    col, aux = render_rays_fused_dp(scene, torch.tensor(pos), dirs, rcfg, mesh, image_hw=(h, w))
    _save(out_dir, "fused_dp_col", col)
    _save(out_dir, "fused_dp_hit", aux["hit"])
    _save(out_dir, "fused_dp_hit_pos", aux["hit_pos"])

    # the window: this rank's rgb block and the fields' summed gradients
    density, albedo, o, d, g = window_inputs()
    ds = DiffScene(torch.from_numpy(density).requires_grad_(),
                   torch.from_numpy(albedo).requires_grad_())
    rgb = render_window_fused_dp(ds, torch.from_numpy(o), torch.from_numpy(d), mesh,
                                 num_steps=16, sky=False, shading=True)
    (rgb * mesh.block(torch.from_numpy(g))).sum().backward()
    _save(out_dir, "window_rgb", rgb)
    _save(out_dir, "window_g_density", ds.density.grad)
    _save(out_dir, "window_g_albedo", ds.albedo.grad)

    # one step of each train step on the whole batch
    dr, ar = raw_params()
    for name, n in (("fused", 256), ("blind", 64)):
        p = sharding.params_from_jax(dr, ar, device="cpu")
        opt = torch.optim.Adam(p.parameters(), lr=LR)
        if name == "fused":
            step = sharding.make_train_step_fused(p, opt, sharding.guide_scene_from_params(p),
                                                  mesh=mesh)
        else:
            step = sharding.make_train_step(p, opt, num_steps=32, mesh=mesh)
        loss, aux = step(*(torch.from_numpy(x) for x in train_batch(n)))
        _save(out_dir, f"{name}_loss", loss)
        _save(out_dir, f"{name}_density", p.density_raw)
        _save(out_dir, f"{name}_albedo", p.albedo_raw)
        out[f"{name}_aux"] = aux

    # the world split along x: spatial and handoff against one device's frames
    for prefix, sc, views in (("terrain", scene, TERRAIN_VIEWS),
                              ("materials", scene_from_jax(mat_fields, "cpu"), MATERIAL_VIEWS)):
        sscene = spatial.shard_scene_spatial(sc, mesh)
        out["slab_w"][prefix] = tuple(sscene.slab.grid_enc.shape)
        _frames(mesh, sscene, views, prefix, out_dir, out["stats"])

    if extras:
        out["dryrun"] = dryrun.dryrun_multichip(mesh.size, "cpu")
        cam = camera(*DP_VIEW[:2])
        small = RenderConfig(width=16, height=16)
        out["render_rates"] = scaling.measure_render_scaling(scene, cam, small, iters=1,
                                                             device="cpu")
        out["handoff_rates"] = scaling.measure_handoff_scaling(scene, cam, small, iters=1,
                                                               device="cpu")
        out["train_rates"] = scaling.measure_train_scaling((16, 16, 16), 64, iters=1,
                                                           num_steps=8, device="cpu")
    out["jax_imported"] = sorted(m for m in sys.modules if m.split(".")[0] in
                                 ("jax", "raytracing_test_tpu"))
    return out


def fail_on_rank_one():
    """Rank 1 raises while rank 0 waits in a collective that never completes."""
    mesh = meshlib.make_mesh(2, 1, "cpu")
    if meshlib.process_rank() == 1:
        raise ValueError("rank one stops here")
    mesh.psum(torch.ones(1), meshlib.DATA_AXIS)


def sleep_forever():
    import time

    time.sleep(3600)
