"""Inverse rendering: fit voxel densities and albedos to target views.

Port of ``raytracing_test_tpu/app/fit.py`` on one device: targets are
rendered by the hard renderer from a ring of cameras around the world, then
a training step fits the continuous fields. Engine ``"fused"`` and engine
``""`` with ``guided`` run ``make_train_step_fused`` (seed march on an
occupancy guide, window kernel pair, MSE, Adam, through
``render_rays_diff_guided``): on one device the reference's guided step
computes the same. Its guide is re-thresholded from the evolving density
every ``rethreshold_every`` steps. Engine ``""`` without ``guided`` runs
``make_train_step`` with 96 steps of the blind volumetric scan, as the
reference does. Batches are drawn with numpy's ``default_rng(seed)``, as in
the reference.

With a mesh (parallel/mesh.py) the fit is data parallel, as the reference's
fit is over all its devices: every rank builds the same targets and draws
the same indices from the same seed, the batch is rounded down to a multiple
of the data axis (:103-105), and each step takes the rank's block and
averages the gradients over the axis. Rank 0 alone prints and saves.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..config import FitConfig, RenderConfig
from ..kernels.fused_march import render_rays_fused
from ..parallel import sharding as shardlib
from ..render.camera import Camera, ray_directions
from . import checkpoint


def ring_cameras(center, radius: float, height: float, n: int, device="cuda") -> List[Camera]:
    """n cameras on a ring looking at ``center``."""
    cams = []
    cx, cy, cz = center
    for i in range(n):
        a = 2 * math.pi * i / n
        pos = (cx + radius * math.cos(a), height, cz + radius * math.sin(a))
        d = np.asarray([cx - pos[0], cy - pos[1], cz - pos[2]], np.float32)
        d /= np.linalg.norm(d)
        cams.append(Camera(pos=torch.tensor(pos, dtype=torch.float32, device=device),
                           dir=torch.from_numpy(d).to(device)))
    return cams


def make_targets(scene, cams: List[Camera], res: int):
    """Ground-truth views from the hard renderer, shadows off (the volumetric
    model has no hard-shadow term): the fused march, which is the kernel on
    the card. Returns (origins, dirs, rgb), each [views * res^2, 3]."""
    rcfg = RenderConfig(width=res, height=res, enable_shadows=False)
    origins, dirs, rgbs = [], [], []
    for cam in cams:
        d = ray_directions(cam, res, res)
        col, _ = render_rays_fused(scene, cam.pos, d, rcfg)
        origins.append(cam.pos[None, :].expand(d.shape))
        dirs.append(d)
        rgbs.append(col)
    return torch.cat(origins), torch.cat(dirs), torch.cat(rgbs)


def fit_world(scene, grid_shape, fcfg: FitConfig = FitConfig(), batch: int = 16384,
              seed: int = 0, ckpt_path: Optional[str] = None, log_every: int = 20, mesh=None):
    """Run the fit on ``scene``'s device (data parallel over ``mesh``'s data
    axis, given one); returns (params, losses)."""
    if fcfg.engine not in ("", "fused"):
        raise ValueError(f"unknown fit engine {fcfg.engine!r}")
    dev = scene.device
    lead = mesh is None or mesh.coords == (0, 0)  # rank 0 prints and saves
    if mesh is not None:
        batch = (batch // mesh.n_data) * mesh.n_data
    Sx, Sy, Sz = grid_shape
    center = (Sx / 2, Sy / 3, Sz / 2)
    cams = ring_cameras(center, radius=0.8 * Sx, height=0.9 * Sy, n=fcfg.views, device=dev)
    origins, dirs, targets = make_targets(scene, cams, fcfg.resolution)
    N = origins.shape[0]
    if lead:
        print(f"fit: {fcfg.views} views, {N} target rays, {dev}"
              + (f", {mesh.n_data} data ranks" if mesh is not None else ""))

    params = shardlib.init_params(grid_shape, dev)
    optimizer = torch.optim.Adam(params.parameters(), lr=fcfg.lr)
    guided = fcfg.engine == "fused" or fcfg.guided
    if guided:
        step_fn = shardlib.make_train_step_fused(params, optimizer, num_steps=fcfg.guided_steps,
                                                 shading=fcfg.shading, mesh=mesh)
    else:
        step_fn = shardlib.make_train_step(params, optimizer, num_steps=96, mesh=mesh)
    guide = None
    rng = np.random.default_rng(seed)
    losses = []
    for step in range(fcfg.steps):
        if guided and (guide is None or step % fcfg.rethreshold_every == 0):
            # occupancy re-thresholding: the guide tracks the evolving field
            guide = shardlib.guide_scene_from_params(params, tau=fcfg.guide_tau)
        idx = torch.from_numpy(rng.integers(0, N, batch)).to(dev)
        kw = {"guide": guide} if guided else {}
        loss, _ = step_fn(origins[idx], dirs[idx], targets[idx], **kw)
        losses.append(float(loss))
        if lead and step % log_every == 0:
            print(f"fit step {step}: loss {losses[-1]:.5f}")
        if lead and ckpt_path and step and step % 100 == 0:
            checkpoint.save_fit(ckpt_path, params, optimizer, step)
    if lead and ckpt_path:
        checkpoint.save_fit(ckpt_path, params, optimizer, fcfg.steps)
    return params, losses
