"""Multi-rank dry run: one training step with the voxel fields split over the
space axis, then the spatial, handoff and data-parallel fused paths, each
checked finite at tiny shapes.

Port of ``__graft_entry__.py:dryrun_multichip`` (:40). Every rank of a world
of at least ``n_devices`` ranks calls it (``launch.run_ranks``, ``torchrun``).
The reference places ``density_raw``, ``albedo_raw`` and their Adam moments
with ``P("space")`` and lets XLA insert the collectives; here they are
spelled out: each rank keeps its x-slab of both fields (and Adam keeps the
slab's moments), the slabs are gathered over the space axis for the
forward, and the gradient is averaged over the data axis and handed back as
each rank's slab (a reduce-scatter over space, divided by the space size:
the space ranks hold the same rays, so their gradients are the same) before
Adam steps the slab.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig, WorldConfig
from ..core.flatten import scene_from_grid
from ..render.camera import Camera
from ..worldgen import terrain
from . import handoff, mesh as meshlib, sharding as shardlib, spatial
from .mesh import DATA_AXIS, SPACE_AXIS


def _spatial_step(mesh, slabs: shardlib.FitParams, opt, origins, dirs, targets, num_steps: int):
    """One unguided step on space-split fields; returns the loss averaged
    over the data axis."""
    opt.zero_grad(set_to_none=True)
    full = shardlib.gather_params_spatial(slabs, mesh)
    loss = shardlib.loss_fn(full, mesh.block(origins), mesh.block(dirs), mesh.block(targets),
                            num_steps)
    loss.backward()
    gd, ga = full.density_raw.grad, full.albedo_raw.grad
    S = gd.shape[0]
    flat = torch.cat([gd.reshape(S, -1), ga.reshape(S, -1)], dim=1)  # x stays dim 0
    mesh.psum_(flat, DATA_AXIS)
    n = float(mesh.axis_size(DATA_AXIS) * mesh.axis_size(SPACE_AXIS))
    mine = mesh.psum_scatter(flat, SPACE_AXIS) / torch.tensor(n, device=flat.device)
    k = gd[0].numel()
    slabs.density_raw.grad = mine[:, :k].reshape(slabs.density_raw.shape).contiguous()
    slabs.albedo_raw.grad = mine[:, k:].reshape(slabs.albedo_raw.shape).contiguous()
    opt.step()
    return mesh.pmean(loss.detach(), DATA_AXIS)


def _rays(rng, n: int, center: float, spread: float, dev):
    o = np.full((n, 3), center, np.float32) + rng.normal(0, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run on an (n_devices / n_space, n_space) mesh, ``n_space`` 2
    when ``n_devices`` is even, else 1. Raises unless every loss and frame is
    finite; returns the numbers rank 0 prints."""
    n_space = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = meshlib.make_mesh(n_devices // n_space, n_space, device)
    if not mesh.member:
        raise ValueError(f"rank {meshlib.process_rank()} is outside the {n_devices}-rank mesh")
    dev = mesh.device
    rng = np.random.default_rng(0)

    # one unguided step at 16^3 with the fields split over the space axis
    S = 16
    slabs = shardlib.shard_params_spatial(shardlib.init_params((S, S, S), dev), mesh)
    opt = torch.optim.Adam(slabs.parameters(), lr=1e-2)
    N = 8 * n_devices
    origins, dirs = _rays(rng, N, 8.0, 1.0, dev)
    loss = float(_spatial_step(mesh, slabs, opt, origins, dirs,
                               torch.zeros((N, 3), device=dev), 16))
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun: unguided step loss {loss}")

    # the spatially sharded renders: collective lookups, then ray handoff
    grid, pal = terrain.gen_world_grid(WorldConfig(width=16, length=16, grid_shape=(16, 16, 16)))
    sc = spatial.shard_scene_spatial(scene_from_grid(grid, pal, dev), mesh)
    cam = Camera(pos=torch.tensor([8.0, 14.0, 8.0], device=dev),
                 dir=torch.tensor([0.5, -0.7, 0.5], device=dev))
    rcfg = RenderConfig(width=8, height=n_devices, max_steps=48, shadow_steps=16)
    img = spatial.render_image_spatial(sc, cam, rcfg, mesh)
    img2 = handoff.render_image_handoff(sc, cam, rcfg, mesh)
    if not (torch.isfinite(img).all() and torch.isfinite(img2).all()):
        raise AssertionError("dryrun: a spatial or handoff frame is not finite")

    # the data-parallel fused step: seed march and window pair on each block
    grid2, pal2 = terrain.gen_world_grid(WorldConfig(width=24, length=48,
                                                     grid_shape=(32, 32, 64)))
    guide = scene_from_grid(grid2, pal2, dev)
    params2 = shardlib.init_params((32, 32, 64), dev)
    step = shardlib.make_train_step_fused(params2, torch.optim.Adam(params2.parameters(), lr=1e-2),
                                          guide, num_steps=4, mesh=mesh)
    Nf = 32 * n_devices
    of, df = _rays(rng, Nf, 12.0, 2.0, dev)
    loss_f, aux = step(of, df, torch.zeros((Nf, 3), device=dev))
    loss_f = float(loss_f)
    if not np.isfinite(loss_f) or aux["n_escaped"] < 0:
        raise AssertionError(f"dryrun: fused dp step loss {loss_f}, aux {aux}")

    out = {"n": n_devices, "mesh": (mesh.n_data, mesh.n_space), "loss": loss,
           "spatial_render_mean": float(img.mean()), "handoff_render_mean": float(img2.mean()),
           "fused_dp_loss": loss_f}
    if meshlib.process_rank() == 0:
        print("dryrun_multichip ok: " + " ".join(f"{k}={v}" for k, v in out.items()))
    return out
