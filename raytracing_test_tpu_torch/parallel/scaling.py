"""Scaling harness: rays/s against the number of ranks.

Port of ``raytracing_test_tpu/parallel/scaling.py``: the ray-split forward
render (:31), the data-parallel train step (:74) and the handoff render on
(1, k) meshes (:134), each measured for several rank counts k, with
``overhead_table`` (:165) and ``efficiency`` (:176). The reference makes one
mesh per count over the first k devices; the port cannot remake its world,
so every rank of the world calls these functions and each count runs on a
mesh of the first k ranks while the others wait. A count's time is its
slowest rank's (a max over the world), and each timed iteration ends with
the card synchronised, so the time is the work's and not its enqueue.

Ranks that share one card (gloo ranks on ``cuda:0``) time-share it, so
their figures are an overhead (``overhead_table``), not scaling.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..core.flatten import Scene
from ..kernels.fused_march import render_rays_fused
from ..render.camera import Camera, ray_directions
from . import mesh as meshlib
from .mesh import DATA_AXIS, Mesh


def _counts(counts: Optional[List[int]]) -> List[int]:
    world = meshlib.world_size()
    return counts or sorted({1, 2, 4, 8, world} & set(range(1, world + 1)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _slowest(everyone: Mesh, dt: float) -> float:
    """The largest of every rank's time (0 from ranks outside the count)."""
    return float(everyone.pmax(torch.tensor([dt], dtype=torch.float64, device=everyone.device),
                               DATA_AXIS))


def _timed(fn, iters: int, dev: torch.device) -> float:
    """Seconds per call of ``fn`` after one warm-up call, the card
    synchronised inside every iteration."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        _sync(dev)
    return (time.perf_counter() - t0) / iters


def measure_render_scaling(scene: Scene, camera: Camera, cfg: RenderConfig,
                           device_counts: List[int] = None, iters: int = 3,
                           device=None) -> Dict[int, float]:
    """rays/s of the fused-march render of one frame with its rays split
    over a (k, 1) mesh, for each count k."""
    everyone = meshlib.make_mesh(meshlib.world_size(), 1, device)
    dev = everyone.device
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees).to(dev)
    pos = camera.pos.to(dev)
    N = dirs.shape[0]
    out = {}
    for k in _counts(device_counts):
        if N % k:
            continue
        mesh = meshlib.make_mesh(k, 1, dev)
        dt = 0.0
        if mesh.member:
            from .sharding import shard_scene

            sc, blk = shard_scene(scene, mesh), mesh.block(dirs)
            dt = _timed(lambda: render_rays_fused(sc, pos, blk, cfg), iters, dev)
        out[k] = N / _slowest(everyone, dt)
    return out


def measure_train_scaling(grid_shape=(64, 64, 64), n_rays: int = 4096,
                          device_counts: List[int] = None, iters: int = 3, num_steps: int = 24,
                          seed: int = 0, device=None) -> Dict[int, float]:
    """rays/s of the whole data-parallel guided train step (seed march,
    window pair, loss, gradient all-reduce, Adam) on (k, 1) meshes, for each
    count k, at constant total work."""
    from . import sharding as shardlib

    everyone = meshlib.make_mesh(meshlib.world_size(), 1, device)
    dev = everyone.device
    rng = np.random.default_rng(seed)
    origins = np.full((n_rays, 3), grid_shape[0] / 2, np.float32)
    origins[:, 1] = grid_shape[1] - 4.0
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs[:, 1] = -np.abs(dirs[:, 1]) - 0.3
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o, d = torch.from_numpy(origins).to(dev), torch.from_numpy(dirs).to(dev)
    t = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    out = {}
    for k in _counts(device_counts):
        if n_rays % k:
            continue
        mesh = meshlib.make_mesh(k, 1, dev)
        dt = 0.0
        if mesh.member:
            params = shardlib.init_params(grid_shape, dev)
            opt = torch.optim.Adam(params.parameters(), lr=1e-2)
            guide = shardlib.guide_scene_from_params(params, tau=1.0)
            step = shardlib.make_train_step_guided(params, opt, guide, num_steps=num_steps,
                                                   mesh=mesh)
            dt = _timed(lambda: float(step(o, d, t)[0]), iters, dev)
        out[k] = n_rays / _slowest(everyone, dt)
    return out


def measure_handoff_scaling(scene: Scene, camera: Camera, cfg: RenderConfig,
                            space_counts: List[int] = None, iters: int = 2,
                            device=None) -> Dict[int, float]:
    """rays/s of the ray-handoff render on (1, k) meshes: the world split
    along x over k ranks, for each count k that divides its x extent."""
    from . import handoff, spatial

    everyone = meshlib.make_mesh(meshlib.world_size(), 1, device)
    dev = everyone.device
    N = cfg.width * cfg.height
    out = {}
    for k in _counts(space_counts):
        if scene.shape3[0] % k:
            continue
        mesh = meshlib.make_mesh(1, k, dev)
        dt = 0.0
        if mesh.member:
            sc = spatial.shard_scene_spatial(scene, mesh)
            dt = _timed(lambda: handoff.render_image_handoff(sc, camera, cfg, mesh), iters, dev)
        out[k] = N / _slowest(everyone, dt)
    return out


def overhead_table(rates: Dict[int, float]) -> Dict[int, float]:
    """The sharding overhead where k ranks share the same silicon, so wall
    time cannot drop with k: overhead(k) = t_k / t_1 - 1 at constant total
    work. On separate cards the compute divides by k, so their efficiency
    is bounded below by about 1 / (1 + overhead)."""
    if not rates or 1 not in rates:
        return {}
    return {k: rates[1] / rates[k] - 1.0 for k in rates}


def efficiency(rates: Dict[int, float]) -> Dict[int, float]:
    """Scaling efficiency relative to the smallest measured count."""
    if not rates:
        return {}
    k0 = min(rates)
    base = rates[k0] / k0
    return {k: rates[k] / (k * base) for k in rates}
