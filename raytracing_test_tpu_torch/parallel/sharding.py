"""Sharded rendering and the training steps, on one device or data parallel.

Port of ``raytracing_test_tpu/parallel/sharding.py``: ``shard_scene`` (:30)
and ``render_image_sharded`` (:36), the reference march on each rank's block
of rays, gathered over the data axis; the fit parameters (``FitParams`` :61, ``params_to_scene`` :68,
``init_params`` :75), the blind loss ``loss_fn`` (:83) and its step
``make_train_step`` (:255): the blind volumetric scan
(``render/diff.py:render_rays_diff``, 128 steps by default), MSE, backward
and an Adam step; the occupancy guide (``guide_scene_from_params`` :89) and
``make_train_step_fused`` (:156): seed march on the guide (the lean fused
march), the 24-step window render (the window kernel pair), MSE loss,
backward and an Adam step, all through ``render/diff.py:
render_rays_diff_guided``; ``make_train_step_guided`` (:117) is the same
step on one device, and its name here.

Data parallel (``mesh=``, parallel/mesh.py): each step is called with the
whole batch on every rank, takes the rank's contiguous block, computes the
local loss and its backward, then averages the two fields' gradients over
the data axis (one coalesced all-reduce, divided by the axis size: the
reference's ``pmean``, :224-229) before Adam, so every rank keeps the same
weights. The step returns the loss averaged over the data axis, with
``n_escaped`` summed and ``grads_dropped`` as a max. Without a mesh the steps
are the single-device steps, unchanged.

``params_from_jax`` and ``adam_state_from_optax`` carry weights and optimizer
state across from the JAX package as numpy arrays (checkpoints, tests).
"""

from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import torch
from torch import nn

from ..config import RenderConfig
from ..core.color import rgb_to_u64
from ..core.flatten import Scene, scene_from_grid
from ..core.tree import Palette
from ..core.types import Block
from ..render import renderer
from ..render.camera import Camera, ray_directions
from ..render.diff import DiffScene, render_rays_diff, render_rays_diff_guided
from .mesh import DATA_AXIS, Mesh

GRAD_SYNCS = 0  # average_grads calls in this process (the data-parallel steps)


def shard_scene(scene: Scene, mesh: Mesh) -> Scene:
    """The scene replicated: every rank holds all of it on its own device."""
    if scene.device == mesh.device:
        return scene
    moved = {f.name: getattr(scene, f.name).to(mesh.device) for f in fields(scene)
             if isinstance(getattr(scene, f.name), torch.Tensor)}
    return replace(scene, **moved)


@torch.no_grad()
def render_image_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh):
    """The reference render (``renderer.render_rays``) with the pixels split
    over the data axis: each rank marches its block of rows, then the blocks
    are gathered over the axis. Returns the [H, W, 3] frame on every rank."""
    scene = shard_scene(scene, mesh)
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees).to(mesh.device)
    col, _ = renderer.render_rays(scene, camera.pos.to(mesh.device), mesh.block(dirs), cfg)
    return mesh.all_gather(col, DATA_AXIS).reshape(cfg.height, cfg.width, 3)


def average_grads(params: FitParams, mesh: Mesh) -> None:
    """Replace the two fields' gradients by their mean over the data axis:
    one all-reduce of both, coalesced into one buffer, divided by the axis
    size. The whole of it is the profiler range ``grad_sync``; each call
    counts in ``GRAD_SYNCS``."""
    global GRAD_SYNCS
    GRAD_SYNCS += 1
    with torch.profiler.record_function("grad_sync"):
        gs = [params.density_raw.grad, params.albedo_raw.grad]
        flat = torch.cat([g.reshape(-1) for g in gs])
        mesh.psum_(flat, DATA_AXIS)
        flat /= torch.tensor(float(mesh.axis_size(DATA_AXIS)), device=flat.device)
        i = 0
        for g in gs:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


def _reduce_step(loss: torch.Tensor, n_escaped: int, dropped: bool, mesh: Mesh):
    """(loss averaged, {n_escaped summed, grads_dropped as a max}) over the
    data axis, in one all-reduce (a sum of 0/1 flags is positive exactly
    when their max is 1)."""
    st = mesh.psum(torch.stack([loss.detach(), loss.new_tensor(float(n_escaped)),
                                loss.new_tensor(float(dropped))]), DATA_AXIS)
    n = torch.tensor(float(mesh.axis_size(DATA_AXIS)), device=loss.device)
    return st[0] / n, {"n_escaped": int(st[1]), "grads_dropped": bool(st[2] > 0)}


class FitParams(nn.Module):
    """Optimizable voxel fields: density through softplus for positivity."""

    def __init__(self, density_raw: torch.Tensor, albedo_raw: torch.Tensor):
        super().__init__()
        self.density_raw = nn.Parameter(density_raw)  # f32 [Sx,Sy,Sz]; sigma = softplus(.)
        self.albedo_raw = nn.Parameter(albedo_raw)  # f32 [Sx,Sy,Sz,3]; albedo = sigmoid(.)


def params_to_scene(p: FitParams, density_scale: float = 25.0) -> DiffScene:
    return DiffScene(
        density=torch.nn.functional.softplus(p.density_raw) * density_scale,
        albedo=torch.sigmoid(p.albedo_raw),
    )


def init_params(grid_shape, device="cuda") -> FitParams:
    Sx, Sy, Sz = grid_shape
    f32 = torch.float32
    return FitParams(
        density_raw=torch.full((Sx, Sy, Sz), -2.0, dtype=f32, device=device),
        albedo_raw=torch.zeros((Sx, Sy, Sz, 3), dtype=f32, device=device),
    )


def loss_fn(params: FitParams, origins, dirs, targets, num_steps: int = 128):
    """MSE of the blind scan (``sky=False``) against ``targets``."""
    rgb = render_rays_diff(params_to_scene(params), origins, dirs, num_steps=num_steps, sky=False)
    return torch.mean((rgb - targets) ** 2)


def params_from_jax(density_raw, albedo_raw, device="cuda") -> FitParams:
    """FitParams from the JAX package's ``FitParams`` arrays (numpy)."""
    put = lambda a: torch.from_numpy(np.array(a, np.float32, order="C")).to(device)
    return FitParams(put(density_raw), put(albedo_raw))


def shard_params_spatial(params: FitParams, mesh: Mesh) -> FitParams:
    """This space rank's x-slab of both fields (``Sx / n_space`` columns), on
    the mesh's device: the fields as the multi-chip dry run shards them over
    the space axis (``params_from_jax`` weights too)."""
    from .mesh import SPACE_AXIS

    with torch.no_grad():
        return FitParams(*(mesh.block(p.detach(), SPACE_AXIS).to(mesh.device).clone()
                           for p in (params.density_raw, params.albedo_raw)))


def gather_params_spatial(params: FitParams, mesh: Mesh) -> FitParams:
    """The whole fields from every space rank's slab (``shard_params_spatial``
    undone), on every rank."""
    from .mesh import SPACE_AXIS

    with torch.no_grad():
        return FitParams(*(mesh.all_gather(p.detach(), SPACE_AXIS)
                           for p in (params.density_raw, params.albedo_raw)))


def adam_state_from_optax(count, mu, nu):
    """``optax.adam``'s ``ScaleByAdamState`` (count, mu, nu; mu and nu as
    (density, albedo) numpy pairs) -> per-parameter ``torch.optim.Adam`` state
    in ``FitParams`` order. ``load_adam_state`` installs it."""
    put = lambda a: torch.from_numpy(np.array(a, np.float32, order="C"))
    return [
        {"step": torch.tensor(float(count), dtype=torch.float32),
         "exp_avg": put(m), "exp_avg_sq": put(v)}
        for m, v in zip(mu, nu)
    ]


def load_adam_state(optimizer: torch.optim.Adam, params: FitParams, states) -> None:
    """Install ``adam_state_from_optax`` state for ``params`` in ``optimizer``."""
    for p, st in zip((params.density_raw, params.albedo_raw), states):
        optimizer.state[p] = {
            "step": st["step"].clone(),
            "exp_avg": st["exp_avg"].to(p.device).clone(),
            "exp_avg_sq": st["exp_avg_sq"].to(p.device).clone(),
        }


def adam_state_to_optax(optimizer: torch.optim.Adam, params: FitParams):
    """Inverse of ``adam_state_from_optax``: (count, mu, nu) as numpy arrays;
    a fresh optimizer gives count 0 and zero moments."""
    ps = (params.density_raw, params.albedo_raw)
    sts = [optimizer.state.get(p, {}) for p in ps]
    count = int(sts[0]["step"]) if "step" in sts[0] else 0
    zero = lambda p: np.zeros(tuple(p.shape), np.float32)
    mu = tuple(st["exp_avg"].detach().cpu().numpy() if st else zero(p) for p, st in zip(ps, sts))
    nu = tuple(st["exp_avg_sq"].detach().cpu().numpy() if st else zero(p) for p, st in zip(ps, sts))
    return np.int32(count), mu, nu


def guide_occupancy(params: FitParams, tau: float = 1.0,
                    density_scale: float = 25.0) -> torch.Tensor:
    """The guide's u8 material grid, on the field's device: id 1 where the
    density exceeds ``tau``, 0 elsewhere."""
    with torch.no_grad():
        dens = torch.nn.functional.softplus(params.density_raw) * density_scale
        return (dens > tau).to(torch.uint8)


def guide_palette() -> Palette:
    """The guide's palette: one white material, id 1."""
    pal = Palette()
    pal.id_for(Block(0, int(rgb_to_u64(255, 255, 255))))
    return pal


def guide_scene_from_params(params: FitParams, tau: float = 1.0,
                            density_scale: float = 25.0) -> Scene:
    """Threshold the evolving density field into an occupancy guide Scene
    (fit-time occupancy re-thresholding): the seed march finds the current
    surface estimate, the window samples around it. Pruning is one-way:
    matter cannot re-emerge inside a region the guide has pruned.

    The threshold and the Scene are computed where the field lives
    (``scene_from_grid`` of a tensor); only ``y_max`` comes to the host."""
    occ = guide_occupancy(params, tau, density_scale)
    return scene_from_grid(occ, guide_palette(), params.density_raw.device)


def make_train_step_fused(params: FitParams, optimizer: torch.optim.Optimizer,
                          guide_scene: Scene = None, num_steps: int = 24, shading: bool = False,
                          shadow_steps: int = 0, mesh: Mesh = None):
    """One training step on the fused engines: ``train_step(origins, dirs,
    targets, guide=None) -> (loss, aux)``. It renders through
    ``render_rays_diff_guided``: the lean seed march on ``guide`` (default
    ``guide_scene``; re-thresholded guides swap in per call), margin 3, no
    coarse pass, then the window kernel pair; MSE, backward, Adam. ``aux``
    holds the reference's ``n_escaped`` (0) and ``grads_dropped`` (False):
    the port's window has no escapes. With ``mesh``, data parallel (module
    docstring): the reference's ``shard_map`` + ``pmean`` step.

    The reference's ``make_train_step_guided`` (:117) computes the same step
    on its XLA accumulators; here it is this function."""

    def train_step(origins, dirs, targets, guide=None):
        g = guide_scene if guide is None else guide
        if mesh is not None:
            origins, dirs, targets = (mesh.block(x) for x in (origins, dirs, targets))
        optimizer.zero_grad(set_to_none=True)
        rgb = render_rays_diff_guided(params_to_scene(params), g, origins, dirs,
                                      num_steps=num_steps, sky=False, shading=shading,
                                      shadow_steps=shadow_steps)
        loss = torch.mean((rgb - targets) ** 2)
        loss.backward()
        return _finish_step(params, optimizer, loss, mesh)

    return train_step


make_train_step_guided = make_train_step_fused


def make_train_step(params: FitParams, optimizer: torch.optim.Optimizer, num_steps: int = 128,
                    mesh: Mesh = None):
    """One training step on the blind scan: ``train_step(origins, dirs,
    targets) -> (loss, aux)``: ``loss_fn``, backward, then ``optimizer``'s
    step on ``params``. ``aux`` holds ``make_train_step_fused``'s keys: the
    scan has no escapes and drops no gradient. With ``mesh``, data parallel
    (module docstring): the reference's sharded step, whose gradient
    all-reduce XLA inserts from the sharding annotations."""

    def train_step(origins, dirs, targets):
        if mesh is not None:
            origins, dirs, targets = (mesh.block(x) for x in (origins, dirs, targets))
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, origins, dirs, targets, num_steps)
        loss.backward()
        return _finish_step(params, optimizer, loss, mesh)

    return train_step


def _finish_step(params: FitParams, optimizer, loss, mesh: Mesh):
    """Adam on the gradients (averaged over the data axis first, with a
    mesh) -> (loss, aux). The port's steps have no escapes and drop no
    gradient."""
    if mesh is None:
        optimizer.step()
        return loss.detach(), {"n_escaped": 0, "grads_dropped": False}
    average_grads(params, mesh)
    optimizer.step()
    return _reduce_step(loss, 0, False, mesh)
