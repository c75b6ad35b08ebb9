"""Continuous voxel fields for the differentiable renderer, in PyTorch.

Port of the subset of ``raytracing_test_tpu/render/diff.py`` that the
training slice runs: the field container (``DiffScene``, :49), its construction
from a hard grid (:56), the field gathers (:67, :80), the soft sun-shadow
primitive ``transmittance`` (:666), the surface-guided render
``render_rays_diff_guided`` (:455) and the prox-seeded render with its exact
patch-up ``render_rays_guided_prox`` (:553). The window render itself is
``kernels/fused_window.py:render_window_fused``.

The reference's ``accum`` / ``enumerate_mode`` engines of
``render_rays_diff_window`` (:322) are XLA accumulators of one function, the
window; here every ``accum`` runs the window kernel pair. The blind scan
(:105) and ``ao_diff`` are not ported (ROADMAP.md, remaining differentiable
variants).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import RenderConfig
from .renderer import _argmin_axis, _build_ray, _get, _init_tmax, _onehot

# Guided seeds at/above this value are the "no surface" sentinel (the guided
# path seeds misses with 1e6): window renders treat such rays as pure sky.
MISS_SEED_MIN = 9.9e5


@dataclass(frozen=True)
class DiffScene:
    """Continuous voxel fields over the grid window (origin-anchored)."""

    density: torch.Tensor  # f32 [Sx, Sy, Sz] >= 0
    albedo: torch.Tensor  # f32 [Sx, Sy, Sz, 3]

    @property
    def shape3(self):
        return tuple(self.density.shape)

    @property
    def device(self) -> torch.device:
        return self.density.device


def diff_scene_from_grid(grid, albedo_table, device, solid_density: float = 1e4) -> DiffScene:
    """Hard material grid -> continuous fields (solid voxels get a large
    density so the volumetric render matches the hard first-hit limit)."""
    g = np.asarray(grid)
    density = np.where(g > 0, solid_density, 0.0).astype(np.float32)
    albedo = np.asarray(albedo_table)[g]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return DiffScene(put(density), put(albedo))


def _window_lin(shape3, cell):
    """(row index, inside) of integer cells in the flattened field. Cells wrap
    &1023; outside the window a sample reads row 0, masked by ``inside``."""
    Sx, Sy, Sz = shape3
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    return torch.where(inside, lin, torch.zeros_like(lin)).long(), inside


def _gather_fields(scene: DiffScene, cell):
    """Density and albedo at integer cells; air outside the window/wrap."""
    lin, inside = _window_lin(scene.shape3, cell)
    sigma = scene.density.reshape(-1)[lin]
    alb = scene.albedo.reshape(-1, 3)[lin]
    z = inside.to(sigma.dtype)
    return sigma * z, alb * z[:, None]


def _pack_fields(scene: DiffScene):
    """[V, 4] rows of (sigma, r, g, b): one 16-byte row per sample."""
    return torch.cat([scene.density.reshape(-1, 1), scene.albedo.reshape(-1, 3)], dim=1)


def transmittance(scene: DiffScene, origins, dirs, num_steps: int = 8):
    """Volumetric transmittance along short rays — the differentiable
    occlusion primitive (no colour accumulation). origins/dirs: f32[N,3]."""
    d, step, delta, abs_delta = _build_ray(dirs)
    cell = torch.floor(origins).to(torch.int32)
    tmax = _init_tmax(origins, cell, step, delta, abs_delta)
    istep = step.to(torch.int32)
    t_cur = torch.zeros_like(tmax[:, 0])
    trans = torch.ones_like(t_cur)
    for _ in range(num_steps):
        ax = _argmin_axis(tmax)
        oh = _onehot(ax, tmax.dtype)
        t_next = _get(tmax, ax)
        dt = torch.clamp(t_next - t_cur, min=0.0)
        sigma, _ = _gather_fields(scene, cell)
        trans = trans * torch.exp(-sigma * dt)
        cell = cell + oh.to(torch.int32) * istep
        tmax = tmax + oh * abs_delta
        t_cur = t_next
    return trans


GUIDED_ACCUMS = ("dedup", "scatter", "fused")


def render_rays_diff_guided(scene: DiffScene, hard_scene, origin, dirs, num_steps: int = 24,
                            margin: float = 3.0, sun_dir=(2.0, 1.0, 4.0), sky: bool = True,
                            image_hw=None, coarse_factor: int = 4, window: bool = True,
                            accum: str = "dedup", engine: str = "fast", shading: bool = False,
                            shadow_steps: int = 0):
    """Surface-guided differentiable render (reference :455): a lean hard
    march on ``hard_scene`` (not differentiated) finds each ray's first solid
    depth, then the ``num_steps`` window starts ``margin`` cells before it.

    ``engine``: ``"fast"`` marches with the fused march (its kernel on the
    card, ``render/fast.py`` on the CPU), ``"bricks"`` / ``"bricks-pallas"``
    with the brick engine. Every ``accum`` renders the window on the window
    kernel pair; ``window=False`` (the blind scan) is not ported.
    ``image_hw=(H, W)`` seeds the hard march from a 1/coarse_factor depth
    pass, as the reference does.
    """
    from ..kernels import brick_kernels, fused_march
    from ..kernels.fused_window import render_window_fused
    from .progressive import guided_seeds

    if engine == "fast":
        hard_render = fused_march.render_rays_fused
    elif engine in ("bricks", "bricks-pallas"):
        hard_render = brick_kernels.render_rays_bricks_pallas
    else:
        raise ValueError(f"unknown engine {engine!r}")
    if accum not in GUIDED_ACCUMS:
        raise ValueError(f"unknown accum {accum!r} (choose from {', '.join(GUIDED_ACCUMS)})")
    if not window:
        raise NotImplementedError(
            "render_rays_diff_guided(window=False) renders with the blind volumetric scan, "
            "which is not ported yet; see ROADMAP.md, 'Modules to port', item 10")
    seed = guided_seeds(hard_render, hard_scene, origin, dirs, margin, image_hw, coarse_factor)
    return render_window_fused(scene, origin, dirs, num_steps=num_steps, sun_dir=sun_dir,
                               sky=sky, start_t=seed, shading=shading,
                               shadow_steps=shadow_steps)


def render_rays_guided_prox(scene: DiffScene, hard_scene, origin, dirs, image_hw,
                            num_steps: int = 24, margin: float = 0.5, sun_dir=(2.0, 1.0, 4.0),
                            coarse_factor: int = 4, patch_div: int = 64, sat_eps: float = 1e-3,
                            shading: bool = False, shadow_steps: int = 0,
                            return_aux: bool = False):
    """Prox-seeded window render with an exact, compacted patch-up
    (reference :553; its ``tables`` and ``interpret`` arguments are TPU
    matters and are dropped). ``sky=False``.

    The seed march stops at the first entry into an occupied 8^3 brick
    (``seed_depth_fused(prox=True)``). Rays whose window then ends
    unsaturated (transmittance > ``sat_eps``) and is not sky are patched:
    taken in 8-ray groups, the first ``max((N // patch_div) // 8, 16)``
    groups in ray order, re-marched exactly from the prox seed (margin 3)
    and re-windowed. The patched rows replace the first window's out of
    place, so the first window gets no cotangent there. Rays beyond the
    budget keep the first window's values and gradients; aux says so:
    ``n_need``, ``n_escaped`` (0: the window has no escapes),
    ``patch_capacity`` and ``grads_dropped``.
    """
    from ..kernels.fused_march import hit_seeds, seed_depth_fused
    from ..kernels.fused_window import render_window_fused

    f32 = torch.float32
    dev = scene.device
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    N = dirs.shape[0]
    if N % 8:
        raise ValueError(f"render_rays_guided_prox: {N} rays are not 8-ray groups")
    seed = seed_depth_fused(hard_scene, origin, dirs, image_hw, coarse_factor=coarse_factor,
                            margin=margin, prox=True)
    rgb, waux = render_window_fused(scene, origin, dirs, num_steps=num_steps, sun_dir=sun_dir,
                                    sky=False, start_t=seed, shading=shading,
                                    shadow_steps=shadow_steps, return_aux=True)

    need = (waux["t_end"] > sat_eps) & (seed < MISS_SEED_MIN)
    need8 = need.reshape(-1, 8).any(dim=1)
    n_need, n_need8 = int(need.sum()), int(need8.sum())
    K8 = max((N // patch_div) // 8, 16)
    idx8 = torch.nonzero(need8)[:K8, 0]
    idx = (idx8[:, None] * 8 + torch.arange(8, device=dev)[None, :]).reshape(-1)
    kept = idx[need[idx]]
    if kept.numel():
        ob = origin if origin.ndim == 2 else origin[None, :].expand(N, 3)
        sub_o, sub_d = ob[kept], dirs[kept]
        lean = RenderConfig(width=1, height=kept.numel(), enable_materials=False,
                            enable_shadows=False)
        seed2 = hit_seeds(hard_scene, sub_o, sub_d, lean, margin=3.0, start_t=seed[kept])
        rgb2 = render_window_fused(scene, sub_o, sub_d, num_steps=num_steps, sun_dir=sun_dir,
                                   sky=False, start_t=seed2, shading=shading,
                                   shadow_steps=shadow_steps)
        rgb = rgb.index_put((kept,), rgb2)
    if return_aux:
        return rgb, {"n_need": n_need, "n_escaped": 0, "patch_capacity": K8 * 8,
                     "grads_dropped": n_need8 > K8}
    return rgb
