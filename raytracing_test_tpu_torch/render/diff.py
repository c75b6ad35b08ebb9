"""Continuous voxel fields for the differentiable renderer, in PyTorch.

Port of the subset of ``raytracing_test_tpu/render/diff.py`` that the
training slice runs: the field container (``DiffScene``, :49), its construction
from a hard grid (:56), the field gathers (:67, :80) and the soft sun-shadow
primitive ``transmittance`` (:666). The window render itself is
``kernels/fused_window.py:render_window_fused``.

The reference's ``accum`` / ``enumerate_mode`` engines of
``render_rays_diff_window`` (:322) are XLA accumulators and are not ported;
neither are the blind scan (:105), the guided engines (:455) and ``ao_diff``
(ROADMAP.md, remaining differentiable variants).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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
