"""Hemisphere sampling directions for AO / diffuse GI, in PyTorch.

Port of ``raytracing_test_tpu/render/hemisphere.py``. The reference generates
a 20-point Fibonacci-spiral table offline (gen_hemisphare_distrib.py: phi =
arccos(1 - (i+0.5)*0.85/N), theta = pi*(1+5^.5)*(i+0.5)) and hardcodes it in
the GLSL pass (light_scattering.frag:133-154). Here the same table is computed
at import time with numpy, in y-up convention (the generator's cos(phi) "up"
axis mapped to y).

``sample_hemisphere`` draws stochastic cosine-weighted directions from an
explicit ``torch.Generator`` (the reference takes a JAX PRNG key), and is
reparameterized: gradients flow through the frame rotation.
"""

from __future__ import annotations

import numpy as np
import torch


def fibonacci_hemisphere(n: int = 20, cap: float = 0.85) -> np.ndarray:
    """The reference's spiral table, y-up: [n, 3] float32."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - i * cap / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    x = np.cos(theta) * np.sin(phi)
    z = np.sin(theta) * np.sin(phi)
    y = np.cos(phi)  # the "up" component
    return np.stack([x, y, z], axis=-1).astype(np.float32)


HEMISPHERE_DIRS_20 = fibonacci_hemisphere(20, 0.85)


def tangent_frame(normal: torch.Tensor):
    """Orthonormal frame with ``normal`` as its y-axis.

    The reference's computeTransformMat (light_scattering.frag:124-131) uses
    up=(0,1,0) and NaNs out for vertical normals; voxel normals are always
    one of ±x/±y/±z, so the fallback axis is picked branchlessly.
    normal: f32[..., 3] -> (t1, t2) each f32[..., 3].
    """
    n = normal
    vertical = n[..., 1:2].abs() > 0.9
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    up = torch.where(vertical, ex, ey)
    t1 = torch.linalg.cross(up.expand_as(n), n, dim=-1)
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
    t2 = torch.linalg.cross(n, t1, dim=-1)
    return t1, t2


def sample_hemisphere(generator: torch.Generator, normal: torch.Tensor, n: int):
    """Stochastic cosine-weighted hemisphere directions around per-point
    normals: the differentiable counterpart of the fixed Fibonacci table.

    ``generator`` lives on ``normal``'s device. normal: f32[N, 3]; returns
    f32[N, n, 3].
    """
    N = normal.shape[0]
    kw = dict(generator=generator, dtype=normal.dtype, device=normal.device)
    e1 = torch.rand((N, n), **kw)
    e2 = torch.rand((N, n), **kw)
    r = torch.sqrt(e1)
    phi = 2.0 * torch.pi * e2
    x = r * torch.cos(phi)
    z = r * torch.sin(phi)
    y = torch.sqrt(torch.clamp(1.0 - e1, min=0.0))  # cosine-weighted up component
    t1, t2 = tangent_frame(normal)
    return (
        x[..., None] * t1[:, None, :]
        + y[..., None] * normal[:, None, :]
        + z[..., None] * t2[:, None, :]
    )


def oriented_dirs(normal: torch.Tensor, table=None) -> torch.Tensor:
    """Rotate the hemisphere table into the frame of ``normal``.

    normal: f32[N, 3]; returns f32[N, K, 3] with dirs biased along the normal.
    """
    if table is None:
        table = torch.from_numpy(HEMISPHERE_DIRS_20).to(normal.device)
    t1, t2 = tangent_frame(normal)
    # world = x*t1 + y*n + z*t2
    return (
        table[None, :, 0:1] * t1[:, None, :]
        + table[None, :, 1:2] * normal[:, None, :]
        + table[None, :, 2:3] * t2[:, None, :]
    )
