"""PyTorch port: hemisphere AO against the JAX package.

``render/hemisphere.py`` (the Fibonacci table, the tangent frame, the
oriented and the sampled directions), ``renderer._ao_march`` and AO in
``shade``: the reference path (``render_rays``) and the fused path (its
plain version on the CPU) with ``enable_ao=True`` against the JAX
``renderer.render_rays`` on the same world and rays. Contracts: the table
exact, frames within ``assert_images_close``, directions within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_test_tpu.config import RenderConfig as JRenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.render import hemisphere as jhemi, renderer as jrend
from raytracing_test_tpu.render.camera import Camera as JCamera, ray_directions as jrays
from raytracing_test_tpu.worldgen import terrain
from raytracing_test_tpu_torch.config import RenderConfig
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.kernels import fused_march as tfm
from raytracing_test_tpu_torch.render import hemisphere as themi, renderer as trend
from tests.test_render_parity import _material_world, assert_images_close

torch.set_num_threads(1)

AXES = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                  np.float32)


@pytest.mark.parametrize("n,cap", [(20, 0.85), (7, 1.0), (64, 0.5)])
def test_fibonacci_hemisphere_exact(n, cap):
    np.testing.assert_array_equal(themi.fibonacci_hemisphere(n, cap),
                                  jhemi.fibonacci_hemisphere(n, cap))
    np.testing.assert_array_equal(themi.HEMISPHERE_DIRS_20, jhemi.HEMISPHERE_DIRS_20)


def test_tangent_frame_and_oriented_dirs_on_axis_normals():
    t1, t2 = themi.tangent_frame(torch.from_numpy(AXES))
    j1, j2 = jhemi.tangent_frame(jnp.asarray(AXES))
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=1e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), atol=1e-6)
    got = themi.oriented_dirs(torch.from_numpy(AXES)).numpy()
    np.testing.assert_allclose(got, np.asarray(jhemi.oriented_dirs(jnp.asarray(AXES))), atol=1e-6)
    assert got.shape == (6, 20, 3)
    # every direction leaves through the face: along the normal, unit length
    assert (np.einsum("nkc,nc->nk", got, AXES) > 0).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_sample_hemisphere():
    normal = torch.from_numpy(np.repeat(AXES, 5, axis=0))
    draw = lambda seed: themi.sample_hemisphere(torch.Generator().manual_seed(seed), normal, 16)
    d = draw(5)
    assert d.shape == (30, 16, 3)
    torch.testing.assert_close(torch.linalg.vector_norm(d, dim=-1), torch.ones(30, 16))
    assert ((d * normal[:, None, :]).sum(-1) >= 0).all()
    assert torch.equal(d, draw(5)) and not torch.equal(d, draw(6))
    # reparameterized: the directions carry the normal's gradient
    n = normal.clone().requires_grad_(True)
    themi.sample_hemisphere(torch.Generator().manual_seed(5), n, 4).sum().backward()
    assert torch.isfinite(n.grad).all() and n.grad.abs().sum() > 0


def _worlds():
    grid, pal = terrain.gen_world_grid(WorldConfig(width=48, length=48, grid_shape=(64, 64, 64)))
    return {"terrain": (grid, pal, (24.3, 45.7, -6.2), (0.31, -0.62, 0.83)),
            "materials": _material_world() + ((30.4, 14.3, 5.1), (0.05, -0.35, 0.93))}


@pytest.fixture(scope="module")
def worlds():
    return _worlds()


@pytest.mark.parametrize("world", ["terrain", "materials"])
def test_ao_march_matches_jax(worlds, world):
    """The occlusion of every point a 16x16 frame ends on: within 1e-6 (the
    hit count divided by 20; XLA multiplies by the reciprocal, an ulp off) on
    >= 99% of points (a tie in an AO ray's DDA may flip one of its hits)."""
    grid, pal, pos, dirn = worlds[world]
    js, ts = jflat.scene_from_grid(grid, pal), tflat.scene_from_grid(grid, pal, "cpu")
    cfg = JRenderConfig(width=16, height=16)
    dirs = jrays(JCamera(jnp.asarray(pos, jnp.float32), jnp.asarray(dirn, jnp.float32)), 16, 16)
    _, aux = jax.jit(lambda d: jrend.render_rays(js, jnp.asarray(pos, jnp.float32), d, cfg))(dirs)
    p, normal = np.array(aux["hit_pos"]), np.array(aux["normal"])
    want = np.asarray(jax.jit(lambda a, b: jrend._ao_march(js, a, b, cfg))(p, normal))
    got = trend._ao_march(ts, torch.from_numpy(p), torch.from_numpy(normal),
                          RenderConfig(width=16, height=16)).numpy()
    assert got.dtype == np.float32 and got.shape == (256,)
    assert (np.abs(got - want) > 1e-6).mean() <= 0.01, np.abs(got - want).max()
    assert want.max() > 0  # some hit points are occluded


@pytest.mark.parametrize("world", ["terrain", "materials"])
@pytest.mark.parametrize("path", ["reference", "fused"])
def test_shade_with_ao_matches_jax(worlds, world, path):
    """render_rays with enable_ao at 16x16 (time 0.9: the water moves), the
    port's reference path and its fused path (the march's plain version on
    the CPU) against JAX ``renderer.render_rays``."""
    grid, pal, pos, dirn = worlds[world]
    js, ts = jflat.scene_from_grid(grid, pal), tflat.scene_from_grid(grid, pal, "cpu")
    kw = dict(width=16, height=16, enable_ao=True, time=0.9)
    dirs = np.array(jrays(JCamera(jnp.asarray(pos, jnp.float32),
                                    jnp.asarray(dirn, jnp.float32)), 16, 16))
    want, jaux = jax.jit(lambda d: jrend.render_rays(js, jnp.asarray(pos, jnp.float32), d,
                                                     JRenderConfig(**kw)))(dirs)
    render = trend.render_rays if path == "reference" else tfm.render_rays_fused
    launches = tfm.LAUNCHES
    got, aux = render(ts, torch.tensor(pos), torch.from_numpy(dirs), RenderConfig(**kw))
    assert tfm.LAUNCHES == launches
    assert_images_close(got.numpy().reshape(16, 16, 3), np.asarray(want).reshape(16, 16, 3))
    off, _ = render(ts, torch.tensor(pos), torch.from_numpy(dirs),
                    RenderConfig(**dict(kw, enable_ao=False)))
    hit = aux["hit"].numpy()
    assert hit.any() and (got.numpy()[hit] < off.numpy()[hit] - 1e-6).any()  # AO darkens
    np.testing.assert_array_equal(got.numpy()[~hit], off.numpy()[~hit])  # not the sky
    if path == "reference":
        for name in ("mat", "cell", "steps", "last_axis", "hit", "reflected"):
            assert (aux[name].numpy() == np.asarray(jaux[name])).mean() >= 0.99, name
        for name in ("ray_ratios_a", "ray_ratios_b"):
            np.testing.assert_allclose(aux[name].numpy(), np.asarray(jaux[name]), rtol=1e-5)
