"""PyTorch port: the plain march (render/fast.py) against the JAX fast path.

The same rays go through ``raytracing_test_tpu.render.fast.render_rays_fast``
(jit) and the port's ``render_rays_fast`` on CPU, plus the port's fused
wrapper, which runs the same plain march for CPU tensors. Contract:
``assert_images_close`` (|diff| <= 1e-5 on >= 99% of pixels, the budget for
DDA near-ties that an FMA-contracted XLA expression resolves differently)
and equal ``mat`` / ``hit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_test_tpu.config import RenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.render import fast as jfast
from raytracing_test_tpu.render.camera import Camera as JCamera, ray_directions as jrays
from raytracing_test_tpu.worldgen import terrain
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.kernels import fused_march as tfm
from raytracing_test_tpu_torch.render import fast as tfast
from raytracing_test_tpu_torch.render.camera import Camera as TCamera
from tests.test_render_parity import CASES, _material_world, assert_images_close

torch.set_num_threads(1)

_jit_rays = jax.jit(jfast.render_rays_fast, static_argnames=("cfg",))
_jit_image = jax.jit(jfast.render_image_fast, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def mat_scenes():
    grid, pal = _material_world()
    return jflat.scene_from_grid(grid, pal), tflat.scene_from_grid(grid, pal, "cpu")


@pytest.fixture(scope="module")
def terrain_scenes():
    grid, pal = terrain.gen_world_grid(WorldConfig(width=48, length=48, grid_shape=(64, 64, 64)))
    return jflat.scene_from_grid(grid, pal), tflat.scene_from_grid(grid, pal, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _compare_rays(scenes, pos, dirn, rcfg, time_s=0.0, start_t=None):
    js, ts = scenes
    jc = JCamera(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(dirn, jnp.float32))
    dirs = np.asarray(jrays(jc, rcfg.width, rcfg.height))
    jst = None if start_t is None else jnp.asarray(start_t)
    jcol, jaux = _jit_rays(js, jc.pos, jnp.asarray(dirs), cfg=rcfg, start_t=jst,
                           time_s=jnp.float32(time_s))
    tst = None if start_t is None else _t(start_t)
    tt = torch.tensor(time_s, dtype=torch.float32)
    tcol, taux = tfast.render_rays_fast(ts, _t(pos).float(), _t(dirs), rcfg, start_t=tst, time_s=tt)
    fcol, faux = tfm.render_rays_fused(ts, _t(pos).float(), _t(dirs), rcfg, start_t=tst, time_s=tt)

    hw = (rcfg.height, rcfg.width, 3)
    assert_images_close(tcol.numpy().reshape(hw), np.asarray(jcol).reshape(hw))
    np.testing.assert_array_equal(taux["mat"].numpy(), np.asarray(jaux["mat"]))
    np.testing.assert_array_equal(taux["hit"].numpy(), np.asarray(jaux["hit"]))
    # the fused wrapper's plain path is the same march, shaded the same way
    assert torch.equal(fcol, tcol)
    assert torch.equal(faux["mat"], taux["mat"])
    return tcol, taux


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_plain_march_material_cases(mat_scenes, case):
    pos, dirn, time_s = case
    rcfg = RenderConfig(width=24, height=24, max_steps=150, shadow_steps=40)
    _compare_rays(mat_scenes, pos, dirn, rcfg, time_s)


def test_plain_march_tight_budget(mat_scenes):
    # budget freezes, including frozen-in-water lanes that still shadow
    rcfg = RenderConfig(width=16, height=16, max_steps=24, shadow_steps=6)
    _, aux = _compare_rays(mat_scenes, (12.0, 10.5, 12.0), (0.8, -0.1, 0.55), rcfg, 1.2)
    assert (aux["steps"] >= 24).any()


def test_plain_march_lean(terrain_scenes):
    rcfg = RenderConfig(width=16, height=16, max_steps=150, shadow_steps=30,
                        enable_materials=False, enable_shadows=False)
    _compare_rays(terrain_scenes, (24.0, 45.0, -8.0), (0.3, -0.5, 0.8), rcfg)


def test_plain_march_start_t_seed(terrain_scenes):
    rcfg = RenderConfig(width=16, height=16, max_steps=150, shadow_steps=30)
    seed = np.full(256, 5.0, np.float32)
    _compare_rays(terrain_scenes, (24.0, 50.0, -10.0), (0.2, -0.7, 0.8), rcfg, start_t=seed)


@pytest.mark.parametrize("start", [
    ((-40.0, 30.0, -40.0), (0.6, -0.2, 0.6)),  # enter through the slab
    ((32.0, 90.0, 32.0), (0.1, 0.9, 0.1)),  # sky-up exit
    ((200.0, 30.0, 200.0), (1.0, 0.1, 1.0)),  # outside moving away
    ((24.0, 30.0, 24.0), (0.3, 0.2, 0.9)),  # start below the surface
], ids=["slab", "sky", "away", "below"])
def test_plain_image_edges_and_sky(terrain_scenes, start):
    js, ts = terrain_scenes
    pos, dirn = start
    rcfg = RenderConfig(width=16, height=16, max_steps=200, shadow_steps=40,
                        crosshair=True, mouse_px=(5.0, 9.0))
    jc = JCamera(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(dirn, jnp.float32))
    tc = TCamera(pos=torch.tensor(pos), dir=torch.tensor(dirn))
    want = np.asarray(_jit_image(js, jc, cfg=rcfg, time_s=jnp.float32(0.0)))
    got = tfast.render_image_fast(ts, tc, rcfg, time_s=0.0).numpy()
    assert got.shape == want.shape == (16, 16, 3)
    assert np.isfinite(got).all()
    assert_images_close(got, want)
    got_fused = tfm.render_image_fused(ts, tc, rcfg, time_s=0.0).numpy()
    np.testing.assert_array_equal(got_fused, got)
