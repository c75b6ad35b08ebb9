"""PyTorch port: Scene construction and camera rays against the JAX package.

Same numpy inputs through ``raytracing_test_tpu`` and ``raytracing_test_tpu_torch``.
The scene builders are numpy in both packages, so their tensors must be equal
bit for bit; ray directions agree to 1e-6 (XLA may contract a*b+c into one
FMA, PyTorch rounds each operation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_test_tpu.config import WorldConfig
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.render import camera as jcamera
from raytracing_test_tpu.worldgen import terrain
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.render import camera as tcamera
from tests.test_render_parity import _material_world

torch.set_num_threads(1)


def _terrain64():
    return terrain.gen_world_grid(WorldConfig(width=48, length=48, grid_shape=(64, 64, 64)))


@pytest.mark.parametrize("world", [_material_world, _terrain64], ids=["materials", "terrain64"])
def test_scene_from_grid_matches_jax(world):
    grid, pal = world()
    js = jflat.scene_from_grid(grid, pal)
    ts = tflat.scene_from_grid(grid, pal, "cpu")
    for name in ("grid_enc", "macro", "albedo", "flags", "metadata"):
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert ts.y_max == int(js.y_max)
    assert ts.shape3 == tuple(js.shape3)

    # the state carried across: a JAX Scene's arrays -> the port's Scene
    fields = {k: np.asarray(v) for k, v in js._asdict().items() if v is not None}
    tj = tflat.scene_from_jax(fields, "cpu")
    for name in ("grid_enc", "macro", "albedo", "flags", "metadata"):
        assert torch.equal(getattr(tj, name), getattr(ts, name)), name
    assert tj.y_max == ts.y_max


@pytest.mark.parametrize("world", [_material_world, _terrain64], ids=["materials", "terrain64"])
def test_brick_fields_match_jax(world):
    """brick_mat and brick_dist equal the reference's arrays bit for bit;
    brick_dist_shadow equals its nibble table decoded; scene_from_jax
    carries all three."""
    from raytracing_test_tpu.ops.mxu_lookup import mxu_nibble_lookup2

    grid, pal = world()
    js = jflat.scene_from_grid(grid, pal)
    ts = tflat.scene_from_grid(grid, pal, "cpu")
    assert ts.brick_shift == js.brick_shift and ts.brick_grid == tuple(js.brick_grid)
    for name in ("brick_mat", "brick_dist"):
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == want.dtype == np.uint8, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    nb = ts.brick_dist.numel()
    decoded = np.asarray(mxu_nibble_lookup2(js.brick_nib_shadow, jnp.arange(nb, dtype=jnp.int32)))
    np.testing.assert_array_equal(ts.brick_dist_shadow.numpy().reshape(-1), decoded)
    assert ts.brick_dist_shadow.dtype == torch.uint8

    fields = {k: np.asarray(v) for k, v in js._asdict().items() if v is not None}
    tj = tflat.scene_from_jax(fields, "cpu")
    for name in ("brick_mat", "brick_dist", "brick_dist_shadow"):
        assert torch.equal(getattr(tj, name), getattr(ts, name)), name
    bare = {k: v for k, v in fields.items() if not k.startswith("brick_")}
    assert tflat.scene_from_jax(bare, "cpu").brick_mat is None


def test_default_world_bricks():
    """The default world: 4^3 bricks, 131,072 of them, an 8.4 MB brick_mat."""
    assert tflat.pick_brick_shift((256, 128, 256)) == 2
    g = np.zeros((256, 128, 256), np.uint8)
    g[3, 5, 7] = 1
    rows = tflat.brick_rows(g, 2)
    assert rows.shape == (131072, 64) and rows.nbytes == 8388608
    assert rows[(0 * 32 + 1) * 64 + 1, (3 * 4 + 1) * 4 + 3] == 1
    with pytest.raises(ValueError):
        tflat.pick_brick_shift((6, 8, 8))


def test_grid_enc_rejects_wide_material_ids():
    g = np.zeros((8, 8, 8), np.uint8)
    g[1, 1, 1] = 128
    with pytest.raises(ValueError):
        tflat.build_grid_enc(g)


CAMERAS = [
    ((35.0, 50.0, 35.0), (0.5, -0.6, 0.6), 24, 24, 90.0),
    ((100.0, 60.0, 40.0), (0.55, -0.4, 0.55), 32, 16, 90.0),
    ((10.0, 10.0, 10.0), (1.0, 0.0, 0.0), 16, 16, 70.0),  # axis-aligned
    ((10.0, 10.0, 10.0), (0.0, 0.0, 1.0), 8, 12, 90.0),  # axis-aligned
    ((10.0, 10.0, 10.0), (1.0, 0.0, 1.0), 16, 8, 60.0),  # unnormalised ref default
]


@pytest.mark.parametrize("cam", CAMERAS, ids=[f"cam{i}" for i in range(len(CAMERAS))])
def test_ray_directions_match_jax(cam):
    pos, d, w, h, fov = cam
    jc = jcamera.Camera(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(d, jnp.float32))
    tc = tcamera.Camera(pos=torch.tensor(pos), dir=torch.tensor(d))
    want = np.asarray(jcamera.ray_directions(jc, w, h, fov))
    got = tcamera.ray_directions(tc, w, h, fov).numpy()
    assert got.shape == (w * h, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_camera_from_yaw_pitch_matches_jax():
    jc = jcamera.camera_from_yaw_pitch((35.0, 50.0, 35.0), 45.0, 25.0)
    tc = tcamera.camera_from_yaw_pitch((35.0, 50.0, 35.0), 45.0, 25.0, "cpu")
    np.testing.assert_array_equal(tc.dir.numpy(), np.asarray(jc.dir))
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
