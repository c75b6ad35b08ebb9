"""PyTorch port: Scene construction and camera rays against the JAX package.

Same numpy inputs through ``raytracing_test_tpu`` and ``raytracing_test_tpu_torch``.
The scene builders are numpy in both packages, so their tensors must be equal
bit for bit; ray directions agree to 1e-6 (XLA may contract a*b+c into one
FMA, PyTorch rounds each operation).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_test_tpu.config import WorldConfig
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.render import camera as jcamera
from raytracing_test_tpu.worldgen import terrain
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.core.color import rgb_to_u64
from raytracing_test_tpu_torch.core.tree import Palette as TPalette
from raytracing_test_tpu_torch.core.types import Block as TBlock, Properties as TProperties
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


def _palette(liquid: bool = False):
    """Stone as id 1; with ``liquid``, water (REFRACTIVE | LIQUID) as id 2."""
    pal = TPalette()
    pal.id_for(TBlock(0, int(rgb_to_u64(120, 120, 120))))
    if liquid:
        pal.id_for(TBlock(int(TProperties.REFRACTIVE | TProperties.LIQUID),
                          int(rgb_to_u64(0, 150, 10))))
    return pal


def _sparse_liquid(shape=(64, 32, 64), seed=5):
    """A random sparse grid of stone and water: many bricks hold only water,
    so the shadow field differs from the brick field."""
    rng = np.random.default_rng(seed)
    u = rng.random(shape)
    grid = np.where(u < 0.0015, 1, np.where(u < 0.006, 2, 0)).astype(np.uint8)
    return grid, _palette(liquid=True)


def _empty():
    return np.zeros((32, 32, 32), np.uint8), _palette()


def _full():
    return np.ones((32, 32, 32), np.uint8), _palette()


def _corner():
    grid = np.zeros((64, 64, 64), np.uint8)
    grid[0, 0, 0] = 1
    return grid, _palette()


def _flat():
    """64x16x64: every licence in y reaches the border."""
    grid = np.zeros((64, 16, 64), np.uint8)
    grid[30, 3, 17] = grid[5, 12, 60] = 1
    return grid, _palette()


TENSOR_WORLDS = [_material_world, _terrain64, _empty, _full, _corner, _flat, _sparse_liquid]


@pytest.mark.parametrize("world", TENSOR_WORLDS, ids=[
    "materials", "terrain64", "empty", "full", "corner", "flat64x16x64", "sparse-liquid"])
def test_scene_from_tensor_matches_numpy(world):
    """scene_from_grid of the grid as a u8 tensor (built by PyTorch and the
    distance kernel's plain passes here) equals the numpy builders' Scene bit
    for bit in every field, y_max and dtypes included; each path counts."""
    grid, pal = world()
    counts = (tflat.SCENES_FROM_NUMPY, tflat.SCENES_FROM_TENSOR)
    want = tflat.scene_from_grid(grid, pal, "cpu")
    got = tflat.scene_from_grid(torch.from_numpy(grid), pal, "cpu")
    assert (tflat.SCENES_FROM_NUMPY, tflat.SCENES_FROM_TENSOR) == (counts[0] + 1, counts[1] + 1)
    for f in dataclasses.fields(tflat.Scene):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f.name
        else:
            assert type(a) is type(b) and a == b, f.name
    if world is _sparse_liquid:
        assert not torch.equal(want.brick_dist, want.brick_dist_shadow)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_brick_fields_tensor_each_shift(s):
    """The tensor brick builder at each brick shift (world-512 runs 3) equals
    brick_rows and chebyshev_distance_field of the grid's occupancy, the
    shadow field with LIQUID voxels as air."""
    grid, pal = _sparse_liquid((64, 32, 96), seed=s)
    flags = tflat.palette_arrays(pal)[1]
    rows, dist, shadow = tflat.build_brick_fields_tensor(torch.from_numpy(grid), flags, s)
    want_rows = tflat.brick_rows(grid, s)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    bgrid = tuple(d >> s for d in grid.shape)
    liquid = (flags & int(TProperties.LIQUID)) > 0
    for got, occ in ((dist, want_rows > 0), (shadow, (want_rows > 0) & ~liquid[want_rows])):
        want = tflat.chebyshev_distance_field(occ.any(axis=1).reshape(bgrid),
                                              cap=tflat.BRICK_DIST_CAP)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_tensor_grid_rejects_wide_material_ids():
    g = torch.zeros((8, 8, 8), dtype=torch.uint8)
    g[1, 1, 1] = 128
    with pytest.raises(ValueError):
        tflat.scene_from_grid(g, _palette(), "cpu")


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
