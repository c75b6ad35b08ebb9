"""PyTorch port: its own copies of the JAX-free host modules against the
JAX package's originals.

The port imports nothing of ``raytracing_test_tpu``, so it carries copies of
``config``, ``core.types`` / ``core.color`` / ``core.tree``, the noise (2D,
3D and 4D), ``ops.morton``, ``worldgen.terrain``, ``app.picking``,
``chebyshev_distance_field``, ``rasterize_tree`` / ``scene_from_tree`` /
``lookup_material`` (``core/flatten.py``) and ``make_camera``. The copies are
numpy and Python in both packages (``lookup_material`` and ``make_camera``
on tensors here), so worlds, palettes, noise, codes, lookups and pick results
must be equal exactly; the 3D and 4D noise also to the golden values of
tests/golden/opensimplex34.npz.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_test_tpu import config as jconfig
from raytracing_test_tpu.app import picking as jpicking
from raytracing_test_tpu.core import color as jcolor
from raytracing_test_tpu.worldgen import opensimplex as jnoise
from raytracing_test_tpu.worldgen import terrain as jterrain
from raytracing_test_tpu_torch import config as tconfig
from raytracing_test_tpu_torch.app import picking as tpicking
from raytracing_test_tpu_torch.core import color as tcolor
from raytracing_test_tpu_torch.worldgen import opensimplex as tnoise
from raytracing_test_tpu_torch.worldgen import terrain as tterrain

WORLDS = {
    "default": lambda cfg: cfg.WorldConfig(),
    "size48": lambda cfg: cfg.world_for_size(48),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_gen_world_grid_matches_jax(world):
    tg, tpal = tterrain.gen_world_grid(WORLDS[world](tconfig))
    jg, jpal = jterrain.gen_world_grid(WORLDS[world](jconfig))
    assert tg.dtype == jg.dtype and tg.shape == jg.shape
    np.testing.assert_array_equal(tg, jg)
    assert len(tpal) == len(jpal)
    for name in ("flags", "color", "metadata"):
        np.testing.assert_array_equal(getattr(tpal, name), getattr(jpal, name), err_msg=name)
    np.testing.assert_array_equal(tterrain.heightmap(WORLDS[world](tconfig)),
                                  jterrain.heightmap(WORLDS[world](jconfig)))


@pytest.mark.parametrize("cls", ["WorldConfig", "CameraConfig", "RenderConfig", "FitConfig"])
def test_config_defaults_match_jax(cls):
    assert dataclasses.asdict(getattr(tconfig, cls)()) == dataclasses.asdict(getattr(jconfig, cls)())


@pytest.mark.parametrize("n", [16, 48, 200, 700])
def test_world_for_size_matches_jax(n):
    assert dataclasses.asdict(tconfig.world_for_size(n)) == dataclasses.asdict(jconfig.world_for_size(n))


@pytest.mark.parametrize("seed", [42, 64, 100, -7])
def test_noise_matches_jax(seed):
    np.testing.assert_array_equal(tnoise.build_perm(seed), jnoise.build_perm(seed))
    rng = np.random.default_rng(seed & 0xFFFF)
    x, y = rng.uniform(-50, 50, (2, 300))
    tn, jn = tnoise.OpenSimplex2D(seed), jnoise.OpenSimplex2D(seed)
    np.testing.assert_array_equal(tn.eval_vec(x, y), jn.eval_vec(x, y))
    assert tn.eval(1.5, -2.25) == jn.eval(1.5, -2.25)


@pytest.mark.parametrize("cap", [8, 15])
def test_chebyshev_distance_field_matches_jax(cap):
    from raytracing_test_tpu.ops.mxu_lookup import chebyshev_distance_field as jcheb
    from raytracing_test_tpu_torch.core.flatten import chebyshev_distance_field as tcheb

    occ = np.random.default_rng(cap).random((20, 9, 14)) < 0.01
    got, want = tcheb(occ, cap=cap), jcheb(occ, cap=cap)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got[occ] == 0).all() and got.max() >= 3


def test_color_packing_matches_jax():
    rgb = np.random.default_rng(0).integers(0, 256, (50, 3))
    for r, g, b in rgb:
        assert tcolor.rgb_to_u64(r, g, b) == jcolor.rgb_to_u64(r, g, b)
    packed = np.array([int(jcolor.rgb_to_u64(r, g, b)) for r, g, b in rgb], np.uint64)
    np.testing.assert_array_equal(tcolor.u64_to_unit_f32(packed), jcolor.u64_to_unit_f32(packed))


@pytest.fixture(scope="module")
def trees():
    tcfg, jcfg = tconfig.world_for_size(48), jconfig.world_for_size(48)
    tg, tpal = tterrain.gen_world_grid(tcfg)
    jg, jpal = jterrain.gen_world_grid(jcfg)
    return (tterrain.gen_world_tree(tcfg, tg, tpal), jterrain.gen_world_tree(jcfg, jg, jpal),
            (tg, tpal), (jg, jpal))


def test_cast_ray_matches_jax(trees):
    ttree, jtree, (tg, tpal), (jg, jpal) = trees
    rng = np.random.default_rng(7)
    origins = rng.uniform([2.0, 20.0, 2.0], [46.0, 60.0, 46.0], (200, 3))
    dirs = rng.normal(size=(200, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    hits = 0
    tgrid = tpicking.GridBlockSource(tg, tpal)
    jgrid = jpicking.GridBlockSource(jg, jpal)
    for o, d in zip(origins, dirs):
        want = jpicking.cast_ray(jtree, o, d, 30)
        assert tpicking.cast_ray(ttree, o, d, 30) == want
        assert tpicking.cast_ray(tgrid, o, d, 30) == jpicking.cast_ray(jgrid, o, d, 30)
        hits += want.steps > 0
    assert 20 < hits < 200  # the rays both hit and miss


def test_world_tree_matches_jax(trees):
    ttree, jtree, _, _ = trees
    for name in ("flags", "word", "aux_u32", "aux_f32", "children"):
        np.testing.assert_array_equal(getattr(ttree, name), getattr(jtree, name), err_msg=name)
    assert ttree.root == jtree.root


@pytest.mark.parametrize("dim", [3, 4])
def test_opensimplex34_bit_equal_to_golden_and_jax(dim):
    g = np.load("tests/golden/opensimplex34.npz")
    for si, seed in enumerate(g["seeds"]):
        tn = getattr(tnoise, f"OpenSimplex{dim}D")(int(seed))
        jn = getattr(jnoise, f"OpenSimplex{dim}D")(int(seed))
        np.testing.assert_array_equal(tn.perm, jn.perm)
        sel = np.nonzero(g[f"si{dim}"] == si)[0]
        pts = g[f"pts{dim}"][sel]
        got = np.array([tn.eval(*p) for p in pts])
        np.testing.assert_array_equal(got, g[f"val{dim}"][sel])
        np.testing.assert_array_equal(got, np.array([jn.eval(*p) for p in pts]))


def test_morton_matches_jax():
    from raytracing_test_tpu.ops import morton as jm
    from raytracing_test_tpu_torch.ops import morton as tm

    x, y, z = np.random.default_rng(3).integers(0, 2048, (3, 500))
    want = jm.morton_encode(x, y, z)
    got = tm.morton_encode(x, y, z)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    t = tm.morton_encode(*(torch.from_numpy(v) for v in (x, y, z)))
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), want)
    for xi, yi, zi in zip(x[:50].tolist(), y[:50].tolist(), z[:50].tolist()):
        code = tm.morton_encode(xi, yi, zi)
        assert code == jm.morton_encode(xi, yi, zi)
        assert tm.morton_digits(code) == jm.morton_digits(code)
        assert [tm.child_index(xi, yi, zi, k) for k in range(5)] == tm.morton_digits(code)


def test_rasterize_and_scene_from_tree_match_jax(trees):
    from raytracing_test_tpu.core import flatten as jflat
    from raytracing_test_tpu_torch.core import flatten as tflat

    ttree, jtree, (tg, tpal), (jg, jpal) = trees
    shape = tg.shape
    got = tflat.rasterize_tree(ttree, tpal, shape)
    np.testing.assert_array_equal(got, jflat.rasterize_tree(jtree, jpal, shape))
    np.testing.assert_array_equal(got, tg)
    ts = tflat.scene_from_tree(ttree, tpal, shape, "cpu")
    js = jflat.scene_from_tree(jtree, jpal, shape)
    for name in ("grid_enc", "macro", "albedo", "flags", "metadata", "brick_mat", "brick_dist"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert ts.y_max == int(js.y_max)

    rng = np.random.default_rng(5)
    x, y, z = (rng.integers(-1100, 2100, 4000) for _ in range(3))
    x[:200], y[:200], z[:200] = (rng.integers(0, 48, 200) for _ in range(3))  # in the world
    want = np.asarray(jflat.lookup_material(js, *(jnp.asarray(v, jnp.int32) for v in (x, y, z))))
    mats = tflat.lookup_material(ts, *(torch.from_numpy(v.astype(np.int32)) for v in (x, y, z)))
    assert mats.dtype == torch.int32 and (want > 0).sum() > 20
    np.testing.assert_array_equal(mats.numpy(), want)


def test_make_camera_matches_jax():
    from raytracing_test_tpu.render.camera import make_camera as jmake
    from raytracing_test_tpu_torch.render.camera import make_camera as tmake

    for cfg in (tconfig.CameraConfig(), tconfig.CameraConfig(pos=(1.5, 90.0, -3.25),
                                                              dir=(0.2, -0.7, 0.4))):
        got = tmake(cfg, "cpu")
        want = jmake(jconfig.CameraConfig(**dataclasses.asdict(cfg)))
        np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
        np.testing.assert_array_equal(got.dir.numpy(), np.asarray(want.dir))
