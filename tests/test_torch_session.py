"""PyTorch port: the interactive edit session against the JAX package.

The tree's delete / traverse / to_dense, the native runtime, the incremental
scene mirror, the world checkpoints, the debug channels, ``WorldSession``
and the CLI's ``edit`` and ``probe`` verbs. The same seeded inputs go
through ``raytracing_test_tpu`` and ``raytracing_test_tpu_torch`` (both on
the CPU; the port's marches run their plain versions there). Contracts:
host structures equal; frames within ``assert_images_close``.
"""

import io
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_test_tpu.app import checkpoint as jckpt, debug as jdbg
from raytracing_test_tpu.app.session import WorldSession as JSession
from raytracing_test_tpu.config import RenderConfig as JRenderConfig, WorldConfig as JWorldConfig
from raytracing_test_tpu.core.mirror import SceneMirror as JMirror
from raytracing_test_tpu.core.tree import VoxelTree as JTree
from raytracing_test_tpu.core.types import Block as JBlock
from raytracing_test_tpu.render.camera import Camera as JCamera
from raytracing_test_tpu_torch.app import checkpoint as tckpt, cli, debug as tdbg
from raytracing_test_tpu_torch.app.session import WorldSession
from raytracing_test_tpu_torch.config import RenderConfig, WorldConfig
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.core.color import rgb_to_u64
from raytracing_test_tpu_torch.core.mirror import SceneMirror, y_brick_counts
from raytracing_test_tpu_torch.core.tree import VoxelTree
from raytracing_test_tpu_torch.core.types import Block, Properties
from raytracing_test_tpu_torch.kernels import fused_march as tfm
from raytracing_test_tpu_torch.native import runtime as native
from raytracing_test_tpu_torch.render.camera import Camera
from raytracing_test_tpu_torch.worldgen import terrain
from raytracing_test_tpu_torch.worldgen.opensimplex import OpenSimplex2D
from tests.test_render_parity import assert_images_close

torch.set_num_threads(1)

SMALL = dict(width=48, length=48, grid_shape=(64, 64, 64))
RED = Block(0, int(rgb_to_u64(200, 0, 0)))
GREEN = Block(0, int(rgb_to_u64(0, 200, 0)))
MIRROR = Block(int(Properties.REFLECTIVE), int(rgb_to_u64(255, 255, 255)), 0.94)
# one edit script for both sessions: generic poses (AO and pick rays are
# sensitive to ties), a place, a delete, a second place from another spot
SCRIPT = [("goto", (24.3, 45.7, 23.6)), ("look", (41.0, 57.0)), ("place", 0), ("place", 2),
          ("look", (-33.0, 48.0)), ("delete", None), ("goto", (30.2, 44.1, 17.9)),
          ("look", (12.0, 61.0)), ("place", 1), ("delete", None)]


def _jblock(b):
    return JBlock(b.flags, b.color, b.metadata)


# ---- the tree


def test_tree_delete_traverse_to_dense_match_jax():
    """One seeded put/delete sequence through both python trees: pools, free
    lists, dirty bricks, traverse and to_dense equal."""
    rng = np.random.default_rng(11)
    tt, jt = VoxelTree(), JTree()
    blocks = [RED, GREEN, MIRROR]
    for _ in range(400):
        pos = tuple(int(v) for v in rng.integers(0, 64, 3))
        lvl = int(rng.choice([4, 5, 6, 6, 6]))
        if rng.integers(0, 3):
            b = blocks[int(rng.integers(0, 3))]
            tt.put_block(pos, b, lvl)
            jt.put_block(pos, _jblock(b), lvl)
        else:
            assert tuple(tt.delete_block(pos, lvl)) == tuple(jt.delete_block(pos, lvl))
    for name in ("flags", "word", "aux_u32", "aux_f32", "children", "_free_nodes",
                 "_free_arrays", "dirty_bricks", "num_nodes"):
        np.testing.assert_array_equal(np.asarray(sorted(getattr(tt, name)) if name == "dirty_bricks"
                                                 else getattr(tt, name)),
                                      np.asarray(sorted(getattr(jt, name)) if name == "dirty_bricks"
                                                 else getattr(jt, name)), err_msg=name)
    probe = [tuple(int(v) for v in p) for p in rng.integers(0, 64, (300, 3))]
    assert [tuple(b) for b in tt.traverse(probe)] == [tuple(b) for b in jt.traverse(probe)]
    for got, want in zip(tt.to_dense(64), jt.to_dense(64)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tt.to_dense(16, (8, 0, 24)), jt.to_dense(16, (8, 0, 24))):
        np.testing.assert_array_equal(got, want)


def test_native_tree_matches_python_tree():
    rng = np.random.default_rng(3)
    nt, pt = native.NativeVoxelTree(), VoxelTree()
    blocks = [RED, GREEN, MIRROR]
    for _ in range(500):
        op = rng.integers(0, 3)
        pos = tuple(int(v) for v in rng.integers(0, 64, 3))
        lvl = int(rng.choice([5, 6, 6, 6]))
        if op == 0:
            b = blocks[int(rng.integers(0, 3))]
            nt.put_block(pos, b, lvl)
            pt.put_block(pos, b, lvl)
        elif op == 1:
            assert nt.delete_block(pos, lvl) == pt.delete_block(pos, lvl)
        else:
            assert nt.get_block(pos) == pt.get_block(pos), pos
    assert sorted(nt.dirty_bricks()) == sorted(pt.dirty_bricks)
    nt.clear_dirty()
    assert nt.dirty_bricks() == []
    for pos in rng.integers(0, 64, (300, 3)):
        assert nt.get_block(pos) == pt.get_block(pos)


def test_native_worldgen_matches_terrain_grid():
    """The native session's world (its palette remap, ``_export_native_grid``)
    holds the blocks of ``terrain.gen_world_grid`` at every voxel."""
    cfg = WorldConfig(**SMALL)
    s = WorldSession(cfg, use_native=True, device="cpu")
    grid, pal = terrain.gen_world_grid(cfg)
    np.testing.assert_array_equal(s.grid > 0, grid > 0)
    np.testing.assert_array_equal(s.palette.color[s.grid], pal.color[grid])
    np.testing.assert_array_equal(s.palette.flags[s.grid] | 1, pal.flags[grid] | 1)
    np.testing.assert_array_equal(s.palette.metadata[s.grid], pal.metadata[grid])
    assert native.noise2(42, 1.5, -2.25) == pytest.approx(
        OpenSimplex2D(42).eval(1.5, -2.25), abs=1e-15)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ build raises with the compiler's message, caches nothing,
    and the session does not fall back to the python tree."""
    bad = tmp_path / "voxel_runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        WorldSession(WorldConfig(**SMALL), use_native=True, device="cpu")
    assert native._lib is None
    assert not list((tmp_path / "build").glob("*.so"))


# ---- the mirror


def _assert_scene_equal(a, b):
    for name in ("grid_enc", "macro", "albedo", "flags", "metadata", "brick_mat", "brick_dist",
                 "brick_dist_shadow", "prox_enc"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.y_max == b.y_max


def _edit(grid, mirror, cells_and_mats):
    """Apply voxel edits to the host grid and sync incrementally."""
    bricks = sorted({(x >> 3, y >> 3, z >> 3) for (x, y, z), _ in cells_and_mats})
    old = {b: y_brick_counts(grid, b) for b in bricks}
    for (x, y, z), m in cells_and_mats:
        grid[x, y, z] = m
    return mirror.apply_bricks(bricks, old)


def _mirror_edits(shape, grid, pal):
    """tests/test_mirror.py's edits: a tower that raises y_max, a hole, a
    corner edit, the origin, then the tower removed (y_max lowered)."""
    mid = int(pal.id_for(Block(0, int(rgb_to_u64(200, 30, 30)))))
    yt = shape[1] - 10
    water = int(pal.id_for(terrain.WATER))
    return [
        [((40, yt, 40), mid), ((40, yt + 1, 40), mid)],
        [((40, int(grid[40, :, 41].nonzero()[0].max()), 41), 0)],
        [((shape[0] - 1, 5, shape[2] - 1), mid)],
        [((0, 3, 0), 0)],
        [((12, 30, 52), water), ((13, 30, 52), water)],  # liquid: brick_dist_shadow differs
        [((40, yt, 40), 0), ((40, yt + 1, 40), 0)],
    ]


@pytest.mark.parametrize("shape", [(64, 64, 64), (256, 128, 256)])
def test_mirror_incremental_equals_full_rebuild(shape):
    wcfg = WorldConfig(width=min(shape[0], 96), length=min(shape[2], 96), grid_shape=shape)
    grid, pal = terrain.gen_world_grid(wcfg)
    mirror = SceneMirror(grid, pal, "cpu")
    first = mirror.scene
    first.prox_enc  # cached on the first Scene: a later Scene must not reuse it
    y_maxes = []
    for batch in _mirror_edits(shape, grid, pal):
        scene = _edit(grid, mirror, batch)
        assert scene is not first
        _assert_scene_equal(scene, tflat.scene_from_grid(grid, pal, "cpu"))
        y_maxes.append(scene.y_max)
    assert y_maxes[0] == shape[1] - 8 and y_maxes[-1] < y_maxes[0]  # raised, then lowered
    assert first.grid_enc.data_ptr() == mirror.scene.grid_enc.data_ptr()  # updated in place


@pytest.mark.parametrize("shape", [(64, 64, 64), (256, 128, 256)])
def test_mirror_matches_jax_mirror(shape):
    """The port's mirrored Scene after the edits equals ``scene_from_jax`` of
    the JAX mirror's Scene."""
    from raytracing_test_tpu.worldgen import terrain as jterrain

    n = min(shape[0], 96)
    jgrid, jpal = jterrain.gen_world_grid(JWorldConfig(width=n, length=n, grid_shape=shape))
    tgrid, tpal = terrain.gen_world_grid(WorldConfig(width=n, length=n, grid_shape=shape))
    jm, tm = JMirror(jgrid, jpal), SceneMirror(tgrid, tpal, "cpu")
    jedits, tedits = _mirror_edits(shape, jgrid, jpal), _mirror_edits(shape, tgrid, tpal)
    assert jedits == tedits
    for batch in tedits:
        for grid, mirror in ((jgrid, jm), (tgrid, tm)):
            bricks = sorted({(x >> 3, y >> 3, z >> 3) for (x, y, z), _ in batch})
            old = {b: y_brick_counts(grid, b) for b in bricks}
            for (x, y, z), m in batch:
                grid[x, y, z] = m
            got = mirror.apply_bricks(bricks, old)
    fields = {k: np.asarray(v) for k, v in jm.scene._asdict().items() if v is not None}
    _assert_scene_equal(got, tflat.scene_from_jax(fields, "cpu"))


# ---- the session


def _run_script(s):
    """SCRIPT through a session; returns what each verb reported."""
    out = []
    for op, arg in SCRIPT:
        if op == "goto":
            s.pos = np.asarray(arg, np.float64)
        elif op == "look":
            s.yaw, s.pitch = arg
        elif op == "place":
            out.append(("pick", tuple(s.pick())))
            out.append(("place", s.place(arg)))
        elif op == "delete":
            out.append(("delete", s.delete()))
        out.append(("sync", s.sync()))
    return out


@pytest.fixture(scope="module")
def sessions():
    js = JSession(JWorldConfig(**SMALL), use_native=False)
    ts = WorldSession(WorldConfig(**SMALL), use_native=False, device="cpu")
    return js, ts, _run_script(js), _run_script(ts)


def test_session_edit_script_matches_jax(sessions):
    js, ts, jout, tout = sessions
    assert tout == jout
    assert any(op == "delete" and pos is not None for op, pos in tout)
    np.testing.assert_array_equal(ts.grid, js.grid)
    np.testing.assert_array_equal(ts.palette.color, js.palette.color)
    fields = {k: np.asarray(v) for k, v in js.scene._asdict().items() if v is not None}
    _assert_scene_equal(ts.scene, tflat.scene_from_jax(fields, "cpu"))
    _assert_scene_equal(ts.scene, tflat.scene_from_grid(ts.grid, ts.palette, "cpu"))
    assert set(ts.sync_ms) == {"rasterize", "boxes", "apply"}


@pytest.mark.parametrize("mode", ["fast", "fused", "reference", "progressive"])
def test_session_render_modes_match_jax(sessions, mode):
    """After the edit script, each mode's 20x20 frame (AO on, at a time where
    the water moves) against the JAX session's frame in that mode (the JAX
    ``fast`` for ``fused``, which the JAX session holds equal to it)."""
    js, ts, _, _ = sessions
    for s in (js, ts):
        s.pos, s.yaw, s.pitch, s.time = np.asarray([30.2, 44.1, 17.9]), 23.0, 31.0, 0.7
    launches = tfm.LAUNCHES
    got = ts.render(RenderConfig(width=20, height=20, enable_ao=True), mode=mode)
    want = js.render(JRenderConfig(width=20, height=20, enable_ao=True),
                     mode="fast" if mode == "fused" else mode)
    assert got.shape == (20, 20, 3) and torch.isfinite(got).all()
    assert_images_close(got.numpy(), np.asarray(want))
    assert tfm.LAUNCHES == launches  # CPU tensors run the plain version


def test_session_fused_renders_a_wide_palette_without_fallback():
    """15 interned materials (the JAX session's fused tables take 13 and fall
    back to fast): the port's fused mode renders them through the march and
    equals fast, and the mirrored scene holds all of them."""
    s = WorldSession(WorldConfig(**SMALL), use_native=False, device="cpu")
    s.pos, s.yaw, s.pitch = np.asarray([20.3, 44.6, 2.7]), 12.0, 21.0
    for i in range(15):
        s.tree.put_block((10 + i, 40, 10), Block(0, (i * 1371235) % (1 << 63)), 6)
    s.sync()
    assert int(s.scene.grid_enc[s.scene.grid_enc < 128].max()) > 13
    assert len(s.palette) >= 15 + 4
    rcfg = RenderConfig(width=16, height=16)
    img = s.render(rcfg, mode="fused")
    assert torch.equal(img, s.render(rcfg, mode="fast"))
    assert (img.numpy().reshape(-1, 3) != img.numpy().reshape(-1, 3)[0]).any()
    _assert_scene_equal(s.scene, tflat.scene_from_grid(s.grid, s.palette, "cpu"))


def test_session_rejects_unported_and_unknown_modes():
    """``spatial`` and ``handoff`` (once rejected as not ported) render in a
    plain process on a one-rank CPU group of its own: spatial equal to the
    reference frame with AO, handoff to the fast frame (AO off, as the
    reference's session renders it). ``pallas`` is still rejected."""
    from raytracing_test_tpu_torch.parallel import mesh as meshlib

    s = WorldSession(WorldConfig(width=16, length=16, grid_shape=(64, 64, 64)),
                     use_native=False, device="cpu")
    rcfg = RenderConfig(width=8, height=8, enable_ao=True)
    try:
        assert torch.equal(s.render(rcfg, mode="spatial"), s.render(rcfg, mode="reference"))
        no_ao = replace(rcfg, enable_ao=False)
        assert torch.equal(s.render(rcfg, mode="handoff"), s.render(no_ao, mode="fast"))
        assert meshlib.world_size() == 1
    finally:
        meshlib.shutdown()
    with pytest.raises(ValueError, match="unknown render mode 'pallas'"):
        s.render(RenderConfig(width=8, height=8), mode="pallas")


def test_session_camera_matches_jax(sessions):
    js, ts, _, _ = sessions
    for yaw, pitch, moves in [(0.0, 0.0, (1, 0, 0)), (170.0, 45.0, (0.5, -2, 1)),
                              (-120.0, -60.0, (3, 1, -1))]:
        for s in (js, ts):
            s.pos, s.yaw, s.pitch = np.asarray([10.0, 40.0, 12.0]), yaw, pitch
            s.rotate(20.0, 60.0)
            s.move(*moves, sprint=True)
        np.testing.assert_array_equal(ts.camera_dir(), js.camera_dir())
        np.testing.assert_array_equal(ts.pos, js.pos)
        assert (ts.yaw, ts.pitch) == (js.yaw, js.pitch)
        cam = ts.camera()
        assert cam.pos.dtype == torch.float32 and cam.pos.device == ts.device


# ---- debug channels and the world checkpoint


def test_debug_channels_match_jax(sessions):
    js, ts, _, _ = sessions
    pos, dirn = np.asarray([24.3, 45.7, 23.6], np.float32), np.asarray([0.53, -0.62, 0.41])
    rcfg = RenderConfig(width=8, height=8)
    got = tdbg.render_debug(ts.scene, Camera(torch.from_numpy(pos), torch.tensor(dirn,
                                             dtype=torch.float32)), rcfg)
    want = jdbg.render_debug(js.scene, JCamera(jnp.asarray(pos), jnp.asarray(dirn, jnp.float32)),
                             JRenderConfig(width=8, height=8))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
    assert tdbg.probe_pixel(got, 3, 5).keys() == jdbg.probe_pixel(want, 3, 5).keys()
    assert tdbg.probe_pixel(got, 3, 5)["mat"] == jdbg.probe_pixel(want, 3, 5)["mat"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_world_checkpoint_crosses_packages(sessions, tmp_path, writer):
    js, ts, _, _ = sessions
    path = str(tmp_path / "world.npz")
    s, save, load = ((ts, tckpt.save_world, jckpt.load_world) if writer == "port"
                     else (js, jckpt.save_world, tckpt.load_world))
    save(path, s.grid, s.palette, meta={"seed": 7})
    grid, pal = load(path)
    np.testing.assert_array_equal(grid, s.grid)
    for name in ("flags", "color", "metadata"):
        np.testing.assert_array_equal(getattr(pal, name), getattr(s.palette, name))
    assert pal.id_for(s.palette.block(len(s.palette) - 1)) == len(s.palette) - 1
    assert int(np.load(path)["meta_seed"]) == 7


# ---- the CLI


ARGV = ["--device", "cpu", "--world", "48", "--width", "24", "--height", "24"]


def test_cli_edit_from_stdin(tmp_path, monkeypatch):
    out, world = tmp_path / "out.png", tmp_path / "w.npz"
    monkeypatch.setattr("sys.stdin", io.StringIO(
        f"look 55 -25; place; delete; render {out}; save {world}\n"))
    cli.main(ARGV + ["edit", "-"])
    from tests.test_torch_cli import _read_png

    assert _read_png(out).shape == (24, 24, 3)
    grid, pal = tckpt.load_world(str(world))
    s = WorldSession(cli.world_for_size(48), use_native=True, device="cpu")
    s.yaw, s.pitch = 55.0, -25.0
    placed = s.place()
    assert s.delete() == placed
    s.sync()
    np.testing.assert_array_equal(grid, s.grid)  # the place was deleted again


def test_cli_probe_and_reference_ao(tmp_path, capsys):
    cli.main(ARGV + ["probe", "--row", "12", "--col", "12"])
    lines = capsys.readouterr().out.splitlines()
    keys = [ln.split(":")[0] for ln in lines]
    assert keys[:2] == ["color", "hit_pos"] and "proj_pln_inter" in keys
    cli.main(ARGV + ["--ao", "render", "--mode", "reference", "--out", str(tmp_path / "r.png")])
    cli.main(ARGV + ["--ao", "--slow", "render", "--out", str(tmp_path / "s.png")])
    assert os.path.getsize(tmp_path / "r.png") > 0
    assert open(tmp_path / "r.png", "rb").read() == open(tmp_path / "s.png", "rb").read()


def test_profiling_utilities_and_animate_trace(tmp_path, capsys):
    """FrameStats' rolling window (the reference's 40-frame average), the
    phase timer, and ``animate --trace`` writing a torch.profiler trace."""
    import time

    from raytracing_test_tpu_torch.utils import profiling

    st = profiling.FrameStats(window=4)
    for _ in range(6):
        st.start()
        time.sleep(0.001)
        st.stop(rays=100)
    assert len(st.times) == 4 and st.avg_ms >= 1.0 and st.fps > 0 and st.rays_per_s > 0
    assert "fps" in st.status()
    with pytest.raises(RuntimeError, match="start"):
        st.stop()
    with profiling.phase("unit-test-phase"):
        profiling.sync(torch.zeros(2))
    assert "unit-test-phase" in capsys.readouterr().err
    cli.main(["--device", "cpu", "--world", "16", "--width", "8", "--height", "8", "--no-native",
              "animate", "--frames", "2", "--out-dir", str(tmp_path / "anim"),
              "--trace", str(tmp_path / "trace")])
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert "avg frame" in capsys.readouterr().err
