"""The plain reference against the port at a tiny size on the CPU (where the
port runs its kernels' plain versions): the world and its tables, a
session frame with its highlight, a fit's first steps; and the roofline
counts on a tiny world."""

import numpy as np
import pytest
import torch

from reference import march as rm
from reference import scene as rs
from reference import train as rt
from reference import world as rw
from roofline import march as mroof
from roofline import window as wroof
from tiny import tiny_spec


def _world():
    from raytracing_test_tpu_torch.config import WorldConfig, world_for_size

    spec = tiny_spec("serve-ref-1024")
    w = {k: tuple(v) if isinstance(v, list) else v for k, v in spec["config"]["world"].items()}
    assert WorldConfig(**w) == world_for_size(16)
    return spec, WorldConfig(**w)


@pytest.mark.parametrize("size", [16, 48])
def test_world_and_tables_match_the_port(size):
    from raytracing_test_tpu_torch.config import world_for_size
    from raytracing_test_tpu_torch.core.flatten import palette_arrays, scene_from_grid
    from raytracing_test_tpu_torch.worldgen import terrain

    wcfg = world_for_size(size)
    grid_p, pal_p = terrain.gen_world_grid(wcfg)
    world = {f: getattr(wcfg, f) for f in ("width", "length", "seeds", "octave_freqs",
                                            "octave_amps", "base_height", "water_level",
                                            "include_init_blocks", "grid_shape")}
    grid_r, pal_r = rw.gen_world(world)
    assert np.array_equal(grid_p, grid_r)
    for a, b in zip(palette_arrays(pal_p), pal_r.arrays()):
        assert np.array_equal(a, b)
    sc = scene_from_grid(grid_p, pal_p, "cpu")
    assert np.array_equal(sc.grid_enc.numpy(), rs.build_grid_enc(grid_r))
    for t, r in zip((sc.brick_mat, sc.brick_dist, sc.brick_dist_shadow),
                    rs.brick_fields(grid_r, pal_r.arrays()[1])):
        assert np.array_equal(t.numpy(), r)
    assert sc.y_max == rs.y_max(grid_r)


def test_session_frame_matches_the_reference():
    from raytracing_test_tpu_torch.app.session import WorldSession
    from raytracing_test_tpu_torch.config import RenderConfig

    import checks.frames as cf

    spec, wcfg = _world()
    s = WorldSession(wcfg, device="cpu")
    s.pos = np.array([8.0, 42.0, 2.0])
    s.yaw, s.pitch, s.time = 10.0, 35.0, 0.4
    rcfg = RenderConfig(width=24, height=16)
    img = s.render(rcfg, mode="fused")
    grid, pal = rw.gen_world(spec["config"]["world"])
    albedo, flags, _ = pal.arrays()
    scene = rs.ref_scene(grid, albedo, flags, "cpu")
    ref = cf.reference_frame(scene, grid, flags, (s.pos, s.yaw, s.pitch), s.time, rcfg)
    assert s.pick().steps > 0  # the highlight is in the frame
    assert torch.equal(img, ref)


def test_window_rows_and_bounds():
    g = torch.Generator().manual_seed(3)
    shape3 = (8, 8, 8)
    origins = torch.rand((64, 3), generator=g) * 8
    dirs = torch.nn.functional.normalize(torch.randn((64, 3), generator=g), dim=1)
    cell, tmax, istep, absd = rt.window_inputs(shape3, origins, dirs, torch.zeros(64))
    rows = wroof.distinct_rows(cell, tmax, istep, absd, shape3, 6)
    # brute force: walk each ray alone
    want = set()
    for i in range(64):
        c, t = cell[i:i + 1].clone(), tmax[i:i + 1].clone()
        for _ in range(6):
            lin, inside = rt._window_lin(shape3, c)
            if bool(inside[0]):
                want.add(int(lin[0]))
            ax = int(rm._argmin_axis(t)[0])
            c[0, ax] += istep[i, ax]
            t[0, ax] += absd[i, ax]
    assert rows == len(want)
    b = wroof.pair_bound(64, rows, 6)
    assert b == pytest.approx((64 * 72 + rows * 16) / 3.35e12
                              + (64 * 104 + rows * 48) / 3.35e12)


def test_march_crossings_match_the_port_steps():
    from raytracing_test_tpu_torch.config import RenderConfig
    from raytracing_test_tpu_torch.core.flatten import scene_from_grid
    from raytracing_test_tpu_torch.kernels import fused_march
    from raytracing_test_tpu_torch.render import fast
    from raytracing_test_tpu_torch.render.camera import Camera, ray_directions
    from raytracing_test_tpu_torch.worldgen import terrain

    spec, wcfg = _world()
    grid, pal = terrain.gen_world_grid(wcfg)
    sc = scene_from_grid(grid, pal, "cpu")
    pos, look = (8.0, 45.0, -6.0), rm.yaw_pitch_dir(10.0, 35.0)
    rcfg = RenderConfig(width=16, height=16)
    dirs = ray_directions(Camera(torch.tensor(pos), torch.tensor(look, dtype=torch.float32)),
                          16, 16)
    s = fast._init_state(torch.tensor(pos), dirs, torch.ones(256))
    o = fused_march.fused_march_call(sc, s, rcfg, 0.0)
    grid_r, pal_r = rw.gen_world(spec["config"]["world"])
    albedo, flags, _ = pal_r.arrays()
    scene = rs.ref_scene(grid_r, albedo, flags, "cpu")
    n = mroof.frame_crossings(scene, pos, look, rm.RCfg(width=16, height=16))
    assert n >= int(o["steps"].sum()) > 0
    assert mroof.launch_bound(100, 8, 256, n) == pytest.approx(
        max((100 + 32 + 256 * 160) / 3.35e12, n * 3 / 67e12))
