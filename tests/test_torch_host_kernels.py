"""PyTorch port: the per-ray code of the CUDA kernels, built as host C++ with
g++, against the kernels' plain PyTorch versions.

``csrc/fused_march.cu`` and ``csrc/fused_window.cu`` keep their per-ray code
in plain C++ behind ``RT_DEV``. A harness (below) includes each source and
calls the same entry points the CUDA kernels call: the march's ``ray_of``
work order (8x4 pixel tiles of an image, or natural order) and its
``march_ray`` in each compile-time mode; and the window's ``forward_ray``
and ``backward_ray`` (the backward's warp reduction and atomics are
device-only: the host adds each sample's row with ``+=``).
The library is built inside the tests, never at import; without g++ they
skip.

Tolerances: the lean and prox marches exactly. The full march exactly on
rays that no refraction bent; a bent ray's normal wobbles through
``sinf``, which glibc and the PyTorch CPU kernel may round one ulp apart, so
those are held to ``assert_images_close`` after shading, with mat and cell
equal on >= 99.9% of rays. window_fwd to 1e-6, window_bwd's gradients to
1e-5 of their largest magnitude against autograd of ``window_plain``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raytracing_test_tpu_torch.config import RenderConfig, WorldConfig
from raytracing_test_tpu_torch.core.color import rgb_to_u64
from raytracing_test_tpu_torch.core.flatten import palette_arrays, scene_from_grid
from raytracing_test_tpu_torch.core.types import Block, Properties
from raytracing_test_tpu_torch.kernels import build
from raytracing_test_tpu_torch.kernels import fused_march as fm
from raytracing_test_tpu_torch.kernels import fused_window as fw
from raytracing_test_tpu_torch.render import fast
from raytracing_test_tpu_torch.render.camera import Camera, ray_directions
from raytracing_test_tpu_torch.render.diff import _pack_fields, diff_scene_from_grid
from raytracing_test_tpu_torch.worldgen import terrain
from tests.test_render_parity import assert_images_close

torch.set_num_threads(1)

W, H = 44, 38  # neither a multiple of the 8x4 warp tile
MODES = {"lean": (0, False, False), "materials": (1, True, False), "shadows": (2, False, True),
         "full": (3, True, True), "prox": (4, False, False)}

MARCH_HARNESS = r"""
#include "fused_march.cu"

using namespace rt;

// fused_march_kernel's work: work item j on thread j, its ray by ray_of
template <bool M, bool S, bool X>
static void run(const Params& P, const int* flags_s) {
  const int n_work = work_items(P);
  for (int j = 0; j < n_work; ++j) {
    const int i = ray_of(P, j);
    if (i >= 0) march_ray<M, S, X>(P, flags_s, i);
  }
}

extern "C" void host_march(const uint8_t* grid_enc, const uint8_t* prox_enc, int mode,
                           const int32_t* flags, int n_flags, int sx, int sy, int sz, int y_max,
                           int budget, int shadow_budget, float time_s, float sun_x,
                           float sun_y, float sun_z, const int32_t* cell0, const float* tmax0,
                           const float* dir0, const float* step0, const float* abs0,
                           const float* org0, int n, int width, int32_t* mat0,
                           int32_t* mat, int32_t* cell, int32_t* la, int32_t* refl,
                           int32_t* shad, int32_t* steps, float* dir, float* step, float* seg,
                           float* lt, float* cmod) {
  Params P{grid_enc, prox_enc, sx, sy, sz, y_max, budget, shadow_budget, time_s,
           {sun_x, sun_y, sun_z}, cell0, tmax0, dir0, step0, abs0, org0, n, width,
           mat0, mat, cell, la, refl, shad, steps, dir, step, seg, lt, cmod};
  int flags_s[kMaxMat];
  for (int j = 0; j < kMaxMat; ++j) flags_s[j] = j < n_flags ? flags[j] : 0;
  switch (mode) {
    case 0: run<false, false, false>(P, flags_s); break;
    case 1: run<true, false, false>(P, flags_s); break;
    case 2: run<false, true, false>(P, flags_s); break;
    case 3: run<true, true, false>(P, flags_s); break;
    default: run<false, false, true>(P, flags_s); break;
  }
}

extern "C" int host_work_items(int n, int width) {
  Params P{};
  P.n = n;
  P.width = width;
  return work_items(P);
}

extern "C" int host_ray_of(int n, int width, int j) {
  Params P{};
  P.n = n;
  P.width = width;
  return ray_of(P, j);
}
"""

WINDOW_HARNESS = r"""
#include "fused_window.cu"

static rtw::Params params(const float* field, int sx, int sy, int sz, const int32_t* cell,
                          const float* tmax, const int32_t* istep, const float* absd, int n,
                          int S, int shading, float sun_x, float sun_y, float sun_z) {
  rtw::Params P{reinterpret_cast<const float4*>(field), sx, sy, sz, n, S, shading,
                {sun_x, sun_y, sun_z}, cell, tmax, istep, absd};
  return P;
}

extern "C" void host_window_fwd(const float* field, int sx, int sy, int sz, const int32_t* cell,
                                const float* tmax, const int32_t* istep, const float* absd,
                                int n, int S, int shading, float sun_x, float sun_y,
                                float sun_z, float* surf, float* t_end, float* w_sum,
                                float* t_exp) {
  const rtw::Params P = params(field, sx, sy, sz, cell, tmax, istep, absd, n, S, shading,
                               sun_x, sun_y, sun_z);
  for (int i = 0; i < n; ++i) rtw::forward_ray(P, i, surf, t_end, w_sum, t_exp);
}

extern "C" void host_window_bwd(const float* field, int sx, int sy, int sz, const int32_t* cell,
                                const float* tmax, const int32_t* istep, const float* absd,
                                int n, int S, int shading, float sun_x, float sun_y,
                                float sun_z, const float* g_surf, const float* g_tend,
                                const float* surf, const float* t_end, float* grad,
                                float* g_tmax, float* g_abs) {
  const rtw::Params P = params(field, sx, sy, sz, cell, tmax, istep, absd, n, S, shading,
                               sun_x, sun_y, sun_z);
  for (int i = 0; i < n; ++i) {
    rtw::backward_ray(P, i, true, g_surf, g_tend, surf, t_end, grad, g_tmax, g_abs);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the CUDA sources needs it")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "march_harness.cpp").write_text(MARCH_HARNESS)
    (d / "window_harness.cpp").write_text(WINDOW_HARNESS)
    so = d / "libhost_kernels.so"
    cmd = [gxx, "-std=c++17", "-x", "c++", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
           "-I", str(build.CSRC_DIR), "-o", str(so),
           str(d / "march_harness.cpp"), str(d / "window_harness.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_march.argtypes = ([P, P, I, P, I] + [I] * 6 + [F] * 4 + [P] * 6 + [I] * 2
                               + [P] * 12)
    lib.host_march.restype = None
    lib.host_work_items.argtypes = [I, I]
    lib.host_work_items.restype = I
    lib.host_ray_of.argtypes = [I, I, I]
    lib.host_ray_of.restype = I
    rays = [P, I, I, I] + [P] * 4 + [I] * 3 + [F] * 3
    lib.host_window_fwd.argtypes = rays + [P] * 4
    lib.host_window_fwd.restype = None
    lib.host_window_bwd.argtypes = rays + [P] * 7
    lib.host_window_bwd.restype = None
    return lib


@pytest.fixture(scope="module")
def worlds():
    """A small terrain world, and the same world with a water pool dug into
    its surface, a mirror wall and a glass slab (water time 1.2)."""
    cfg = WorldConfig(width=48, length=48, grid_shape=(64, 64, 64))
    grid, pal = terrain.gen_world_grid(cfg)
    scene = scene_from_grid(grid, pal, "cpu")
    hm = terrain.heightmap(cfg).astype(int)
    water = pal.id_for(terrain.WATER)
    mirror = pal.id_for(Block(int(Properties.REFLECTIVE), int(rgb_to_u64(255, 255, 255)), 0.94))
    glass = pal.id_for(Block(int(Properties.REFRACTIVE), int(rgb_to_u64(0, 0, 0)), 1.5))
    wgrid = grid.copy()
    for x in range(12, 36):
        for z in range(12, 36):
            wgrid[x, hm[x, z] - 3:hm[x, z] + 1, z] = water
    wgrid[14:30, 40:48, 38] = mirror
    wgrid[38, 38:46, 16:26] = glass
    wscene = scene_from_grid(wgrid, pal, "cpu")
    views = {"terrain": (scene, (24.0, 45.0, -8.0), (0.25, -0.65, 0.9), 0.0),
             "water": (wscene, (2.0, 48.0, 2.0), (0.6, -0.3, 0.6), 1.2)}
    return grid, pal, views


def _state(pos, dirn):
    cam = Camera(pos=torch.tensor(pos), dir=torch.tensor(dirn))
    dirs = ray_directions(cam, W, H)
    return fast._init_state(cam.pos, dirs, torch.ones(dirs.shape[0]))


def _host_march(lib, scene, s, rcfg, time_s, mode, width):
    n = s.cell.shape[0]
    out = {k: torch.empty((n, 3) if k in ("cell", "dir", "step", "seg_origin", "color_mod")
                          else (n,), dtype=torch.float32 if k in ("dir", "step", "seg_origin",
                                                                  "lt", "color_mod")
                          else torch.int32)
           for k in ("mat0", "mat", "cell", "la", "refl", "shad", "steps", "dir", "step",
                     "seg_origin", "lt", "color_mod")}
    prox = scene.prox_enc if mode == 4 else scene.grid_enc
    sun = fast.sun_unit(rcfg.sun_dir)
    Sx, Sy, Sz = scene.shape3
    lib.host_march(scene.grid_enc.data_ptr(), prox.data_ptr(), mode, scene.flags.data_ptr(),
                   scene.flags.shape[0], Sx, Sy, Sz, int(scene.y_max), rcfg.max_steps,
                   rcfg.shadow_steps, float(time_s), *[float(v) for v in sun],
                   *[t.data_ptr() for t in (s.cell, s.tmax, s.dir, s.step, s.abs_delta,
                                            s.seg_origin)],
                   n, width, *[t.data_ptr() for t in out.values()])
    out["refl"] = out["refl"] != 0
    out["shad"] = out["shad"] != 0
    return out


@pytest.mark.parametrize("order", ["tiles", "natural"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("view", ["terrain", "water"])
def test_host_march_matches_plain_version(host_lib, worlds, view, mode, order):
    _, _, views = worlds
    scene, pos, dirn, time_s = views[view]
    code, mat_on, shadows_on = MODES[mode]
    rcfg = RenderConfig(width=W, height=H, max_steps=150, shadow_steps=40,
                        enable_materials=mat_on, enable_shadows=shadows_on)
    s = _state(pos, dirn)
    got = _host_march(host_lib, scene, s, rcfg, time_s, code, W if order == "tiles" else 0)
    want = fm.fused_march_plain(scene, s, rcfg, time_s, prox=mode == "prox")
    assert bool((want["mat"] != 0).any())
    bent = (want["dir"].abs() != s.dir.abs()).any(dim=1)  # refracted (reflection flips signs)
    if view == "water" and mat_on:
        assert bool(want["refl"].any()) and bool(bent.any())
    for k, w in want.items():
        g = got[k]
        if w.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        same = (g == w).reshape(g.shape[0], -1).all(dim=1)
        assert bool(same[~bent].all()), f"{k} differs on {int((~same[~bent]).sum())} rays"
    if bool(bent.any()):
        cg, _ = fm.shade_outputs(scene, got, rcfg)
        cw, _ = fm.shade_outputs(scene, want, rcfg)
        assert_images_close(cg.numpy(), cw.numpy())
        assert float((got["mat"] == want["mat"]).float().mean()) >= 0.999
        assert float((got["cell"] == want["cell"]).all(dim=1).float().mean()) >= 0.999


@pytest.mark.parametrize("size", [(44, 38), (8, 4), (13, 7), (1, 5), (64, 64)])
def test_host_tile_map_is_a_permutation(host_lib, size):
    w, h = size
    n = w * h
    items = host_lib.host_work_items(n, w)
    rays = np.array([host_lib.host_ray_of(n, w, j) for j in range(items)])
    assert items % 32 == 0
    np.testing.assert_array_equal(np.sort(rays[rays >= 0]), np.arange(n))
    np.testing.assert_array_equal(rays, fm.tile_order(w, h).numpy())
    natural = np.array([host_lib.host_ray_of(n, 0, j) for j in range(n + 3)])
    np.testing.assert_array_equal(natural, np.r_[np.arange(n), [-1] * 3])


@pytest.mark.parametrize("shading", [False, True])
def test_host_window_matches_plain_version(host_lib, worlds, shading):
    grid, pal, views = worlds
    scene, pos, dirn, _ = views["terrain"]
    ds = diff_scene_from_grid(grid, palette_arrays(pal)[0], "cpu", solid_density=50.0)
    field = _pack_fields(ds).detach().contiguous()
    shape3 = tuple(ds.shape3)
    cam = Camera(pos=torch.tensor(pos), dir=torch.tensor(dirn))
    dirs = ray_directions(cam, W, H)
    seed = fm.seed_depth_fused(scene, cam.pos, dirs, None)
    _, _, cell, tmax, istep, absd = fw.window_inputs(shape3, cam.pos, dirs, seed)
    n, S = cell.shape[0], 24
    sun = fast.sun_unit((2.0, 1.0, 4.0))
    rays = [field.data_ptr(), *shape3, cell.data_ptr(), tmax.data_ptr(), istep.data_ptr(),
            absd.data_ptr(), n, S, int(shading), *[float(v) for v in sun]]

    surf, t_end, w_sum, t_exp = torch.empty(n, 3), torch.empty(n), torch.empty(n), torch.empty(n)
    host_lib.host_window_fwd(*rays, surf.data_ptr(), t_end.data_ptr(), w_sum.data_ptr(),
                             t_exp.data_ptr())
    leaves = [t.detach().clone().requires_grad_(True) for t in (field, tmax, absd)]
    want = fw.window_plain(leaves[0], cell, leaves[1], istep, leaves[2], shape3, sun, S, shading)
    for g, w in zip((surf, t_end, w_sum, t_exp), want):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), rtol=0, atol=1e-6)
    assert float(want[3].detach().abs().max()) > 0

    rng = np.random.default_rng(0)
    g_surf = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    g_tend = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    grad = torch.zeros_like(field)
    g_tmax, g_abs = torch.empty(n, 3), torch.empty(n, 3)
    host_lib.host_window_bwd(*rays, g_surf.data_ptr(), g_tend.data_ptr(), surf.data_ptr(),
                             t_end.data_ptr(), grad.data_ptr(), g_tmax.data_ptr(),
                             g_abs.data_ptr())
    plain = torch.autograd.grad(want[:2], leaves, (g_surf, g_tend))
    for name, g, w in zip(("field", "tmax", "abs_delta"), (grad, g_tmax, g_abs), plain):
        scale = float(w.abs().max())
        assert scale > 0, name
        err = float((g - w).abs().max()) / scale
        assert err <= 1e-5, f"{name} gradient: {err:.3e} max-scaled"
