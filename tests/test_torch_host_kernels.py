"""PyTorch port: the per-ray code of the CUDA kernels, built as host C++ with
g++, against the kernels' plain PyTorch versions.

``csrc/fused_march.cu``, ``csrc/fused_window.cu`` and ``csrc/brick_march.cu``
keep their per-ray code in plain C++ behind ``RT_DEV``. A harness (below)
includes each source and calls the same entry points the CUDA kernels call:
the march's ``ray_of`` work order (8x4 pixel tiles of an image, or natural
order) and its ``march_ray`` in each compile-time mode; the window's
``forward_ray`` (generic and unrolled), its split forward (each lane's
``load_share``, then ``composite_share`` in lane order, the running sums
passed on as the device's shuffles pass them) and ``backward_ray`` (the
backward's warp reduction and atomics are device-only: the host adds each
sample's row with ``+=``); and brick_advance's in-place ``advance_in_place``
on every lane, with the launch function's arguments.
The library is built inside the tests, never at import; without g++ they
skip.

Tolerances: the lean and prox marches exactly. The full march exactly on
rays that no refraction bent; a bent ray's normal wobbles through
``sinf``, which glibc and the PyTorch CPU kernel may round one ulp apart, so
those are held to ``assert_images_close`` after shading, with mat and cell
equal on >= 99.9% of rays. window_fwd to 1e-6, window_bwd's gradients to
1e-5 of their largest magnitude against autograd of ``window_plain``; the
forward's paths equal to each other to the bit. brick_advance exactly.
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
from raytracing_test_tpu_torch.kernels import brick_kernels as bk
from raytracing_test_tpu_torch.kernels import build
from raytracing_test_tpu_torch.kernels import fused_march as fm
from raytracing_test_tpu_torch.kernels import fused_window as fw
from raytracing_test_tpu_torch.render import bricks, fast
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

template <int kS, int kK>
static void split_fwd(const rtw::Params& P, float* surf, float* t_end, float* w_sum,
                      float* t_exp) {
  constexpr int kC = kS / kK;
  for (int i = 0; i < P.n; ++i) {
    rtw::Acc a = rtw::acc_start();
    for (int sub = 0; sub < kK; ++sub) {  // the ray's lanes in turn, the sums passed on
      rtw::Share<kC> sh;
      rtw::load_share<kC>(P, i, sub * kC, sh);
      rtw::composite_share<kC>(P, sh, a);
    }
    rtw::write_out(a, i, surf, t_end, w_sum, t_exp);
  }
}

// path 0: the generic loop, 1: unrolled for 24 samples, 2 + k: split over
// 1, 2, 4 or 8 lanes a ray (k = 0..3); the unrolled and split paths need S 24
extern "C" int host_window_fwd_path(int path, const float* field, int sx, int sy, int sz,
                                    const int32_t* cell, const float* tmax,
                                    const int32_t* istep, const float* absd, int n, int S,
                                    int shading, float sun_x, float sun_y, float sun_z,
                                    float* surf, float* t_end, float* w_sum, float* t_exp) {
  const rtw::Params P = params(field, sx, sy, sz, cell, tmax, istep, absd, n, S, shading,
                               sun_x, sun_y, sun_z);
  if (path > 0 && S != 24) return 1;
  switch (path) {
    case 0:
      for (int i = 0; i < n; ++i) rtw::forward_ray<0>(P, i, surf, t_end, w_sum, t_exp);
      break;
    case 1:
      for (int i = 0; i < n; ++i) rtw::forward_ray<24>(P, i, surf, t_end, w_sum, t_exp);
      break;
    case 2: split_fwd<24, 1>(P, surf, t_end, w_sum, t_exp); break;
    case 3: split_fwd<24, 2>(P, surf, t_end, w_sum, t_exp); break;
    case 4: split_fwd<24, 4>(P, surf, t_end, w_sum, t_exp); break;
    case 5: split_fwd<24, 8>(P, surf, t_end, w_sum, t_exp); break;
    default: return 1;
  }
  return 0;
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


BRICK_HARNESS = r"""
#include "brick_march.cu"

// brick_advance_launch's work on the host, with its arguments: thread i of
// the launch advances lane i in place
extern "C" int host_brick_advance(const void* dist, int sx, int sy, int sz, int shift,
                                  int y_max, int budget, void* cell, void* tmax,
                                  const void* step, const void* abs_delta, void* mat,
                                  void* done, void* lt, void* la, void* steps, int n,
                                  void* stream) {
  (void)stream;
  rb::State S{static_cast<const int32_t*>(cell), static_cast<const float*>(tmax),
              static_cast<const float*>(step), static_cast<const float*>(abs_delta),
              static_cast<const int32_t*>(mat), static_cast<const uint8_t*>(done),
              static_cast<const float*>(lt), static_cast<const int32_t*>(la),
              static_cast<const int32_t*>(steps)};
  rb::Out O{static_cast<int32_t*>(mat), static_cast<int32_t*>(cell),
            static_cast<float*>(tmax), static_cast<float*>(lt), static_cast<int32_t*>(la),
            static_cast<int32_t*>(steps), static_cast<uint8_t*>(done)};
  rb::Grid G{sx, sy, sz, shift, sy >> shift, sz >> shift};
  for (int i = 0; i < n; ++i) {
    rb::advance_in_place(S, O, static_cast<const uint8_t*>(dist), G, y_max, budget, i);
  }
  return 0;
}

// brick_fine_launch's work on the host, with its arguments: thread j of the
// launch runs lane i = lanes[j] (or j) in place; an event lane is appended to
// list_out in thread order (the card's order differs from run to run)
extern "C" int host_brick_fine(const void* brick_mat, const void* luts, int sx, int sy, int sz,
                               int shift, int budget, void* cell, void* tmax, const void* step,
                               const void* abs_delta, void* mat, void* done, void* lt, void* la,
                               void* steps, const void* blin, void* evt, const void* lanes, int n,
                               void* list_out, void* count_out, void* count_clear, void* stream) {
  (void)stream;
  rb::State S{static_cast<const int32_t*>(cell), static_cast<const float*>(tmax),
              static_cast<const float*>(step), static_cast<const float*>(abs_delta),
              static_cast<const int32_t*>(mat), static_cast<const uint8_t*>(done),
              static_cast<const float*>(lt), static_cast<const int32_t*>(la),
              static_cast<const int32_t*>(steps)};
  rb::Out O{static_cast<int32_t*>(mat), static_cast<int32_t*>(cell),
            static_cast<float*>(tmax), static_cast<float*>(lt), static_cast<int32_t*>(la),
            static_cast<int32_t*>(steps), static_cast<uint8_t*>(done)};
  rb::Grid G{sx, sy, sz, shift, sy >> shift, sz >> shift};
  const auto* bmat = static_cast<const uint8_t*>(brick_mat);
  const auto* lut = static_cast<const int32_t*>(luts);
  const auto* bl = static_cast<const int32_t*>(blin);
  if (count_clear != nullptr) *static_cast<int32_t*>(count_clear) = 0;
  for (int j = 0; j < n; ++j) {
    const int i = lanes != nullptr ? static_cast<const int32_t*>(lanes)[j] : j;
    const bool ev = rb::fine_in_place(S, O, bmat, lut, bl, G, budget, i);
    static_cast<uint8_t*>(evt)[i] = ev ? 1 : 0;
    if (ev && list_out != nullptr) {
      int32_t* c = static_cast<int32_t*>(count_out);
      static_cast<int32_t*>(list_out)[(*c)++] = i;
    }
  }
  return 0;
}

extern "C" const char* kernel_error_string(int err) { return err ? "host error" : "no error"; }
"""


def build_host_library(d, harnesses):
    """g++ the harnesses ({file stem: source}) into one shared library in
    directory ``d``, loaded; skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the CUDA sources needs it")
    files = []
    for stem, code in harnesses.items():
        (d / f"{stem}.cpp").write_text(code)
        files.append(str(d / f"{stem}.cpp"))
    so = d / "libhost_kernels.so"
    cmd = [gxx, "-std=c++17", "-x", "c++", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
           "-I", str(build.CSRC_DIR), "-o", str(so), *files]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def declare_brick_advance(lib):
    """The argument types of host_brick_advance and host_brick_fine:
    brick_advance_launch's and brick_fine_launch's (kernels/build.py)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_brick_advance.argtypes = [P] + [I] * 6 + [P] * 9 + [I, P]
    lib.host_brick_advance.restype = I
    lib.host_brick_fine.argtypes = [P, P] + [I] * 5 + [P] * 9 + [P, P, P, I] + [P] * 4
    lib.host_brick_fine.restype = I
    lib.kernel_error_string.argtypes = [I]
    lib.kernel_error_string.restype = ctypes.c_char_p


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host_library(tmp_path_factory.mktemp("host_kernels"),
                             {"march_harness": MARCH_HARNESS, "window_harness": WINDOW_HARNESS,
                              "brick_harness": BRICK_HARNESS})
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
    lib.host_window_fwd_path.argtypes = [I] + rays + [P] * 4
    lib.host_window_fwd_path.restype = I
    declare_brick_advance(lib)
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


@pytest.fixture(scope="module")
def window_rays(worlds):
    """(field, shape3, cell, tmax, istep, abs_delta) of the terrain view's
    windows, seeded by the march."""
    grid, pal, views = worlds
    scene, pos, dirn, _ = views["terrain"]
    ds = diff_scene_from_grid(grid, palette_arrays(pal)[0], "cpu", solid_density=50.0)
    field = _pack_fields(ds).detach().contiguous()
    shape3 = tuple(ds.shape3)
    cam = Camera(pos=torch.tensor(pos), dir=torch.tensor(dirn))
    dirs = ray_directions(cam, W, H)
    seed = fm.seed_depth_fused(scene, cam.pos, dirs, None)
    _, _, cell, tmax, istep, absd = fw.window_inputs(shape3, cam.pos, dirs, seed)
    return field, shape3, cell, tmax, istep, absd


@pytest.mark.parametrize("shading", [False, True])
def test_host_window_matches_plain_version(host_lib, window_rays, shading):
    field, shape3, cell, tmax, istep, absd = window_rays
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


FWD_PATHS = {"generic": 0, "unrolled": 1, "split1": 2, "split2": 3, "split4": 4, "split8": 5}


@pytest.mark.parametrize("path", list(FWD_PATHS))
def test_host_window_fwd_paths_match_plain_version(host_lib, window_rays, path):
    """Each forward path (the unrolled loop, and the split forward with 1,
    2, 4 or 8 lanes a ray: each lane's share loaded ahead, then composited
    in lane order) equal to the generic loop to the bit, and within 1e-6 of
    window_plain."""
    field, shape3, cell, tmax, istep, absd = window_rays
    n, S = cell.shape[0], 24
    sun = fast.sun_unit((2.0, 1.0, 4.0))
    for shading in (False, True):
        rays = [field.data_ptr(), *shape3, cell.data_ptr(), tmax.data_ptr(), istep.data_ptr(),
                absd.data_ptr(), n, S, int(shading), *[float(v) for v in sun]]
        outs = {}
        for p in ("generic", path):
            o = (torch.empty(n, 3), torch.empty(n), torch.empty(n), torch.empty(n))
            assert host_lib.host_window_fwd_path(FWD_PATHS[p], *rays,
                                                 *[t.data_ptr() for t in o]) == 0
            outs[p] = o
        with torch.no_grad():
            want = fw.window_plain(field, cell, tmax, istep, absd, shape3, sun, S, shading)
        for g, base, w in zip(outs[path], outs["generic"], want):
            assert torch.equal(g.view(torch.int32), base.view(torch.int32))
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def brick_rounds(worlds):
    """Each view's primary march in rounds 1 to 3, from the plain brick
    path: at brick_advance's input (after the round's fine phase), and at
    brick_fine's (the round's start: state, blin, time)."""
    _, _, views = worlds
    rcfg = RenderConfig(width=W, height=H, max_steps=150, shadow_steps=40)
    out, fine_in = {}, {}
    for view, (scene, pos, dirn, time_s) in views.items():
        s, _, _ = fast.start_cell(scene, _state(pos, dirn))
        for r in (1, 2, 3):
            blin = bricks.occupied_brick(scene, scene.brick_dist, s)
            fine_in[view, r] = (scene, s, blin, time_s)
            s = bricks._fine_loop(scene, s, blin, rcfg, rcfg.max_steps, False, time_s)
            out[view, r] = (scene, s)
            s = bricks._brick_loop(scene, scene.brick_dist, s, rcfg.max_steps)
    return rcfg, out, fine_in


def _poison_done(s, lanes=None):
    """``s`` with the fields the brick kernels write set to sentinels on the
    done lanes, or on ``lanes`` (which they must leave as they are: the
    plain versions do)."""
    d = s.done if lanes is None else lanes
    sentinel = {"cell": 987654, "tmax": float("nan"), "mat": -5, "last_t": -1.5,
                "last_axis": 7, "steps": -3}
    out = {}
    for f, v in sentinel.items():
        t = getattr(s, f)
        mask = d[:, None].expand_as(t) if t.ndim == 2 else d
        out[f] = torch.where(mask, torch.full_like(t, v), t)
    return s._replace(**out)


def _host_advance(lib, scene, s, budget):
    """brick_advance's host build in place on a writable copy of ``s``."""
    got = bricks.writable(s)
    Sx, Sy, Sz = scene.shape3
    err = lib.host_brick_advance(
        scene.brick_dist.data_ptr(), Sx, Sy, Sz, scene.brick_shift, int(scene.y_max), budget,
        got.cell.data_ptr(), got.tmax.data_ptr(), s.step.data_ptr(), s.abs_delta.data_ptr(),
        got.mat.data_ptr(), got.done.data_ptr(), got.last_t.data_ptr(),
        got.last_axis.data_ptr(), got.steps.data_ptr(), s.cell.shape[0], None)
    assert err == 0
    return got


def test_host_brick_advance_exit_rules(host_lib):
    """Lanes standing in the occupied brick above y_max (moving up: done
    with mat 0; moving down, or one cell lower: waiting), and outside the
    window (moving away: done; moving back: advancing), each against
    brick_advance_plain to the bit."""
    from raytracing_test_tpu_torch.core.tree import Palette

    grid = np.zeros((16, 16, 16), np.uint8)
    grid[1, 8, 1] = 1  # y_max 9; the brick of cells y 8..11 is occupied
    pal = Palette()
    pal.id_for(Block(0, 5))
    scene = scene_from_grid(grid, pal, "cpu")
    cells = [(1, 10, 1), (1, 10, 1), (1, 9, 1), (-3, 5, 5), (-3, 5, 5), (20, 30, 2)]
    steps = [(1, 1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1), (1, 1, 1), (-1, -1, 1)]
    n = len(cells)
    f32 = torch.float32
    s = fast._init_state(torch.zeros(3), torch.ones(n, 3), torch.ones(n))._replace(
        cell=torch.tensor(cells, dtype=torch.int32), step=torch.tensor(steps, dtype=f32),
        abs_delta=torch.tensor([[3.25, 1.25, 2.0]] * n, dtype=f32),
        tmax=torch.tensor([[0.5, 0.75, 0.625]] * n, dtype=f32),
        mat=torch.full((n,), 3, dtype=torch.int32),
        steps=torch.full((n,), 7, dtype=torch.int32), done=torch.zeros(n, dtype=torch.bool))
    want = bk.brick_advance_plain(scene, scene.brick_dist, s, 150)
    got = _host_advance(host_lib, scene, s, 150)
    for f in bricks.HOOK_WRITES:
        g, w = getattr(got, f), getattr(want, f)
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f
    assert want.done.tolist()[:4] == [True, False, False, True]
    assert want.mat.tolist()[:3] == [0, 3, 3]
    assert torch.equal(want.cell[1:3], s.cell[1:3])  # waiting
    assert not torch.equal(want.cell[4], s.cell[4])  # back into the window


@pytest.mark.parametrize("rnd", [1, 3])
@pytest.mark.parametrize("view", ["terrain", "water"])
def test_host_brick_advance_matches_plain_version(host_lib, brick_rounds, view, rnd):
    """brick_advance's per-lane code in place against brick_advance_plain to
    the bit on a round's input; the done lanes (their fields set to
    sentinels) and the lanes waiting in an occupied brick come back as they
    went in."""
    rcfg, states, _ = brick_rounds
    scene, s = states[view, rnd]
    s = _poison_done(s)
    n = s.cell.shape[0]
    want = bk.brick_advance_plain(scene, scene.brick_dist, s, rcfg.max_steps)
    got = _host_advance(host_lib, scene, s, rcfg.max_steps)
    same_lane = torch.ones(n, dtype=torch.bool)
    for f in bricks.HOOK_WRITES:
        g, w, s_in = getattr(got, f), getattr(want, f), getattr(s, f)
        if g.is_floating_point():
            g, w, s_in = (t.view(torch.int32) for t in (g, w, s_in))
        n_bad = int((g != w).reshape(n, -1).any(dim=1).sum())
        assert torch.equal(g, w), f"{f} differs on {n_bad} lanes"
        same_lane &= (g == s_in).reshape(n, -1).all(dim=1)
    live = ~s.done
    moved = live & (want.steps != s.steps)
    waiting = live & same_lane
    assert bool(same_lane[s.done].all())
    assert int(moved.sum()) > 0
    if rnd > 1:  # a later round has lanes of every kind
        assert int(s.done.sum()) > 0 and int(waiting.sum()) > 0


@pytest.fixture
def host_fine(host_lib, monkeypatch):
    """``run(scene, s, blin, luts, budget, evt, lanes, k, list_out, counts,
    w)``: brick_fine's host build with the arguments the wrapper builds
    (``bk._fine_args``), in place on ``s`` and ``evt``."""
    monkeypatch.setattr(bk, "_stream", lambda dev: None)

    def run(scene, s, blin, luts, budget, evt, lanes=None, k=0, list_out=None, counts=None, w=0):
        args, _ = bk._fine_args(scene, s, blin, luts, budget, evt, lanes, k, list_out, counts, w)
        assert host_lib.host_brick_fine(*args) == 0

    return run


def _assert_lanes_equal(got, want, evt_got=None, evt_want=None):
    """Every field the kernels write equal to the bit (and evt equal)."""
    n = got.cell.shape[0]
    for f in bricks.HOOK_WRITES:
        g, w = getattr(got, f), getattr(want, f)
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        n_bad = int((g != w).reshape(n, -1).any(dim=1).sum())
        assert torch.equal(g, w), f"{f} differs on {n_bad} lanes"
    if evt_got is not None:
        assert torch.equal(evt_got, evt_want), f"evt differs on {int((evt_got != evt_want).sum())}"


@pytest.mark.parametrize("rnd", [2, 3])  # round 1 starts in the air: no lane has a brick
@pytest.mark.parametrize("view", ["terrain", "water"])
def test_host_brick_fine_matches_plain_version(host_fine, brick_rounds, view, rnd):
    """brick_fine's per-lane code in place over all lanes against
    brick_fine_plain to the bit on a round's input; the done lanes and the lanes
    without a brick (their fields set to sentinels), and lanes given a brick
    they do not stand in, come back untouched, with evt 0."""
    rcfg, _, fine_in = brick_rounds
    scene, s, blin, _ = fine_in[view, rnd]
    assert scene.brick_shift == 2
    # at a round's start every live lane stands in its brick: take some away
    lane = torch.arange(blin.shape[0])
    live = ~s.done
    blin = torch.where(live & (lane % 7 == 0), torch.full_like(blin, -1), blin)
    elsewhere = live & (lane % 7 == 1)
    blin = torch.where(elsewhere, (blin + 1) % scene.brick_mat.shape[0], blin)
    idle = s.done | (blin < 0)
    s = _poison_done(s, idle)
    luts = bk._prop_luts(scene, False, True)
    want, evt_want = bk.brick_fine_plain(scene, s, blin, luts, rcfg.max_steps)
    got = bricks.writable(s)
    evt = torch.ones_like(s.done)  # every launched lane writes its evt
    host_fine(scene, got, blin, luts, rcfg.max_steps, evt)
    _assert_lanes_equal(got, want, evt, evt_want)
    untouched = idle | elsewhere
    for f in bricks.HOOK_WRITES:  # those lanes as they went in, sentinels and all
        g, w = getattr(got, f)[untouched], getattr(s, f)[untouched]
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f
    assert not bool(evt[untouched].any())
    assert int((want.steps != s.steps).sum()) > 0
    assert int((~s.done & (blin < 0)).sum()) > 0 and bool(elsewhere.any())
    assert int(s.done.sum()) > 0 or (view, rnd) == ("terrain", 2)  # every ray still marches there


def _glue_input(scene, s, blin, luts, rcfg, time_s, run):
    """A full launch of the host build with its event list, then the
    material glue on its event lanes: (glue output, evt, list, count)."""
    n = s.cell.shape[0]
    s = bricks.writable(s)
    evt = torch.empty(n, dtype=torch.bool)
    lanes, counts = torch.full((n,), -1, dtype=torch.int32), torch.full((2,), 99, dtype=torch.int32)
    counts[0] = 0
    run(scene, s, blin, luts, rcfg.max_steps, evt, list_out=lanes, counts=counts, w=0)
    k = int(counts[0])
    assert int(counts[1]) == 0  # the other list's count, zeroed
    assert torch.equal(torch.sort(lanes[:k]).values, torch.nonzero(evt).flatten().to(torch.int32))
    return bk.material_glue(scene, s, evt, rcfg, rcfg.max_steps, time_s), evt, lanes, k


@pytest.mark.parametrize("rnd", [2, 3])
def test_host_brick_fine_list_launch_on_a_glue_pass(host_fine, brick_rounds, rnd):
    """A glue pass: the full launch lists its event lanes, material_glue
    (material_step and one DDA step) runs on them, then the host build runs
    over the list only, in place: every one of the N lanes equal to the bit
    to brick_fine_plain over all lanes on the glue's output, evt too (so no
    unlisted lane changed), its own events listed in the other list."""
    rcfg, _, fine_in = brick_rounds
    scene, s, blin, time_s = fine_in["water", rnd]
    luts = bk._prop_luts(scene, False, True)
    s2, evt, lanes, k = _glue_input(scene, s, blin, luts, rcfg, time_s, host_fine)
    assert k > 0
    want, evt_want = bk.brick_fine_plain(scene, s2, blin, luts, rcfg.max_steps)
    got = bricks.writable(s2)
    nxt, counts = torch.full((k,), -1, dtype=torch.int32), torch.tensor([7, 0], dtype=torch.int32)
    host_fine(scene, got, blin, luts, rcfg.max_steps, evt, lanes, k, nxt, counts, 1)
    _assert_lanes_equal(got, want, evt, evt_want)
    k2 = int(counts[1])
    assert int(counts[0]) == 0 and k2 == int(evt_want.sum())
    assert torch.equal(torch.sort(nxt[:k2]).values, torch.nonzero(evt_want).flatten().to(torch.int32))
    moved = (want.steps != s2.steps) | evt_want
    listed = torch.zeros_like(evt)
    listed[lanes[:k].long()] = True
    assert bool(moved.any()) and not bool((moved & ~listed).any())


class _HostBrickLibrary:
    """The brick_march library's launch functions from the host build."""

    def __init__(self, lib):
        self.brick_advance_launch = lib.host_brick_advance
        self.brick_fine_launch = lib.host_brick_fine
        self.kernel_error_string = lib.kernel_error_string


@pytest.mark.parametrize("view", ["terrain", "water"])
def test_host_kernels_drive_the_brick_frame(host_lib, worlds, monkeypatch, view):
    """render_rays_bricks_pallas on the wrappers' kernel path with the host
    build as the library (in place, the glue passes over the listed event
    lanes, the counts read back): the frame and its aux equal to the bit to
    the plain brick path's; the caller's start state is not written."""
    from raytracing_test_tpu_torch import kernels

    _, _, views = worlds
    scene, pos, dirn, time_s = views[view]
    rcfg = RenderConfig(width=W, height=H, max_steps=150, shadow_steps=40)
    cam = Camera(pos=torch.tensor(pos), dir=torch.tensor(dirn))
    dirs = ray_directions(cam, W, H)
    want_rgb, want_aux = bricks.render_rays_bricks(scene, cam.pos, dirs, rcfg, time_s=time_s)

    monkeypatch.setattr(bk, "_device", lambda scene, st, what: torch.device("cuda"))
    monkeypatch.setattr(bk, "_stream", lambda dev: None)
    monkeypatch.setattr(kernels.build, "_LIBS", {"brick_march": _HostBrickLibrary(host_lib)})
    monkeypatch.setattr(bk, "LAUNCHES_FINE", 0)
    monkeypatch.setattr(bk, "LAUNCHES_ADVANCE", 0)
    s0 = fast._init_state(cam.pos, dirs, torch.ones(dirs.shape[0]))
    start, _, _ = fast.start_cell(scene, s0)
    before = {f: getattr(start, f).clone() for f in bricks.HOOK_WRITES}
    glue = []
    real_glue = bk.material_glue
    monkeypatch.setattr(bk, "material_glue", lambda *a: glue.append(int(a[2].sum())) or real_glue(*a))
    got_rgb, got_aux = bk.render_rays_bricks_pallas(scene, cam.pos, dirs, rcfg, time_s=time_s)
    assert torch.equal(got_rgb.view(torch.int32), want_rgb.view(torch.int32))
    assert got_aux.keys() == want_aux.keys()
    for key, w in want_aux.items():
        g = got_aux[key]
        if isinstance(w, torch.Tensor):
            assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                               w.view(torch.int32) if w.is_floating_point() else w), key
        else:
            assert g == w, key
    bricks.brick_march(scene, start, rcfg, 150, time_s=time_s, fine_loop=bk.fine_loop,
                       brick_loop=bk.advance_loop)
    for f in bricks.HOOK_WRITES:
        assert torch.equal(getattr(start, f), before[f]), f
    rounds = want_aux["march_rounds"]
    assert bk.LAUNCHES_FINE > rounds and bk.LAUNCHES_ADVANCE > rounds
    if view == "water":
        assert glue and max(glue) < dirs.shape[0]  # the glue passes ran on listed lanes
