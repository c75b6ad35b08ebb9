"""PyTorch port: the march's prox mode, the prox grid, the guided render and
the prox-seeded render against the JAX package.

On CPU tensors the march runs its plain version (``render/fast.py`` with
``prox=True``) and the window ``window_plain``. The prox march is held
against the reference's Pallas kernel in interpret mode
(``fused_march_call(prox_stop=True, interpret=True)``) on the 64^3 terrain
and cameras of tests/test_fused_window.py at 16x32, with and without start
points inside surface bricks: ``mat0``, ``mat``, ``cell``, ``steps`` and
``la`` equal, ``lt`` within 1e-5 (XLA's CPU jit contracts FMAs). The
guided render is held against the reference's
``render_rays_diff_guided(accum="scatter")`` to the window contract of
tests/test_torch_window.py, and the prox-seeded render against the port's
exact-seed guided render to the reference's own contract
(test_fused_window.py:608,622: rgb 2e-3, gradients 5e-3 max-scaled).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from raytracing_test_tpu.config import RenderConfig as JRenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.core.fused_tables import build_fused_tables
from raytracing_test_tpu.kernels import fused_march as jfm
from raytracing_test_tpu.render import diff as jdiff
from raytracing_test_tpu.render import fast as jfast
from raytracing_test_tpu.render.camera import Camera as JCamera, ray_directions as jrays
from raytracing_test_tpu.worldgen import terrain
from raytracing_test_tpu_torch.app import cli
from raytracing_test_tpu_torch.config import FitConfig, RenderConfig
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.kernels import fused_march as tfm
from raytracing_test_tpu_torch.kernels import fused_window as tfw
from raytracing_test_tpu_torch.parallel import sharding as tshard
from raytracing_test_tpu_torch.render import diff as tdiff
from raytracing_test_tpu_torch.render import fast as tfast

torch.set_num_threads(1)

H, W = 16, 32
MAX_STEPS = 96
# tests/test_fused_window.py:581 (prox seed) and :593 (guided prox)
CAMS = {"a": ((24.0, 50.0, 10.0), (0.3, -0.75, 0.55)),
        "b": ((10.0, 34.0, 10.0), (0.8, -0.12, 0.55))}
LEAN = dict(enable_materials=False, enable_shadows=False, max_steps=MAX_STEPS)


@pytest.fixture(scope="module")
def world():
    """The 64^3 terrain of tests/test_fused_window.py:537, in both packages."""
    grid, pal = terrain.gen_world_grid(WorldConfig(width=48, length=48, grid_shape=(64, 64, 64)))
    js = jflat.scene_from_grid(grid, pal)
    albedo = jflat.palette_arrays(pal)[0]
    return dict(grid=grid, js=js, ft=jfm.tables_for_scene(js),
                ts=tflat.scene_from_grid(grid, pal, "cpu"),
                jd=jdiff.diff_scene_from_grid(grid, albedo, solid_density=50.0),
                td=tdiff.diff_scene_from_grid(grid, albedo, "cpu", solid_density=50.0))


def _rays(cam):
    pos, d = CAMS[cam]
    jc = JCamera(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(d, jnp.float32))
    return np.array(jc.pos), np.array(jrays(jc, W, H))


@pytest.fixture(scope="module")
def jax_prox_march(world):
    """The reference's prox kernel in interpret mode, jitted once for 16x32 rays."""
    cfg = JRenderConfig(width=W, height=H, **LEAN)

    @jax.jit
    def run(origin, dirs, start_t):
        s = jfast._init_state(origin, dirs, jnp.ones(dirs.shape[0], jnp.float32), start_t=start_t)
        o = jfm.fused_march_call(world["js"], world["ft"], s, cfg, 0.0, True, prox_stop=True)
        return {k: o[k] for k in ("mat0", "mat", "cell", "steps", "la", "lt", "seg_origin")}

    return lambda o, d, st: {k: np.asarray(v) for k, v in run(o, d, st).items()}


def _exact_depth(scene, origin, dirs):
    """First-solid distance of each ray on the exact lean march (1e6 = sky)."""
    cfg = RenderConfig(width=W, height=H, **LEAN)
    return tfm.hit_seeds(scene, torch.from_numpy(origin), torch.from_numpy(dirs), cfg,
                         margin=0.0).numpy()


@pytest.mark.parametrize("case", ["a", "b", "a_in_brick", "b_in_brick"])
def test_prox_march_matches_reference_kernel(world, jax_prox_march, case):
    origin, dirs = _rays(case[0])
    start_t = np.zeros(H * W, np.float32)
    ts = world["ts"]
    if case.endswith("in_brick"):
        # start 1.5 before the exact hit: inside the surface brick, or just before it
        depth = _exact_depth(ts, origin, dirs)
        start_t = np.where(depth < 1e6, np.maximum(depth - 1.5, 0.0), 0.0).astype(np.float32)
        p = np.floor(origin[None, :] + start_t[:, None] * dirs).astype(np.int64)
        enc = ts.prox_enc.numpy()[p[:, 0], p[:, 1], p[:, 2]]
        assert (enc < 128).mean() > 0.3  # many start cells are stop cells
    want = jax_prox_march(jnp.asarray(origin), jnp.asarray(dirs), jnp.asarray(start_t))
    s = tfast._init_state(torch.from_numpy(origin), torch.from_numpy(dirs), torch.ones(H * W),
                          start_t=torch.from_numpy(start_t))
    got = tfm.fused_march_call(ts, s, RenderConfig(width=W, height=H, **LEAN), 0.0, prox=True)
    got = {k: v.numpy() for k, v in got.items()}
    c = np.clip(got["cell"], 0, 63)
    assert (ts.prox_enc.numpy()[c[:, 0], c[:, 1], c[:, 2]] == tflat.PROX_AIR).any()
    for k in ("mat0", "mat", "cell", "steps", "la"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("lt", "seg_origin"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_prox_seed_matches_reference_and_is_conservative(world):
    origin, dirs = _rays("a")
    want = np.asarray(jax.jit(lambda: jfm.seed_depth_fused(
        world["js"], world["ft"], origin, dirs, (H, W), margin=0.0, prox=True,
        interpret=True, max_steps=MAX_STEPS))())
    o, d = torch.from_numpy(origin), torch.from_numpy(dirs)
    got = tfm.seed_depth_fused(world["ts"], o, d, (H, W), margin=0.0, prox=True,
                               max_steps=MAX_STEPS).numpy()
    exact = tfm.seed_depth_fused(world["ts"], o, d, (H, W), margin=0.0,
                                 max_steps=MAX_STEPS).numpy()
    hit = want < 9.9e5
    assert hit.any()
    # no ray of this view is seeded at the far cap, where the port departs
    # from the reference (test_far_cap_seed_is_sky)
    np.testing.assert_array_equal(got < 9.9e5, hit)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(exact < 9.9e5, hit)
    assert (got[hit] <= exact[hit] + 1e-4).all()
    assert (got[hit] < exact[hit] - 1.0).any()  # the prox seed stops short of the surface


@pytest.mark.parametrize("prox", [False, True])
def test_far_cap_seed_is_sky(prox):
    """A ray seeded at the coarse pass's far cap (``seed_from_depth`` caps at
    1e5 when every coarse neighbour saw sky) starts 1e5 cells out, where the
    &1023 wrap puts its start cell inside the grid. A solid cell there makes
    a march hit; the port's seed calls the ray sky (1e6). The reference keeps
    that hit and seeds its window 1e5 cells out, on wrapped cells: a
    deliberate departure (ROADMAP.md, faults), which the JAX parity tests of
    the seeds do not meet on their views."""
    from raytracing_test_tpu.config import world_for_size
    from raytracing_test_tpu_torch.render import progressive as tprog

    _, pal = terrain.gen_world_grid(world_for_size(16))
    grid = np.zeros((16, 16, 16), np.uint8)
    grid[3, 4, 4] = 1
    scene = tflat.scene_from_grid(grid, pal, "cpu")
    # 355.5 + 1e5 = 98 * 1024 + 3.5: the start cell wraps to x = 3
    o = torch.tensor([[355.5, 4.5, 4.5], [0.5, 4.5, 4.5]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    start = torch.tensor([tprog.FAR_SEED, 0.0])
    cfg = RenderConfig(width=1, height=2, enable_materials=False, enable_shadows=False)
    _, aux = tfm.render_rays_fused(scene, o, d, cfg, start_t=start, prox=prox)
    assert aux["hit"].tolist() == [True, True]
    seed = tfm.hit_seeds(scene, o, d, cfg, margin=0.5, start_t=start, prox=prox)
    # the second ray starts in the brick (prox: seed 0); its cell is 2.5 ahead
    want_second = 0.0 if prox else 2.0
    np.testing.assert_allclose(seed.numpy(), [1e6, want_second], atol=1e-5)


def _meta_class(ft):
    """Brick classes from the reference's meta table (u16 >> 14)."""
    nb = int(np.prod(ft.bgrid))
    b = np.asarray(ft.meta).reshape(-1).astype(np.uint16)[: 2 * nb]
    return ((b[0::2] | (b[1::2] << 8)) >> 14).reshape(ft.bgrid)


def _boxes_hold_no_stop_cell(enc):
    """True when no licence box [c - r, c + r] (r = v - 129) of an air cell
    holds a stop cell (v < 128): counted with a summed-area table."""
    stop = (enc < 128).astype(np.int64)
    S = np.zeros(tuple(d + 1 for d in stop.shape), np.int64)
    S[1:, 1:, 1:] = stop.cumsum(0).cumsum(1).cumsum(2)
    air = np.argwhere(enc >= 128)
    r = enc[tuple(air.T)].astype(np.int64) - 129
    lo = np.maximum(air - r[:, None], 0)
    hi = np.minimum(air + r[:, None] + 1, np.asarray(stop.shape))
    x0, y0, z0 = lo.T
    x1, y1, z1 = hi.T
    n = (S[x1, y1, z1] - S[x0, y1, z1] - S[x1, y0, z1] - S[x1, y1, z0]
         + S[x0, y0, z1] + S[x0, y1, z0] + S[x1, y0, z0] - S[x0, y0, z0])
    return not n.any()


def test_prox_grid_stop_cells_are_the_occupied_bricks(world):
    enc = world["ts"].prox_enc.numpy()
    cls = _meta_class(build_fused_tables(world["grid"], np.asarray(world["js"].flags)))
    stop = np.broadcast_to((cls >= 1)[:, None, :, None, :, None],
                           tuple(x for d in cls.shape for x in (d, 8))).reshape(enc.shape)
    assert 0.01 < stop.mean() < 0.9
    np.testing.assert_array_equal(enc < 128, stop)
    g = np.asarray(world["js"].grid_enc)
    np.testing.assert_array_equal(np.where(g < 128, g, 127)[stop], enc[stop])
    assert _boxes_hold_no_stop_cell(enc)
    assert world["ts"].prox_enc is world["ts"].prox_enc  # built once per Scene


@settings(max_examples=25, deadline=None)
@given(st.tuples(*[st.sampled_from([8, 16, 24])] * 3), st.floats(0.0, 0.02),
       st.integers(0, 2**31 - 1))
def test_prox_grid_licences_on_random_grids(shape, fill, seed):
    """The licences of prox_enc are build_grid_enc's on the grid whose
    occupied 8^3 bricks are filled, and no box holds a stop cell."""
    rng = np.random.default_rng(seed)
    grid = np.where(rng.random(shape) < fill, rng.integers(1, 127, shape), 0).astype(np.uint8)
    enc = tflat.build_prox_enc(jflat.build_grid_enc(grid))
    assert _boxes_hold_no_stop_cell(enc)
    occ = grid.reshape(shape[0] // 8, 8, shape[1] // 8, 8, shape[2] // 8, 8).any(axis=(1, 3, 5))
    filled = np.where(np.broadcast_to(occ[:, None, :, None, :, None],
                                      occ.shape[:1] + (8,) + occ.shape[1:2] + (8,)
                                      + occ.shape[2:] + (8,)).reshape(shape), 1, 0)
    filled = np.where(grid > 0, grid, filled).astype(np.uint8)
    want = np.asarray(jflat.build_grid_enc(filled))
    air = want >= 128
    np.testing.assert_array_equal(enc[air], want[air])
    np.testing.assert_array_equal(enc[~air], np.where(grid > 0, grid, 127)[~air])


def test_prox_grid_and_mode_refuse_what_they_cannot_take(world):
    with pytest.raises(ValueError, match="divisible"):
        tflat.build_prox_enc(np.full((8, 12, 8), 129, np.uint8))
    g = np.full((8, 8, 8), 129, np.uint8)
    g[1, 2, 3] = 127
    with pytest.raises(ValueError, match="reserved"):
        tflat.build_prox_enc(g)
    origin, dirs = _rays("a")
    s = tfast._init_state(torch.from_numpy(origin), torch.from_numpy(dirs), torch.ones(H * W))
    with pytest.raises(ValueError, match="lean"):
        tfm.fused_march_call(world["ts"], s, RenderConfig(width=W, height=H), 0.0, prox=True)


def _jax_guided(world, cam, cot, **kw):
    origin, dirs = _rays(cam)

    def loss(ds):
        rgb = jdiff.render_rays_diff_guided(ds, world["js"], origin, dirs, num_steps=24,
                                            accum="scatter", **kw)
        return jnp.sum(rgb * cot), rgb

    (_, rgb), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(world["jd"])
    return np.asarray(rgb), np.asarray(g.density), np.asarray(g.albedo)


def _torch_grads(world, render, cam, cot=None):
    """rgb and the field gradients of sum(rgb * cot) (mean(rgb^2) without cot)."""
    origin, dirs = _rays(cam)
    d = world["td"].density.clone().requires_grad_(True)
    a = world["td"].albedo.clone().requires_grad_(True)
    out = render(tdiff.DiffScene(d, a), torch.from_numpy(origin), torch.from_numpy(dirs))
    rgb, aux = out if isinstance(out, tuple) else (out, None)
    loss = torch.mean(rgb ** 2) if cot is None else torch.sum(rgb * torch.from_numpy(cot))
    loss.backward()
    return rgb.detach().numpy(), d.grad.numpy(), a.grad.numpy(), aux


def _max_scaled(got, want, tol, name):
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    assert err <= tol, f"{name}: max-scaled error {err:.3e} > {tol}"


@pytest.mark.parametrize("case", ["fast_image", "bricks_sky_shading"])
def test_guided_render_matches_reference(world, case):
    kw = (dict(sky=False, image_hw=(H, W)) if case == "fast_image"
          else dict(sky=True, engine="bricks", shading=True))
    cam = "b" if case == "fast_image" else "a"
    cot = np.random.default_rng(7).normal(size=(H * W, 3)).astype(np.float32)
    want = _jax_guided(world, cam, cot, **kw)
    tkw = dict(kw, accum="fused")
    got = _torch_grads(world, lambda s, o, d: tdiff.render_rays_diff_guided(
        s, world["ts"], o, d, num_steps=24, **tkw), cam, cot)
    assert (want[0] > 0).any()
    # the two packages' seeds differ by up to an ulp (4e-6 here) on some rays:
    # their hit distances sum in other orders. A window moves by up to
    # density x that shift, 50 x 4e-6 = 2e-4; the others match to 1e-5
    np.testing.assert_allclose(got[0], want[0], atol=2e-4)
    assert (np.abs(got[0] - want[0]).max(axis=1) <= 1e-5).mean() >= 0.97
    _max_scaled(got[1], want[1], 1e-4, "density")
    _max_scaled(got[2], want[2], 1e-4, "albedo")


def test_guided_render_options(world):
    """``window=False`` renders the blind scan from the guided seeds (the
    reference's route, :546-550), and refuses shading; unknown engines and
    accums are refused."""
    from raytracing_test_tpu_torch.render.progressive import guided_seeds

    origin, dirs = (torch.from_numpy(v) for v in _rays("a"))
    got = tdiff.render_rays_diff_guided(world["td"], world["ts"], origin, dirs, num_steps=32,
                                        window=False)
    seed = guided_seeds(tfm.render_rays_fused, world["ts"], origin, dirs, 3.0)
    assert (seed < tdiff.MISS_SEED_MIN).any()
    want = tdiff.render_rays_diff(world["td"], origin, dirs, num_steps=32, start_t=seed)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    with pytest.raises(ValueError, match="shading requires the window path"):
        tdiff.render_rays_diff_guided(world["td"], world["ts"], origin, dirs, window=False,
                                      shadow_steps=4)
    with pytest.raises(ValueError, match="engine"):
        tdiff.render_rays_diff_guided(None, None, None, None, engine="scan")
    with pytest.raises(ValueError, match="accum"):
        tdiff.render_rays_diff_guided(None, None, None, None, accum="sum")


@pytest.mark.parametrize("cam,patch_div,capacity", [("a", 1, 512), ("b", 64, 128)])
def test_guided_prox_matches_exact_seed_pipeline(world, cam, patch_div, capacity):
    """Camera a looks down steeply: a third of its rays stop in the air of a
    surface brick too far above the surface for the window, and are patched
    (all fit at patch_div 1). Camera b's windows all saturate: the port's
    window has no box escapes, the reference's patch reason on this view.

    Density gradients are held on the solid cells. An air cell's density
    gradient is nonzero wherever a window samples it, and the prox window
    starts up to a brick earlier than the exact one: the two pipelines cull
    other empty space, so their gradients there differ by design. The
    reference's own measure (tests/test_fused_window.py:622, skipped there
    without RTT_HEAVY_TESTS: every cell, scaled by the whole field's
    maximum) is printed; at the default sat_eps it reads 7.5 on camera a
    and 8.7e-2 on camera b, where no ray is patched, against 5e-3."""
    got = _torch_grads(world, lambda s, o, d: tdiff.render_rays_guided_prox(
        s, world["ts"], o, d, (H, W), patch_div=patch_div, return_aux=True), cam)
    aux = got[3]
    assert (aux["n_need"] > 0) == (cam == "a") and not aux["grads_dropped"], aux
    assert aux["patch_capacity"] == capacity and aux["n_escaped"] == 0
    ref = _torch_grads(world, lambda s, o, d: tdiff.render_rays_diff_guided(
        s, world["ts"], o, d, num_steps=24, sky=False, image_hw=(H, W)), cam)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-3)
    solid = world["grid"] > 0
    whole = np.abs(got[1] - ref[1]).max() / np.abs(ref[1]).max()
    print(f"camera {cam}: density gradient, every cell over the whole field's maximum {whole:.3e}")
    _max_scaled(got[1][solid], ref[1][solid], 5e-3, "density")
    _max_scaled(got[2], ref[2], 5e-3, "albedo")


@pytest.mark.parametrize("patch_div", [1, 64])
def test_guided_prox_bookkeeping_matches_reference(world, monkeypatch, patch_div):
    """The reference's ``render_rays_guided_prox`` itself, forward, on the
    port's seed and first window: its need mask, 8-ray groups, K8, kept rays,
    exact re-march (``render_rays_fast``) and re-window (the XLA dedup
    window) against the port's. Its two Pallas kernels in interpret mode are
    stood in for by the port's outputs: jitted whole, the reference's
    forward does not finish compiling in minutes on a CPU (PERF.md).
    Camera a: 165 rays need a patch; patch_div 64 keeps 16 of 22 groups."""
    from raytracing_test_tpu.kernels import fused_window as jfw

    origin, dirs = _rays("a")
    first = {}
    seed_fn, window = tfm.seed_depth_fused, tfw.render_window_fused

    def seed_spy(*a, **kw):
        first["seed"] = seed_fn(*a, **kw)
        return first["seed"]

    def window_spy(*a, **kw):
        out = window(*a, **kw)
        if kw.get("return_aux"):
            first["rgb"], first["t_end"] = out[0].detach(), out[1]["t_end"]
        return out

    monkeypatch.setattr(tfm, "seed_depth_fused", seed_spy)
    monkeypatch.setattr(tfw, "render_window_fused", window_spy)
    got, aux = tdiff.render_rays_guided_prox(world["td"], world["ts"], torch.from_numpy(origin),
                                             torch.from_numpy(dirs), (H, W), patch_div=patch_div,
                                             return_aux=True)
    n = H * W
    monkeypatch.setattr(jfm, "seed_depth_fused", lambda *a, **kw: jnp.asarray(first["seed"].numpy()))
    monkeypatch.setattr(jfw, "render_window_fused", lambda *a, **kw: (
        jnp.asarray(first["rgb"].numpy()),
        {"escaped": jnp.zeros(n, bool), "n_escaped": jnp.zeros((), jnp.int32),
         "t_end": jnp.asarray(first["t_end"].numpy())}))
    want, jaux = jdiff.render_rays_guided_prox(world["jd"], world["js"], world["ft"], origin, dirs,
                                               (H, W), patch_div=patch_div, return_aux=True)
    want = np.asarray(want)
    assert {k: int(v) for k, v in jaux.items()} == {
        "n_need": aux["n_need"], "n_escaped": 0, "patch_capacity": aux["patch_capacity"],
        "grads_dropped": int(aux["grads_dropped"])}
    assert aux["n_need"] == 165 and aux["grads_dropped"] == (patch_div == 64)
    got = got.detach().numpy()
    patched = np.abs(want - first["rgb"].numpy()).max(axis=1) > 1e-3
    assert patched.sum() > 16
    # the rows each package overwrote, and their values (the window contract)
    np.testing.assert_array_equal(np.abs(got - first["rgb"].numpy()).max(axis=1) > 1e-3, patched)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_guided_prox_overflow_drops_patched_rows_first_window_gradient(world, monkeypatch):
    calls = []
    window = tfw.render_window_fused

    def spy(*a, **kw):
        out = window(*a, **kw)
        rgb = out[0] if isinstance(out, tuple) else out
        rgb.retain_grad()
        calls.append((kw["start_t"], rgb))
        return out

    monkeypatch.setattr(tfw, "render_window_fused", spy)
    rgb, _, _, aux = _torch_grads(world, lambda s, o, d: tdiff.render_rays_guided_prox(
        s, world["ts"], o, d, (H, W), sat_eps=-1.0, return_aux=True), "b")
    assert aux["n_need"] > aux["patch_capacity"] == 128 and aux["grads_dropped"]
    (seed, first), (_, second) = calls
    need = (seed < 9.9e5).numpy()
    groups = np.nonzero(need.reshape(-1, 8).any(axis=1))[0][:16]
    rows = (groups[:, None] * 8 + np.arange(8)).reshape(-1)
    kept = rows[need[rows]]
    assert second.shape[0] == kept.size
    np.testing.assert_array_equal(rgb[kept], second.detach().numpy())
    g = first.grad.numpy()
    assert not g[kept].any()
    rest = np.setdiff1d(np.arange(H * W), kept)
    assert np.abs(g[rest]).sum() > 0
    np.testing.assert_array_equal(rgb[rest], first.detach().numpy()[rest])


def test_guided_step_matches_reference_step(world):
    """One step of the port's guided step (``make_train_step_guided``, the
    fused step's other name) against one step of the reference's
    ``make_train_step_guided`` on a one-device mesh, from the same weights,
    guide and batch: the loss, and Adam's first moment (0.1 x the gradient)
    within 1e-4 max-scaled, the window contract."""
    import optax
    from raytracing_test_tpu.parallel import mesh as jmesh
    from raytracing_test_tpu.parallel import sharding as jshard

    origin, dirs = _rays("b")
    rng = np.random.default_rng(3)
    d0 = rng.normal(-3.5, 1.5, (64, 64, 64)).astype(np.float32)
    a0 = rng.normal(0.0, 1.0, (64, 64, 64, 3)).astype(np.float32)
    targets = rng.uniform(0, 1, (H * W, 3)).astype(np.float32)
    o = np.broadcast_to(origin[None, :], (H * W, 3)).copy()

    p = tshard.params_from_jax(d0, a0, device="cpu")
    opt = torch.optim.Adam(p.parameters(), lr=0.05)
    loss, aux = tshard.make_train_step_guided(p, opt)(
        torch.from_numpy(o), torch.from_numpy(dirs), torch.from_numpy(targets), guide=world["ts"])
    assert aux == {"n_escaped": 0, "grads_dropped": False}

    jopt = optax.adam(0.05)
    jp = jshard.FitParams(jnp.asarray(d0), jnp.asarray(a0))
    jstep = jshard.make_train_step_guided(jmesh.make_mesh(1, 1, jax.devices()[:1]), jopt)
    jp, jst, jloss = jstep(jp, jopt.init(jp), world["js"], jnp.asarray(o), jnp.asarray(dirs),
                           jnp.asarray(targets))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    mu = jst[0].mu
    for got, want in ((p.density_raw, mu.density_raw), (p.albedo_raw, mu.albedo_raw)):
        assert np.abs(np.asarray(want)).max() > 0
        _max_scaled(opt.state[got]["exp_avg"].numpy(), np.asarray(want), 1e-4, "adam mu")


def test_fit_guided_engine_cpu(capsys, monkeypatch):
    """``fit --engine '' --guided`` trains through the guided render, one
    call a step."""
    from raytracing_test_tpu_torch.app import fit as tfit

    calls = []
    render = tshard.render_rays_diff_guided
    monkeypatch.setattr(tshard, "render_rays_diff_guided",
                        lambda *a, **k: calls.append(1) or render(*a, **k))
    cli.main(["--device", "cpu", "--world", "16", "fit", "--engine", "", "--guided", "--steps",
              "2", "--views", "2", "--fit-res", "8", "--batch", "32"])
    out = capsys.readouterr().out
    losses = [float(v) for v in out.split("fit done: loss ")[1].split(" -> ")]
    assert np.isfinite(losses).all() and calls == [1, 1]
    with pytest.raises(ValueError, match="engine"):
        tfit.fit_world(None, (8, 8, 8), FitConfig(engine="xla"))
