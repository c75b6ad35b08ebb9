"""PyTorch port: the differentiable renders of ``render/diff.py`` against the
JAX package.

The blind volumetric scan (``render_rays_diff``), ``render_image_diff``,
the guided render's blind route (``render_rays_diff_guided(window=False)``),
the window render as PyTorch operations (``render_rays_diff_window``, both
crossing enumerators, both ``accum`` engines), ``ao_diff``, the blind train
step (``parallel/sharding.make_train_step``) and the unguided fit with
``fit --out``, each on the same numpy inputs as the JAX function. Everything
runs on CPU tensors. Tolerances, stated in each test: forward values within
``assert_images_close`` (1e-5 on >= 99% of rays), field gradients within
1e-5 max-scaled, ray gradients within 1e-4 max-scaled on generic directions;
the crossing enumerations equal exactly to the reference run op by op (XLA's
CPU jit contracts FMAs, so its closed-form crossing values differ by ulps).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracing_test_tpu.config import FitConfig as JFitConfig, world_for_size as jworld_for_size
from raytracing_test_tpu.app import fit as jfit
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.parallel import mesh as jmesh
from raytracing_test_tpu.parallel import sharding as jshard
from raytracing_test_tpu.render import diff as jdiff
from raytracing_test_tpu.render import hemisphere as jhemi
from raytracing_test_tpu.render.camera import Camera as JCamera, ray_directions as jrays
from raytracing_test_tpu.render.renderer import _build_ray as jbuild, _init_tmax as jinit
from raytracing_test_tpu.worldgen import terrain
from raytracing_test_tpu_torch.app import cli
from raytracing_test_tpu_torch.app import fit as tfit
from raytracing_test_tpu_torch.config import FitConfig, RenderConfig, world_for_size
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.kernels import fused_window as tfw
from raytracing_test_tpu_torch.parallel import sharding as tshard
from raytracing_test_tpu_torch.render import diff as tdiff
from raytracing_test_tpu_torch.render import renderer as trend
from raytracing_test_tpu_torch.render.camera import Camera, camera_from_yaw_pitch, ray_directions
from raytracing_test_tpu_torch.render.fast import sun_unit
from raytracing_test_tpu_torch.render.renderer import _build_ray as tbuild, _init_tmax as tinit
from tests.test_diff import _simple_world
from tests.test_render_parity import assert_images_close

torch.set_num_threads(1)

FIELD_TOL, RAY_TOL = 1e-5, 1e-4  # max-scaled gradient tolerances
POS = (16.3, 20.7, 15.1)
DIR = (0.43, -0.61, 0.52)  # generic: no ray of the view crosses a cell corner exactly


def _fields(grid, pal):
    """(density, albedo) numpy fields of ``grid``: 8 on solid cells and a
    seeded jitter everywhere, so every sampled cell has a gradient."""
    albedo = jflat.palette_arrays(pal)[0]
    rng = np.random.default_rng(grid.size)
    density = np.where(grid > 0, 8.0, 0.0) + rng.uniform(0.0, 0.3, grid.shape)
    return density.astype(np.float32), albedo[grid]


def _camera_rays(pos=POS, dirn=DIR, w=12, h=12):
    jc = JCamera(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(dirn, jnp.float32))
    return np.array(jc.pos), np.array(jrays(jc, w, h))


def _max_scaled(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all(), name
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    assert err <= tol, f"{name}: max-scaled error {err:.3e} > {tol}"


def _vjp_both(jfn, tfn, inputs, cot):
    """Forward values and the VJPs of ``cot`` w.r.t. every input, JAX then port."""
    want, vjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(v) for v in inputs))
    g_want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    leaves = [torch.tensor(v, requires_grad=True) for v in inputs]
    got = tfn(*leaves)
    got.backward(torch.from_numpy(cot))
    return (np.asarray(want), g_want), (got.detach().numpy(), [t.grad.numpy() for t in leaves])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_render_rays_diff_matches_jax(remat, seeded):
    """The blind scan, 64 steps from the grid box or from seeds, with and
    without remat: rgb within assert_images_close, density and albedo
    gradients within 1e-5 and origin and dirs gradients within 1e-4
    max-scaled."""
    density, albedo = _fields(*_simple_world())
    pos, dirs = _camera_rays()
    N = dirs.shape[0]
    rng = np.random.default_rng(2)
    st = rng.uniform(0.0, 5.0, N).astype(np.float32) if seeded else None
    cot = rng.normal(size=(N, 3)).astype(np.float32)
    kw = dict(num_steps=64, sky=False, remat=remat)
    (want, g_want), (got, g_got) = _vjp_both(
        lambda d, a, o, r: jdiff.render_rays_diff(
            jdiff.DiffScene(d, a), o, r, start_t=None if st is None else jnp.asarray(st), **kw),
        lambda d, a, o, r: tdiff.render_rays_diff(
            tdiff.DiffScene(d, a), o, r, start_t=None if st is None else torch.from_numpy(st),
            **kw),
        (density, albedo, pos, dirs), cot)
    assert (want > 0).any()
    assert_images_close(got, want)
    for name, g, w, tol in zip(("density", "albedo", "origin", "dirs"), g_got, g_want,
                               (FIELD_TOL, FIELD_TOL, RAY_TOL, RAY_TOL)):
        _max_scaled(g, w, tol, name)


def test_render_rays_diff_sky_and_gradient_sink():
    """With the sky term, rgb within assert_images_close of the reference;
    the field gradient of a second backward through the same graph equals
    the first (the scan's one gradient buffer is handed over and reset)."""
    density, albedo = _fields(*_simple_world())
    pos, dirs = _camera_rays()
    want = np.asarray(jdiff.render_rays_diff(jdiff.DiffScene(jnp.asarray(density),
                                                             jnp.asarray(albedo)),
                                             pos, dirs, num_steps=48))
    d = torch.tensor(density, requires_grad=True)
    rgb = tdiff.render_rays_diff(tdiff.DiffScene(d, torch.from_numpy(albedo)),
                                 torch.from_numpy(pos), torch.from_numpy(dirs), num_steps=48)
    assert_images_close(rgb.detach().numpy(), want)
    rgb.sum().backward(retain_graph=True)
    first = d.grad.clone()
    d.grad = None
    rgb.sum().backward()
    assert first.abs().max() > 0 and torch.equal(d.grad, first)
    with torch.no_grad():
        again = tdiff.render_rays_diff(tdiff.DiffScene(d, torch.from_numpy(albedo)),
                                       torch.from_numpy(pos), torch.from_numpy(dirs),
                                       num_steps=48)
    assert torch.equal(again, rgb.detach())


def test_hard_limit_matches_first_hit_albedo():
    """tests/test_diff.py:27 on the port: with solid densities -> inf the
    blind scan equals the port's hard renderer's unshaded first-hit albedo
    on the rays that hit, and its skybox on the others (atol 1e-4), at the
    reference test's view and one that sees the sky."""
    grid, pal = _simple_world()
    scene = tflat.scene_from_grid(grid, pal, "cpu")
    albedo = tflat.palette_arrays(pal)[0]
    ds = tdiff.diff_scene_from_grid(grid, albedo, "cpu", solid_density=1e6)
    rcfg = RenderConfig(width=16, height=16)
    hits = []
    for dirn in ((0.3, -0.8, 0.4), (0.3, -0.3, 0.4)):
        cam = Camera(pos=torch.tensor([16.0, 20.0, 16.0]), dir=torch.tensor(dirn))
        dirs = ray_directions(cam, 16, 16)
        vol = tdiff.render_rays_diff(ds, cam.pos, dirs, num_steps=96).numpy()
        _, aux = trend.render_rays(scene, cam.pos, dirs, rcfg)
        hit, mat = aux["hit"].numpy(), aux["mat"].numpy()
        np.testing.assert_allclose(vol[hit], albedo[mat][hit], atol=1e-4)
        sky = trend.skybox(dirs, torch.from_numpy(sun_unit(rcfg.sun_dir))).numpy()
        np.testing.assert_allclose(vol[~hit], sky[~hit], atol=1e-4)
        hits.append(hit)
    assert hits[0].all() and hits[1].any() and not hits[1].all()


def test_render_image_diff_matches_jax():
    """The blind scan of a 16x16 image of a 64^3 terrain at 192 steps, from
    the CLI's camera convention: within assert_images_close."""
    grid, pal = terrain.gen_world_grid(world_for_size(48))
    albedo = tflat.palette_arrays(pal)[0]
    jd = jdiff.diff_scene_from_grid(grid, albedo, solid_density=50.0)
    td = tdiff.diff_scene_from_grid(grid, albedo, "cpu", solid_density=50.0)
    from raytracing_test_tpu.config import RenderConfig as JRenderConfig
    from raytracing_test_tpu.render.camera import camera_from_yaw_pitch as jcam

    pos = (24.0, 60.0, -4.0)
    want = np.asarray(jdiff.render_image_diff(jd, jcam(pos, 20.0, 35.0),
                                              JRenderConfig(width=16, height=12)))
    got = tdiff.render_image_diff(td, camera_from_yaw_pitch(pos, 20.0, 35.0, "cpu"),
                                  RenderConfig(width=16, height=12))
    assert got.shape == (12, 16, 3) and want.std() > 0.01
    assert_images_close(got.numpy(), want)


def test_guided_blind_route_matches_jax():
    """``render_rays_diff_guided(window=False)``: the blind scan from the hard
    march's seeds, against the reference's (its seeds from ``fast``): rgb
    within assert_images_close, field gradients within 1e-5 max-scaled on the
    solid cells (seeds differ by up to an ulp between the packages, which
    moves an air cell's gradient); shading refused as in the reference."""
    grid, pal = _simple_world()
    density, albedo = _fields(grid, pal)
    pos, dirs = _camera_rays()
    cot = np.random.default_rng(4).normal(size=(dirs.shape[0], 3)).astype(np.float32)
    js, ts = jflat.scene_from_grid(grid, pal), tflat.scene_from_grid(grid, pal, "cpu")
    kw = dict(num_steps=32, window=False, sky=True)
    (want, g_want), (got, g_got) = _vjp_both(
        lambda d, a: jdiff.render_rays_diff_guided(jdiff.DiffScene(d, a), js, pos, dirs, **kw),
        lambda d, a: tdiff.render_rays_diff_guided(tdiff.DiffScene(d, a), ts,
                                                   torch.from_numpy(pos), torch.from_numpy(dirs),
                                                   **kw),
        (density, albedo), cot)
    assert_images_close(got, want)
    solid = grid > 0
    _max_scaled(g_got[0][solid], g_want[0][solid], FIELD_TOL, "density")
    _max_scaled(g_got[1], g_want[1], FIELD_TOL, "albedo")
    with pytest.raises(ValueError, match="shading requires the window path"):
        tdiff.render_rays_diff_guided(tdiff.DiffScene(torch.from_numpy(density),
                                                      torch.from_numpy(albedo)), ts,
                                      torch.from_numpy(pos), torch.from_numpy(dirs),
                                      window=False, shading=True)


def _enum_inputs(kind):
    """test_diff_vec.py's random and tie-storm rays."""
    if kind == "random":
        rng = np.random.default_rng(11)
        dirs = rng.normal(size=(2048, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        return dirs, rng.uniform(4, 60, size=(2048, 3)).astype(np.float32)
    base = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [1, 1, 0], [1, 1, 1],
                     [-1, 1, -1], [1e-6, 1, 1e-6], [1, 2, 3], [3, -2, 1]], np.float32)
    dirs = np.repeat(base, 16, axis=0)
    return dirs, np.full((len(dirs), 3), 8.0, np.float32)


@pytest.mark.parametrize("kind", ["random", "tie_storm"])
def test_window_enumerations_match_jax(kind):
    """Both enumerators equal to the reference's run op by op (lin, inside,
    dt, entry axis exactly), and the port's closed-form ranks against its
    scan within test_diff_vec.py's bounds (0.2% of random rays, 2% of the
    tie-storm cells)."""
    dirs, origs = _enum_inputs(kind)
    S, shape3 = 24, (64, 64, 64)
    d, step, delta, ab = jbuild(jnp.asarray(dirs))
    ob = jnp.asarray(origs)
    cell = jnp.floor(ob).astype(jnp.int32)
    tmax = jinit(ob, cell, step, delta, ab)
    td, tstep, tdelta, tab = tbuild(torch.from_numpy(dirs))
    tob = torch.from_numpy(origs)
    tcell = torch.floor(tob).to(torch.int32)
    ttmax = tinit(tob, tcell, tstep, tdelta, tab)
    got = {}
    for name in ("_enumerate_window", "_enumerate_window_vec"):
        want = getattr(jdiff, name)(shape3, ob, d, step, ab, cell, tmax, S)
        got[name] = getattr(tdiff, name)(shape3, tob, td, tstep, tab, tcell, ttmax, S)
        for field, g, w in zip(("lin", "inside", "dt", "ax_in"), got[name], want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} {field}")
    lin_scan, lin_vec = got["_enumerate_window"][0].numpy(), got["_enumerate_window_vec"][0].numpy()
    if kind == "random":
        assert (lin_scan != lin_vec).any(axis=1).mean() <= 0.002
    else:
        assert (lin_scan != lin_vec).mean() <= 0.02


WINDOW_CASES = {
    "scan_scatter_sky": (dict(accum="scatter", enumerate_mode="scan", sky=True), False),
    "scan_dedup": (dict(accum="dedup", enumerate_mode="scan", sky=False), False),
    "vec_scatter_misses": (dict(accum="scatter", enumerate_mode="vec", sky=False), True),
    "vec_dedup_shaded": (dict(accum="dedup", enumerate_mode="vec", sky=False, shading=True,
                              shadow_steps=6), False),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_render_matches_jax(case):
    """``render_rays_diff_window`` against the reference's on the same seeds
    (30% of them miss seeds in one case): rgb within assert_images_close,
    density and albedo gradients within 1e-5 and origin gradients within
    1e-4 max-scaled; dirs gradients within 1e-4 where the reference's are
    finite (with the sky, the sun sigmoid overflows on most rays in both
    packages: non-finite on the same entries)."""
    kw, miss = WINDOW_CASES[case]
    grid, pal = _simple_world()
    density, albedo = _fields(grid, pal)
    pos, dirs = _camera_rays(w=16, h=8)
    N = dirs.shape[0]
    rng = np.random.default_rng(len(case))
    seed = rng.uniform(0.0, 6.0, N).astype(np.float32)
    if miss:
        seed[rng.random(N) < 0.3] = 1e6
    cot = rng.normal(size=(N, 3)).astype(np.float32)
    (want, g_want), (got, g_got) = _vjp_both(
        lambda d, a, o, r: jdiff.render_rays_diff_window(jdiff.DiffScene(d, a), o, r,
                                                         start_t=jnp.asarray(seed), **kw),
        lambda d, a, o, r: tdiff.render_rays_diff_window(tdiff.DiffScene(d, a), o, r,
                                                         start_t=torch.from_numpy(seed), **kw),
        (density, albedo, pos, dirs), cot)
    assert (want > 0).any()
    assert_images_close(got, want)
    for name, g, w, tol in zip(("density", "albedo", "origin"), g_got, g_want,
                               (FIELD_TOL, FIELD_TOL, RAY_TOL)):
        _max_scaled(g, w, tol, name)
    finite = np.isfinite(g_want[3])
    np.testing.assert_array_equal(np.isfinite(g_got[3]), finite)
    _max_scaled(g_got[3][finite], g_want[3][finite], RAY_TOL, "dirs")


def test_window_accums_agree_and_anchor_the_kernel_pair():
    """``accum="dedup"`` and ``"scatter"`` give the same values (one plain row
    gather); on CPU tensors the window pair (``window_plain``) agrees with
    ``render_rays_diff_window(accum="scatter")`` to the chip contract:
    rgb within 1e-5, gradients within 1e-5 max-scaled."""
    grid, pal = _simple_world()
    density, albedo = _fields(grid, pal)
    pos, dirs = _camera_rays(w=16, h=8)
    seed = torch.from_numpy(np.random.default_rng(8).uniform(0.0, 6.0, dirs.shape[0])
                            .astype(np.float32))

    def run(render, **kw):
        d = torch.tensor(density, requires_grad=True)
        a = torch.tensor(albedo, requires_grad=True)
        rgb = render(tdiff.DiffScene(d, a), torch.from_numpy(pos), torch.from_numpy(dirs),
                     start_t=seed, sky=False, **kw)
        (rgb ** 2).mean().backward()
        return rgb.detach(), d.grad, a.grad

    scatter = run(tdiff.render_rays_diff_window, accum="scatter")
    dedup = run(tdiff.render_rays_diff_window, accum="dedup")
    for a, b in zip(scatter, dedup):
        assert torch.equal(a, b)
    launches = (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD)
    pair = run(tfw.render_window_fused)
    assert (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD) == launches
    np.testing.assert_allclose(pair[0].numpy(), scatter[0].numpy(), rtol=0, atol=1e-5)
    for name, g, w in zip(("density", "albedo"), pair[1:], scatter[1:]):
        _max_scaled(g.numpy(), w.numpy(), FIELD_TOL, name)
    with pytest.raises(ValueError, match="accum"):
        tdiff.render_rays_diff_window(tdiff.DiffScene(torch.from_numpy(density),
                                                      torch.from_numpy(albedo)),
                                      torch.from_numpy(pos), torch.from_numpy(dirs), accum="sum")


def test_ao_diff_matches_jax(monkeypatch):
    """``ao_diff`` on the reference's hemisphere directions (fed into the
    port in place of its ``torch.Generator`` draw): occlusion within 1e-6,
    its density gradient within 1e-5 max-scaled; a point beside the green
    box more occluded than one in the open. The port's own draw: occlusion
    in [0, 1], the same for the same generator seed."""
    grid, pal = _simple_world()
    albedo = jflat.palette_arrays(pal)[0]
    density = np.where(grid > 0, 5.0, 0.0).astype(np.float32)
    pts = np.asarray([[11.5, 8.6, 11.5], [28.5, 8.6, 28.5], [9.3, 8.2, 12.7]], np.float32)
    up = np.asarray([[0.0, 1.0, 0.0]] * 3, np.float32)
    key = jax.random.PRNGKey(0)
    jdirs = np.array(jhemi.sample_hemisphere(key, jnp.asarray(up), 32))
    monkeypatch.setattr(tdiff, "sample_hemisphere",
                        lambda gen, normals, n: torch.from_numpy(jdirs))

    def jf(d):
        return jdiff.ao_diff(jdiff.DiffScene(d, jnp.asarray(albedo[grid])), jnp.asarray(pts),
                             jnp.asarray(up), key, n_rays=32, num_steps=6)

    want, vjp = jax.vjp(jax.jit(jf), jnp.asarray(density))
    (g_want,) = vjp(jnp.ones(3, jnp.float32))
    d = torch.tensor(density, requires_grad=True)
    got = tdiff.ao_diff(tdiff.DiffScene(d, torch.from_numpy(albedo[grid])), torch.from_numpy(pts),
                        torch.from_numpy(up), None, n_rays=32, num_steps=6)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert got[0] > got[1] + 0.02
    _max_scaled(d.grad.numpy(), g_want, FIELD_TOL, "density")

    monkeypatch.undo()
    scene = tdiff.DiffScene(torch.from_numpy(density), torch.from_numpy(albedo[grid]))
    occ = [tdiff.ao_diff(scene, torch.from_numpy(pts), torch.from_numpy(up),
                         torch.Generator().manual_seed(5), n_rays=16) for _ in range(2)]
    assert torch.equal(occ[0], occ[1]) and ((occ[0] >= 0) & (occ[0] <= 1)).all()


def test_train_step_matches_jax():
    """One ``make_train_step`` step (the blind scan, 64 steps, remat on)
    against the reference's ``make_train_step`` on a one-device mesh from the
    same ``params_from_jax`` weights and batch: the loss within 1e-5, Adam's
    first moment and the updated parameters within 1e-5 max-scaled."""
    shape = (24, 20, 28)
    rng = np.random.default_rng(9)
    d0 = rng.normal(-1.5, 1.5, shape).astype(np.float32)
    a0 = rng.normal(0.0, 1.0, shape + (3,)).astype(np.float32)
    n = 128
    o = (rng.normal(0, 1, (n, 3)) * [4.0, 2.0, 4.0] + [-6.0, 26.0, -5.0]).astype(np.float32)
    d = (np.array([12.0, 8.0, 14.0]) + rng.normal(0, 4, (n, 3)) - o)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 3)).astype(np.float32)

    tp = tshard.params_from_jax(d0, a0, device="cpu")
    topt = torch.optim.Adam(tp.parameters(), lr=0.05)
    loss, aux = tshard.make_train_step(tp, topt, num_steps=64)(
        *(torch.from_numpy(x) for x in (o, d, t)))
    assert aux == {"n_escaped": 0, "grads_dropped": False}

    jopt = optax.adam(0.05)
    jp = jshard.FitParams(jnp.asarray(d0), jnp.asarray(a0))
    jstep = jshard.make_train_step(jmesh.make_mesh(1, 1, jax.devices()[:1]), jopt, num_steps=64)
    jp, jst, jloss = jstep(jp, jopt.init(jp), *(jnp.asarray(x) for x in (o, d, t)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    mu = jst[0].mu
    for got, want_mu, want_p in ((tp.density_raw, mu.density_raw, jp.density_raw),
                                 (tp.albedo_raw, mu.albedo_raw, jp.albedo_raw)):
        assert np.abs(np.asarray(want_mu)).max() > 0
        _max_scaled(topt.state[got]["exp_avg"].numpy(), want_mu, FIELD_TOL, "adam mu")
        _max_scaled(got.detach().numpy(), want_p, FIELD_TOL, "params")


def _read_png(path):
    """8-bit RGB PNG as written by ``cli.write_png`` -> uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    idat = data.index(b"IDAT")
    n = int.from_bytes(data[idat - 4:idat], "big")
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]), np.uint8)
    return raw.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def test_fit_world_blind_and_out_match_jax(tmp_path, capsys):
    """``fit_world(engine='')`` (the blind step, 96 steps) on a 16-column
    world against the reference's ``fit_world`` on a one-device mesh: the
    same losses within 1e-4 (the targets come from the two packages' hard
    marches); no window launch. Then ``fit --out`` through the CLI writes
    ``render_image_diff`` of the fitted fields from the CLI's camera."""
    grid, pal = terrain.gen_world_grid(world_for_size(16))
    fc = dict(views=2, steps=2, resolution=8)
    scene = tflat.scene_from_grid(grid, pal, "cpu")
    launches = (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD)
    params, losses = tfit.fit_world(scene, grid.shape, FitConfig(**fc), batch=64)
    assert (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD) == launches
    assert params.density_raw.shape == grid.shape
    jgrid, jpal = terrain.gen_world_grid(jworld_for_size(16))
    _, jlosses = jfit.fit_world(jflat.scene_from_grid(jgrid, jpal), jgrid.shape, JFitConfig(**fc),
                                mesh=jmesh.make_mesh(1, 1, jax.devices()[:1]), batch=64)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)

    out, ck = str(tmp_path / "fit.png"), str(tmp_path / "fit.npz")
    cli.main(["--device", "cpu", "--world", "16", "--width", "16", "--height", "8", "--pos",
              "30,70,-10", "fit", "--steps", "2", "--views", "2", "--fit-res", "8", "--batch",
              "32", "--ckpt", ck, "--out", out])
    assert "fit done" in capsys.readouterr().out
    from raytracing_test_tpu_torch.app import checkpoint as tckpt

    fitted, _, _ = tckpt.load_fit(ck, device="cpu")
    args = cli.build_parser().parse_args(["fit"])
    with torch.no_grad():
        img = tdiff.render_image_diff(
            tshard.params_to_scene(fitted),
            camera_from_yaw_pitch((30.0, 70.0, -10.0), args.yaw, args.pitch, "cpu"),
            RenderConfig(width=16, height=8))
    want = (np.clip(img.numpy(), 0.0, 1.0) * 255).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(out), want)
