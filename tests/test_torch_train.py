"""PyTorch port: the training slice against the JAX package.

Seeds (``render/progressive.py``, ``seed_depth_fused``), the fit parameters
and guide (``parallel/sharding.py``), the converters and checkpoints that
carry weights and Adam state across, three steps of
``make_train_step_fused`` against three steps of ``jax.value_and_grad`` over
the JAX window anchor + ``optax.adam`` on the same seeds and batches, and
``fit_world`` / the ``fit`` verb at a tiny size. Everything here runs on CPU
tensors, so the window is ``window_plain`` and the march the plain march.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracing_test_tpu.app import checkpoint as jckpt
from raytracing_test_tpu.config import RenderConfig, world_for_size
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.ops.mxu_lookup import mxu_nibble_lookup2
from raytracing_test_tpu.parallel import sharding as jshard
from raytracing_test_tpu.render import diff as jdiff
from raytracing_test_tpu.render import fast as jfast
from raytracing_test_tpu.render import progressive as jprog
from raytracing_test_tpu.render.camera import Camera as JCamera, ray_directions as jrays
from raytracing_test_tpu.worldgen import terrain
from raytracing_test_tpu_torch.app import checkpoint as tckpt
from raytracing_test_tpu_torch.app import cli
from raytracing_test_tpu_torch.app import fit as tfit
from raytracing_test_tpu_torch.config import FitConfig
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.kernels import fused_march as tfm
from raytracing_test_tpu_torch.kernels import fused_window as tfw
from raytracing_test_tpu_torch.parallel import sharding as tshard
from raytracing_test_tpu_torch.render import progressive as tprog

torch.set_num_threads(1)

SHAPE = (24, 20, 28)
_jit_fast = jax.jit(jfast.render_rays_fast, static_argnames=("cfg",))


def _raw_params(seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(-3.5, 1.5, SHAPE).astype(np.float32)
    a = rng.normal(0.0, 1.0, SHAPE + (3,)).astype(np.float32)
    return d, a


def test_seed_from_depth_matches_jax():
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.0, 80.0, (6, 5)).astype(np.float32)
    depth[rng.random((6, 5)) < 0.3] = 1e6
    for factor, H, W in ((4, 24, 20), (4, 22, 18), (2, 12, 10)):
        want = np.asarray(jprog.seed_from_depth(jnp.asarray(depth), factor, H, W))
        got = tprog.seed_from_depth(torch.from_numpy(depth), factor, H, W).numpy()
        np.testing.assert_array_equal(got, want)


def _jax_seed_depth(js, jc, dirs, H, W, margin):
    """seed_depth_fused's scheme on the JAX fast path."""
    lean = dict(enable_materials=False, enable_shadows=False)
    cdirs = dirs.reshape(H, W, 3)[2::4, 2::4].reshape(-1, 3)
    _, caux = _jit_fast(js, jc.pos, cdirs, cfg=RenderConfig(width=8, height=8, **lean))
    ct = jnp.linalg.norm(caux["hit_pos"] - jc.pos[None, :], axis=1)
    st = jprog.seed_from_depth(jnp.where(caux["hit"], ct, 1e6).reshape(8, 8), 4, H, W)
    _, aux = _jit_fast(js, jc.pos, dirs, cfg=RenderConfig(width=W, height=H, **lean), start_t=st)
    t_hit = jnp.linalg.norm(aux["hit_pos"] - jc.pos[None, :], axis=1)
    return np.asarray(jnp.where(aux["hit"], jnp.maximum(t_hit - margin, 0.0), 1e6))


@pytest.mark.parametrize("prox", [False, True])
def test_seed_depth_fused_matches_jax_fast_path(prox):
    """seed_depth_fused's two lean marches against the same scheme on the JAX
    fast path (the port's march is the plain version on CPU). The prox mode
    is the fast path on the grid whose occupied 8^3 bricks are filled, with
    the real y_max (the reference's prox_stop kernel equals that;
    tests/test_torch_prox.py holds it against the kernel itself). A ray
    seeded at the coarse pass's far cap is sky in the port and not in the
    reference (test_torch_prox.py:test_far_cap_seed_is_sky); no ray of
    this view is seeded there."""
    grid, pal = terrain.gen_world_grid(world_for_size(48))
    js, ts = jflat.scene_from_grid(grid, pal), tflat.scene_from_grid(grid, pal, "cpu")
    margin = 0.5 if prox else 3.0
    if prox:
        B = tuple(d // 8 for d in grid.shape)
        occ = grid.reshape(B[0], 8, B[1], 8, B[2], 8).any(axis=(1, 3, 5))
        stop = np.repeat(np.repeat(np.repeat(occ, 8, 0), 8, 1), 8, 2)
        filled = np.where(grid > 0, grid, np.where(stop, 1, 0)).astype(np.uint8)
        js = jflat.scene_from_grid(filled, pal)._replace(y_max=js.y_max)
    H = W = 32
    jc = JCamera(pos=jnp.asarray([24.0, 55.0, -6.0], jnp.float32),
                 dir=jnp.asarray([0.2, -0.6, 0.8], jnp.float32))
    dirs = jrays(jc, W, H)
    want = _jax_seed_depth(js, jc, dirs, H, W, margin)

    got = tfm.seed_depth_fused(ts, torch.tensor([24.0, 55.0, -6.0]),
                               torch.from_numpy(np.array(dirs)), (H, W), margin=margin,
                               prox=prox).numpy()
    # with prox, this view's sky rays all graze the air of a surface brick
    assert (want < 1e6).any() and (want >= 1e6).any() != prox
    close = np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))
    assert close.mean() >= 0.99, close.mean()


def test_params_to_scene_and_init_match_jax():
    d, a = _raw_params()
    jp = jshard.FitParams(jnp.asarray(d), jnp.asarray(a))
    tp = tshard.params_from_jax(d, a, device="cpu")
    js, ts = jshard.params_to_scene(jp), tshard.params_to_scene(tp)
    np.testing.assert_allclose(ts.density.detach().numpy(), np.asarray(js.density), rtol=1e-6)
    np.testing.assert_allclose(ts.albedo.detach().numpy(), np.asarray(js.albedo), rtol=1e-6)
    ji, ti = jshard.init_params(SHAPE), tshard.init_params(SHAPE, device="cpu")
    np.testing.assert_array_equal(ti.density_raw.detach().numpy(), np.asarray(ji.density_raw))
    np.testing.assert_array_equal(ti.albedo_raw.detach().numpy(), np.asarray(ji.albedo_raw))


def test_guide_scene_matches_jax():
    d, a = _raw_params(2)
    jg = jshard.guide_scene_from_params(jshard.FitParams(jnp.asarray(d), jnp.asarray(a)))
    tg = tshard.guide_scene_from_params(tshard.params_from_jax(d, a, device="cpu"))
    occ = np.asarray(jg.grid_enc) < 128
    assert 0.1 < occ.mean() < 0.9
    for name in ("grid_enc", "macro", "albedo", "flags", "brick_mat", "brick_dist"):
        want = np.asarray(getattr(jg, name))
        got = getattr(tg, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    nb = tg.brick_dist.numel()
    decoded = np.asarray(mxu_nibble_lookup2(jg.brick_nib_shadow, jnp.arange(nb, dtype=jnp.int32)))
    np.testing.assert_array_equal(tg.brick_dist_shadow.numpy().reshape(-1), decoded)
    assert tg.y_max == int(jg.y_max)


def test_fit_world_builds_guides_on_tensors(monkeypatch):
    """Every guide of a guided fit is built from the thresholded tensor: the
    tensor counter rises once per rebuild, and no numpy builder runs."""
    grid, pal = terrain.gen_world_grid(world_for_size(16))
    scene = tflat.scene_from_grid(grid, pal, "cpu")

    def refuse(*a, **k):
        raise AssertionError("a numpy scene builder ran in the fit")

    for name in ("build_grid_enc", "build_macro", "build_brick_fields", "world_y_max"):
        monkeypatch.setattr(tflat, name, refuse)
    counts = (tflat.SCENES_FROM_NUMPY, tflat.SCENES_FROM_TENSOR)
    fcfg = FitConfig(views=2, steps=5, resolution=8, engine="fused", rethreshold_every=2)
    _, losses = tfit.fit_world(scene, grid.shape, fcfg, batch=64)
    assert len(losses) == 5 and np.isfinite(losses).all()
    # rebuilds at steps 0, 2 and 4
    assert (tflat.SCENES_FROM_NUMPY, tflat.SCENES_FROM_TENSOR) == (counts[0], counts[1] + 3)


@pytest.fixture(scope="module")
def jax_state():
    """JAX params and optax state after one Adam update with random grads."""
    d, a = _raw_params(3)
    p = jshard.FitParams(jnp.asarray(d), jnp.asarray(a))
    opt = optax.adam(0.05)
    st = opt.init(p)
    rng = np.random.default_rng(4)
    g = jshard.FitParams(*(jnp.asarray(rng.normal(size=x.shape).astype(np.float32)) for x in p))
    upd, st = opt.update(g, st, p)
    return optax.apply_updates(p, upd), st


def test_params_and_adam_state_round_trip(jax_state):
    p, st = jax_state
    adam = st[0]
    tp = tshard.params_from_jax(np.asarray(p.density_raw), np.asarray(p.albedo_raw),
                               device="cpu")
    opt = torch.optim.Adam(tp.parameters(), lr=0.05)
    states = tshard.adam_state_from_optax(np.asarray(adam.count), tuple(np.asarray(x) for x in adam.mu),
                                          tuple(np.asarray(x) for x in adam.nu))
    tshard.load_adam_state(opt, tp, states)
    count, mu, nu = tshard.adam_state_to_optax(opt, tp)
    assert int(count) == int(adam.count) == 1
    for got, want in zip(mu + nu, tuple(adam.mu) + tuple(adam.nu)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(tp.density_raw.detach().numpy(), np.asarray(p.density_raw))
    np.testing.assert_array_equal(tp.albedo_raw.detach().numpy(), np.asarray(p.albedo_raw))


def test_checkpoints_cross_between_packages(jax_state, tmp_path):
    p, st = jax_state
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_fit(jpath, p, st, 7)
    tp, states, step = tckpt.load_fit(jpath, device="cpu")
    assert step == 7
    np.testing.assert_array_equal(tp.albedo_raw.detach().numpy(), np.asarray(p.albedo_raw))
    opt = torch.optim.Adam(tp.parameters(), lr=0.05)
    tshard.load_adam_state(opt, tp, states)
    tpath = str(tmp_path / "torch.npz")
    tckpt.save_fit(tpath, tp, opt, 9)
    jp, jst, jstep = jckpt.load_fit(tpath, p, st)
    assert jstep == 9
    for got, want in zip(jax.tree_util.tree_leaves((jp, jst)), jax.tree_util.tree_leaves((p, st))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _batches(n_batches=3, n=256):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n_batches):
        center = np.array([12.0, 8.0, 14.0])
        o = rng.normal(0, 1, (n, 3)) * np.array([4.0, 2.0, 4.0]) + np.array([-6.0, 26.0, -5.0])
        d = center + rng.normal(0, 4, (n, 3)) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t = rng.uniform(0, 1, (n, 3))
        out.append(tuple(x.astype(np.float32) for x in (o, d, t)))
    return out


def test_train_steps_match_jax_adam():
    """Three make_train_step_fused steps vs three JAX steps (window anchor +
    optax.adam) from the same weights, guide, seeds and batches."""
    d, a = _raw_params(6)
    tp = tshard.params_from_jax(d, a, device="cpu")
    topt = torch.optim.Adam(tp.parameters(), lr=0.05)
    guide = tshard.guide_scene_from_params(tp)
    step_fn = tshard.make_train_step_fused(tp, topt, guide)

    jp = jshard.FitParams(jnp.asarray(d), jnp.asarray(a))
    jopt = optax.adam(0.05)
    jst = jopt.init(jp)

    @jax.jit
    def jstep(p, st, o, dr, t, seed):
        def loss(p):
            rgb = jdiff.render_rays_diff_window(
                jshard.params_to_scene(p), o, dr, num_steps=24, sky=False, start_t=seed,
                accum="scatter", enumerate_mode="scan")
            return jnp.mean((rgb - t) ** 2)

        val, g = jax.value_and_grad(loss)(p)
        upd, st = jopt.update(g, st, p)
        return optax.apply_updates(p, upd), st, val

    cfg = RenderConfig(width=1, height=256, enable_materials=False, enable_shadows=False)
    n_hit = 0
    for o, dr, t in _batches():
        seed = tfm.hit_seeds(guide, torch.from_numpy(o), torch.from_numpy(dr), cfg, margin=3.0)
        n_hit += int((seed < 1e6).sum())
        jp, jst, jloss = jstep(jp, jst, *(jnp.asarray(x) for x in (o, dr, t)),
                               jnp.asarray(seed.numpy()))
        tloss, aux = step_fn(*(torch.from_numpy(x) for x in (o, dr, t)))
        assert aux == {"n_escaped": 0, "grads_dropped": False}
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert n_hit > 300
    for got, want in ((tp.density_raw, jp.density_raw), (tp.albedo_raw, jp.albedo_raw)):
        want = np.asarray(want)
        err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, err
    assert not np.array_equal(np.asarray(jp.density_raw), d)  # the steps moved the weights


def test_fit_world_tiny_and_engines(monkeypatch):
    grid, pal = terrain.gen_world_grid(world_for_size(16))
    scene = tflat.scene_from_grid(grid, pal, "cpu")
    fcfg = FitConfig(views=2, steps=3, resolution=8, engine="fused", rethreshold_every=2)
    launches = (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD)
    params, losses = tfit.fit_world(scene, grid.shape, fcfg, batch=64)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert params.density_raw.shape == grid.shape
    assert (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD) == launches
    # engine '' without guided: the blind scan's step, no guide and no window
    guides = []
    guide = tshard.guide_scene_from_params
    monkeypatch.setattr(tshard, "guide_scene_from_params",
                        lambda *a, **k: guides.append(1) or guide(*a, **k))
    params, losses = tfit.fit_world(scene, grid.shape, FitConfig(views=1, steps=2, resolution=4),
                                    batch=8)
    assert len(losses) == 2 and np.isfinite(losses).all() and not guides
    assert (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD) == launches


def test_fit_verb_cpu(tmp_path, capsys):
    ck = str(tmp_path / "fit.npz")
    cli.main(["--device", "cpu", "--world", "16", "fit", "--engine", "fused", "--steps", "2",
              "--views", "2", "--fit-res", "8", "--batch", "32", "--ckpt", ck])
    out = capsys.readouterr().out
    losses = [float(v) for v in out.split("fit done: loss ")[1].split(" -> ")]
    assert np.isfinite(losses).all()
    params, states, step = tckpt.load_fit(ck, device="cpu")
    assert step == 2 and int(states[0]["step"]) == 2
    assert cli.build_parser().parse_args(["fit"]).engine == ""
    assert cli.build_parser().parse_args(["render"]).device == "cuda"
