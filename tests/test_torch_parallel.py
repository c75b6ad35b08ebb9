"""PyTorch port: multi-device execution (parallel/) on CPU ranks over gloo,
against the JAX package on its 8 virtual CPU devices.

One module fixture starts a world of ranks for each mesh shape (2, 1),
(1, 2), (2, 2) and (1, 4) through ``launch.run_ranks`` (spawned processes,
a FileStore, a 120 s limit each; the four worlds run at once). Every rank runs
``tests/torch_parallel_ranks.py:run_checks``, which imports no JAX and
writes its outputs as .npy files; the tests read them here:

  - ``render_image_sharded`` against the JAX package's on the same mesh
    shape (``assert_images_close``) and bit-equal to the port's one-device
    reference frame; ``render_rays_fused_dp`` against the JAX fast path (the
    plain reference of its Pallas march: the reference's dp render is
    bit-exact to its one-device kernel) and bit-equal to the port's
    one-device ``render_rays_fused``;
  - ``render_window_fused_dp``'s rgb and summed field gradients against the
    JAX package's (its XLA window on these fields) within 1e-5 max-scaled;
  - one data-parallel ``make_train_step_fused`` and ``make_train_step``
    step: against the JAX package's guided and unguided steps on the (2, 1)
    mesh (loss rtol 1e-5, fields 1e-5 max-scaled, as
    tests/test_torch_train.py), and against the port's one-device step on
    every mesh within 1e-6 (tests/test_sharding.py:195-197);
  - ``spatial`` bit-equal to the port's reference frame and ``handoff``
    bit-equal to its plain fast frame and to ``render_image_fused``, on the
    terrain (the boundary crossings of tests/test_handoff.py:58 included)
    and on the material world; each slab holds Sx / n_space columns;
  - ``dryrun_multichip(4)`` and the scaling harness on the (2, 2) world;
    ``overhead_table`` and ``efficiency`` against the JAX package's;
  - a rank that raises makes ``run_ranks`` raise with its traceback long
    before the limit, and a rank that hangs is killed at the limit.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracing_test_tpu.config import RenderConfig as JRenderConfig
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.kernels import fused_window as jfw
from raytracing_test_tpu.parallel import mesh as jmesh, scaling as jscaling
from raytracing_test_tpu.parallel import sharding as jshard
from raytracing_test_tpu.render import fast as jfast
from raytracing_test_tpu.render.camera import Camera as JCamera, ray_directions as jrays
from raytracing_test_tpu.render.diff import DiffScene as JDiffScene
from raytracing_test_tpu_torch.config import RenderConfig
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.kernels import fused_march as tfm
from raytracing_test_tpu_torch.kernels import fused_window as tfw
from raytracing_test_tpu_torch.parallel import scaling as tscaling, sharding as tshard
from raytracing_test_tpu_torch.parallel.launch import run_ranks
from raytracing_test_tpu_torch.render import fast as tfast, renderer as trenderer
from raytracing_test_tpu_torch.render.camera import ray_directions
from raytracing_test_tpu_torch.render.diff import DiffScene
from raytracing_test_tpu_torch.worldgen import terrain
from tests import torch_parallel_ranks as R
from tests.test_render_parity import _material_world, assert_images_close

torch.set_num_threads(1)

SHAPES = [(2, 1), (1, 2), (2, 2), (1, 4)]
TIMEOUT = 120.0
GRAD_TOL = 1e-5  # max-scaled, window field gradients against the JAX package's
STEP_TOL = 1e-6  # max-scaled, a dp step against the one-device step (test_sharding.py:197)


def _max_scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def worlds():
    grid, pal = terrain.gen_world_grid(R.TERRAIN)
    mgrid, mpal = _material_world()
    mscene = tflat.scene_from_grid(mgrid, mpal, "cpu")
    fields = {k: getattr(mscene, k).numpy() for k in ("grid_enc", "macro", "albedo", "flags",
                                                     "metadata")}
    fields["y_max"] = mscene.y_max
    return {"terrain": (grid, pal, tflat.scene_from_grid(grid, pal, "cpu")),
            "materials": (mgrid, mpal, mscene), "mat_fields": fields}


@pytest.fixture(scope="module")
def runs(worlds, tmp_path_factory):
    """{mesh shape: (output dir, every rank's returned dict)}: one world of
    ranks per mesh shape, the four worlds at once (each rank is one thread)."""
    dirs = {shape: tmp_path_factory.mktemp(f"ranks{shape[0]}x{shape[1]}") for shape in SHAPES}
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        futures = {(nd, ns): pool.submit(run_ranks, R.run_checks, nd * ns, timeout=TIMEOUT,
                                         args=(nd, ns, str(dirs[(nd, ns)]), worlds["mat_fields"],
                                               (nd, ns) == (2, 2)))
                   for nd, ns in SHAPES}
        return {shape: (dirs[shape], f.result()) for shape, f in futures.items()}


def _load(d, name: str, rank: int = 0) -> np.ndarray:
    return np.load(os.path.join(d, f"{name}_r{rank}.npy"))


def _same_on_every_rank(d, name: str, n: int) -> np.ndarray:
    first = _load(d, name)
    for r in range(1, n):
        np.testing.assert_array_equal(_load(d, name, r), first)
    return first


def _jcam(pos, dirn):
    return JCamera(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(dirn, jnp.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ranks_import_no_jax(runs, shape):
    d, res = runs[shape]
    assert len(res) == shape[0] * shape[1]
    for r in res:
        assert not r["jax_imported"], r["jax_imported"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_render_matches_jax_and_one_device(runs, worlds, shape):
    d, _ = runs[shape]
    got = _same_on_every_rank(d, "sharded", shape[0] * shape[1])
    pos, dirn, w, h = R.DP_VIEW
    grid, pal, tscene = worlds["terrain"]
    jscene = jflat.scene_from_grid(grid, pal)
    want = np.asarray(jshard.render_image_sharded(jscene, _jcam(pos, dirn), JRenderConfig(
        width=w, height=h), jmesh.make_mesh(*shape)))
    assert_images_close(got, want)
    one = trenderer.render_image(tscene, R.camera(pos, dirn), RenderConfig(width=w, height=h))
    np.testing.assert_array_equal(got, one.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_dp_matches_jax_and_one_device(runs, worlds, shape):
    d, _ = runs[shape]
    n = shape[0] * shape[1]
    col = _same_on_every_rank(d, "fused_dp_col", n)
    hit = _same_on_every_rank(d, "fused_dp_hit", n)
    hit_pos = _same_on_every_rank(d, "fused_dp_hit_pos", n)
    pos, dirn, w, h = R.DP_VIEW
    grid, pal, tscene = worlds["terrain"]
    jc = _jcam(pos, dirn)
    want, jaux = jax.jit(jfast.render_rays_fast, static_argnames=("cfg",))(
        jflat.scene_from_grid(grid, pal), jc.pos, jrays(jc, w, h), cfg=JRenderConfig(
            width=w, height=h))
    assert_images_close(col.reshape(h, w, 3), np.asarray(want).reshape(h, w, 3))
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(hit, np.asarray(jaux["hit"]))
    one, aux = tfm.render_rays_fused(tscene, torch.tensor(pos), ray_directions(R.camera(pos, dirn),
                                     w, h), RenderConfig(width=w, height=h))
    np.testing.assert_array_equal(col, one.numpy())
    np.testing.assert_array_equal(hit, aux["hit"].numpy())
    np.testing.assert_array_equal(hit_pos, aux["hit_pos"].numpy())


@pytest.fixture(scope="module")
def window_one_device():
    density, albedo, o, dr, g = R.window_inputs()
    ds = DiffScene(torch.from_numpy(density).requires_grad_(),
                   torch.from_numpy(albedo).requires_grad_())
    rgb = tfw.render_window_fused(ds, torch.from_numpy(o), torch.from_numpy(dr), num_steps=16,
                                  sky=False, shading=True)
    (rgb * torch.from_numpy(g)).sum().backward()
    return rgb.detach().numpy(), ds.density.grad.numpy(), ds.albedo.grad.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_window_dp_matches_jax(runs, window_one_device, shape):
    d, _ = runs[shape]
    n = shape[0] * shape[1]
    rgb = np.concatenate([_load(d, "window_rgb", r) for r in range(0, n, shape[1])])
    gd = _same_on_every_rank(d, "window_g_density", n)
    ga = _same_on_every_rank(d, "window_g_albedo", n)
    density, albedo, o, dr, g = R.window_inputs()
    mesh = jmesh.make_mesh(*shape)

    def loss(dens, alb):
        out = jfw.render_window_fused_dp(JDiffScene(dens, alb), jnp.asarray(o), jnp.asarray(dr),
                                         mesh, num_steps=16, sky=False, shading=True)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), (jgd, jga) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(density), jnp.asarray(albedo))
    assert _max_scaled(rgb, want) <= 1e-5
    assert _max_scaled(gd, jgd) <= GRAD_TOL
    assert _max_scaled(ga, jga) <= GRAD_TOL
    one_rgb, one_gd, one_ga = window_one_device
    np.testing.assert_array_equal(rgb, one_rgb)  # the rays are independent
    assert _max_scaled(gd, one_gd) <= STEP_TOL and _max_scaled(ga, one_ga) <= STEP_TOL


@pytest.fixture(scope="module")
def steps_one_device():
    """The port's one-device steps: {name: (loss, density, albedo)}."""
    out = {}
    dr, ar = R.raw_params()
    for name, n in (("fused", 256), ("blind", 64)):
        p = tshard.params_from_jax(dr, ar, device="cpu")
        opt = torch.optim.Adam(p.parameters(), lr=R.LR)
        step = (tshard.make_train_step_fused(p, opt, tshard.guide_scene_from_params(p))
                if name == "fused" else tshard.make_train_step(p, opt, num_steps=32))
        loss, _ = step(*(torch.from_numpy(x) for x in R.train_batch(n)))
        out[name] = (float(loss), p.density_raw.detach().numpy(), p.albedo_raw.detach().numpy())
    return out


@pytest.fixture(scope="module")
def steps_jax():
    """The JAX package's data-parallel steps on the (2, 1) mesh: its guided
    step (the XLA twin of its fused step) and its unguided step."""
    mesh = jmesh.make_mesh(2, 1)
    dr, ar = R.raw_params()
    out = {}
    for name, n in (("fused", 256), ("blind", 64)):
        p = jshard.FitParams(jnp.asarray(dr), jnp.asarray(ar))
        opt = optax.adam(R.LR)
        batch = tuple(jnp.asarray(x) for x in R.train_batch(n))
        if name == "fused":
            step = jshard.make_train_step_guided(mesh, opt, num_steps=24)
            p, _, loss = step(p, opt.init(p), jshard.guide_scene_from_params(p), *batch)
        else:
            step = jshard.make_train_step(mesh, opt, num_steps=32)
            p, _, loss = step(p, opt.init(p), *batch)
        out[name] = (float(loss), np.asarray(p.density_raw), np.asarray(p.albedo_raw))
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["fused", "blind"])
def test_train_step_dp(runs, steps_one_device, steps_jax, shape, name):
    d, res = runs[shape]
    n = shape[0] * shape[1]
    loss = float(_same_on_every_rank(d, f"{name}_loss", n))
    dens = _same_on_every_rank(d, f"{name}_density", n)
    alb = _same_on_every_rank(d, f"{name}_albedo", n)
    assert all(r[f"{name}_aux"] == {"n_escaped": 0, "grads_dropped": False} for r in res)
    l1, d1, a1 = steps_one_device[name]
    assert abs(loss - l1) <= STEP_TOL * abs(l1), (loss, l1)
    assert _max_scaled(dens, d1) <= STEP_TOL and _max_scaled(alb, a1) <= STEP_TOL
    assert not np.array_equal(dens, R.raw_params()[0])  # the step moved the weights
    if shape == (2, 1):
        lj, dj, aj = steps_jax[name]
        np.testing.assert_allclose(loss, lj, rtol=1e-5)
        assert _max_scaled(dens, dj) <= 1e-5 and _max_scaled(alb, aj) <= 1e-5


@pytest.fixture(scope="module")
def one_device_frames(worlds):
    """{prefix + index: (reference frame, plain fast frame, fused frame)}."""
    out = {}
    for prefix, views in (("terrain", R.TERRAIN_VIEWS), ("materials", R.MATERIAL_VIEWS)):
        scene = worlds[prefix][2]
        for i, (pos, dirn, w, h, t, ao) in enumerate(views):
            rcfg = RenderConfig(width=w, height=h, time=t, enable_ao=ao)
            cam = R.camera(pos, dirn)
            out[f"{prefix}{i}"] = tuple(f.numpy() for f in (
                trenderer.render_image(scene, cam, rcfg, time_s=t),
                tfast.render_image_fast(scene, cam, rcfg),
                tfm.render_image_fused(scene, cam, rcfg)))
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_spatial_and_handoff_bit_equal(runs, one_device_frames, shape):
    d, res = runs[shape]
    n = shape[0] * shape[1]
    for key, (ref, plain, fused) in one_device_frames.items():
        np.testing.assert_array_equal(_same_on_every_rank(d, f"{key}_spatial", n), ref,
                                      err_msg=key)
        img = _same_on_every_rank(d, f"{key}_handoff", n)
        np.testing.assert_array_equal(img, plain, err_msg=key)
        np.testing.assert_array_equal(img, fused, err_msg=key)
    stats = res[0]["stats"]
    assert all(r["stats"] == stats for r in res)
    shipped = sum(s["lanes_shipped"] for s in stats.values())
    assert (shipped > 0) == (shape[1] > 1), stats
    for s in stats.values():
        assert s["bytes_shipped"] == s["lanes_shipped"] * 116


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_slabs_hold_their_share(runs, worlds, shape):
    _, res = runs[shape]
    for prefix in ("terrain", "materials"):
        Sx, Sy, Sz = worlds[prefix][0].shape
        for r in res:
            assert r["slab_w"][prefix] == (Sx // shape[1], Sy, Sz)


def test_dryrun_multichip_on_four_ranks(runs):
    _, res = runs[(2, 2)]
    for r in res:
        out = r["dryrun"]
        assert out["n"] == 4 and out["mesh"] == (2, 2)
        for k in ("loss", "spatial_render_mean", "handoff_render_mean", "fused_dp_loss"):
            assert np.isfinite(out[k]), out
        assert out["spatial_render_mean"] == out["handoff_render_mean"]  # the same frame


def test_scaling_harness_on_four_ranks(runs):
    _, res = runs[(2, 2)]
    for key, counts in (("render_rates", {1, 2, 4}), ("handoff_rates", {1, 2, 4}),
                        ("train_rates", {1, 2, 4})):
        rates = res[0][key]
        assert set(rates) == counts and all(v > 0 for v in rates.values()), (key, rates)
        assert all(r[key] == rates for r in res)  # every rank reports the slowest rank's time
        assert tscaling.efficiency(rates)[1] == 1.0


def test_overhead_and_efficiency_match_jax():
    rates = {1: 1000.0, 2: 1800.0, 4: 3000.0, 8: 4100.0}
    assert tscaling.overhead_table(rates) == jscaling.overhead_table(rates)
    assert tscaling.efficiency(rates) == jscaling.efficiency(rates)
    assert tscaling.overhead_table({2: 5.0}) == {} and tscaling.efficiency({}) == {}
    assert tscaling.efficiency({2: 10.0, 4: 15.0}) == jscaling.efficiency({2: 10.0, 4: 15.0})


def test_run_ranks_raises_with_the_failing_rank_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank one stops here") as e:
        run_ranks(R.fail_on_rank_one, 2, timeout=60.0)
    assert "rank 1 of 2 failed" in str(e.value) and "Traceback" in str(e.value)
    assert time.monotonic() - t0 < 30.0  # the waiting rank was killed, not waited for


def test_run_ranks_kills_a_hung_world_at_its_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 of 2 ranks still running"):
        run_ranks(R.sleep_forever, 2, timeout=3.0)
    assert time.monotonic() - t0 < 20.0
