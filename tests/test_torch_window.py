"""PyTorch port: the window render (kernels/fused_window.py) against the JAX
window anchor, and the wrapper's dispatch rules.

On CPU tensors ``render_window_fused`` runs ``window_plain`` (the kernels'
plain version, differentiated by autograd). It is held against
``render_rays_diff_window(accum="scatter", enumerate_mode="scan")``, the XLA
anchor the JAX package's own fused-window tests use, on the 64^3 pillar world
of tests/test_fused_window.py with 16x64 rays and numpy-seeded seeds, a
numpy-seeded density jitter and a random output cotangent. Tolerances are
those of tests/test_fused_window.py: forward atol 1e-5, field gradients 1e-4
and pose gradients 2e-4, max-scaled. Where the reference's own ray-direction
gradient is not finite (the sky's sun sigmoid overflows), the port's must be
non-finite on the same entries. The CUDA kernels run only on a card
(``python3 chip_smoke.py`` holds them against ``window_plain`` there).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.core.color import rgb_to_u64
from raytracing_test_tpu.core.tree import Palette
from raytracing_test_tpu.core.types import Block
from raytracing_test_tpu.render import diff as jdiff
from raytracing_test_tpu.render.camera import Camera as JCamera, ray_directions as jrays
from raytracing_test_tpu_torch.kernels import fused_window as tfw
from raytracing_test_tpu_torch.render import diff as tdiff
from raytracing_test_tpu_torch.render.fast import sun_unit

torch.set_num_threads(1)


def _fields(shape):
    """The pillar world of tests/test_fused_window.py as (density, albedo)
    numpy fields, density jittered so every cell has a gradient."""
    pal = Palette()
    red = pal.id_for(Block(0, int(rgb_to_u64(200, 30, 30))))
    green = pal.id_for(Block(0, int(rgb_to_u64(30, 200, 30))))
    grid = np.zeros(shape, np.uint8)
    grid[:, 0:8, :] = red
    grid[shape[0] // 2: shape[0] // 2 + 4, 8:30, 20:24] = green
    albedo, _, _ = jflat.palette_arrays(pal)
    rng = np.random.default_rng(sum(shape))
    density = np.where(grid > 0, 8.0, 0.0) + rng.uniform(0.0, 0.3, shape)
    return density.astype(np.float32), albedo[grid]


# name: (render kwargs, num_steps, world shape, camera pos, miss seeds)
CASES = {
    "sky_off": (dict(sky=False), 24, (64, 64, 64), (16.3, 20.7, 15.1), False),
    "sky_on": (dict(sky=True), 24, (64, 64, 64), (16.3, 20.7, 15.1), False),
    "shading_shadow": (dict(sky=True, shading=True, shadow_steps=6), 24, (64, 64, 64),
                       (16.3, 20.7, 15.1), False),
    "miss_seeds": (dict(sky=False, shading=True), 24, (64, 64, 64), (16.3, 20.7, 15.1), True),
    "steps7": (dict(sky=True), 7, (64, 64, 64), (16.3, 20.7, 15.1), False),
    "world16": (dict(sky=False, shading=True, shadow_steps=6), 24, (16, 16, 16),
                (3.3, 14.7, 2.1), False),
}


def _max_scaled(got, want, tol, name, finite_only=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    m = np.isfinite(want)
    if finite_only:
        np.testing.assert_array_equal(np.isfinite(got), m, err_msg=f"{name}: non-finite entries")
    else:
        assert m.all(), f"{name}: the reference gradient is not finite"
    sc = np.abs(want[m]).max() + 1e-12
    err = np.abs(got[m] - want[m]).max() / sc
    assert err <= tol, f"{name}: max-scaled error {err:.3e} > {tol}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_matches_jax_anchor(case):
    kw, S, shape, pos, miss = CASES[case]
    density, albedo = _fields(shape)
    pos = np.asarray(pos, np.float32)
    jc = JCamera(pos=jnp.asarray(pos), dir=jnp.asarray([0.43, -0.61, 0.52], jnp.float32))
    dirs = np.asarray(jrays(jc, 64, 16))
    N = dirs.shape[0]
    rng = np.random.default_rng(S)
    seed = rng.uniform(0.0, 6.0, N).astype(np.float32)
    if miss:
        seed[rng.random(N) < 0.3] = 1e6
    cot = rng.normal(size=(N, 3)).astype(np.float32)

    def jf(d, a, o, r):
        return jdiff.render_rays_diff_window(
            jdiff.DiffScene(d, a), o, r, num_steps=S, start_t=jnp.asarray(seed),
            accum="scatter", enumerate_mode="scan", **kw)

    want, vjp = jax.vjp(jax.jit(jf), *(jnp.asarray(v) for v in (density, albedo, pos, dirs)))
    g_want = vjp(jnp.asarray(cot))

    leaves = [torch.tensor(v, requires_grad=True) for v in (density, albedo, pos, dirs)]
    launches = (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD)
    got = tfw.render_window_fused(tdiff.DiffScene(leaves[0], leaves[1]), leaves[2], leaves[3],
                                  num_steps=S, start_t=torch.from_numpy(seed), **kw)
    got.backward(torch.from_numpy(cot))
    assert (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD) == launches  # CPU tensors never launch

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    sky_dirs = kw.get("sky", True)
    for name, leaf, g, tol in zip(("density", "albedo", "origin", "dirs"), leaves, g_want,
                                  (1e-4, 1e-4, 2e-4, 2e-4)):
        _max_scaled(leaf.grad.numpy(), g, tol, name, finite_only=name == "dirs" and sky_dirs)
    if miss:
        # miss seeds render pure sky: no colour and no field gradient
        dead = seed >= tdiff.MISS_SEED_MIN
        assert dead.any() and not got.detach().numpy()[dead].any()


def test_window_aux_keys_and_miss_rays():
    density, albedo = _fields((64, 64, 64))
    scene = tdiff.DiffScene(torch.from_numpy(density), torch.from_numpy(albedo))
    dirs = torch.nn.functional.normalize(torch.tensor([[0.4, -0.6, 0.5]] * 4), dim=1)
    seed = torch.tensor([0.0, 1.0, 1e6, 2e6])
    rgb, aux = tfw.render_window_fused(scene, torch.tensor([16.3, 20.7, 15.1]), dirs,
                                       start_t=seed, sky=True, return_aux=True)
    assert set(aux) == {"escaped", "n_escaped", "t_end", "w_sum", "grads_dropped"}
    assert aux["n_escaped"] == 0 and aux["grads_dropped"] is False
    assert not aux["escaped"].any()
    # parked rays keep transmittance 1 and show the sky
    assert torch.equal(aux["t_end"][2:], torch.ones(2)) and torch.equal(aux["w_sum"][2:], torch.zeros(2))
    assert (aux["w_sum"][:2] > 0.5).all()


def test_window_function_plumbing(monkeypatch):
    """_WindowFn with its launches replaced by the plain version and autograd:
    the gradients land on the field, tmax and abs_delta, in the right slots."""
    rng = np.random.default_rng(3)
    shape = (12, 10, 14)
    field = torch.tensor(rng.uniform(0, 2, (12 * 10 * 14, 4)).astype(np.float32))
    N = 64
    cell = torch.tensor(rng.integers(0, 10, (N, 3)).astype(np.int32))
    istep = torch.tensor(rng.choice([-1, 1], (N, 3)).astype(np.int32))
    tmax = torch.tensor(rng.uniform(0.1, 1.0, (N, 3)).astype(np.float32))
    absd = torch.tensor(rng.uniform(1.0, 3.0, (N, 3)).astype(np.float32))
    sun = sun_unit((2.0, 1.0, 4.0))

    def fake_fwd(*a):
        with torch.no_grad():
            return tfw.window_plain(*a)

    def fake_bwd(f, c, t, i, ab, shp, s, S, sh, g_surf, g_tend, surf, t_end):
        f, t, ab = (x.detach().requires_grad_(True) for x in (f, t, ab))
        with torch.enable_grad():
            out = tfw.window_plain(f, c, t, i, ab, shp, s, S, sh)
            return torch.autograd.grad(out[:2], (f, t, ab), (g_surf, g_tend))

    monkeypatch.setattr(tfw, "_launch_fwd", fake_fwd)
    monkeypatch.setattr(tfw, "_launch_bwd", fake_bwd)
    leaves = [x.clone().requires_grad_(True) for x in (field, tmax, absd)]
    out = tfw._WindowFn.apply(leaves[0], cell, leaves[1], istep, leaves[2], shape,
                              tuple(float(v) for v in sun), 24, True)
    assert not out[2].requires_grad and not out[3].requires_grad  # w_sum, t_exp
    cot = [torch.tensor(rng.normal(size=o.shape).astype(np.float32)) for o in out[:2]]
    torch.autograd.backward(out[:2], cot)
    ref = [x.clone().requires_grad_(True) for x in (field, tmax, absd)]
    r = tfw.window_plain(ref[0], cell, ref[1], istep, ref[2], shape, sun, 24, True)
    torch.autograd.backward(r[:2], cot)
    for a, b in zip(leaves, ref):
        assert torch.equal(a.grad, b.grad)


class _PlainForwardLibrary:
    """Stands in for the fused_window library: its window_fwd_launch runs
    window_plain on the memory it is handed and writes the four outputs
    there, as the kernel does."""

    def __init__(self, field):
        self.field, self.launches = field, []

    def window_fwd_launch(self, field, sx, sy, sz, cell, tmax, istep, absd, n, S, shading,
                          sun_x, sun_y, sun_z, surf, t_end, w_sum, t_exp, stream):
        def view(ptr, ct, shape):
            mem = (ct * int(np.prod(shape))).from_address(ptr)
            return torch.from_numpy(np.ctypeslib.as_array(mem)).reshape(shape)

        i32, f32 = ctypes.c_int32, ctypes.c_float
        assert field == self.field.data_ptr()
        fld = view(field, f32, (sx * sy * sz, 4))
        rays = [view(cell, i32, (n, 3)), view(tmax, f32, (n, 3)), view(istep, i32, (n, 3)),
                view(absd, f32, (n, 3))]
        outs = [view(surf, f32, (n, 3))] + [view(p, f32, (n,)) for p in (t_end, w_sum, t_exp)]
        with torch.no_grad():
            got = tfw.window_plain(fld, rays[0], rays[1], rays[2], rays[3], (sx, sy, sz),
                                   (sun_x, sun_y, sun_z), S, bool(shading))
        for o, g in zip(outs, got):
            o.copy_(g)
        self.launches.append((n, S, shading))
        return 0

    def kernel_error_string(self, err):
        return b"stand-in"


def test_window_fwd_launch_plumbing(monkeypatch):
    """_launch_fwd on a stand-in library that computes on the memory it is
    handed: the arguments reach window_fwd_launch in its order, the outputs
    come back as window_plain's, and the launch counts once."""
    from raytracing_test_tpu_torch.kernels import build

    rng = np.random.default_rng(5)
    shape = (12, 10, 14)
    field = torch.tensor(rng.uniform(0, 2, (12 * 10 * 14, 4)).astype(np.float32))
    N = 40
    cell = torch.tensor(rng.integers(0, 10, (N, 3)).astype(np.int32))
    istep = torch.tensor(rng.choice([-1, 1], (N, 3)).astype(np.int32))
    tmax = torch.tensor(rng.uniform(0.1, 1.0, (N, 3)).astype(np.float32))
    absd = torch.tensor(rng.uniform(1.0, 3.0, (N, 3)).astype(np.float32))
    sun = tuple(float(v) for v in sun_unit((2.0, 1.0, 4.0)))
    lib = _PlainForwardLibrary(field)
    monkeypatch.setattr(build, "_LIBS", {"fused_window": lib})
    monkeypatch.setattr(tfw, "_stream", lambda dev: 0)
    monkeypatch.setattr(tfw, "LAUNCHES_FWD", tfw.LAUNCHES_FWD)  # restored afterwards
    n0 = tfw.LAUNCHES_FWD
    got = tfw._launch_fwd(field, cell, tmax, istep, absd, shape, sun, 24, True)
    assert tfw.LAUNCHES_FWD == n0 + 1 and lib.launches == [(N, 24, 1)]
    want = tfw.window_plain(field, cell, tmax, istep, absd, shape, sun, 24, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w.detach())


def test_window_dispatch_never_falls_back():
    density, albedo = _fields((16, 16, 16))
    meta = torch.device("meta")
    field = tdiff._pack_fields(tdiff.DiffScene(torch.from_numpy(density), torch.from_numpy(albedo)))
    rays = dict(cell=torch.zeros((4, 3), dtype=torch.int32), tmax=torch.ones((4, 3)),
                istep=torch.ones((4, 3), dtype=torch.int32), abs_delta=torch.ones((4, 3)))
    sun = sun_unit((2.0, 1.0, 4.0))
    launches = (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD)
    with pytest.raises(ValueError, match="unsupported device"):
        tfw.window_call(field.to(meta), *(v.to(meta) for v in rays.values()), (16, 16, 16),
                        sun, 24, False)
    with pytest.raises(ValueError, match="field on"):
        tfw.window_call(field.to(meta), *rays.values(), (16, 16, 16), sun, 24, False)
    # the launch path checks its inputs before it builds anything
    with pytest.raises(ValueError, match="tmax must be"):
        tfw._launch_fwd(field, rays["cell"], rays["tmax"].double(), rays["istep"],
                        rays["abs_delta"], (16, 16, 16), sun, 24, False)
    with pytest.raises(ValueError, match="field must be"):
        tfw._launch_fwd(field, *rays.values(), (16, 16, 15), sun, 24, False)
    assert (tfw.LAUNCHES_FWD, tfw.LAUNCHES_BWD) == launches


def test_window_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; chip_smoke.py covers the launch")
    density, albedo = _fields((16, 16, 16))
    scene = tdiff.DiffScene(torch.from_numpy(density), torch.from_numpy(albedo))
    with pytest.raises((RuntimeError, AssertionError)):
        cuda_scene = tdiff.DiffScene(scene.density.to("cuda"), scene.albedo.to("cuda"))
        tfw.render_window_fused(cuda_scene, torch.zeros(3), torch.ones((4, 3)))


def test_transmittance_matches_jax():
    density, albedo = _fields((64, 64, 64))
    rng = np.random.default_rng(11)
    o = rng.uniform([2, 2, 2], [60, 30, 60], (200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cot = rng.normal(size=200).astype(np.float32)
    want, vjp = jax.vjp(lambda dn: jdiff.transmittance(jdiff.DiffScene(dn, jnp.asarray(albedo)),
                                                       jnp.asarray(o), jnp.asarray(d), num_steps=8),
                        jnp.asarray(density))
    dn = torch.tensor(density, requires_grad=True)
    got = tdiff.transmittance(tdiff.DiffScene(dn, torch.from_numpy(albedo)), torch.from_numpy(o),
                              torch.from_numpy(d), num_steps=8)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    _max_scaled(dn.grad.numpy(), vjp(jnp.asarray(cot))[0], 1e-5, "density")
