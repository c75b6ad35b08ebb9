"""PyTorch port: the brick path against the JAX package on the same inputs.

``render/bricks.py`` (the plain path) against the JAX XLA twin
``bricks.render_rays_bricks``; the two kernels' plain versions
(``brick_advance_plain``, ``brick_fine_plain`` + the material glue) against
the twin's inner loops on the same state; ``_prop_luts``; the Pallas kernels
in interpret mode in one tiny case; and the CLI's ``render --mode``. On CPU
tensors the wrappers run the plain versions, so ``LAUNCHES_*`` stay 0; the
CUDA kernels run in ``chip_smoke.py``.

Contracts: images ``assert_images_close`` (XLA's CPU jit contracts a*b+c into
FMAs, PyTorch rounds each operation), integer fields equal; within the port,
the brick frame equals the plain fused frame bit for bit, as
``tests/test_bricks.py`` holds the JAX brick path to the JAX fast path.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_test_tpu.config import RenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten as jflat
from raytracing_test_tpu.kernels import brick_kernels as jbk
from raytracing_test_tpu.render import bricks as jbricks
from raytracing_test_tpu.render import fast as jfast
from raytracing_test_tpu.render.camera import Camera as JCamera, ray_directions as jrays
from raytracing_test_tpu.worldgen import terrain
from raytracing_test_tpu_torch.app import cli
from raytracing_test_tpu_torch.core import flatten as tflat
from raytracing_test_tpu_torch.kernels import brick_kernels as tbk
from raytracing_test_tpu_torch.kernels import build
from raytracing_test_tpu_torch.kernels import fused_march as tfm
from raytracing_test_tpu_torch.render import bricks as tbricks
from raytracing_test_tpu_torch.render import fast as tfast
from raytracing_test_tpu_torch.render.renderer import _March
from tests.test_render_parity import CASES, _material_world, assert_images_close
from tests.test_torch_cli import _read_png

torch.set_num_threads(1)

TERRAIN_VIEW = ((24.0, 45.0, -8.0), (0.25, -0.65, 0.9))
# one compile per config and shape, shared by the cases (scene and rays are traced)
_jit_bricks = jax.jit(jbricks.render_rays_bricks, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def mat_scenes():
    grid, pal = _material_world()
    return jflat.scene_from_grid(grid, pal), tflat.scene_from_grid(grid, pal, "cpu")


@pytest.fixture(scope="module")
def terrain_scenes():
    grid, pal = terrain.gen_world_grid(WorldConfig(width=48, length=48, grid_shape=(64, 64, 64)))
    return jflat.scene_from_grid(grid, pal), tflat.scene_from_grid(grid, pal, "cpu")


def _dirs(pos, dirn, rcfg):
    jc = JCamera(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(dirn, jnp.float32))
    return jc.pos, jrays(jc, rcfg.width, rcfg.height)


def _both(scenes, pos, dirn, rcfg, time_s=0.0, start_t=None):
    """(JAX twin rgb, aux), (port plain brick rgb, aux), (port fused rgb, aux)."""
    js, ts = scenes
    o, dirs = _dirs(pos, dirn, rcfg)
    st = None if start_t is None else jnp.asarray(start_t)
    cj, aj = _jit_bricks(js, o, dirs, cfg=rcfg, time_s=jnp.float32(time_s), start_t=st)
    to, td = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(dirs))
    tst = None if start_t is None else torch.from_numpy(np.asarray(start_t))
    cb, ab = tbricks.render_rays_bricks(ts, to, td, rcfg, time_s=time_s, start_t=tst)
    cf, af = tfm.render_rays_fused(ts, to, td, rcfg, time_s=time_s, start_t=tst)
    return (np.asarray(cj), aj), (cb.numpy(), ab), (cf.numpy(), af)


def _assert_port_pair(b, f, exact_rgb):
    """The port's brick frame against its fused frame, as tests/test_bricks.py
    holds the two JAX paths: rgb equal where that file is exact, else
    assert_images_close; mat equal. Both paths cross the same cells, but
    the brick path adds c * abs_delta over other spans of cells than the
    fused path, so a later near-tie can resolve the other way: cell and
    steps are held on the rays that hit, within the 1% budget. A sky ray
    stops where an exit rule first fires, which depends on the size of the
    air boxes it crossed, so its end cell differs between the paths (in the
    JAX package too); its colour does not."""
    if exact_rgb:
        np.testing.assert_array_equal(b[0], f[0])
    else:
        side = int(np.sqrt(b[0].shape[0]))
        assert_images_close(b[0].reshape(side, side, 3), f[0].reshape(side, side, 3))
    np.testing.assert_array_equal(b[1]["mat"].numpy(), f[1]["mat"].numpy())
    hit = f[1]["mat"].numpy() != 0
    for k in ("steps", "cell"):
        eq = b[1][k].numpy()[hit] == f[1][k].numpy()[hit]
        eq = eq.all(axis=1) if eq.ndim == 2 else eq
        assert eq.size == 0 or eq.mean() >= 0.99, (k, eq.mean())


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_bricks_match_jax_material_cases(mat_scenes, case):
    pos, dirn, time_s = case
    rcfg = RenderConfig(width=24, height=24, max_steps=150, shadow_steps=40)
    j, b, f = _both(mat_scenes, pos, dirn, rcfg, time_s)
    hw = (rcfg.height, rcfg.width, 3)
    assert_images_close(b[0].reshape(hw), j[0].reshape(hw))
    for k in ("mat", "steps", "cell"):
        np.testing.assert_array_equal(b[1][k].numpy(), np.asarray(j[1][k]), err_msg=k)
    assert b[1]["march_rounds"] == int(j[1]["march_rounds"])
    _assert_port_pair(b, f, exact_rgb=False)


def test_bricks_match_jax_terrain_exact(terrain_scenes):
    rcfg = RenderConfig(width=32, height=32, max_steps=150, shadow_steps=40)
    j, b, f = _both(terrain_scenes, *TERRAIN_VIEW, rcfg)
    np.testing.assert_array_equal(b[0], j[0])
    for k in ("mat", "steps", "cell"):
        np.testing.assert_array_equal(b[1][k].numpy(), np.asarray(j[1][k]), err_msg=k)
    assert b[1]["march_rounds"] == int(j[1]["march_rounds"]) > 1
    np.testing.assert_array_equal(b[0], f[0])
    for k in ("mat", "steps", "cell"):
        np.testing.assert_array_equal(b[1][k].numpy(), f[1][k].numpy(), err_msg=k)


@pytest.mark.parametrize("view", [
    ((-40.0, 30.0, -40.0), (0.6, -0.2, 0.6)),  # enter through the slab
    ((32.0, 90.0, 32.0), (0.1, 0.9, 0.1)),  # sky-up exit
    ((200.0, 30.0, 200.0), (1.0, 0.1, 1.0)),  # outside moving away
], ids=["slab", "sky-up", "away"])
def test_bricks_outside_window_and_sky(terrain_scenes, view):
    rcfg = RenderConfig(width=16, height=16, max_steps=200, shadow_steps=40)
    j, b, f = _both(terrain_scenes, *view, rcfg)
    assert_images_close(b[0].reshape(16, 16, 3), j[0].reshape(16, 16, 3))
    # these views' directions tie x and z exactly, and XLA's FMA flips a few
    # ties by an ulp: integer fields within assert_images_close's 1% budget
    for k in ("mat", "steps", "cell"):
        eq = (b[1][k].numpy() == np.asarray(j[1][k])).reshape(256, -1).all(axis=1)
        assert eq.mean() >= 0.99, (k, eq.mean())
    assert np.isfinite(b[0]).all()
    assert b[1]["march_rounds"] == int(j[1]["march_rounds"])
    _assert_port_pair(b, f, exact_rgb=True)


def test_bricks_start_t_seed(terrain_scenes):
    rcfg = RenderConfig(width=16, height=16, max_steps=150, shadow_steps=30)
    seed = np.full(16 * 16, 5.0, np.float32)
    j, b, f = _both(terrain_scenes, (24.0, 50.0, -10.0), (0.2, -0.7, 0.8), rcfg, start_t=seed)
    np.testing.assert_array_equal(b[0], j[0])
    _assert_port_pair(b, f, exact_rgb=True)


# ---- the kernels' plain versions against the twin's loops, on one state


def _to_torch(js) -> _March:
    return _March(**{k: torch.from_numpy(np.array(v)) for k, v in js._asdict().items()})


def _assert_state_equal(t, j, fields=("mat", "cell", "tmax", "last_t", "last_axis", "steps",
                                      "done", "dir", "step", "abs_delta", "seg_origin",
                                      "color_mod", "ior", "reflected")):
    """Integer and boolean fields equal; float fields within 1e-6 relative
    (XLA's CPU jit contracts tmax + (n - 1) * abs_delta into one FMA)."""
    for k in fields:
        got, want = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def _round_inputs(js, s, shadow):
    """(table, blin) at the start of a round, as brick_march computes them."""
    table = js.brick_nib_shadow if shadow else js.brick_nib
    d, in_w = jbricks.brick_dist_at(js, table, s.cell)
    want = ~s.done & in_w & (d == 0)
    rows, blin = jbricks.fetch_rows(js, s.cell, want)
    return table, rows, jnp.where(want, blin, -1)


@pytest.fixture(scope="module")
def round_states(mat_scenes):
    """JAX states of the primary march at the mirror-and-glass view (case 1):
    after the first fine phase (the brick phase's input) and after the first
    round (the second fine phase's input)."""
    js, _ = mat_scenes
    pos, dirn, time_s = CASES[1]
    rcfg = RenderConfig(width=24, height=24, max_steps=150, shadow_steps=40)
    o, dirs = _dirs(pos, dirn, rcfg)

    @jax.jit
    def first_round():
        s = jfast._init_state(o, dirs, jnp.ones(dirs.shape[0], jnp.float32))
        mat0, flags0 = jfast.lookup_mat_flags(js, s.cell)
        raw0 = (mat0 != 0) & ((flags0 & 4) == 0)
        s = s._replace(done=raw0, mat=jnp.where(raw0, mat0, 0))
        _, rows, blin = _round_inputs(js, s, False)
        s1 = jbricks._fine_loop(js, s, rows, blin, rcfg, 150, False, time_s)
        s2 = jbricks._brick_loop(js, js.brick_nib, s1, 150)
        return s1, s2

    s1, s2 = first_round()
    return rcfg, time_s, s1, s2


@pytest.mark.parametrize("shadow", [False, True], ids=["primary", "shadow-table"])
def test_brick_advance_plain_matches_jax_brick_loop(mat_scenes, round_states, shadow):
    js, ts = mat_scenes
    _, _, s1, _ = round_states
    table = js.brick_nib_shadow if shadow else js.brick_nib
    want = jax.jit(lambda s: jbricks._brick_loop(js, table, s, 150))(s1)
    t_table = ts.brick_dist_shadow if shadow else ts.brick_dist
    got = tbk.brick_advance(ts, t_table, _to_torch(s1), 150)
    assert tbk.LAUNCHES_ADVANCE == 0
    _assert_state_equal(got, want)
    assert not np.array_equal(np.asarray(want.cell), np.asarray(s1.cell))  # lanes advanced


@pytest.mark.parametrize("shadow", [False, True], ids=["primary", "shadow"])
def test_brick_fine_plain_and_glue_match_jax_fine_loop(mat_scenes, round_states, shadow):
    js, ts = mat_scenes
    rcfg, time_s, _, s2 = round_states
    _, rows, blin = _round_inputs(js, s2, shadow)
    want = jax.jit(lambda s: jbricks._fine_loop(js, s, rows, blin, rcfg, 150, shadow, time_s))(s2)
    tblin = torch.from_numpy(np.array(blin))
    assert (tblin >= 0).sum() > 50
    got = tbk.fine_loop(ts, _to_torch(s2), tblin, rcfg, 150, shadow, time_s)
    assert tbk.LAUNCHES_FINE == 0
    _assert_state_equal(got, want)
    if not shadow:
        assert np.asarray(want.reflected).any()  # the glue ran on mirror events

    # kernel B alone stops at the events, with mat at the event block
    luts = tbk._prop_luts(ts, shadow, True)
    alone, evt = tbk.brick_fine(ts, _to_torch(s2), tblin, luts, 150)
    assert evt.any() != shadow
    flags = ts.flags[alone.mat[evt].long()] & 0x7
    assert ((flags == 0x3) | (flags == 0x5)).all()


def test_exit_rules_zero_mat_in_an_occupied_brick_above_y_max():
    """A lane standing in an occupied brick above y_max, moving up, with a
    stale material id: the brick phase marks it done with mat 0, as the
    twin's final sweep and render/fast.py do; one cell lower it waits."""
    from raytracing_test_tpu.core.tree import Palette as JPalette
    from raytracing_test_tpu.core.types import Block as JBlock
    from raytracing_test_tpu_torch.core.tree import Palette as TPalette
    from raytracing_test_tpu_torch.core.types import Block as TBlock

    grid = np.zeros((16, 16, 16), np.uint8)
    grid[1, 8, 1] = 1  # y_max 9; the brick holding cells y 8..11 is occupied
    jp, tp = JPalette(), TPalette()
    jp.id_for(JBlock(0, 5)), tp.id_for(TBlock(0, 5))
    js, ts = jflat.scene_from_grid(grid, jp), tflat.scene_from_grid(grid, tp, "cpu")
    assert int(js.y_max) == ts.y_max == 9
    one = lambda a: jnp.asarray([a])
    s = jbricks._March(
        mat=one(3), cell=jnp.asarray([[1, 10, 1]], jnp.int32),
        dir=jnp.asarray([[0.3, 0.8, 0.5]], jnp.float32), step=jnp.ones((1, 3), jnp.float32),
        abs_delta=jnp.asarray([[3.25, 1.25, 2.0]], jnp.float32),
        tmax=jnp.asarray([[0.5, 0.75, 0.625]], jnp.float32), seg_origin=jnp.zeros((1, 3)),
        last_t=one(0.25), last_axis=one(1), color_mod=jnp.ones((1, 3)), ior=one(1.0),
        reflected=one(False), done=one(False), steps=one(7))
    for cell, done, mat in (((1, 10, 1), True, 0), ((1, 9, 1), False, 3)):
        state = s._replace(cell=jnp.asarray([cell], jnp.int32))
        want = jbricks._brick_loop(js, js.brick_nib, state, 150)
        got = tbk.brick_advance_plain(ts, ts.brick_dist, _to_torch(state), 150)
        _assert_state_equal(got, want)
        assert (bool(got.done[0]), int(got.mat[0])) == (done, mat)


@pytest.mark.parametrize("world", ["materials", "terrain"])
def test_prop_luts_match_jax(mat_scenes, terrain_scenes, world):
    js, ts = mat_scenes if world == "materials" else terrain_scenes
    for shadow, mats in ((False, True), (False, False), (True, True)):
        want = np.asarray(jbk._prop_luts(js, shadow, mats))
        got = tbk._prop_luts(ts, shadow, mats)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_kernels_match_pallas_interpret(mat_scenes):
    """Both Pallas kernels in interpret mode with the XLA glue, against the
    port's plain kernel versions with the PyTorch glue (12x12, one case)."""
    js, ts = mat_scenes
    pos, dirn, time_s = CASES[5]  # mirror reflection path
    rcfg = RenderConfig(width=12, height=12, max_steps=150, shadow_steps=40)
    o, dirs = _dirs(pos, dirn, rcfg)
    cj, aj = jax.jit(lambda t: jbk.render_rays_bricks_pallas(
        js, o, dirs, rcfg, interpret=True, time_s=t))(jnp.float32(time_s))
    cp, ap = tbk.render_rays_bricks_pallas(ts, torch.from_numpy(np.array(o)),
                                           torch.from_numpy(np.array(dirs)), rcfg, time_s=time_s)
    hw = (12, 12, 3)
    assert_images_close(cp.numpy().reshape(hw), np.asarray(cj).reshape(hw))
    for k in ("mat", "steps", "cell"):
        np.testing.assert_array_equal(ap[k].numpy(), np.asarray(aj[k]), err_msg=k)
    assert ap["reflected"].any()
    assert ap["march_rounds"] == int(aj["march_rounds"])
    assert (tbk.LAUNCHES_ADVANCE, tbk.LAUNCHES_FINE) == (0, 0)


# ---- dispatch


def test_no_silent_fallback_off_cpu(terrain_scenes, monkeypatch):
    """Off the CPU the wrappers launch or raise, never the plain versions."""
    _, ts = terrain_scenes
    s = tfast._init_state(torch.tensor([24.0, 45.0, -8.0]),
                          torch.nn.functional.normalize(torch.ones(4, 3), dim=1), torch.ones(4))
    blin = torch.zeros(4, dtype=torch.int32)
    luts = tbk._prop_luts(ts, False, True)

    def plain_must_not_run(*a, **k):
        raise AssertionError("the plain version ran for a CUDA call")

    meta = torch.device("meta")
    ms = tfast._init_state(torch.zeros(3, device=meta), torch.ones((4, 3), device=meta),
                           torch.ones(4, device=meta))
    with pytest.raises(ValueError, match="scene on"):
        tbk.brick_advance(ts, ts.brick_dist, ms, 10)
    with pytest.raises(ValueError, match="scene on"):
        tbk.brick_fine(ts, ms, blin, luts, 10)

    # the CUDA branch with the kernel library unavailable: the build's error
    monkeypatch.setattr(tbk, "_device", lambda scene, st, what: torch.device("cuda"))
    monkeypatch.setattr(tbk, "brick_advance_plain", plain_must_not_run)
    monkeypatch.setattr(tbk, "brick_fine_plain", plain_must_not_run)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        tbk.brick_advance(ts, ts.brick_dist, s, 10)
    with pytest.raises(RuntimeError, match="nvcc"):
        tbk.advance_loop(ts, ts.brick_dist, s, 10)
    with pytest.raises(RuntimeError, match="nvcc"):
        tbk.brick_fine(ts, s, blin, luts, 10)
    assert (tbk.LAUNCHES_ADVANCE, tbk.LAUNCHES_FINE) == (0, 0)


def _view(ptr, dtype, shape):
    """A CPU tensor on the memory at address ``ptr``: what a stand-in for a
    kernel sees of the pointer it is handed."""
    ct = {torch.int32: ctypes.c_int32, torch.float32: ctypes.c_float, torch.bool: ctypes.c_bool}
    n = int(np.prod(shape))
    return torch.from_numpy(np.ctypeslib.as_array((ct[dtype] * n).from_address(ptr))).reshape(shape)


class _PlainAdvanceLibrary:
    """Stands in for the brick_march library: its brick_advance_launch runs
    brick_advance_plain on the memory it is handed and writes the result
    there, in place, as the kernel does."""

    def __init__(self, scene, base):
        self.scene, self.base, self.launches = scene, base, 0

    def brick_advance_launch(self, table, sx, sy, sz, shift, y_max, budget, cell, tmax, step,
                             abs_delta, mat, done, last_t, last_axis, steps, n, stream):
        assert table == self.scene.brick_dist.data_ptr() and (sx, sy, sz) == self.scene.shape3
        i32, f32 = torch.int32, torch.float32
        mem = {"cell": (cell, i32, (n, 3)), "tmax": (tmax, f32, (n, 3)),
               "step": (step, f32, (n, 3)), "abs_delta": (abs_delta, f32, (n, 3)),
               "mat": (mat, i32, (n,)), "done": (done, torch.bool, (n,)),
               "last_t": (last_t, f32, (n,)), "last_axis": (last_axis, i32, (n,)),
               "steps": (steps, i32, (n,))}
        views = {k: _view(*v) for k, v in mem.items()}
        s = self.base._replace(**{k: v.clone() for k, v in views.items()})
        out = tbk.brick_advance_plain(self.scene, self.scene.brick_dist, s, budget)
        for f in tbricks.HOOK_WRITES:
            views[f].copy_(getattr(out, f))
        self.launches += 1
        return 0

    def kernel_error_string(self, err):
        return b"stand-in"


def test_brick_advance_kernel_path_owns_its_writes(terrain_scenes, monkeypatch):
    """The wrappers' CUDA branch on a stand-in library that advances in
    place (on CPU memory): brick_advance leaves the caller's state as it
    was and returns the advanced copy; advance_loop, the brick path's hook,
    advances the state it is given in place; each launch counts once; a
    field that is not contiguous is refused."""
    _, ts = terrain_scenes
    rcfg = RenderConfig(width=16, height=12, max_steps=150, shadow_steps=40)
    s = tfast._init_state(torch.tensor(TERRAIN_VIEW[0]),
                          torch.from_numpy(np.array(_dirs(*TERRAIN_VIEW, rcfg)[1])),
                          torch.ones(16 * 12))
    s, _, _ = tfast.start_cell(ts, s)
    s = tbricks._fine_loop(ts, s, tbricks.occupied_brick(ts, ts.brick_dist, s), rcfg, 150, False,
                           0.0)
    want = tbk.brick_advance_plain(ts, ts.brick_dist, s, 150)
    assert not torch.equal(want.cell, s.cell)  # lanes advance
    lib = _PlainAdvanceLibrary(ts, s)
    monkeypatch.setattr(tbk, "_device", lambda scene, st, what: torch.device("cuda"))
    monkeypatch.setattr(tbk, "_stream", lambda dev: 0)
    monkeypatch.setattr(build, "_LIBS", {"brick_march": lib})
    monkeypatch.setattr(tbk, "LAUNCHES_ADVANCE", tbk.LAUNCHES_ADVANCE)  # restored afterwards
    before = {f: getattr(s, f).clone() for f in tbricks.HOOK_WRITES}
    n0 = tbk.LAUNCHES_ADVANCE

    got = tbk.brick_advance(ts, ts.brick_dist, s, 150)
    assert tbk.LAUNCHES_ADVANCE == n0 + 1 == n0 + lib.launches
    for f in tbricks.HOOK_WRITES:
        assert torch.equal(getattr(s, f), before[f]), f  # the caller's state is untouched
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).data_ptr() != getattr(s, f).data_ptr(), f

    mine = tbricks.writable(s)
    ptrs = {f: getattr(mine, f).data_ptr() for f in tbricks.HOOK_WRITES}
    out = tbk.advance_loop(ts, ts.brick_dist, mine, 150)
    assert tbk.LAUNCHES_ADVANCE == n0 + 2 == n0 + lib.launches
    for f in tbricks.HOOK_WRITES:
        assert getattr(out, f).data_ptr() == ptrs[f], f  # written in place
        assert torch.equal(getattr(mine, f), getattr(want, f)), f

    strided = s._replace(tmax=s.tmax.t().contiguous().t())
    with pytest.raises(ValueError, match="tmax must be contiguous"):
        tbk.advance_loop(ts, ts.brick_dist, strided, 150)
    assert tbk.LAUNCHES_ADVANCE == n0 + 2


class _PlainFineLibrary:
    """Stands in for the brick_march library: its brick_fine_launch runs
    brick_fine_plain on the memory it is handed and writes the result there,
    in place, over all lanes or over the listed ones, writes evt on those,
    and appends the event lanes to the list, as the kernel does."""

    def __init__(self, scene, base):
        self.scene, self.base, self.launches, self.listed = scene, base, 0, []

    def brick_fine_launch(self, bmat, luts, sx, sy, sz, shift, budget, cell, tmax, step, abs_delta,
                          mat, done, last_t, last_axis, steps, blin, evt, lanes, n, list_out,
                          count_out, count_clear, stream):
        assert bmat == self.scene.brick_mat.data_ptr() and (sx, sy, sz) == self.scene.shape3
        N = self.base.cell.shape[0]
        i32, f32 = torch.int32, torch.float32
        mem = {"cell": (cell, i32, (N, 3)), "tmax": (tmax, f32, (N, 3)),
               "step": (step, f32, (N, 3)), "abs_delta": (abs_delta, f32, (N, 3)),
               "mat": (mat, i32, (N,)), "done": (done, torch.bool, (N,)),
               "last_t": (last_t, f32, (N,)), "last_axis": (last_axis, i32, (N,)),
               "steps": (steps, i32, (N,))}
        views = {k: _view(*v) for k, v in mem.items()}
        ids = torch.arange(n) if lanes is None else _view(lanes, i32, (n,)).long().clone()
        if count_clear:
            _view(count_clear, i32, (1,))[0] = 0
        keep = torch.zeros(N, dtype=torch.bool)
        keep[ids] = True
        b = _view(blin, i32, (N,))
        s = self.base._replace(**{k: v.clone() for k, v in views.items()})
        out, e = tbk.brick_fine_plain(self.scene, s, torch.where(keep, b, torch.full_like(b, -1)),
                                      _view(luts, i32, (8,)).clone(), budget)
        for f in tbricks.HOOK_WRITES:
            views[f].copy_(getattr(out, f))
        _view(evt, torch.bool, (N,))[ids] = e[ids]
        if list_out:
            c = _view(count_out, i32, (1,))
            ev = ids[e[ids]].to(i32)
            if ev.numel():
                _view(list_out, i32, (int(c[0]) + ev.numel(),))[int(c[0]):] = ev
            c[0] += ev.numel()
        self.launches += 1
        self.listed.append(None if lanes is None else n)
        return 0

    def kernel_error_string(self, err):
        return b"stand-in"


@pytest.fixture
def fine_kernel_path(mat_scenes, round_states, monkeypatch):
    """The mirror-and-glass view's second fine phase input, and the
    wrappers' CUDA branch on a stand-in library (_PlainFineLibrary, on CPU
    memory): (scene, state, blin, library)."""
    js, ts = mat_scenes
    _, _, _, s2 = round_states
    _, _, blin = _round_inputs(js, s2, False)
    s = _to_torch(s2)
    lib = _PlainFineLibrary(ts, s)
    monkeypatch.setattr(tbk, "_device", lambda scene, st, what: torch.device("cuda"))
    monkeypatch.setattr(tbk, "_stream", lambda dev: 0)
    monkeypatch.setattr(build, "_LIBS", {"brick_march": lib})
    monkeypatch.setattr(tbk, "LAUNCHES_FINE", 0)
    return ts, s, torch.from_numpy(np.array(blin)), lib


def test_brick_fine_leaves_its_input_unchanged(fine_kernel_path):
    """brick_fine's CUDA branch, whose kernel writes in place, on a stand-in
    library: the caller's state is left as it was and the result is
    brick_fine_plain's; a launch over the event lanes after the glue, in
    place on a writable copy, is brick_fine_plain's over all lanes."""
    ts, s, blin, lib = fine_kernel_path
    luts = tbk._prop_luts(ts, False, True)
    before = {f: getattr(s, f).clone() for f in tbricks.HOOK_WRITES}
    got, evt = tbk.brick_fine(ts, s, blin, luts, 150)
    want, evt_want = tbk.brick_fine_plain(ts, s, blin, luts, 150)
    assert tbk.LAUNCHES_FINE == lib.launches == 1 and bool(evt_want.any())
    assert torch.equal(evt, evt_want)
    for f in tbricks.HOOK_WRITES:
        assert torch.equal(getattr(s, f), before[f]), f  # the caller's state is untouched
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).data_ptr() != getattr(s, f).data_ptr(), f

    s2 = tbk.material_glue(ts, got, evt, RenderConfig(width=24, height=24), 150, CASES[1][2])
    lanes = torch.nonzero(evt).flatten().to(torch.int32)
    got2, evt2 = tbricks.writable(s2), evt.clone()
    tbk._launch_fine(ts, got2, blin, luts, 150, evt2, lanes, lanes.numel())
    want2, evt_want2 = tbk.brick_fine_plain(ts, s2, blin, luts, 150)
    assert lib.listed == [None, lanes.numel()] and tbk.LAUNCHES_FINE == 2
    assert torch.equal(evt2, evt_want2)
    for f in tbricks.HOOK_WRITES:
        assert torch.equal(getattr(got2, f), getattr(want2, f)), f


def test_fine_loop_kernel_path_works_in_place(fine_kernel_path):
    """fine_loop's CUDA branch on the stand-in library: the first launch over
    all lanes, each glue pass over the listed event lanes of the one before,
    in place on the state it is given (which the march owns); the result is
    the plain fine_loop's; every launch counts once."""
    ts, s, blin, lib = fine_kernel_path
    rcfg = RenderConfig(width=24, height=24, max_steps=150, shadow_steps=40)
    time_s = CASES[1][2]
    mine = tbricks.writable(s)
    mat_ptr = mine.mat.data_ptr()
    got = tbk.fine_loop(ts, mine, blin, rcfg, 150, False, time_s)
    assert got.mat.data_ptr() == mat_ptr  # written in place; the glue never replaces mat
    assert lib.launches == tbk.LAUNCHES_FINE >= 2
    assert lib.listed[0] is None and all(k is not None and k > 0 for k in lib.listed[1:])
    assert lib.listed[1] < blin.shape[0]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tbk, "_device", lambda scene, st, what: torch.device("cpu"))
        want = tbk.fine_loop(ts, s, blin, rcfg, 150, False, time_s)
    for f in ("mat", "cell", "tmax", "last_t", "last_axis", "steps", "done", "dir", "step",
              "abs_delta", "seg_origin", "color_mod", "ior", "reflected"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f

    strided = tbricks.writable(s)._replace(tmax=s.tmax.t().contiguous().t())
    with pytest.raises(ValueError, match="tmax must be contiguous"):
        tbk.fine_loop(ts, strided, blin, rcfg, 150, False, time_s)


# ---- the CLI


def test_cli_bricks_pallas_matches_fused_png(tmp_path):
    argv = ["--device", "cpu", "--world", "48", "--width", "64", "--height", "64", "render"]
    cli.main(argv + ["--mode", "bricks-pallas", "--out", str(tmp_path / "b.png")])
    cli.main(argv + ["--out", str(tmp_path / "f.png")])
    b, f = _read_png(tmp_path / "b.png"), _read_png(tmp_path / "f.png")
    assert b.shape == (64, 64, 3)
    np.testing.assert_array_equal(b, f)
    assert (tbk.LAUNCHES_ADVANCE, tbk.LAUNCHES_FINE, tfm.LAUNCHES) == (0, 0, 0)
    assert cli.build_parser().parse_args(["render"]).mode == "fused"
    assert cli.build_parser().parse_args(["render", "--mode", "bricks"]).mode == "bricks"


@pytest.mark.parametrize("mode", ["spatial", "handoff", "nonsense"])
def test_cli_unported_modes_raise(mode, capsys):
    """The multi-rank modes, once rejected as not ported, now parse (they
    render in tests/test_torch_session.py and tests/test_torch_parallel.py);
    an unknown mode still raises, naming the modes there are."""
    if mode != "nonsense":
        assert cli.build_parser().parse_args(["render", "--mode", mode]).mode == mode
        return
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["render", "--mode", mode])
    err = capsys.readouterr().err
    assert "unknown render mode 'nonsense'" in err and "spatial, handoff" in err, err
    assert "not ported" not in err, err


@pytest.mark.parametrize("mode", ["fast", "reference", "progressive"])
def test_cli_ported_modes_parse(mode):
    """The modes ported with the edit session (once rejected as unported)."""
    assert cli.build_parser().parse_args(["render", "--mode", mode]).mode == mode


def test_cli_pallas_mode_has_no_renderer(capsys):
    """The JAX CLI offers ``--mode pallas`` but its session renders nothing
    for it (``ValueError: unknown render mode``); the port rejects it so."""
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["render", "--mode", "pallas"])
    err = capsys.readouterr().err
    assert "'pallas'" in err and "the reference does not render this mode" in err, err
    assert "ROADMAP" not in err and "not ported" not in err, err
