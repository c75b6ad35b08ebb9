"""The reference renderer in PyTorch: ray helpers, the material state
machine, shading with hemisphere AO, and the per-cell reference march.

Port of ``raytracing_test_tpu/render/renderer.py``: the DDA helpers
(:58-129), the march state (:132), ``classify`` and ``material_step``
(:149-221), ``_lookup`` (:104, over ``grid_enc``), the primary and shadow
marches (:224, :313), the AO march (:350), ``shade`` (:379-452) and
``render_rays`` / ``render_image`` / ``render_jit`` (:455-503). The marches
and ``shade`` take the reference's ``lookup_fn`` / ``ao_lookup_fn`` hooks,
through which parallel/spatial.py answers each lookup from the x-slabs. Every
function works on [N]-shaped tensors on any device; the arithmetic is the
reference's, operation for operation, so the CUDA kernel
(csrc/fused_march.cu) can reproduce the parts it shares with contraction off.

The reference path (``render_rays``) is PyTorch operations on the card, as
XLA runs it in the JAX package: its ``while_loop`` marches become masked
loops that test for a live lane every ``_ANY_EVERY`` iterations (a done lane's
state does not change, so the result is the same with fewer host syncs).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties
from .camera import Camera, ray_directions
from .hemisphere import oriented_dirs

_EPS_DIR = 1e-12
_ANY_EVERY = 8  # masked-loop iterations between tests for a live lane
IOR_WATER = 1.1  # refractive index after the first refractive contact (frag:227)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device (divisions by it stay IEEE
    divisions; a Python-scalar divisor may become a reciprocal multiply)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _sanitize(d):
    """Replace ~zero direction components with tiny positive values (the
    reference leaves 1/0 = inf; +1e-12 marches identically without NaNs)."""
    return torch.where(d.abs() < _EPS_DIR, torch.full_like(d, _EPS_DIR), d)


def _build_ray(d):
    """step/delta/absDelta from a direction (ref buildRay, low_res.frag:61-97).
    The reference's step is +1 for a zero component (only `< 0` flips)."""
    d = _sanitize(d)
    step = torch.where(d < 0, -1.0, 1.0).to(d.dtype)
    delta = 1.0 / d
    abs_delta = delta.abs()
    return d, step, delta, abs_delta


def _init_tmax(p, cell, step, delta, abs_delta):
    """Per-axis parameter distance from p to the first crossing
    (ref init, low_res.frag:290-296)."""
    shifted = p + torch.clamp(step, max=0.0)
    return abs_delta - (shifted - cell.to(p.dtype)) * delta


def _argmin_axis(tmax):
    """Ref tie-breaking: x iff strictly smallest, else y iff y<z, else z
    (nextIntersectDDA, low_res.frag:450-476)."""
    tx, ty, tz = tmax[:, 0], tmax[:, 1], tmax[:, 2]
    two = torch.full_like(tx, 2, dtype=torch.int32)
    yz = torch.where(ty < tz, torch.ones_like(two), two)
    return torch.where((tx < ty) & (tx < tz), torch.zeros_like(two), yz)


def _onehot(ax, dtype=torch.float32):
    return (torch.arange(3, device=ax.device)[None, :] == ax[:, None]).to(dtype)


def _get(v, ax):
    """v[:, ax] per row."""
    return torch.gather(v, 1, ax[:, None].long())[:, 0]


def _lookup(scene: Scene, cell):
    """Material id at integer cells [N,3] from ``grid_enc`` (a value < 128 is
    a material, anything else air); wraps &1023, air outside the window."""
    Sx, Sy, Sz = scene.shape3
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    lin = torch.where(inside, lin, torch.zeros_like(lin))
    v = torch.take(scene.grid_enc, lin.long()).to(torch.int32)
    return torch.where(inside & (v < 128), v, torch.zeros_like(v))


def _sigmoid(x, scale, steep):
    return scale / (1.0 + torch.exp(-x * steep))


def _norm3(v):
    """Euclidean norm over the last axis of size 3, summed left to right."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def skybox(d, sun_dir):
    """genSkyBox (low_res.frag:157-168). ``d`` is the (normalised) ray dir
    [N,3]; the reference pre-scales dir.y by 1.4 when negative."""
    dy = torch.where(d[:, 1] < 0, d[:, 1] * 1.4, d[:, 1])
    d2 = torch.stack([d[:, 0], dy, d[:, 2]], dim=1)
    haze = (0.1 - torch.clamp(dy, -0.3, 0.3).abs()) * 0.8 + 0.1
    modifier = torch.clamp(_sigmoid(1.0 - haze * 2.0, 1.0, 2.0), 0.0, 1.0)
    sky = torch.tensor([0.2, 0.4, 1.0], dtype=d.dtype, device=d.device)
    b = _norm3(d2 - sun_dir[None, :]) * 50.0
    sun = torch.tensor([1.0, 1.0, 0.0], dtype=d.dtype, device=d.device)[None, :] * _sigmoid(
        1.5 - b, 1.0, 1.6
    )[:, None]
    return (sky[None, :] + torch.clamp(haze, 0.0, 1.0)[:, None] * 3.0) * modifier[:, None] + sun


@dataclass(frozen=True)
class _March:
    mat: torch.Tensor  # i32[N] material at the current cell
    cell: torch.Tensor  # i32[N,3]
    dir: torch.Tensor  # f32[N,3]
    step: torch.Tensor  # f32[N,3]
    abs_delta: torch.Tensor  # f32[N,3]
    tmax: torch.Tensor  # f32[N,3]
    seg_origin: torch.Tensor  # f32[N,3] origin of the current ray segment
    last_t: torch.Tensor  # f32[N] segment parameter of the last crossing
    last_axis: torch.Tensor  # i32[N]
    color_mod: torch.Tensor  # f32[N,3] accumulated tint (finalColorMod)
    ior: torch.Tensor  # f32[N]
    reflected: torch.Tensor  # bool[N]
    done: torch.Tensor  # bool[N] frozen (solid hit)
    steps: torch.Tensor  # i32[N] steps actually marched

    def _replace(self, **kw) -> "_March":
        return replace(self, **kw)


def classify(flags, mat, active, cfg: RenderConfig):
    """Split active lanes at a non-air block into reflect/refract/hit, matching
    the reference's flags==0x3 / ==0x5 / else-break dispatch (frag:317-328)."""
    f7 = flags & 0x7
    solid = active & (mat != 0)
    if cfg.enable_materials:
        is_refl = solid & (f7 == 0x3)
        is_refr = solid & (f7 == 0x5)
    else:
        is_refl = torch.zeros_like(solid)
        is_refr = torch.zeros_like(solid)
    return is_refl, is_refr, solid & ~is_refl & ~is_refr


def material_step(s: _March, is_refl, is_refr, flags, cfg: RenderConfig, time_s=None):
    """Apply reflection/refraction state updates for the masked lanes.

    Returns (dir, step, abs_delta, tmax, seg_origin, last_t, color_mod, ior,
    reflected), unchanged where unmasked. ``time_s`` is the animation clock.
    """
    if time_s is None:
        time_s = cfg.time
    dt = s.dir.dtype
    p = s.seg_origin + s.last_t[:, None] * s.dir
    oh = _onehot(s.last_axis, dt)

    # ---- reflection (reflectRay, low_res.frag:178-194)
    refl_m = is_refl[:, None]
    dir_r = torch.where(refl_m, s.dir * (1.0 - 2.0 * oh), s.dir)
    step_r = torch.where(refl_m, s.step * (1.0 - 2.0 * oh), s.step)
    tmax_r = torch.where(refl_m, s.tmax - oh * s.abs_delta, s.tmax)
    seg_r = torch.where(refl_m, p - s.last_t[:, None] * dir_r, s.seg_origin)
    cmod = torch.where(refl_m, s.color_mod * 0.94, s.color_mod)
    reflected = s.reflected | is_refl

    # ---- refraction (refractRay, low_res.frag:198-240)
    liquid = (flags & int(Properties.LIQUID)) > 0
    tint = torch.where(
        liquid[:, None],
        torch.tensor([0.94, 0.97, 1.0], dtype=dt, device=p.device)[None, :],
        torch.tensor([0.95, 0.95, 0.95], dtype=dt, device=p.device)[None, :],
    )
    cmod = torch.where(is_refr[:, None], cmod * tint, cmod)
    ior_w = _f32(IOR_WATER, p)
    bend = is_refr & (s.ior != ior_w)
    normal = oh * step_r  # points along travel through the face
    wob = torch.sin((time_s + p[:, 0] * 0.2 - p[:, 2] * 0.1) * 10.0) * 0.2
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=p.device)[None, :]
    normal = torch.where((bend & liquid)[:, None], normal + wob[:, None] * ex, normal)
    nn = _norm3(normal)[:, None]
    normal = normal / torch.where(nn > 0, nn, torch.ones_like(nn))
    r = s.ior / ior_w
    c1 = normal[:, 0] * dir_r[:, 0] + normal[:, 1] * dir_r[:, 1] + normal[:, 2] * dir_r[:, 2]
    normal = torch.where((c1 < 0)[:, None], -normal, normal)
    c1 = c1.abs()
    c2 = torch.sqrt(torch.clamp(1.0 - r * r * (1.0 - c1 * c1), min=0.0))
    dir_b = r[:, None] * dir_r + (r * c1 - c2)[:, None] * normal
    bend_m = bend[:, None]
    new_dir = torch.where(bend_m, dir_b, dir_r)
    new_dir_s, new_step, new_delta, new_abs = _build_ray(new_dir)
    dirx = torch.where(bend_m, new_dir_s, dir_r)
    stepx = torch.where(bend_m, new_step, step_r)
    absx = torch.where(bend_m, new_abs, s.abs_delta)
    tmax_b = _init_tmax(p, s.cell, new_step, new_delta, new_abs)
    tmaxx = torch.where(bend_m, tmax_b, tmax_r)
    segx = torch.where(bend_m, p, seg_r)
    last_t = torch.where(bend, torch.zeros_like(s.last_t), s.last_t)
    ior = torch.where(is_refr, ior_w, s.ior)
    return dirx, stepx, absx, tmaxx, segx, last_t, cmod, ior, reflected


def _any(mask) -> bool:
    return bool(mask.any())


def _march_loop(body, state, live, budget: int, any_fn=_any):
    """``while i < budget and live(state).any(): state = body(state)`` with the
    any-test every ``_ANY_EVERY`` iterations (``body`` leaves a finished lane
    unchanged, so the extra iterations change nothing). ``any_fn(mask) ->
    bool`` makes the test: a loop whose body holds a collective passes one
    that agrees on every rank of the collective's group."""
    for i in range(budget):
        if i % _ANY_EVERY == 0 and not any_fn(live(state)):
            break
        state = body(state)
    return state


def _primary_march(scene: Scene, origin, dirs, cfg: RenderConfig, time_s=None, lookup_fn=None,
                   any_fn=_any):
    """The unified primary+material march loop (renderer.py:224): one voxel a
    step, ``max_steps`` steps at most. ``lookup_fn(cell) -> mat`` overrides
    the voxel lookup (parallel/spatial.py's slab lookup), ``any_fn`` the
    live-lane test (``_march_loop``)."""
    lookup = lookup_fn if lookup_fn is not None else (lambda c: _lookup(scene, c))
    N = dirs.shape[0]
    f32 = dirs.dtype
    d, step, delta, abs_delta = _build_ray(dirs)
    cell = torch.floor(origin).to(torch.int32)[None, :].expand(N, 3)
    origin_b = origin[None, :].expand(N, 3).to(f32)
    tmax = _init_tmax(origin_b, cell, step, delta, abs_delta)
    mat0 = lookup(cell)
    flags0 = scene.flags[mat0.long()]

    # camera-inside-block special cases (low_res.frag:299-307)
    refr0 = (flags0 & int(Properties.REFRACTIVE)) > 0
    raw0 = (mat0 != 0) & ~refr0  # solid start: flat colour, no shading
    ior = torch.where((mat0 != 0) & refr0, _f32(IOR_WATER, dirs), _f32(1.0, dirs))
    state = _March(
        mat=mat0,
        cell=cell,
        dir=d,
        step=step,
        abs_delta=abs_delta,
        tmax=tmax,
        seg_origin=origin_b,
        last_t=torch.zeros(N, dtype=f32, device=dirs.device),
        last_axis=torch.zeros(N, dtype=torch.int32, device=dirs.device),
        color_mod=torch.ones((N, 3), dtype=f32, device=dirs.device),
        ior=ior,
        reflected=torch.zeros(N, dtype=torch.bool, device=dirs.device),
        done=raw0,
        steps=torch.zeros(N, dtype=torch.int32, device=dirs.device),
    )
    sun = torch.tensor(cfg.sun_dir, dtype=f32, device=dirs.device)
    sun = sun / torch.linalg.vector_norm(sun)

    def body(s: _March) -> _March:
        flags = scene.flags[s.mat.long()]
        is_refl, is_refr, is_hit = classify(flags, s.mat, ~s.done, cfg)
        done = s.done | is_hit
        dirx, stepx, absx, tmaxx, segx, last_t, cmod, ior, reflected = material_step(
            s, is_refl, is_refr, flags, cfg, time_s)

        # ---- DDA step for rays still marching (nextIntersectDDA)
        march = ~done
        ax = _argmin_axis(tmaxx)
        oh2 = _onehot(ax, f32)
        t_cross = _get(tmaxx, ax)
        tmax_n = tmaxx + oh2 * absx
        cell_n = s.cell + (oh2 * stepx).to(torch.int32)
        m = march[:, None]
        cell_f = torch.where(m, cell_n, s.cell)
        return _March(
            mat=torch.where(march, lookup(cell_f), s.mat),
            cell=cell_f,
            dir=dirx,
            step=stepx,
            abs_delta=absx,
            tmax=torch.where(m, tmax_n, tmaxx),
            seg_origin=segx,
            last_t=torch.where(march, t_cross, last_t),
            last_axis=torch.where(march, ax, s.last_axis),
            color_mod=cmod,
            ior=ior,
            reflected=reflected,
            done=done,
            steps=s.steps + march.to(torch.int32),
        )

    state = _march_loop(body, state, lambda s: ~s.done, cfg.max_steps, any_fn)
    return state, raw0, mat0, sun


def _shadow_march(scene: Scene, p, cell, last_axis, step, cfg, sun, active, lookup_fn=None,
                  any_fn=_any):
    """Sun shadow ray (low_res.frag:373-391; renderer.py:313): rebuild toward
    the sun, exit through the hit face first, march <= ``shadow_steps`` steps
    skipping LIQUID blocks. Returns occluded bool[N] (any non-air terminator,
    budget-exhausted liquid included, matching frag:389). ``lookup_fn`` and
    ``any_fn``: as in ``_primary_march``."""
    lookup = lookup_fn if lookup_fn is not None else (lambda c: _lookup(scene, c))
    _, sstep, sdelta, sabs = _build_ray(sun[None, :].expand(p.shape))
    tmax = _init_tmax(p, cell, sstep, sdelta, sabs)
    tmax = tmax - _onehot(last_axis, p.dtype) * sabs  # step out through the hit face (frag:380)
    liquid_bit = int(Properties.LIQUID)

    def body(c):
        cell, tmax, mat, alive = c
        ax = _argmin_axis(tmax)
        oh2 = _onehot(ax, p.dtype)
        m = alive[:, None]
        cell_f = torch.where(m, cell + (oh2 * sstep).to(torch.int32), cell)
        tmax_f = torch.where(m, tmax + oh2 * sabs, tmax)
        mat_n = torch.where(alive, lookup(cell_f), mat)
        fl = scene.flags[mat_n.long()]
        alive_n = alive & ((mat_n == 0) | ((fl & liquid_bit) > 0))
        return cell_f, tmax_f, mat_n, alive_n

    mat0 = torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
    _, _, mat, _ = _march_loop(body, (cell, tmax, mat0, active), lambda c: c[3], cfg.shadow_steps,
                               any_fn)
    return mat != 0


def _ao_march(scene: Scene, p, normal, cfg: RenderConfig, lookup_fn=None):
    """Hemisphere occlusion (renderer.py:350): K short rays from the hit point
    (the reference's light_scattering pass, done properly), ``ao_steps``
    voxel steps each. Returns the occluded fraction f32[N]. ``lookup_fn``
    overrides the voxel lookup (the sharded paths' slab lookup)."""
    lookup = lookup_fn if lookup_fn is not None else (lambda c: _lookup(scene, c))
    N = p.shape[0]
    dirs = oriented_dirs(normal)  # [N, K, 3]
    K = dirs.shape[1]
    start = (p + normal * 1e-3).repeat_interleave(K, dim=0)  # ray i*K + k from point i
    cell = torch.floor(start).to(torch.int32)
    _, sstep, sdelta, sabs = _build_ray(dirs.reshape(N * K, 3))
    tmax = _init_tmax(start, cell, sstep, sdelta, sabs)
    hit = torch.zeros(N * K, dtype=torch.bool, device=p.device)
    for _ in range(cfg.ao_steps):
        oh = _onehot(_argmin_axis(tmax), p.dtype)
        tmax = tmax + oh * sabs
        cell = cell + (oh * sstep).to(torch.int32)
        hit = hit | (lookup(cell) != 0)
    return hit.reshape(N, K).to(p.dtype).mean(dim=1)


def shade(scene: Scene, s: _March, raw0, mat0, sun, cfg: RenderConfig, shadow_fn,
          ao_lookup_fn=None):
    """Post-march shading + overlays (renderer.shade, :379-452), hemisphere
    AO included (``cfg.enable_ao``), shared by every render mode.

    ``shadow_fn(p, cell, last_axis, step, active) -> bool[N]`` supplies the
    sun-shadow result (the fused kernel computes it in the same launch).
    ``ao_lookup_fn`` overrides the AO march's voxel lookup (the sharded
    paths' slab lookup).
    """
    f32 = torch.float32
    hit = s.mat != 0
    albedo = scene.albedo[s.mat.long()]
    p = s.seg_origin + s.last_t[:, None] * s.dir

    # face shading (calcLightIntensity, low_res.frag:242-252)
    sun_ax = sun[s.last_axis.long()]
    step_ax = _get(s.step, s.last_axis)
    lam = sun_ax * -step_ax
    facing = lam > 0
    intensity = torch.clamp(
        torch.clamp(lam, min=0.0) + 0.4 + torch.where(facing, 0.15, 0.0).to(f32), max=1.0
    )

    shadowed = torch.zeros_like(facing)
    if cfg.enable_shadows:
        shadow_active = hit & facing & ~s.reflected & ~raw0
        shadowed = shadow_fn(p, s.cell, s.last_axis, s.step, shadow_active)
        shadowed = shadowed & shadow_active

    dark = (~facing) | shadowed
    shade_f = torch.where(
        s.reflected, intensity, torch.where(dark, torch.full_like(intensity, 0.3), intensity)
    )[:, None]
    hit_col = albedo * shade_f * s.color_mod

    normal = _onehot(s.last_axis, f32) * -s.step
    if cfg.enable_ao:
        occ = _ao_march(scene, p, normal, cfg, lookup_fn=ao_lookup_fn)
        hit_col = hit_col * (1.0 - 0.6 * occ)[:, None]

    sky_col = skybox(s.dir, sun) * s.color_mod
    col = torch.where(hit[:, None], hit_col, sky_col)

    # looked-at highlight (frag:347-350), checked before the air branch; air's
    # "colour" unpacks to ~(1,1,1) in the reference
    look = torch.tensor(cfg.looking_at, dtype=torch.int32, device=s.cell.device)
    is_look = (s.cell == look[None, :]).all(dim=1)
    base = torch.where(hit[:, None], albedo, torch.full_like(albedo, (2**21 - 1) / 2**21))
    col = torch.where(is_look[:, None], base * 2.0 + 0.3, col)

    # camera-inside-solid: flat unshaded colour (frag:300-306)
    raw_col = scene.albedo[mat0.long()]
    col = torch.where(raw0[:, None], raw_col, col)

    aux = {
        "hit": hit,
        "mat": s.mat,
        "cell": s.cell,
        "hit_pos": p,
        "steps": s.steps,
        "last_axis": s.last_axis,
        "normal": normal,
        "reflected": s.reflected,
        "ray_dir": s.dir,
        "ray_origin": s.seg_origin,
        "ray_deltas": s.abs_delta,
        "ray_ratios_a": torch.stack(  # "Y/X, Y/Z, X/Y" (debug frame 3)
            [s.dir[:, 1] / s.dir[:, 0], s.dir[:, 1] / s.dir[:, 2],
             s.dir[:, 0] / s.dir[:, 1]], dim=1),
        "ray_ratios_b": torch.stack(  # "X/Z, Z/X, Z/Y" (debug frame 4)
            [s.dir[:, 0] / s.dir[:, 2], s.dir[:, 2] / s.dir[:, 0],
             s.dir[:, 2] / s.dir[:, 1]], dim=1),
    }
    return col, aux


def render_rays(scene: Scene, origin, dirs, cfg: RenderConfig, time_s=None):
    """The reference path (single-level DDA, renderer.py:455): render
    arbitrary rays -> (rgb [N,3], aux dict of debug channels)."""
    f32 = torch.float32
    origin = torch.as_tensor(origin, dtype=f32, device=scene.device)
    dirs = torch.as_tensor(dirs, dtype=f32, device=scene.device)
    s, raw0, mat0, sun = _primary_march(scene, origin, dirs, cfg, time_s=time_s)

    def shadow_fn(p, cell, last_axis, step, active):
        return _shadow_march(scene, p, cell, last_axis, step, cfg, sun, active)

    return shade(scene, s, raw0, mat0, sun, cfg, shadow_fn)


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig, time_s=None):
    """Full-frame reference render: [H, W, 3] float32, crosshair included."""
    from .fast import crosshair

    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, _ = render_rays(scene, camera.pos, dirs, cfg, time_s=time_s)
    return crosshair(col.reshape(cfg.height, cfg.width, 3), cfg)


@torch.no_grad()
def render_jit(scene: Scene, camera: Camera, cfg: RenderConfig):
    """The reference's ``render_jit`` (a frame at ``cfg.time``). Nothing is
    compiled: the frame runs as PyTorch operations on the scene's device."""
    return render_image(scene, camera, cfg, time_s=cfg.time)
