"""Ray helpers, the material state machine and shading, in PyTorch.

Port of the subset of ``raytracing_test_tpu/render/renderer.py`` that the
serving path needs: the DDA helpers (:58-129), the march state (:132),
``classify`` and ``material_step`` (:149-221) and ``shade`` (:379-452).
Every function works on [N]-shaped tensors on any device; the arithmetic is
the reference's, operation for operation, so the CUDA kernel
(csrc/fused_march.cu) can reproduce it with contraction off.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties

_EPS_DIR = 1e-12
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


def shade(scene: Scene, s: _March, raw0, mat0, sun, cfg: RenderConfig, shadow_fn):
    """Post-march shading + overlays (renderer.shade, :379-452).

    ``shadow_fn(p, cell, last_axis, step, active) -> bool[N]`` supplies the
    sun-shadow result (the fused kernel computes it in the same launch).
    """
    if cfg.enable_ao:
        raise NotImplementedError(
            "enable_ao: hemisphere AO (_ao_march, render/hemisphere.py) is not "
            "ported yet; see ROADMAP.md, 'Modules to port', item AO and hemisphere"
        )
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

    normal = _onehot(s.last_axis, f32) * -s.step
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
    }
    return col, aux
