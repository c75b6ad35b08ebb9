"""Plain reference of the hard renderer: camera rays, the distance-encoded
march with the material state machine, the sun shadow, shading, and the
host pick ray.

A frozen copy of the port's plain march (``render/fast.py``), its helpers
and ``shade`` (``render/renderer.py``), ``ray_directions``
(``render/camera.py``) and ``cast_ray`` (``app/picking.py``), cut to the
modes the benchmark's cells run (no prox mode, no AO, no lookup hooks).
The arithmetic is unchanged, operation for operation, so on the card it
rounds as the march kernel does (the kernel is built without contraction).
It imports nothing of the program: its tables come from
``reference/scene.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

LIQUID = 0x10
REFRACTIVE = 0x4

_EPS_DIR = 1e-12
IOR_WATER = 1.1
_BIG = 1 << 20
_MAX_JUMP = 512
_ITER_CAP = 2048


@dataclass(frozen=True)
class RCfg:
    """The render settings the march reads (the port's ``RenderConfig``)."""

    width: int = 1024
    height: int = 1024
    max_steps: int = 300
    shadow_steps: int = 75
    fov_degrees: float = 90.0
    sun_dir: Tuple[float, float, float] = (2.0, 1.0, 4.0)
    time: float = 0.0
    enable_shadows: bool = True
    enable_materials: bool = True
    looking_at: Tuple[int, int, int] = (-(1 << 30),) * 3


# ------------------------------------------------------------------ camera


def yaw_pitch_dir(yaw_deg: float, pitch_deg: float):
    p = math.radians(pitch_deg)
    y = math.radians(yaw_deg)
    return (math.cos(p) * math.sin(y), -math.sin(p), math.cos(p) * math.cos(y))


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def ray_directions(cam_dir: torch.Tensor, width: int, height: int, fov_degrees: float = 90.0):
    """Per-pixel normalised ray directions [height*width, 3], row 0 the top."""
    f32 = torch.float32
    dev = cam_dir.device
    proj_x = math.tan(math.radians(fov_degrees / 2.0))
    proj_y = proj_x * height / width
    d = cam_dir.to(f32)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=f32, device=dev)
    ppl = _cross(d, up)
    ppd = _cross(d, ppl)
    row = (torch.arange(height, dtype=f32, device=dev) + 0.5) / height
    col = (torch.arange(width, dtype=f32, device=dev) + 0.5) / width
    fy = 1.0 - row
    fx = col
    cx = -(proj_x * (fx - 0.5))
    cy = (0.5 - fy) * proj_y
    dirs = (
        d[None, None, :]
        + ppl[None, None, :] * cx[None, :, None]
        + ppd[None, None, :] * cy[:, None, None]
    )
    n = torch.sqrt(
        dirs[..., 0] * dirs[..., 0] + dirs[..., 1] * dirs[..., 1] + dirs[..., 2] * dirs[..., 2]
    )
    dirs = dirs / n[..., None]
    return dirs.reshape(height * width, 3)


# ------------------------------------------------------------- DDA helpers


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _sanitize(d):
    return torch.where(d.abs() < _EPS_DIR, torch.full_like(d, _EPS_DIR), d)


def _build_ray(d):
    d = _sanitize(d)
    step = torch.where(d < 0, -1.0, 1.0).to(d.dtype)
    delta = 1.0 / d
    abs_delta = delta.abs()
    return d, step, delta, abs_delta


def _init_tmax(p, cell, step, delta, abs_delta):
    shifted = p + torch.clamp(step, max=0.0)
    return abs_delta - (shifted - cell.to(p.dtype)) * delta


def _argmin_axis(tmax):
    tx, ty, tz = tmax[:, 0], tmax[:, 1], tmax[:, 2]
    two = torch.full_like(tx, 2, dtype=torch.int32)
    yz = torch.where(ty < tz, torch.ones_like(two), two)
    return torch.where((tx < ty) & (tx < tz), torch.zeros_like(two), yz)


def _onehot(ax, dtype=torch.float32):
    return (torch.arange(3, device=ax.device)[None, :] == ax[:, None]).to(dtype)


def _get(v, ax):
    return torch.gather(v, 1, ax[:, None].long())[:, 0]


def _sigmoid(x, scale, steep):
    return scale / (1.0 + torch.exp(-x * steep))


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def skybox(d, sun_dir):
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
class March:
    mat: torch.Tensor
    cell: torch.Tensor
    dir: torch.Tensor
    step: torch.Tensor
    abs_delta: torch.Tensor
    tmax: torch.Tensor
    seg_origin: torch.Tensor
    last_t: torch.Tensor
    last_axis: torch.Tensor
    color_mod: torch.Tensor
    ior: torch.Tensor
    reflected: torch.Tensor
    done: torch.Tensor
    steps: torch.Tensor

    def _replace(self, **kw) -> "March":
        return replace(self, **kw)


def classify(flags, mat, active, cfg: RCfg):
    f7 = flags & 0x7
    solid = active & (mat != 0)
    if cfg.enable_materials:
        is_refl = solid & (f7 == 0x3)
        is_refr = solid & (f7 == 0x5)
    else:
        is_refl = torch.zeros_like(solid)
        is_refr = torch.zeros_like(solid)
    return is_refl, is_refr, solid & ~is_refl & ~is_refr


def material_step(s: March, is_refl, is_refr, flags, cfg: RCfg, time_s):
    dt = s.dir.dtype
    p = s.seg_origin + s.last_t[:, None] * s.dir
    oh = _onehot(s.last_axis, dt)
    refl_m = is_refl[:, None]
    dir_r = torch.where(refl_m, s.dir * (1.0 - 2.0 * oh), s.dir)
    step_r = torch.where(refl_m, s.step * (1.0 - 2.0 * oh), s.step)
    tmax_r = torch.where(refl_m, s.tmax - oh * s.abs_delta, s.tmax)
    seg_r = torch.where(refl_m, p - s.last_t[:, None] * dir_r, s.seg_origin)
    cmod = torch.where(refl_m, s.color_mod * 0.94, s.color_mod)
    reflected = s.reflected | is_refl
    liquid = (flags & LIQUID) > 0
    tint = torch.where(
        liquid[:, None],
        torch.tensor([0.94, 0.97, 1.0], dtype=dt, device=p.device)[None, :],
        torch.tensor([0.95, 0.95, 0.95], dtype=dt, device=p.device)[None, :],
    )
    cmod = torch.where(is_refr[:, None], cmod * tint, cmod)
    ior_w = _f32(IOR_WATER, p)
    bend = is_refr & (s.ior != ior_w)
    normal = oh * step_r
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


# ------------------------------------------------------------------- march


def sun_unit(sun_dir) -> np.ndarray:
    s = np.asarray(sun_dir, np.float32)
    return s / np.sqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2])


def _gather_enc(scene, cell):
    Sx, Sy, Sz = scene.shape3
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    lin = torch.where(inside, lin, torch.zeros_like(lin))
    v = torch.take(scene.grid_enc, lin.long()).to(torch.int32)
    return torch.where(inside, v, torch.full_like(v, 129))


def _aabb_advance_bounds(s: March, lo, hi, mask, budget):
    f32 = s.dir.dtype
    istep = s.step.to(torch.int32)
    n = torch.where(istep > 0, hi + 1 - s.cell, s.cell - lo + 1)
    n = torch.clamp(n, 1, _MAX_JUMP)
    t_exit = s.tmax + (n - 1).to(f32) * s.abs_delta
    m = _argmin_axis(t_exit)
    oh = _onehot(m, f32)
    t_m = _get(t_exit, m)
    c = torch.where(
        t_m[:, None] >= s.tmax,
        torch.floor((t_m[:, None] - s.tmax) / s.abs_delta).to(torch.int32) + 1,
        torch.zeros_like(n),
    )
    c = torch.minimum(c, n - 1)
    c = torch.where(oh > 0, n, c)
    c = torch.clamp(c, min=0)
    mask3 = mask[:, None]
    cell = torch.where(mask3, s.cell + c * istep, s.cell)
    tmax = torch.where(mask3, s.tmax + c.to(f32) * s.abs_delta, s.tmax)
    last_axis = torch.where(mask, m, s.last_axis)
    last_t = torch.where(mask, t_m, s.last_t)
    steps = s.steps + torch.where(mask, c.sum(dim=1, dtype=torch.int32), 0)
    done = s.done | (mask & (steps >= budget))
    return s._replace(
        cell=cell, tmax=tmax, last_axis=last_axis, last_t=last_t, steps=steps, done=done
    )


def _march_body(scene, s: March, enc, cfg: RCfg, budget, shadow: bool, time_s):
    Sx, Sy, Sz = scene.shape3
    active = ~s.done
    mat = torch.where(enc < 128, enc, torch.zeros_like(enc))
    fl = scene.flags[mat.long()]
    if shadow:
        liquid = (fl & LIQUID) > 0
        is_hit = active & (mat != 0) & ~liquid
        is_refl = is_refr = None
    else:
        is_refl, is_refr, is_hit = classify(fl, mat, active, cfg)
    s = s._replace(mat=torch.where(active, mat, s.mat), done=s.done | is_hit)
    if not shadow and bool((is_refl | is_refr).any()):
        (dirx, stepx, absx, tmaxx, segx, last_t, cmod, ior, refl) = material_step(
            s, is_refl, is_refr, fl, cfg, time_s
        )
        s = s._replace(
            dir=dirx, step=stepx, abs_delta=absx, tmax=tmaxx, seg_origin=segx,
            last_t=last_t, color_mod=cmod, ior=ior, reflected=refl,
        )
    istep = s.step.to(torch.int32)
    shape = torch.tensor([Sx, Sy, Sz], dtype=torch.int32, device=enc.device)[None, :]
    out_pos = s.cell >= shape
    out_neg = s.cell < 0
    inside = ~(out_pos | out_neg).any(dim=1)
    moving_away = ((out_pos & (istep > 0)) | (out_neg & (istep < 0))).any(dim=1)
    sky_up = (s.cell[:, 1] > scene.y_max) & (istep[:, 1] > 0)
    s = s._replace(done=s.done | (moving_away | sky_up))
    march = ~s.done
    r = torch.clamp(enc - 128 - 1, min=0)[:, None]
    box_lo = s.cell - r
    box_hi = s.cell + r
    out_lo = torch.where(out_pos, shape, -_BIG)
    out_hi = torch.where(out_neg, -1, _BIG).to(torch.int32)
    lo = torch.where(inside[:, None], box_lo, out_lo)
    hi = torch.where(inside[:, None], box_hi, out_hi)
    return _aabb_advance_bounds(s, lo, hi, march, budget)


def fast_march(scene, state: March, cfg: RCfg, budget: int, shadow: bool = False, time_s=None):
    i = 0
    while i < _ITER_CAP and bool((~state.done).any()):
        enc = _gather_enc(scene, state.cell)
        state = _march_body(scene, state, enc, cfg, budget, shadow, time_s)
        i += 1
    return state, i


def init_state(origin, dirs, ior, start_t=None):
    N = dirs.shape[0]
    f32 = dirs.dtype
    dev = dirs.device
    d, step, delta, abs_delta = _build_ray(dirs)
    if origin.ndim == 1:
        origin = origin[None, :].expand(N, 3)
    origin = origin.to(f32)
    if start_t is not None:
        origin = origin + torch.clamp(start_t, min=0.0)[:, None] * d
    cell = torch.floor(origin).to(torch.int32)
    tmax = _init_tmax(origin, cell, step, delta, abs_delta)
    return March(
        mat=torch.zeros(N, dtype=torch.int32, device=dev),
        cell=cell,
        dir=d,
        step=step,
        abs_delta=abs_delta,
        tmax=tmax,
        seg_origin=origin.contiguous(),
        last_t=torch.zeros(N, dtype=f32, device=dev),
        last_axis=torch.zeros(N, dtype=torch.int32, device=dev),
        color_mod=torch.ones((N, 3), dtype=f32, device=dev),
        ior=ior,
        reflected=torch.zeros(N, dtype=torch.bool, device=dev),
        done=torch.zeros(N, dtype=torch.bool, device=dev),
        steps=torch.zeros(N, dtype=torch.int32, device=dev),
    )


def start_cell(scene, s: March):
    v = _gather_enc(scene, s.cell)
    mat0 = torch.where(v < 128, v, torch.zeros_like(v))
    flags0 = scene.flags[mat0.long()]
    refr0 = (flags0 & REFRACTIVE) > 0
    raw0 = (mat0 != 0) & ~refr0
    ior = torch.where((mat0 != 0) & refr0, IOR_WATER, 1.0).to(s.dir.dtype)
    s = s._replace(ior=ior, done=raw0, mat=torch.where(raw0, mat0, torch.zeros_like(mat0)))
    return s, raw0, mat0


def shadow_start(p, cell, last_axis, sun, active) -> March:
    N = p.shape[0]
    dev = p.device
    d, sstep, sdelta, sabs = _build_ray(sun[None, :].expand(N, 3))
    tmax = _init_tmax(p, cell, sstep, sdelta, sabs)
    oh = _onehot(last_axis, p.dtype)
    tmax = tmax - oh * sabs
    s = March(
        mat=torch.zeros(N, dtype=torch.int32, device=dev),
        cell=cell,
        dir=d,
        step=sstep,
        abs_delta=sabs,
        tmax=tmax,
        seg_origin=p,
        last_t=torch.zeros(N, dtype=p.dtype, device=dev),
        last_axis=last_axis,
        color_mod=torch.ones((N, 3), dtype=p.dtype, device=dev),
        ior=torch.ones(N, dtype=p.dtype, device=dev),
        reflected=torch.zeros(N, dtype=torch.bool, device=dev),
        done=~active,
        steps=torch.zeros(N, dtype=torch.int32, device=dev),
    )
    ax = _argmin_axis(s.tmax)
    oh2 = _onehot(ax, p.dtype)
    t_cross = _get(s.tmax, ax)
    m3 = active[:, None]
    return s._replace(
        cell=torch.where(m3, s.cell + (oh2 * s.step).to(torch.int32), s.cell),
        tmax=torch.where(m3, s.tmax + oh2 * s.abs_delta, s.tmax),
        last_axis=torch.where(active, ax, s.last_axis),
        last_t=torch.where(active, t_cross, s.last_t),
        steps=s.steps + active.to(torch.int32),
    )


def shade(scene, s: March, raw0, mat0, sun, cfg: RCfg, shadowed_fn):
    """Face shading, shadows, sky, the looked-at highlight and the start-cell
    colour (``renderer.shade`` without AO). Returns (rgb [N, 3], hit, p)."""
    f32 = torch.float32
    hit = s.mat != 0
    albedo = scene.albedo[s.mat.long()]
    p = s.seg_origin + s.last_t[:, None] * s.dir
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
        shadowed = shadowed_fn(p, s.cell, s.last_axis, shadow_active) & shadow_active
    dark = (~facing) | shadowed
    shade_f = torch.where(
        s.reflected, intensity, torch.where(dark, torch.full_like(intensity, 0.3), intensity)
    )[:, None]
    hit_col = albedo * shade_f * s.color_mod
    sky_col = skybox(s.dir, sun) * s.color_mod
    col = torch.where(hit[:, None], hit_col, sky_col)
    look = torch.tensor(cfg.looking_at, dtype=torch.int32, device=s.cell.device)
    is_look = (s.cell == look[None, :]).all(dim=1)
    base = torch.where(hit[:, None], albedo, torch.full_like(albedo, (2**21 - 1) / 2**21))
    col = torch.where(is_look[:, None], base * 2.0 + 0.3, col)
    raw_col = scene.albedo[mat0.long()]
    col = torch.where(raw0[:, None], raw_col, col)
    return col, hit, p


def render_rays(scene, origin, dirs, cfg: RCfg, start_t=None, time_s=None):
    """The plain march and its shading on arbitrary rays -> (rgb [N, 3], hit,
    hit point)."""
    f32 = torch.float32
    dev = scene.grid_enc.device
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    N = dirs.shape[0]
    time_s = cfg.time if time_s is None else time_s
    sun = torch.from_numpy(sun_unit(cfg.sun_dir)).to(dev)
    s = init_state(origin, dirs, torch.ones(N, dtype=f32, device=dev), start_t=start_t)
    s, raw0, mat0 = start_cell(scene, s)
    s, _ = fast_march(scene, s, cfg, cfg.max_steps, shadow=False, time_s=time_s)

    def shadowed(p, cell, last_axis, active):
        sh = shadow_start(p, cell, last_axis, sun, active)
        sh, _ = fast_march(scene, sh, cfg, cfg.shadow_steps, shadow=True)
        return active & (sh.mat != 0)

    return shade(scene, s, raw0, mat0, sun, cfg, shadowed)


def render_frame(scene, pos, cam_dir, cfg: RCfg, dir_dtype=torch.float32):
    """A [H, W, 3] frame from camera ``pos`` looking along ``cam_dir``.
    ``dir_dtype`` rounds the ray directions to a lower precision first (the
    control)."""
    dev = scene.grid_enc.device
    cam_dir = torch.as_tensor(cam_dir, dtype=torch.float32, device=dev)
    dirs = ray_directions(cam_dir, cfg.width, cfg.height, cfg.fov_degrees)
    dirs = dirs.to(dir_dtype).to(torch.float32)
    col, _, _ = render_rays(scene, torch.as_tensor(pos, dtype=torch.float32, device=dev),
                            dirs, cfg)
    return col.reshape(cfg.height, cfg.width, 3)


# ---------------------------------------------------------------- pick ray


@dataclass
class Pick:
    pos: Tuple[int, int, int]
    last_pos: Tuple[int, int, int]
    steps: int


def cast_ray(grid: np.ndarray, flags: np.ndarray, origin, direction, steps: int = 30) -> Pick:
    """The host pick ray over a dense material grid: DDA until a solid,
    non-LIQUID voxel; cells wrap &1023 and are air outside the grid."""
    ox, oy, oz = (float(v) for v in origin)
    dx, dy, dz = (float(v) for v in direction)
    eps = 1e-12
    dx = dx if abs(dx) > eps else eps
    dy = dy if abs(dy) > eps else eps
    dz = dz if abs(dz) > eps else eps
    step = [1 if dx >= 0 else -1, 1 if dy >= 0 else -1, 1 if dz >= 0 else -1]
    delta = [1.0 / dx, 1.0 / dy, 1.0 / dz]
    abs_delta = [abs(d) for d in delta]
    cell = [int(math.trunc(ox)), int(math.trunc(oy)), int(math.trunc(oz))]
    exact = [ox, oy, oz]
    for a in range(3):
        if step[a] < 0:
            exact[a] -= 1.0
    tmax = [abs_delta[a] - (exact[a] - cell[a]) * delta[a] for a in range(3)]
    Sx, Sy, Sz = grid.shape
    last = tuple(cell)
    while steps:
        steps -= 1
        last = tuple(cell)
        if tmax[0] < tmax[1] and tmax[0] < tmax[2]:
            a = 0
        elif tmax[1] < tmax[2]:
            a = 1
        else:
            a = 2
        cell[a] += step[a]
        tmax[a] += abs_delta[a]
        x, y, z = (c & 1023 for c in cell)
        mat = int(grid[x, y, z]) if (x < Sx and y < Sy and z < Sz) else 0
        if mat and not (int(flags[mat]) & LIQUID):
            return Pick(tuple(cell), last, steps)
    return Pick(tuple(cell), last, 0)
