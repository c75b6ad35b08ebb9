"""The plain march in PyTorch: the fused kernel's twin.

Port of ``raytracing_test_tpu/render/fast.py``: the distance-encoded grid
(one u8 load per iteration gives a material or an all-air jump licence),
analytic exits (sky above ``y_max``, outside the window moving away) and
exterior-slab advances. It is the plain version that
``kernels/fused_march.py`` runs for CPU tensors and that ``chip_smoke.py``
holds the CUDA kernel against on the card.

The reference's straggler compaction (fast.py:208-224) only spares XLA's
lockstep loop; here a masked ``while (~done).any()`` loop does the same work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..core.flatten import PROX_AIR, Scene
from ..core.types import Properties
from .camera import Camera, ray_directions
from .renderer import (
    IOR_WATER,
    _argmin_axis,
    _build_ray,
    _get,
    _init_tmax,
    _March,
    _onehot,
    classify,
    material_step,
    shade,
)

_BIG = 1 << 20  # "infinite" AABB bound (cells)
_MAX_JUMP = 512  # max crossings consumed per bulk advance
_ITER_CAP = 2048  # loop guard; the step budgets end every march long before


def sun_unit(sun_dir) -> np.ndarray:
    """A sun direction (``RenderConfig.sun_dir``) normalised in float32, as the
    reference computes it."""
    s = np.asarray(sun_dir, np.float32)
    return s / np.sqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2])


def _gather_enc(scene: Scene, cell, prox: bool = False):
    """The one load: distance-encoded voxel value at integer cells, from
    ``grid_enc`` (or ``prox_enc`` with ``prox``). Wraps &1023; outside the
    window reads as air with the minimal licence (129)."""
    Sx, Sy, Sz = scene.shape3
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    lin = torch.where(inside, lin, torch.zeros_like(lin))
    grid = scene.prox_enc if prox else scene.grid_enc
    v = torch.take(grid, lin.long()).to(torch.int32)
    return torch.where(inside, v, torch.full_like(v, 129))


def lookup_mat_flags(scene: Scene, cell):
    """(mat, flags) at integer cells; air outside the window."""
    v = _gather_enc(scene, cell)
    mat = torch.where(v < 128, v, torch.zeros_like(v))
    return mat, scene.flags[mat.long()]


def _aabb_advance_bounds(s: _March, lo, hi, mask, budget):
    """Advance masked lanes' DDA to the exit of the all-air AABB [lo, hi]
    (inclusive cell bounds), exactly as sequential stepping would. A lane with
    lo == hi == cell performs one ordinary DDA step."""
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
    c = torch.minimum(c, n - 1)  # stay inside the box on non-exit axes
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


def _march_body(scene: Scene, s: _March, enc, cfg: RenderConfig, budget, shadow: bool, time_s,
                prox: bool = False, shape3=None):
    """One march iteration: process the current cell (materials / hit), apply
    the exit rules, then advance air lanes through their certified empty box
    (a plain DDA step when the box is a single cell). With ``prox``, ``enc``
    is from ``prox_enc``: every value < 128 is a stop cell, and its air cells
    (``PROX_AIR``) report material 1 (``fused_march.py:461-472``).

    ``shape3`` overrides the world window of the exit rules: the handoff
    march (parallel/handoff.py) passes the whole world's while ``scene``
    holds one x-slab."""
    Sx, Sy, Sz = shape3 if shape3 is not None else scene.shape3
    active = ~s.done

    # ---- current-cell processing
    mat = torch.where(enc < 128, enc, torch.zeros_like(enc))
    if prox:
        mat = torch.where(enc == PROX_AIR, torch.ones_like(mat), mat)
    fl = scene.flags[mat.long()]
    if shadow:
        liquid = (fl & int(Properties.LIQUID)) > 0
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

    # ---- exit rules
    shape = torch.tensor([Sx, Sy, Sz], dtype=torch.int32, device=enc.device)[None, :]
    out_pos = s.cell >= shape
    out_neg = s.cell < 0
    inside = ~(out_pos | out_neg).any(dim=1)
    moving_away = ((out_pos & (istep > 0)) | (out_neg & (istep < 0))).any(dim=1)
    sky_up = (s.cell[:, 1] > scene.y_max) & (istep[:, 1] > 0)
    s = s._replace(done=s.done | (moving_away | sky_up))

    # ---- advance air lanes through their empty box
    march = ~s.done
    r = torch.clamp(enc - 128 - 1, min=0)[:, None]  # licence radius (0 => 1 step)
    box_lo = s.cell - r
    box_hi = s.cell + r
    # outside the window: slab up to the window face (overrides the licence)
    out_lo = torch.where(out_pos, shape, -_BIG)
    out_hi = torch.where(out_neg, -1, _BIG).to(torch.int32)
    lo = torch.where(inside[:, None], box_lo, out_lo)
    hi = torch.where(inside[:, None], box_hi, out_hi)
    return _aabb_advance_bounds(s, lo, hi, march, budget)


def fast_march(scene: Scene, state: _March, cfg: RenderConfig, budget: int,
               shadow: bool = False, time_s=None, prox: bool = False):
    """March every lane until it is done. Returns (state, iterations).

    ``prox`` (lean primary march only) stops each lane at its first entry
    into an occupied 8^3 brick: the march reads ``scene.prox_enc``, while
    ``y_max`` and the sky rule stay those of the real scene."""
    i = 0
    while i < _ITER_CAP and bool((~state.done).any()):
        enc = _gather_enc(scene, state.cell, prox)
        state = _march_body(scene, state, enc, cfg, budget, shadow, time_s, prox)
        i += 1
    return state, i


def _init_state(origin, dirs, ior, start_t=None):
    N = dirs.shape[0]
    f32 = dirs.dtype
    dev = dirs.device
    d, step, delta, abs_delta = _build_ray(dirs)
    if origin.ndim == 1:
        origin = origin[None, :].expand(N, 3)
    origin = origin.to(f32)
    if start_t is not None:
        # fast-forward along the ray (progressive-refinement seeding)
        origin = origin + torch.clamp(start_t, min=0.0)[:, None] * d
    cell = torch.floor(origin).to(torch.int32)
    tmax = _init_tmax(origin, cell, step, delta, abs_delta)
    return _March(
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


def start_cell(scene: Scene, s: _March, lookup_fn=None):
    """Start-cell specials (frag:299-307): a camera inside a solid block shows
    its flat colour (``raw0``); inside a refractive block it starts at ior 1.1.
    Returns (state, raw0, mat0). ``lookup_fn(cell) -> mat`` overrides the
    start cell's lookup (the handoff path's slab lookup)."""
    if lookup_fn is None:
        mat0, flags0 = lookup_mat_flags(scene, s.cell)
    else:
        mat0 = lookup_fn(s.cell)
        flags0 = scene.flags[mat0.long()]
    refr0 = (flags0 & int(Properties.REFRACTIVE)) > 0
    raw0 = (mat0 != 0) & ~refr0
    ior = torch.where((mat0 != 0) & refr0, IOR_WATER, 1.0).to(s.dir.dtype)
    s = s._replace(ior=ior, done=raw0, mat=torch.where(raw0, mat0, torch.zeros_like(mat0)))
    return s, raw0, mat0


def _shadow_march_fast(scene: Scene, p, cell, last_axis, step, cfg, sun, active):
    """Sun shadow (semantics of renderer._shadow_march): rebuild toward the
    sun, exit through the hit face, march ``shadow_steps`` skipping LIQUID."""
    s = shadow_start(p, cell, last_axis, sun, active)
    s, _ = fast_march(scene, s, cfg, cfg.shadow_steps, shadow=True)
    return active & (s.mat != 0)


def shadow_start(p, cell, last_axis, sun, active) -> _March:
    """The shadow march's state toward the sun from hit points ``p`` in
    ``cell``, after its first step out of the hit block (``done`` where not
    ``active``)."""
    N = p.shape[0]
    dev = p.device
    d, sstep, sdelta, sabs = _build_ray(sun[None, :].expand(N, 3))
    tmax = _init_tmax(p, cell, sstep, sdelta, sabs)
    oh = _onehot(last_axis, p.dtype)
    tmax = tmax - oh * sabs  # step out through the hit face (frag:380)
    s = _March(
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
    # the shadow loop starts by stepping (frag:383-387): the hit block itself
    # is not re-tested, so take one plain DDA step before the main march
    ax = _argmin_axis(s.tmax)
    oh2 = _onehot(ax, p.dtype)
    t_cross = _get(s.tmax, ax)
    m3 = active[:, None]
    s = s._replace(
        cell=torch.where(m3, s.cell + (oh2 * s.step).to(torch.int32), s.cell),
        tmax=torch.where(m3, s.tmax + oh2 * s.abs_delta, s.tmax),
        last_axis=torch.where(active, ax, s.last_axis),
        last_t=torch.where(active, t_cross, s.last_t),
        steps=s.steps + active.to(torch.int32),
    )
    return s


def render_rays_fast(scene: Scene, origin, dirs, cfg: RenderConfig, start_t=None, time_s=None):
    """Plain render of arbitrary rays -> (rgb [N,3], aux).

    ``start_t`` (f32[N], optional) fast-forwards each ray before marching;
    ``time_s`` is the animation clock (defaults to ``cfg.time``).
    """
    f32 = torch.float32
    dev = scene.device
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    N = dirs.shape[0]
    if time_s is None:
        time_s = cfg.time
    sun = torch.from_numpy(sun_unit(cfg.sun_dir)).to(dev)

    s = _init_state(origin, dirs, torch.ones(N, dtype=f32, device=dev), start_t=start_t)
    s, raw0, mat0 = start_cell(scene, s)
    s, iters = fast_march(scene, s, cfg, cfg.max_steps, shadow=False, time_s=time_s)

    def shadow_fn(p, cell, last_axis, step, active):
        return _shadow_march_fast(scene, p, cell, last_axis, step, cfg, sun, active)

    col, aux = shade(scene, s, raw0, mat0, sun, cfg, shadow_fn)
    aux["march_iters"] = iters
    return col, aux


def crosshair(img, cfg: RenderConfig):
    """White disc of radius 3 px at ``cfg.mouse_px`` (frag:259-262)."""
    if not cfg.crosshair:
        return img
    dev = img.device
    yy = torch.arange(cfg.height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(cfg.width, dtype=torch.float32, device=dev)[None, :]
    mrow, mcol = cfg.mouse_px
    d2 = (yy - mrow) ** 2 + (xx - mcol) ** 2
    return torch.where((d2 <= 9.0)[:, :, None], torch.ones_like(img), img)


def render_image_fast(scene: Scene, camera: Camera, cfg: RenderConfig, time_s=None):
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, _ = render_rays_fast(scene, camera.pos, dirs, cfg, time_s=time_s)
    return crosshair(col.reshape(cfg.height, cfg.width, 3), cfg)
