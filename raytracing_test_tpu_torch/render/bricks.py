"""The brick march in PyTorch: the plain path of the brick engine.

Port of ``raytracing_test_tpu/render/bricks.py``. Rays march at brick
granularity (4^3 voxels for the default world, ``Scene.brick_shift``):

  - **brick phase** (``_brick_loop``): one u8 load of ``brick_dist`` per
    iteration. A lane in an empty brick crosses the certified all-air box of
    radius d - 1 bricks in closed form (``fast._aabb_advance_bounds``);
    outside the window it crosses the slab up to the window face. Lanes
    stop at occupied bricks, or leave by the exit rules or the budget.
  - **fine phase** (``_fine_loop``): single DDA steps inside the occupied
    brick the lane sits in, its voxel read from ``brick_mat[blin]``; hit,
    reflect and refract exactly as ``render/fast.py`` processes a cell.

Rounds alternate fine -> brick until every ray is done. The semantics are
``render/fast.py``'s: a ray crosses the same cells as in the fused march and
the frame is the fused frame (``tests/test_torch_bricks.py``,
``chip_smoke.py``), up to near-ties: the brick path adds c * abs_delta to
tmax over other spans of cells, so the sums can differ in the last bit.

Left out, and why:

  - The reference's straggler compaction between rounds (bricks.py:290-313,
    ``compact_min``) only spares XLA's lockstep loop. Each lane's
    trajectory is independent of the others, so a masked
    ``while (~done).any()`` loop does the same work, and
    ``aux["march_rounds"]`` is the same count as the reference's ``r + r2``.
  - The MXU one-hot nibble lookup of ``brick_dist``, the row fetch
    (``fetch_rows``) and the one-hot ``row_mat`` select stood in for gathers
    on the TPU; here both tables are indexed directly.

``brick_march`` takes the two inner loops as hooks: the CUDA kernels of
``kernels/brick_kernels.py`` plug in there.

The brick phase runs each lane until an iteration in which it does not
advance; in that iteration a lane that leaves by the exit rules gets
``mat = 0``, as ``render/fast.py`` writes the air it stands in. The
reference's twin does that in its final sweep (bricks.py:237-242), its TPU
kernel does not for a lane that stands in an occupied brick above
``y_max``; the port zeroes it in both its versions.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties
from .camera import Camera, ray_directions
from .fast import _BIG, _aabb_advance_bounds, _init_state, crosshair, start_cell, sun_unit
from .renderer import (
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

_FINE_CAP = 64  # loop guard on fine iterations per round
# the fields of the march state that the kernel hooks write in place
HOOK_WRITES = ("cell", "tmax", "mat", "done", "last_t", "last_axis", "steps")
_BRICK_CAP = 512  # loop guard on brick iterations per round
_ROUND_CAP = 512  # loop guard on rounds; the step budgets end every march first


def _wrap_window(scene: Scene, cell):
    """Wrapped (& 1023) coordinates and the in-window mask (fast._gather_enc)."""
    Sx, Sy, Sz = scene.shape3
    wc = cell & 1023
    in_w = (wc[:, 0] < Sx) & (wc[:, 1] < Sy) & (wc[:, 2] < Sz)
    return wc, in_w


def brick_lin(scene: Scene, wc):
    """Linear brick index of wrapped in-window cells."""
    s = scene.brick_shift
    _, By, Bz = scene.brick_grid
    bc = wc >> s
    return (bc[:, 0] * By + bc[:, 1]) * Bz + bc[:, 2]


def brick_dist_at(scene: Scene, table, cell):
    """(dist, in_window): brick-level Chebyshev distance at the voxel cell
    from the u8 ``table`` (``brick_dist`` or ``brick_dist_shadow``).
    dist == 0: the brick holds solids; d >= 1 licenses a (d-1)-brick all-air
    box. Outside the window reads as air (d = 1; the slab rules take over)."""
    wc, in_w = _wrap_window(scene, cell)
    lin = torch.where(in_w, brick_lin(scene, wc), torch.zeros_like(wc[:, 0]))
    d = table.reshape(-1)[lin.long()].to(torch.int32)
    return torch.where(in_w, d, torch.ones_like(d)), in_w


def occupied_brick(scene: Scene, table, s: _March):
    """blin of the occupied brick each lane that is not done stands in, -1
    elsewhere: the brick a fine phase marches in."""
    d, in_w = brick_dist_at(scene, table, s.cell)
    wc, _ = _wrap_window(scene, s.cell)
    want = ~s.done & in_w & (d == 0)
    return torch.where(want, brick_lin(scene, wc), torch.full_like(d, -1))


def voxel_mat(scene: Scene, blin, cell):
    """Material at ``cell`` from the voxel row of brick ``blin`` (a lane with
    blin < 0 reads row 0; callers mask it)."""
    s = scene.brick_shift
    m = (1 << s) - 1
    wc = cell & 1023
    vox = ((((wc[:, 0] & m) << s) | (wc[:, 1] & m)) << s) | (wc[:, 2] & m)
    idx = torch.clamp(blin, min=0).long() * scene.brick_mat.shape[1] + vox.long()
    return scene.brick_mat.reshape(-1)[idx].to(torch.int32)


def _exit_rules(scene: Scene, s: _March, istep):
    """Window/sky analytic exits (fast._march_body's rules)."""
    Sx, Sy, Sz = scene.shape3
    shape = torch.tensor([Sx, Sy, Sz], dtype=torch.int32, device=s.cell.device)[None, :]
    out_pos = s.cell >= shape
    out_neg = s.cell < 0
    inside = ~(out_pos | out_neg).any(dim=1)
    moving_away = ((out_pos & (istep > 0)) | (out_neg & (istep < 0))).any(dim=1)
    sky_up = (s.cell[:, 1] > scene.y_max) & (istep[:, 1] > 0)
    return out_pos, out_neg, inside, moving_away, sky_up, shape


def dda_step(s: _March, mask, budget) -> _March:
    """One plain DDA step for the masked lanes, then the budget freeze."""
    ax = _argmin_axis(s.tmax)
    oh = _onehot(ax, s.dir.dtype)
    m3 = mask[:, None]
    steps = s.steps + mask.to(torch.int32)
    return s._replace(
        cell=torch.where(m3, s.cell + (oh * s.step).to(torch.int32), s.cell),
        tmax=torch.where(m3, s.tmax + oh * s.abs_delta, s.tmax),
        last_axis=torch.where(mask, ax, s.last_axis),
        last_t=torch.where(mask, _get(s.tmax, ax), s.last_t),
        steps=steps,
        done=s.done | (mask & (steps >= budget)),
    )


def _fine_loop(scene: Scene, s: _March, blin, cfg: RenderConfig, budget, shadow: bool, time_s):
    """Per-voxel DDA inside brick ``blin`` (-1: none). Processes the current
    cell exactly like fast._march_body (hit / reflect / refract), then
    single-steps; a lane leaves the loop when done, out of its brick, or
    frozen by the budget."""
    for _ in range(_FINE_CAP):
        wc, in_w = _wrap_window(scene, s.cell)
        active = ~s.done & in_w & (brick_lin(scene, wc) == blin)
        if not bool(active.any()):
            break
        mat = torch.where(active, voxel_mat(scene, blin, s.cell), torch.zeros_like(blin))
        fl = scene.flags[mat.long()]
        if shadow:
            is_hit = active & (mat != 0) & ((fl & int(Properties.LIQUID)) == 0)
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
        s = dda_step(s, active & ~s.done, budget)
    return s


def _brick_step(scene: Scene, table, s: _March, budget):
    """One brick iteration for every lane -> (state, march mask)."""
    sh = scene.brick_shift
    d, in_w = brick_dist_at(scene, table, s.cell)
    istep = s.step.to(torch.int32)
    out_pos, out_neg, inside, moving_away, sky_up, shape = _exit_rules(scene, s, istep)
    occupied = in_w & (d == 0)
    leave = ~s.done & (moving_away | sky_up)
    # an active lane in empty-brick space stands in a provably-air (or
    # outside-window) cell, so its mat is 0, as fast._march_body writes it;
    # lanes waiting at occupied bricks keep mat for the next fine round
    air_here = ~s.done & ~occupied
    s = s._replace(mat=torch.where(air_here | leave, torch.zeros_like(s.mat), s.mat),
                   done=s.done | leave)
    march = ~s.done & ~occupied

    # the empty box, brick-aligned, inside the window; the slab outside it
    r = torch.clamp(d - 1, min=0)[:, None]
    bc = (s.cell & 1023) >> sh
    box_lo = (bc - r) << sh
    box_hi = ((bc + r + 1) << sh) - 1
    out_lo = torch.where(out_pos, shape, -_BIG).to(torch.int32)
    out_hi = torch.where(out_neg, -1, _BIG).to(torch.int32)
    lo = torch.where(inside[:, None], box_lo, out_lo)
    hi = torch.where(inside[:, None], box_hi, out_hi)
    return _aabb_advance_bounds(s, lo, hi, march, budget), march


def _brick_loop(scene: Scene, table, s: _March, budget):
    """Bulk-advance lanes through certified-empty brick boxes until every
    lane stands in an occupied brick or is done. Each lane's cells and tmax
    are those of sequential stepping (the boxes are voxel-aligned)."""
    for _ in range(_BRICK_CAP):
        s, march = _brick_step(scene, table, s, budget)
        if not bool(march.any()):
            break
    return s


def writable(s: _March) -> _March:
    """``s`` with fresh contiguous copies of the fields in HOOK_WRITES."""
    return s._replace(**{f: getattr(s, f).clone(memory_format=torch.contiguous_format)
                         for f in HOOK_WRITES})


def brick_march(scene: Scene, state: _March, cfg: RenderConfig, budget: int,
                shadow: bool = False, time_s=None, fine_loop=None, brick_loop=None):
    """Rounds of fine -> brick until every lane is done. ``fine_loop`` /
    ``brick_loop`` replace the inner loops (the kernels plug in here; the
    defaults are the plain loops above). The hooks may write the fields of
    HOOK_WRITES in place, so a march with a hook owns copies of them, made
    once here (the caller's tensors stay as they are: start_cell's ``done``
    is its ``raw0``). Returns (state, rounds)."""
    if time_s is None:
        time_s = cfg.time
    if fine_loop is not None or brick_loop is not None:
        state = writable(state)
    fine = fine_loop or _fine_loop
    brick = brick_loop or _brick_loop
    table = scene.brick_dist_shadow if shadow else scene.brick_dist
    r = 0
    while r < _ROUND_CAP and bool((~state.done).any()):
        blin = occupied_brick(scene, table, state)
        state = fine(scene, state, blin, cfg, budget, shadow, time_s)
        state = brick(scene, table, state, budget)
        r += 1
    return state, r


def shadow_start(scene: Scene, p, cell, last_axis, cfg: RenderConfig, sun, active) -> _March:
    """The sun-shadow march state of the lanes in ``active`` (the others are
    done): rebuilt toward the sun from the hit point ``p``, out through the
    hit face, after the geometric first step."""
    N = p.shape[0]
    dev = p.device
    d, sstep, sdelta, sabs = _build_ray(sun[None, :].expand(N, 3))
    tmax = _init_tmax(p, cell, sstep, sdelta, sabs)
    tmax = tmax - _onehot(last_axis, p.dtype) * sabs  # step out through the hit face (frag:380)
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
    # the first step is geometric: the hit block itself is not re-tested
    # (frag:383), and it freezes no lane
    return dda_step(s, active, cfg.shadow_steps)._replace(done=~active)


def _shadow_march_bricks(scene: Scene, p, cell, last_axis, cfg: RenderConfig, sun, active,
                         fine_loop=None, brick_loop=None):
    """Sun shadow through the brick machinery (fast._shadow_march_fast
    semantics: exit through the hit face, one geometric first step, skip
    LIQUID, ``shadow_steps`` budget)."""
    s = shadow_start(scene, p, cell, last_axis, cfg, sun, active)
    s, _ = brick_march(scene, s, cfg, cfg.shadow_steps, shadow=True,
                       fine_loop=fine_loop, brick_loop=brick_loop)
    return active & (s.mat != 0)


def render_rays_bricks(scene: Scene, origin, dirs, cfg: RenderConfig, start_t=None, time_s=None,
                       fine_loop=None, brick_loop=None):
    """Brick-path render of arbitrary rays -> (rgb [N,3], aux); the same
    semantics and signature as fast.render_rays_fast, plus
    ``aux["march_rounds"]``."""
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
    s, rounds = brick_march(scene, s, cfg, cfg.max_steps, shadow=False, time_s=time_s,
                            fine_loop=fine_loop, brick_loop=brick_loop)

    def shadow_fn(p, cell, last_axis, step, active):
        return _shadow_march_bricks(scene, p, cell, last_axis, cfg, sun, active,
                                    fine_loop, brick_loop)

    col, aux = shade(scene, s, raw0, mat0, sun, cfg, shadow_fn)
    aux["march_rounds"] = rounds
    return col, aux


def render_image_bricks(scene: Scene, camera: Camera, cfg: RenderConfig, time_s=None, **kw):
    """Full frame [H, W, 3] through the brick path, crosshair included."""
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, _ = render_rays_bricks(scene, camera.pos, dirs, cfg, time_s=time_s, **kw)
    return crosshair(col.reshape(cfg.height, cfg.width, 3), cfg)
