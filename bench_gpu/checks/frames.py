"""The viewer's check: the kept frames against the plain reference
(``reference/``: the world generated again, its tables, the pick ray for
the highlight, the march and its shading) at the same pose and clock.

    px_off    the worst kept frame's share of pixels with a channel off the
              reference's by more than 1e-6

In a traced run it also counts the march bound of the window's first
frames (``roofline/march.py``) for ``march_roofline``.
``control(run, out)`` is the reference with its ray directions rounded to
bfloat16, the precision below the configuration's float32, in the
program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import march as rm
from reference import scene as rs
from reference import world as rw
from roofline import march as mroof

PX_TOL = 1e-6


def rcfg_of(rcfg, t, looking_at=None) -> rm.RCfg:
    kw = {} if looking_at is None else {"looking_at": tuple(looking_at)}
    return rm.RCfg(width=rcfg.width, height=rcfg.height, max_steps=rcfg.max_steps,
                   shadow_steps=rcfg.shadow_steps, fov_degrees=rcfg.fov_degrees,
                   sun_dir=tuple(rcfg.sun_dir), time=t, **kw)


def reference_frame(scene, grid, flags, pose, t, rcfg, dir_dtype=torch.float32):
    """The frame a session shows at ``pose`` and clock ``t``: the pick ray
    picks the highlighted voxel, then the march draws."""
    pos, yaw, pitch = pose
    cam_dir = np.asarray(rm.yaw_pitch_dir(yaw, pitch), np.float32)
    pick = rm.cast_ray(grid, flags, pos, cam_dir, 30)
    cfg = rcfg_of(rcfg, t, pick.pos if pick.steps else None)
    return rm.render_frame(scene, np.asarray(pos, np.float32), cam_dir, cfg, dir_dtype)


def px_off(img: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((img.to(ref.device) - ref).abs().amax(dim=-1) > PX_TOL).double().mean())


def _scene(run):
    grid, pal = rw.gen_world(run.config["world"])
    albedo, flags, _ = pal.arrays()
    return grid, flags, rs.ref_scene(grid, albedo, flags, run.device)


def control(run, out) -> dict:
    grid, flags, scene = _scene(run)
    return dict(out, frames=[(k, pose, t, reference_frame(scene, grid, flags, pose, t, out["rcfg"],
                                                          torch.bfloat16).cpu())
                             for k, pose, t, _ in out["frames"]])


def check(run, out) -> dict:
    grid, flags, scene = _scene(run)
    worst = 0.0
    for _, pose, t, img in out["frames"]:
        worst = max(worst, px_off(img, reference_frame(scene, grid, flags, pose, t, out["rcfg"])))
    if run.trace:
        r = out["rcfg"]
        run.records["march_bound_s"] = [
            mroof.launch_bound(scene.grid_enc.numel(), len(flags), r.width * r.height,
                               mroof.frame_crossings(scene, np.asarray(pose[0], np.float32),
                                                     rm.yaw_pitch_dir(pose[1], pose[2]),
                                                     rcfg_of(r, t)))
            for pose, t in out["shown"]]
    return {"px_off": worst}
