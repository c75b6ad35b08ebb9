"""What one fused march launch (csrc/fused_march.cu) must move and compute,
counted from its inputs: the grid it reads and the palette flags once, per
ray 72 B of state in (cell, tmax, dir, step, abs_delta, seg_origin) and
88 B out (mat0, mat, cell, last axis, reflected, shadowed, steps, dir,
step, seg_origin, last t, colour), and three float32 operations for each
cell a primary or shadow ray crosses (two compares pick the axis, one add
advances it). The crossings come from the reference march
(``reference/march.py``) on the same rays."""

from __future__ import annotations

import torch

from reference import march as rm
from roofline.peaks import bound_s

OPS_PER_CROSSING = 3


@torch.no_grad()
def frame_crossings(scene, pos, cam_dir, rcfg: rm.RCfg) -> int:
    """Cells crossed by the primary and the shadow rays of one frame."""
    dev = scene.grid_enc.device
    f32 = torch.float32
    dirs = rm.ray_directions(torch.as_tensor(cam_dir, dtype=f32, device=dev), rcfg.width,
                             rcfg.height, rcfg.fov_degrees)
    N = dirs.shape[0]
    sun = torch.from_numpy(rm.sun_unit(rcfg.sun_dir)).to(dev)
    s = rm.init_state(torch.as_tensor(pos, dtype=f32, device=dev), dirs,
                      torch.ones(N, dtype=f32, device=dev))
    s, raw0, _ = rm.start_cell(scene, s)
    s, _ = rm.fast_march(scene, s, rcfg, rcfg.max_steps, time_s=rcfg.time)
    total = int(s.steps.to(torch.int64).sum())
    if rcfg.enable_shadows:
        facing = sun[s.last_axis.long()] * -rm._get(s.step, s.last_axis) > 0
        active = (s.mat != 0) & facing & ~s.reflected & ~raw0
        p = s.seg_origin + s.last_t[:, None] * s.dir
        sh = rm.shadow_start(p, s.cell, s.last_axis, sun, active)
        sh, _ = rm.fast_march(scene, sh, rcfg, rcfg.shadow_steps, shadow=True)
        total += int(sh.steps.to(torch.int64).sum())
    return total


def launch_bound(grid_cells: int, n_flags: int, n_rays: int, crossings: int) -> float:
    return bound_s(grid_cells + n_flags * 4 + n_rays * (72 + 88), crossings * OPS_PER_CROSSING)
