"""Plain reference of one guided fit: the ring of target views, the
occupancy guide, the lean seed march, the 24-step volumetric window with
its gradients, the MSE loss and Adam.

The guide, the window's preamble and the window itself are frozen copies
of the port's ``parallel/sharding.py:guide_scene_from_params``,
``render/diff.py:_ray_start`` and ``kernels/fused_window.py:window_plain``
(arithmetic unchanged: rows are gathered from a float64 copy of the
fields, so autograd sums the field gradient in float64 while every value
stays the float32 one); the seed march is ``reference/march.py``. Adam is
written out from its paper (Kingma and Ba, 2015). It imports nothing of
the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import march as rm
from .scene import RefScene, build_grid_enc, y_max

MISS_SEED_MIN = 9.9e5
DENSITY_SCALE = 25.0


def ring_cameras(grid_shape, n: int):
    """(positions [n, 3], directions [n, 3]) of the fit's ring of views
    around the grid's centre, as float32 tensors on the CPU."""
    Sx, Sy, Sz = grid_shape
    cx, cy, cz = Sx / 2, Sy / 3, Sz / 2
    radius, height = 0.8 * Sx, 0.9 * Sy
    pos, dirs = [], []
    for i in range(n):
        a = 2 * math.pi * i / n
        p = (cx + radius * math.cos(a), height, cz + radius * math.sin(a))
        d = np.asarray([cx - p[0], cy - p[1], cz - p[2]], np.float32)
        d /= np.linalg.norm(d)
        pos.append(torch.tensor(p, dtype=torch.float32))
        dirs.append(torch.from_numpy(d))
    return torch.stack(pos), torch.stack(dirs)


def target_rays(cam_pos, cam_dir, res: int, idx: torch.Tensor):
    """(origins, dirs) of the target rays ``idx`` (view-major, row-major
    pixels), on ``idx``'s device."""
    dev = idx.device
    n_pix = res * res
    view = idx // n_pix
    origins = torch.empty((idx.shape[0], 3), dtype=torch.float32, device=dev)
    dirs = torch.empty_like(origins)
    for v in torch.unique(view).tolist():
        sel = view == v
        d = rm.ray_directions(cam_dir[v].to(dev), res, res)
        dirs[sel] = d[idx[sel] - v * n_pix]
        origins[sel] = cam_pos[v].to(dev)
    return origins, dirs


def target_rows(scene: RefScene, cam_pos, cam_dir, res: int, idx: torch.Tensor, rcfg: rm.RCfg):
    """(origins, dirs, target rgb) of the target rays ``idx``, rendered by
    the plain march with shadows off."""
    origins, dirs = target_rays(cam_pos, cam_dir, res, idx)
    col, _, _ = rm.render_rays(scene, origins, dirs, rcfg)
    return origins, dirs, col


def guide_scene(density_raw: torch.Tensor, tau: float) -> RefScene:
    """The occupancy guide of the evolving density: one white material where
    ``softplus(raw) * 25 > tau``."""
    with torch.no_grad():
        dens = (torch.nn.functional.softplus(density_raw) * DENSITY_SCALE).cpu().numpy()
    occ = (dens > tau).astype(np.uint8)
    dev = density_raw.device
    flags = np.zeros(8, np.int32)
    flags[1] = 1
    albedo = np.zeros((8, 3), np.float32)
    albedo[1] = 1.0
    return RefScene(torch.from_numpy(build_grid_enc(occ)).to(dev), torch.from_numpy(flags).to(dev),
                    torch.from_numpy(albedo).to(dev), y_max(occ))


@torch.no_grad()
def seeds(guide: RefScene, origins, dirs, margin: float = 3.0):
    """Window seeds: ``margin`` cells before each ray's first hit on the
    guide (the lean march), 1e6 for a ray that hits nothing."""
    rcfg = rm.RCfg(width=1, height=dirs.shape[0], enable_materials=False, enable_shadows=False)
    _, hit, p = rm.render_rays(guide, origins, dirs, rcfg)
    t_hit = rm._norm3(p - origins)
    return torch.where(hit, torch.clamp(t_hit - margin, min=0.0), rm._f32(1e6, t_hit))


def window_inputs(shape3, origin, dirs, start_t):
    """Slab fast-forward to the grid box, then the detached seed; rays seeded
    at the miss sentinel start at wrapped cell 1023, outside the grid."""
    f32 = torch.float32
    dev = dirs.device
    N = dirs.shape[0]
    Sx, Sy, Sz = shape3
    if origin.ndim == 1:
        origin = origin[None, :].expand(N, 3)
    d, step, delta, abs_delta = rm._build_ray(dirs)
    hi = torch.tensor([Sx, Sy, Sz], dtype=f32, device=dev)
    t1 = (0.0 - origin) * delta
    t2 = (hi[None, :] - origin) * delta
    t_entry = torch.amax(torch.minimum(t1, t2), dim=1)
    t0 = torch.clamp(t_entry - 1e-3, min=0.0)
    st = torch.as_tensor(start_t, dtype=f32, device=dev).detach()
    t0 = torch.maximum(t0, st)
    dead = st >= MISS_SEED_MIN
    origin_b = origin + t0[:, None] * d
    cell = torch.floor(origin_b).to(torch.int32)
    cell = torch.where(dead[:, None], torch.full_like(cell, 1023), cell)
    tmax = rm._init_tmax(origin_b, cell, step, delta, abs_delta)
    return cell, tmax, step.to(torch.int32), abs_delta


def _window_lin(shape3, cell):
    Sx, Sy, Sz = shape3
    c = cell & 1023
    inside = (c[:, 0] < Sx) & (c[:, 1] < Sy) & (c[:, 2] < Sz)
    lin = (c[:, 0] * Sy + c[:, 1]) * Sz + c[:, 2]
    return torch.where(inside, lin, torch.zeros_like(lin)).long(), inside


def window(field, cell, tmax, istep, abs_delta, shape3, S: int):
    """The S-step emission-absorption window over the packed [V, 4] field
    (sigma, r, g, b), unshaded: returns the surface colour [N, 3]."""
    f32 = torch.float32
    field64 = field.double()
    tx, ty, tz = tmax.unbind(1)
    ax, ay, az = abs_delta.unbind(1)
    c = cell
    T = torch.ones_like(tx)
    acc = torch.zeros_like(tmax)
    t_cur = torch.zeros_like(tx)
    for _ in range(S):
        mx = (tx < ty) & (tx < tz)
        my = ~mx & (ty < tz)
        mz = ~(mx | my)
        tn = torch.where(mx, tx, torch.where(my, ty, tz))
        d = tn - t_cur
        dt = d + (torch.clamp(d, min=0.0) - d).detach()
        lin, inside = _window_lin(shape3, c)
        row = field64[lin].to(f32) * inside[:, None].to(f32)
        e = torch.exp(-row[:, 0] * dt)
        w = T * (1.0 - e)
        acc = acc + w[:, None] * row[:, 1:]
        T = T * e
        m3 = torch.stack([mx, my, mz], dim=1)
        c = torch.where(m3, c + istep, c)
        tx = torch.where(mx, tx + ax, tx)
        ty = torch.where(my, ty + ay, ty)
        tz = torch.where(mz, tz + az, tz)
        t_cur = tn
    return acc


class Fit:
    """The reference fit's state: the two raw fields and Adam's moments.
    ``field_dtype`` stores the fields the window reads in a lower precision
    (the control)."""

    def __init__(self, grid_shape, lr: float, field_dtype=torch.float32, device="cuda"):
        Sx, Sy, Sz = grid_shape
        self.shape3 = (Sx, Sy, Sz)
        self.density_raw = torch.full((Sx, Sy, Sz), -2.0, dtype=torch.float32, device=device)
        self.albedo_raw = torch.zeros((Sx, Sy, Sz, 3), dtype=torch.float32, device=device)
        self.m = [torch.zeros_like(p) for p in self.leaves()]
        self.v = [torch.zeros_like(p) for p in self.leaves()]
        self.t = 0
        self.lr = lr
        self.field_dtype = field_dtype

    def leaves(self):
        return [self.density_raw, self.albedo_raw]

    def loss_and_grads(self, guide: RefScene, origins, dirs, targets, S: int):
        seed = seeds(guide, origins, dirs)
        cell, tmax, istep, absd = window_inputs(self.shape3, origins, dirs, seed)
        leaves = [p.detach().requires_grad_(True) for p in self.leaves()]
        density = torch.nn.functional.softplus(leaves[0]) * DENSITY_SCALE
        albedo = torch.sigmoid(leaves[1])
        field = torch.cat([density.reshape(-1, 1), albedo.reshape(-1, 3)], dim=1)
        field = field.to(self.field_dtype).to(torch.float32)
        rgb = window(field, cell, tmax, istep, absd, self.shape3, S)
        loss = torch.mean((rgb - targets) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), grads

    @torch.no_grad()
    def adam(self, grads, b1=0.9, b2=0.999, eps=1e-8):
        self.t += 1
        for p, g, m, v in zip(self.leaves(), grads, self.m, self.v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + eps))
