"""The fit's check: the reference (``reference/train.py``) follows the
program's first ``checked_steps`` steps from the same seed, then rebuilds
the window's last guide and marches its last batch. Four numbers are
compared; the first three are relative gaps:

    loss_gap    the worst step's |loss - reference loss| / reference loss
    grad_gap    the first gradient as Adam got it (its first moment after
                one step over 1 - beta1), by the worst field: the gap between
                the program's norm and the reference's, over the larger of
                the reference's norm of that field and the median field's
    change_gap  the same for each field's change over the checked steps;
                fields whose reference gradient is under a thousandth of the
                median field's are left out (they move by round-off alone)
    seed_off    the share of the window's last batch whose seed (the lean
                march's hit distance less the margin, or the miss sentinel)
                is off the reference's by more than ``SEED_TOL`` cells. The
                reference thresholds its own guide from the density field
                the program's last rebuild thresholded (the program's state
                after thousands of steps: the reference cannot follow the fit
                that far) and casts the batch's rays from its own cameras

``control(run, out)`` is the reference at the precision below the
configuration's float32 in the program's place: its fields stored in
bfloat16 for the checked steps, its ray directions rounded to bfloat16 for
the seeds.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from reference import march as rm
from reference import scene as rs
from reference import train as rt
from reference import world as rw


SEED_TOL = 1e-2


@torch.no_grad()
def reference_seeds(run, out, dir_dtype=torch.float32):
    """The reference's seeds of the window's last batch, the occupied share
    of its guide, and the share of the batch seeded past the cell where it
    enters the grid (all of it hits there on a guide with nothing pruned)."""
    dev = run.device
    cam_pos, cam_dir = rt.ring_cameras(out["grid_shape"], out["views"])
    idx = torch.from_numpy(out["seed_idx"]).to(dev)
    o, d = rt.target_rays(cam_pos, cam_dir, out["resolution"], idx)
    d = d.to(dir_dtype).to(torch.float32)
    density = out["seed_density"].to(dev)
    guide = rt.guide_scene(density, run.config["fit"]["guide_tau"])
    occupied = float((guide.grid_enc < 128).double().mean())
    del density
    seeds = rt.seeds(guide, o, d)
    hi = torch.tensor(out["grid_shape"], dtype=torch.float32, device=dev)
    _, _, delta, _ = rm._build_ray(d)
    t_entry = torch.amax(torch.minimum(-o * delta, (hi - o) * delta), dim=1).clamp(min=0.0)
    past = float((seeds > torch.clamp(t_entry - 3.0, min=0.0) + 1.0).double().mean())
    return seeds.cpu(), occupied, past


def reference_fit(run, out, field_dtype=torch.float32):
    """(losses, first gradient norms, change norms) of the reference fit."""
    c = run.config
    dev = run.device
    grid, pal = rw.gen_world(c["world"])
    albedo, flags, _ = pal.arrays()
    scene = rs.ref_scene(grid, albedo, flags, dev)
    del grid
    fit = c["fit"]
    res, views, batch = out["resolution"], out["views"], out["batch"]
    cam_pos, cam_dir = rt.ring_cameras(out["grid_shape"], views)
    render = dict(c["render"])
    rcfg = rm.RCfg(width=res, height=res, max_steps=render["max_steps"],
                   shadow_steps=render["shadow_steps"], fov_degrees=render["fov_degrees"],
                   sun_dir=tuple(render["sun_dir"]), enable_shadows=False)
    ref = rt.Fit(out["grid_shape"], fit["lr"], field_dtype=field_dtype, device=dev)
    rng = np.random.default_rng(run.seed)
    losses, guide = [], None
    for k in range(len(out["losses"])):
        if guide is None or k % fit["rethreshold_every"] == 0:
            guide = rt.guide_scene(ref.density_raw, fit["guide_tau"])
        idx = torch.from_numpy(rng.integers(0, out["N"], batch)).to(dev)
        o, d, tgt = rt.target_rows(scene, cam_pos, cam_dir, res, idx, rcfg)
        loss, grads = ref.loss_and_grads(guide, o, d, tgt, fit["guided_steps"])
        if k == 0:
            grad_norms = [float(g.double().norm()) for g in grads]
        ref.adam(grads)
        losses.append(loss)
        del o, d, tgt, grads
    init = (-2.0, 0.0)
    change = [float((p - p0).double().norm()) for p, p0 in zip(ref.leaves(), init)]
    return losses, grad_norms, change


def norm_gap(prog, ref, keep=None) -> float:
    """Worst field's |norm - reference norm| over max(its reference norm,
    the median field's)."""
    med = statistics.median(ref)
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx)


def seed_off(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of the reference's rays whose seed the program gives off by
    more than ``SEED_TOL`` cells, or not at all."""
    n = min(prog.shape[0], ref.shape[0])
    off = int(((prog[:n] - ref[:n]).abs() > SEED_TOL).sum())
    return (off + ref.shape[0] - n) / ref.shape[0]


def control(run, out) -> dict:
    losses, grads, change = reference_fit(run, out, torch.bfloat16)
    seeds = reference_seeds(run, out, torch.bfloat16)[0]
    return dict(out, losses=losses, grad_norms=grads, change_norms=change, seeds=seeds)


def check(run, out) -> dict:
    losses, grads, change = reference_fit(run, out)
    med = statistics.median(grads)
    keep = [g >= 1e-3 * med for g in grads]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses))
    seeds, occupied, past = reference_seeds(run, out)
    print(f"bench: seeds: the last guide {100 * occupied:.4f}% occupied; "
          f"{100 * past:.3f}% of the last batch seeded past its grid entry", file=sys.stderr)
    return {"loss_gap": loss_gap,
            "grad_gap": norm_gap(out["grad_norms"], grads),
            "change_gap": norm_gap(out["change_norms"], change, keep),
            "seed_off": seed_off(out["seeds"], seeds)}
