"""What one train step's window launch pair (``window_fwd`` + ``window_bwd``,
csrc/fused_window.cu) must move and compute, counted from its inputs.

The inputs are worked out again from the step's rays and the guide it ran
on, by the reference's seed march and window preamble
(``reference/train.py``), so the count does not depend on what implements
the kernels. Per ray the forward reads cell, tmax, step and abs_delta
(48 B) and writes surf, t_end, w_sum and t_exp (24 B); the backward reads
those 48 B and g_surf, g_tend, surf and t_end (32 B) and writes the tmax
and abs_delta cotangents (24 B). Each distinct in-grid field row the
windows sample is read once by each kernel (16 B) and its gradient row is
read and written once (32 B). The dense [V, 4] zero-fill of the gradient is
glue (it shows in ``step_ms.train``) and is not counted. Float32
operations per sample: 20 forward (enumerate 5, exp and composite 11,
w_sum and t_exp 4), 36 backward (enumerate 5, exp and weights 4, g_od 7,
field grads 8, pose 12).
"""

from __future__ import annotations

import torch

from reference import march as rm
from reference import train as rt
from roofline.peaks import bound_s

FWD_OPS_PER_SAMPLE = 20
BWD_OPS_PER_SAMPLE = 36


@torch.no_grad()
def distinct_rows(cell, tmax, istep, abs_delta, shape3, S: int) -> int:
    """Distinct in-grid rows the S-step windows of these rays sample."""
    rows = []
    for _ in range(S):
        lin, inside = rt._window_lin(shape3, cell)
        rows.append(lin[inside])
        oh = torch.nn.functional.one_hot(rm._argmin_axis(tmax).long(), 3).to(torch.bool)
        cell = torch.where(oh, cell + istep, cell)
        tmax = torch.where(oh, tmax + abs_delta, tmax)
    return int(torch.unique(torch.cat(rows)).numel())


def pair_bound(n_rays: int, rows: int, S: int) -> float:
    fwd = bound_s(n_rays * (48 + 24) + rows * 16, n_rays * S * FWD_OPS_PER_SAMPLE)
    bwd = bound_s(n_rays * (48 + 32 + 24) + rows * (16 + 32), n_rays * S * BWD_OPS_PER_SAMPLE)
    return fwd + bwd


@torch.no_grad()
def step_bound(guide, origins, dirs, grid_shape, S: int) -> float:
    """Seconds the window pair of one step needs at the card's peaks.
    ``guide`` is any scene with ``grid_enc``, ``flags``, ``albedo``,
    ``y_max`` and ``shape3``."""
    seed = rt.seeds(guide, origins, dirs)
    cell, tmax, istep, absd = rt.window_inputs(tuple(grid_shape), origins, dirs, seed)
    rows = distinct_rows(cell, tmax, istep, absd, tuple(grid_shape), S)
    return pair_bound(dirs.shape[0], rows, S)
