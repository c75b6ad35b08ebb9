"""Progressive refinement: a coarse depth pass seeds the full-resolution march.

Port of ``seed_from_depth`` (``raytracing_test_tpu/render/progressive.py:43``),
the step that turns a 1/factor-resolution depth image into per-ray seeds
(the reference shaders' mid_res 8-neighbour minimum, mid_res.frag:211-217).
``kernels/fused_march.py:seed_depth_fused`` runs the two marches around it.
"""

from __future__ import annotations

import torch


def seed_from_depth(depth, factor: int, H: int, W: int, margin: float = 2.0):
    """Min over the 3x3 coarse neighbourhood, upsampled to [H*W] seeds."""
    d = depth
    pad = torch.nn.functional.pad(d[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    mins = d
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            mins = torch.minimum(mins, pad[1 + dy: 1 + dy + d.shape[0], 1 + dx: 1 + dx + d.shape[1]])
    seeds = torch.clamp(mins - margin, min=0.0)
    seeds = seeds.repeat_interleave(factor, dim=0).repeat_interleave(factor, dim=1)
    seeds = seeds[:H, :W]
    # never skip past the far sentinel
    return torch.clamp(seeds, max=1e5).reshape(H * W)
