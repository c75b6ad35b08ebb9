"""Progressive refinement: a coarse depth pass seeds the full-resolution march.

Port of ``raytracing_test_tpu/render/progressive.py``: ``coarse_depth``
(:29), ``seed_from_depth`` (:43), the step that turns a 1/factor-resolution
depth image into per-ray seeds (the reference shaders' mid_res 8-neighbour
minimum, mid_res.frag:211-217), and ``render_image_progressive`` (:59), the
coarse-to-fine frame. Both of its passes march through
``kernels/fused_march.render_rays_fused``: the CUDA kernel for CUDA tensors,
its plain version (the reference's ``fast`` march) for CPU tensors. Also
``seeds_from_hits``, the window seeds of a hard march, and ``guided_seeds``,
the coarse-then-full scheme around a given march
(``kernels/fused_march.py:seed_depth_fused`` on the fused march).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..config import RenderConfig
from ..core.flatten import Scene
from .camera import Camera, ray_directions
from .renderer import _f32, _norm3

FAR_SEED = 1e5  # seed_from_depth's cap: every coarse neighbour of the ray saw sky


def seeds_from_hits(aux, origin, margin: float, start_t=None):
    """Window seeds from a hard march's aux: ``margin`` before each ray's hit
    point (from ``origin``), or the 1e6 sky sentinel.

    A ray started at ``FAR_SEED`` starts 1e5 cells out, far beyond any grid,
    where only the &1023 wrap of its start cell can make a hit, on a cell
    that is nowhere near the ray: it is sky. (The reference reports such a
    hit, at 1e5, and its window then renders the wrapped cells; ROADMAP.md,
    faults.)"""
    o = origin if origin.ndim == 2 else origin[None, :]
    t_hit = _norm3(aux["hit_pos"] - o)
    seed = torch.where(aux["hit"], torch.clamp(t_hit - margin, min=0.0), _f32(1e6, t_hit))
    if start_t is not None:
        seed = torch.where(start_t >= FAR_SEED, _f32(1e6, seed), seed)
    return seed


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
    return torch.clamp(seeds, max=FAR_SEED).reshape(H * W)


@torch.no_grad()
def guided_seeds(hard_render, scene, origin, dirs, margin: float, image_hw=None,
                 coarse_factor: int = 4, max_steps: int = None):
    """Window seeds from a lean hard march: ``margin`` before each ray's first
    hit, 1e6 for sky (``render/diff.py:render_rays_diff_guided``'s scheme,
    reference :497-528; ``seed_depth_fused``). ``hard_render(scene, origin,
    dirs, cfg, start_t=None) -> (rgb, aux)`` is the march. With
    ``image_hw=(H, W)`` (the rays form one camera's image) the march is
    seeded by a 1/coarse_factor depth pass through ``seed_from_depth``."""
    f32 = torch.float32
    origin = torch.as_tensor(origin, dtype=f32, device=scene.device)
    dirs = torch.as_tensor(dirs, dtype=f32, device=scene.device)
    kw = dict(enable_materials=False, enable_shadows=False)
    if max_steps is not None:
        kw["max_steps"] = max_steps
    start_t = None
    if image_hw is not None:
        H, W = image_hw
        cf = coarse_factor
        if H % cf or W % cf:
            raise ValueError(f"image_hw {image_hw} must be divisible by coarse_factor {cf}")
        if origin.ndim != 1:
            raise ValueError("guided_seeds: camera images share one origin")
        cdirs = dirs.reshape(H, W, 3)[cf // 2::cf, cf // 2::cf].reshape(-1, 3).contiguous()
        _, caux = hard_render(scene, origin, cdirs, RenderConfig(width=W // cf, height=H // cf, **kw))
        depth = seeds_from_hits(caux, origin, 0.0)
        start_t = seed_from_depth(depth.reshape(H // cf, W // cf), cf, H, W)
    # the fine pass's config is the image's own when the rays are one
    fw, fh = (image_hw[1], image_hw[0]) if image_hw is not None else (1, dirs.shape[0])
    _, aux = hard_render(scene, origin, dirs, RenderConfig(width=fw, height=fh, **kw),
                         start_t=start_t)
    return seeds_from_hits(aux, origin, margin, start_t)


def coarse_depth(scene: Scene, camera: Camera, cfg: RenderConfig, factor: int):
    """Render at 1/factor resolution; returns the straight-ray hit t [h, w]
    (0 where the ray was reflected or refracted, 1e6 for sky)."""
    from ..kernels.fused_march import render_rays_fused

    h, w = cfg.height // factor, cfg.width // factor
    ccfg = replace(cfg, width=w, height=h, enable_shadows=False, enable_ao=False)
    dirs = ray_directions(camera, w, h, cfg.fov_degrees)
    _, aux = render_rays_fused(scene, camera.pos, dirs, ccfg, image_w=w)
    t = _norm3(aux["hit_pos"] - camera.pos[None, :])
    usable = aux["hit"] & ~aux["reflected"]
    # sky pixels seed "very far": min-of-neighbourhood keeps edges safe
    t = torch.where(usable, t, torch.where(aux["hit"], _f32(0.0, t), _f32(1e6, t)))
    return t.reshape(h, w)


def render_image_progressive(scene: Scene, camera: Camera, cfg: RenderConfig, factor: int = 4,
                             margin: float = 2.0):
    """Coarse-to-fine frame render; returns (image [H,W,3], fine aux)."""
    from ..kernels.fused_march import render_rays_fused

    depth = coarse_depth(scene, camera, cfg, factor)
    seeds = seed_from_depth(depth, factor, cfg.height, cfg.width, margin)
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, aux = render_rays_fused(scene, camera.pos, dirs, cfg, start_t=seeds, image_w=cfg.width)
    return col.reshape(cfg.height, cfg.width, 3), aux
