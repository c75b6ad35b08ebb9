"""Fused march: one CUDA launch runs the whole primary march and the sun
shadow of every ray (csrc/fused_march.cu).

Port of ``raytracing_test_tpu/kernels/fused_march.py``. ``fused_march_call``
returns the same per-ray dict as the reference's; ``render_rays_fused`` and
``render_image_fused`` feed it to the shared ``renderer.shade`` exactly as
the reference does (:869-902).

Dispatch is by the device of the tensors: CPU tensors run the plain PyTorch
version (render/fast.py), CUDA tensors launch the kernel or raise. There is
no fallback from one to the other. ``LAUNCHES`` counts kernel launches, so a
caller can show that a run went through the kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import RenderConfig
from ..core.flatten import Scene
from ..core.types import Properties
from ..render import fast
from ..render.camera import Camera, ray_directions
from ..render.renderer import _build_ray, _f32, _get, _March, _norm3, shade

LAUNCHES = 0  # kernel launches in this process (never incremented by the plain path)

_KMAX_MAT = 128


def fused_march_plain(scene: Scene, s: _March, cfg: RenderConfig, time_s) -> Dict[str, torch.Tensor]:
    """The kernel's plain PyTorch version: fast_march, then the shadow march
    on the lanes that ``shade`` reads it on."""
    s, raw0, mat0 = fast.start_cell(scene, s)
    s, _ = fast.fast_march(scene, s, cfg, cfg.max_steps, shadow=False, time_s=time_s)
    shad = torch.zeros_like(raw0)
    if cfg.enable_shadows:
        sun = torch.from_numpy(fast.sun_unit(cfg.sun_dir)).to(s.dir.device)
        facing = sun[s.last_axis.long()] * -_get(s.step, s.last_axis) > 0
        active = (s.mat != 0) & facing & ~s.reflected & ~raw0
        p = s.seg_origin + s.last_t[:, None] * s.dir
        shad = fast._shadow_march_fast(scene, p, s.cell, s.last_axis, s.step, cfg, sun, active)
    return {
        "mat0": mat0, "mat": s.mat, "cell": s.cell, "la": s.last_axis,
        "refl": s.reflected, "shad": shad, "steps": s.steps, "dir": s.dir,
        "step": s.step, "seg_origin": s.seg_origin, "lt": s.last_t,
        "color_mod": s.color_mod,
    }


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"fused_march: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"fused_march: {name} must be contiguous")


def _launch(scene: Scene, s: _March, cfg: RenderConfig, time_s) -> Dict[str, torch.Tensor]:
    global LAUNCHES
    from . import build

    lib = build.library("fused_march")
    dev = s.cell.device
    N = s.cell.shape[0]
    i32, f32 = torch.int32, torch.float32
    Sx, Sy, Sz = scene.shape3
    _check(scene.grid_enc, "grid_enc", torch.uint8, (Sx, Sy, Sz), dev)
    _check(scene.flags, "flags", i32, scene.flags.shape, dev)
    if scene.flags.ndim != 1 or scene.flags.shape[0] > _KMAX_MAT:
        raise ValueError(f"fused_march: flags must be 1-D with <= {_KMAX_MAT} entries")
    ins = [s.cell, s.tmax, s.dir, s.step, s.abs_delta, s.seg_origin]
    names = ["cell", "tmax", "dir", "step", "abs_delta", "seg_origin"]
    for t, name in zip(ins, names):
        _check(t, name, i32 if name == "cell" else f32, (N, 3), dev)

    out = {
        "mat0": torch.empty(N, dtype=i32, device=dev),
        "mat": torch.empty(N, dtype=i32, device=dev),
        "cell": torch.empty((N, 3), dtype=i32, device=dev),
        "la": torch.empty(N, dtype=i32, device=dev),
        "refl": torch.empty(N, dtype=i32, device=dev),
        "shad": torch.empty(N, dtype=i32, device=dev),
        "steps": torch.empty(N, dtype=i32, device=dev),
        "dir": torch.empty((N, 3), dtype=f32, device=dev),
        "step": torch.empty((N, 3), dtype=f32, device=dev),
        "seg_origin": torch.empty((N, 3), dtype=f32, device=dev),
        "lt": torch.empty(N, dtype=f32, device=dev),
        "color_mod": torch.empty((N, 3), dtype=f32, device=dev),
    }
    sun = fast.sun_unit(cfg.sun_dir)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_march_launch(
        scene.grid_enc.data_ptr(), scene.flags.data_ptr(), scene.flags.shape[0],
        Sx, Sy, Sz, int(scene.y_max),
        int(cfg.max_steps), int(cfg.shadow_steps),
        int(cfg.enable_materials), int(cfg.enable_shadows),
        float(time_s), float(sun[0]), float(sun[1]), float(sun[2]),
        *[t.data_ptr() for t in ins],
        N,
        *[t.data_ptr() for t in out.values()],
        stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_march kernel launch failed: {lib.kernel_error_string(err).decode()}"
        )
    LAUNCHES += 1
    out["refl"] = out["refl"] != 0
    out["shad"] = out["shad"] != 0
    return out


def fused_march_call(scene: Scene, s: _March, cfg: RenderConfig, time_s=None) -> Dict[str, torch.Tensor]:
    """Run the fused march on a ``fast._init_state`` state ``s``.

    Returns the per-ray dict of the reference ``fused_march_call`` (:793-804):
    mat0, mat, cell, la, refl, shad, steps, dir, step, seg_origin, lt,
    color_mod. CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise).
    """
    if time_s is None:
        time_s = cfg.time
    dev = s.cell.device
    if scene.device != dev:
        raise ValueError(f"fused_march: scene on {scene.device}, rays on {dev}")
    if dev.type == "cpu":
        return fused_march_plain(scene, s, cfg, time_s)
    if dev.type != "cuda":
        raise ValueError(f"fused_march: unsupported device {dev}")
    return _launch(scene, s, cfg, float(time_s))


def render_rays_fused(scene: Scene, origin, dirs, cfg: RenderConfig, start_t=None, time_s=None):
    """Fused-march render of arbitrary rays -> (rgb [N,3], aux), shaded by the
    shared ``renderer.shade`` on the kernel's outputs."""
    f32 = torch.float32
    dev = scene.device
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    N = dirs.shape[0]
    if time_s is None:
        time_s = cfg.time

    s = fast._init_state(origin, dirs, torch.ones(N, dtype=f32, device=dev), start_t=start_t)
    return shade_outputs(scene, fused_march_call(scene, s, cfg, time_s), cfg)


def shade_outputs(scene: Scene, o: Dict[str, torch.Tensor], cfg: RenderConfig):
    """``renderer.shade`` on a ``fused_march_call`` dict -> (rgb [N,3], aux)."""
    f32 = torch.float32
    dev = scene.device
    N = o["mat"].shape[0]
    mat0 = o["mat0"]
    raw0 = (mat0 != 0) & ((scene.flags[mat0.long()] & int(Properties.REFRACTIVE)) == 0)
    _, _, _, abs_delta = _build_ray(o["dir"])
    state = _March(
        mat=o["mat"],
        cell=o["cell"],
        dir=o["dir"],
        step=o["step"],
        abs_delta=abs_delta,
        tmax=torch.zeros((N, 3), dtype=f32, device=dev),
        seg_origin=o["seg_origin"],
        last_t=o["lt"],
        last_axis=o["la"],
        color_mod=o["color_mod"],
        ior=torch.ones(N, dtype=f32, device=dev),
        reflected=o["refl"],
        done=torch.ones(N, dtype=torch.bool, device=dev),
        steps=o["steps"],
    )
    sun = torch.from_numpy(fast.sun_unit(cfg.sun_dir)).to(dev)
    shad = o["shad"]
    return shade(scene, state, raw0, mat0, sun, cfg,
                 lambda p, cell, la, step, active: shad & active)


def render_image_fused(scene: Scene, camera: Camera, cfg: RenderConfig, time_s=None):
    """Full frame [H, W, 3] through the fused march, crosshair included."""
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, _ = render_rays_fused(scene, camera.pos, dirs, cfg, time_s=time_s)
    return fast.crosshair(col.reshape(cfg.height, cfg.width, 3), cfg)


def hit_seeds(scene: Scene, origin, dirs, cfg: RenderConfig, margin: float, start_t=None):
    """Window seeds from one lean march: ``margin`` cells before each ray's
    first solid hit, or the 1e6 sky sentinel (``render/diff.py`` MISS_SEED_MIN)."""
    _, aux = render_rays_fused(scene, origin, dirs, cfg, start_t=start_t)
    o = torch.as_tensor(origin, dtype=torch.float32, device=scene.device)
    t_hit = _norm3(aux["hit_pos"] - (o if o.ndim == 2 else o[None, :]))
    return torch.where(aux["hit"], torch.clamp(t_hit - margin, min=0.0), _f32(1e6, t_hit))


def seed_depth_fused(scene: Scene, origin, dirs, image_hw, coarse_factor: int = 4,
                     margin: float = 3.0, prox: bool = False, max_steps: int = None):
    """Window-seed depths from the fused march (``seed_depth_fused``,
    ``raytracing_test_tpu/kernels/fused_march.py:905``): a 1/coarse_factor
    resolution lean march seeds a full-resolution lean march whose
    first-solid depths, less ``margin``, become the window seeds (1e6 = sky).

    ``prox`` (stop at the first surface-brick entry) needs the march kernel's
    prox_stop mode, which is not ported yet (ROADMAP.md, queue item 5).
    """
    from ..render import progressive

    if prox:
        raise NotImplementedError(
            "seed_depth_fused(prox=True): the march kernel's prox_stop mode is not "
            "ported yet; see ROADMAP.md, 'Modules to port', item 5"
        )
    H, W = image_hw
    cf = coarse_factor
    dev = scene.device
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    if origin.ndim != 1:
        raise ValueError("seed_depth_fused: camera images share one origin")
    kw = {} if max_steps is None else {"max_steps": max_steps}
    rc = RenderConfig(width=W // cf, height=H // cf,
                      enable_materials=False, enable_shadows=False, **kw)
    rn = RenderConfig(width=W, height=H, enable_materials=False, enable_shadows=False, **kw)
    cdirs = dirs.reshape(H, W, 3)[cf // 2::cf, cf // 2::cf].reshape(-1, 3).contiguous()
    depth = hit_seeds(scene, origin, cdirs, rc, margin=0.0)
    st = progressive.seed_from_depth(depth.reshape(H // cf, W // cf), cf, H, W)
    return hit_seeds(scene, origin, dirs, rn, margin=margin, start_t=st)
